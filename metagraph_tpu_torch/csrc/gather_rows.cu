// The gather micro-benchmark's kernels: out[0, :] = sum over i < n of
// tab[clamp(idx[i]), :] mod 2^32, n = nblocks * QB (the ragged tail of the
// indices is left out by the wrapper), indices clamped to [0, n_rows) as a
// dynamic slice clamps its start.
//
//   gather_loop replaces scripts/exp_pallas_gather.py::make_loop_kernel.run
//     (:54, pl.pallas_call :57): a fori_loop of dynamic one-row loads into a
//     (1, W) accumulator, carried in out_ref across a sequential grid.
//     Here: rows summed in registers.
//   gather_take replaces make_take_kernel.run (:82, pl.pallas_call :85):
//     jnp.take of the (QB, W) tile, then a sum over axis 0.  Here: rows
//     staged in shared memory, each stage reduced as it lands.
//
// What bounds them on an H100: the table (8.4 or 16.8 MB at the script's
// sizes) stays in the 50 MB L2, so device memory sees the indices and the
// table once (the bytes bound, 0.0100 ms at 2^17 rows), while the gathered
// bytes (128 B a row at W = 32, 512 MB a sweep call) come from L2.  What
// limits them is the L2's rate for random 128 B rows and the bytes a design
// keeps in flight to reach it.  chip_smoke.py's controls measure that rate
// on one H100 (PERF.md, section 6): 2^22 random rows of the 2^17-row
// table take gather_loop 0.078 ms (6.9 TB/s), the same rows in order 0.051
// ms (10.6 TB/s), and random rows of a 268 MB table, out of L2, 0.17 ms
// (3.2 TB/s of rows from device memory).
//
// What both designs do about it:
// * A persistent grid: as many blocks as fit on the SMs (the wrapper asks
//   the occupancy API), block b summing the even share [n b / grid,
//   n (b + 1) / grid) of the indices whatever the chunking, and ending with
//   one atomicAdd per word.  uint32 addition is associative and
//   commutative mod 2^32, so the result is exact and does not depend on the
//   split or on the order of the atomics.
// * W a template parameter (4, 8, .., 256): row shapes are compile-time.
// * Indices fetched ahead of the rows that need them.
//
// gather_loop: a warp step takes 8 rows a lane: each lane loads 16 B of 8
// different rows (ld.global.nc.v4; 8 lanes a row at W = 32, so one warp
// instruction brings 4 whole rows; at W = 256 a lane loads 32 B of each
// row), 128 B in flight a lane, 4 blocks of 8 warps an SM at 64 registers
// (W = 32).  The next step's indices are loaded (__ldcs: evict-first, so
// the table keeps L2) before this step's rows.  Lanes holding the same words
// meet by __shfl_xor_sync, the warps in shared memory.  Measured and
// dropped: 4 and 16 rows a lane (no faster at random rows, slower in
// order), an L2 evict_last hint on the rows (slower).
//
// gather_take: a ring of STAGES stages of 16 KB (4,096 / W rows each) in
// dynamic shared memory, 3 blocks an SM; rows are copied with 16-byte
// cp.async.cg, 4 copies a thread a stage, consecutive threads on one row.
// Each stage's indices are copied into shared memory (4-byte cp.async.ca)
// 2 (STAGES - 1) stages ahead, so a row copy reads an index that landed
// long before.  One barrier a stage: after cp.async.wait_group, one
// __syncthreads both publishes stage t and frees stage t - 1's slot, which
// is refilled right after it.  A stage is read back with 16-byte
// ld.shared.v4, 4 a thread, each thread summing the same 4 words of every
// stage.  Row addresses are 16-byte aligned: the wrapper checks the table's
// alignment, and W >= 4.  It runs at 6.0 TB/s with random and sequential
// rows alike: the copy path, not the L2's random rate, holds it.  Measured
// and dropped: rings of 6 and 8 stages or of 8 KB stages (slower), and the
// ring filled by Hopper's bulk copies (one cp.async.bulk of 4 W bytes a
// row from a producer warp, mbarrier full/empty pairs): 0.34 ms, 3.8x
// slower, the TMA unit's rate for 128 B requests.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 8;                    // rows in flight per lane (loop)
constexpr int STAGES = 4;               // take: ring depth
constexpr int STAGE_WORDS = 4096;       // take: 16 KB a stage
constexpr int STAGE_CHUNKS = STAGE_WORDS / 4;
constexpr int LAG = STAGES - 1;         // stages of rows in flight

__device__ __forceinline__ int clamp_row(int32_t r, int n_rows) {
    return min(max(r, 0), n_rows - 1);
}

__device__ __forceinline__ uint4 &operator+=(uint4 &a, const uint4 &b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
    return a;
}

__device__ __forceinline__ unsigned smem_addr(const void *p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 ld_shared4(const uint4 *p) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(smem_addr(p)));
    return v;
}

// this block's even share [lo, hi) of [0, n)
__device__ __forceinline__ void block_share(int64_t n, int64_t &lo,
                                            int64_t &hi) {
    lo = n * blockIdx.x / gridDim.x;
    hi = n * (blockIdx.x + 1) / gridDim.x;
}

// red (nred words in shared memory, word p of which adds to word p % W of
// the output) -> one atomicAdd per non-zero word
template <int W>
__device__ __forceinline__ void add_out(const uint32_t *red, int nred,
                                        uint32_t *__restrict__ out) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
        uint32_t s = 0;
        for (int p = w; p < nred; p += W)
            s += red[p];
        if (s)
            atomicAdd(out + w, s);
    }
}

// ---------------------------------------------------------------- loop --

template <int W>
struct LoopShape {
    static constexpr int CH = W / 4;                    // 16 B chunks a row
    static constexpr int CPL = CH > 32 ? CH / 32 : 1;   // chunks a lane a row
    static constexpr int LPR = CH < 32 ? CH : 32;       // lanes a row
    static constexpr int RPI = 32 / LPR;                // rows an instruction
    static constexpr int R = RPI * U;                   // rows a warp step
    static constexpr int NI = (R + 31) / 32;            // indices a lane
};

// the clamped indices of rows [s, s + R), -1 past hi
template <int W>
__device__ __forceinline__ void load_indices(int (&ix)[LoopShape<W>::NI],
                                             const int32_t *__restrict__ idx,
                                             int64_t s, int64_t hi,
                                             int n_rows, int lane) {
    using S = LoopShape<W>;
#pragma unroll
    for (int j = 0; j < S::NI; ++j) {
        const int64_t i = s + j * 32 + lane;
        ix[j] = (j * 32 + lane < S::R && i < hi)
                    ? clamp_row(__ldcs(idx + i), n_rows)
                    : -1;
    }
}

template <int W, bool TAIL>
__device__ __forceinline__ void loop_step(uint4 (&acc)[LoopShape<W>::CPL],
                                          const int (&ix)[LoopShape<W>::NI],
                                          const uint4 *__restrict__ tab4,
                                          int lane) {
    using S = LoopShape<W>;
    uint4 v[U][S::CPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int r = u * S::RPI + lane / S::LPR;   // r / 32 is compile-time
        const int row = __shfl_sync(FULL, ix[(u * S::RPI) / 32], r % 32);
#pragma unroll
        for (int c = 0; c < S::CPL; ++c) {
            if (!TAIL || row >= 0)
                v[u][c] = __ldg(tab4 + (int64_t)row * S::CH + lane % S::LPR +
                                32 * c);
            else
                v[u][c] = make_uint4(0, 0, 0, 0);
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < S::CPL; ++c)
            acc[c] += v[u][c];
}

template <int W>
__global__ void __launch_bounds__(THREADS)
gather_loop_kernel(const uint32_t *__restrict__ tab,
                   const int32_t *__restrict__ idx, uint32_t *__restrict__ out,
                   int64_t n, int n_rows) {
    using S = LoopShape<W>;
    extern __shared__ __align__(16) uint32_t red[];     // [WARPS][W]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint4 *tab4 = reinterpret_cast<const uint4 *>(tab);
    int64_t lo, hi;
    block_share(n, lo, hi);
    uint4 acc[S::CPL];
#pragma unroll
    for (int c = 0; c < S::CPL; ++c)
        acc[c] = make_uint4(0, 0, 0, 0);
    constexpr int64_t STRIDE = (int64_t)WARPS * S::R;
    int64_t s = lo + warp * S::R;
    int cur[S::NI];
    load_indices<W>(cur, idx, s, hi, n_rows, lane);
    for (; s < hi; s += STRIDE) {
        int nxt[S::NI];                 // the next step's, ahead of the rows
        load_indices<W>(nxt, idx, s + STRIDE, hi, n_rows, lane);
        if (s + S::R <= hi)
            loop_step<W, false>(acc, cur, tab4, lane);
        else
            loop_step<W, true>(acc, cur, tab4, lane);
#pragma unroll
        for (int j = 0; j < S::NI; ++j)
            cur[j] = nxt[j];
    }
    // lanes l, l + LPR, l + 2 LPR, .. hold the same words
#pragma unroll
    for (int c = 0; c < S::CPL; ++c)
#pragma unroll
        for (int off = S::LPR; off < 32; off <<= 1) {
            acc[c].x += __shfl_xor_sync(FULL, acc[c].x, off);
            acc[c].y += __shfl_xor_sync(FULL, acc[c].y, off);
            acc[c].z += __shfl_xor_sync(FULL, acc[c].z, off);
            acc[c].w += __shfl_xor_sync(FULL, acc[c].w, off);
        }
    if (lane < S::LPR) {
#pragma unroll
        for (int c = 0; c < S::CPL; ++c)
            reinterpret_cast<uint4 *>(red + warp * W)[lane + 32 * c] = acc[c];
    }
    __syncthreads();
    add_out<W>(red, WARPS * W, out);
}

// ---------------------------------------------------------------- take --

template <int W>
struct TakeShape {
    static constexpr int CH = W / 4;
    static constexpr int RS = STAGE_WORDS / W;          // rows a stage
    static constexpr int CPT = STAGE_CHUNKS / THREADS;  // chunks a thread
};

template <int W>
__global__ void __launch_bounds__(THREADS)
gather_take_kernel(const uint32_t *__restrict__ tab,
                   const int32_t *__restrict__ idx, uint32_t *__restrict__ out,
                   int64_t n, int n_rows) {
    using S = TakeShape<W>;
    constexpr int ISLOTS = 2 * STAGES;
    extern __shared__ __align__(16) uint4 ring[];       // [STAGES][chunks]
    int32_t *sidx = reinterpret_cast<int32_t *>(ring + STAGES * STAGE_CHUNKS);
    const int tid = threadIdx.x;
    const uint4 *tab4 = reinterpret_cast<const uint4 *>(tab);
    int64_t lo, hi;
    block_share(n, lo, hi);
    const int T = (int)((hi - lo + S::RS - 1) / S::RS);

    auto stage_rows = [&](int t) -> int {
        const int64_t left = hi - lo - (int64_t)t * S::RS;
        return left < S::RS ? (int)left : S::RS;
    };
    // stage t's indices -> index slot t % ISLOTS
    auto issue_indices = [&](int t) {
        if (t >= T)
            return;
        const int rows = stage_rows(t);
        int32_t *dst = sidx + (t % ISLOTS) * S::RS;
        const int32_t *src = idx + lo + (int64_t)t * S::RS;
        for (int i = tid; i < rows; i += THREADS)
            cp_async4(dst + i, src + i);
    };
    // stage t's rows -> ring slot t % STAGES; its indices have landed
    auto issue_rows = [&](int t) {
        if (t >= T)
            return;
        const int rows = stage_rows(t);
        const int32_t *ix = sidx + (t % ISLOTS) * S::RS;
        uint4 *dst = ring + (t % STAGES) * STAGE_CHUNKS;
#pragma unroll
        for (int k = 0; k < S::CPT; ++k) {
            const int c = tid + k * THREADS, r = c / S::CH;
            if (r < rows)
                cp_async16(dst + c, tab4 + (int64_t)clamp_row(ix[r], n_rows) *
                                               S::CH + c % S::CH);
        }
    };

    for (int t = 0; t < LAG; ++t)
        issue_indices(t);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // group t holds stage t's rows and stage t + LAG's indices
    for (int t = 0; t < LAG; ++t) {
        issue_rows(t);
        issue_indices(t + LAG);
        cp_async_commit();
    }
    // chunk tid + k * THREADS of a stage is words 4 tid .. 4 tid + 3 mod W
    uint4 acc = make_uint4(0, 0, 0, 0);
    for (int t = 0; t < T; ++t) {
        cp_async_wait<LAG - 1>();       // group t: stage t's rows are here
        __syncthreads();                // ... for every thread; slot t - 1
                                        // is read by all and may be refilled
        issue_rows(t + LAG);
        issue_indices(t + 2 * LAG);
        cp_async_commit();
        const uint4 *src = ring + (t % STAGES) * STAGE_CHUNKS;
        const int chunks = stage_rows(t) * S::CH;
#pragma unroll
        for (int k = 0; k < S::CPT; ++k) {
            const int c = tid + k * THREADS;
            if (c < chunks)
                acc += ld_shared4(src + c);
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    reinterpret_cast<uint4 *>(ring)[tid] = acc;
    __syncthreads();
    add_out<W>(reinterpret_cast<const uint32_t *>(ring), THREADS * 4, out);
}

// ------------------------------------------------------------ dispatch --

enum Form { LOOP = 0, TAKE = 1 };

template <int W>
const void *kernel_of(int form) {
    switch (form) {
    case LOOP: return (const void *)gather_loop_kernel<W>;
    case TAKE: return (const void *)gather_take_kernel<W>;
    }
    return nullptr;
}

const void *kernel_for(int form, int W) {
    switch (W) {
    case 4: return kernel_of<4>(form);
    case 8: return kernel_of<8>(form);
    case 16: return kernel_of<16>(form);
    case 32: return kernel_of<32>(form);
    case 64: return kernel_of<64>(form);
    case 128: return kernel_of<128>(form);
    case 256: return kernel_of<256>(form);
    }
    return nullptr;
}

// the kernel of (form, W) allowed `smem` bytes of dynamic shared memory
cudaError_t prepare(const void *fn, int smem) {
    if (!fn)
        return cudaErrorInvalidValue;
    if (smem > 48 * 1024)
        return cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return cudaSuccess;
}

}  // namespace

// Blocks of (form, W) resident on one SM with `smem` bytes of dynamic
// shared memory -> *blocks.
extern "C" int mg_gather_occupancy(int32_t form, int32_t W, int32_t smem,
                                   int32_t *blocks) {
    const void *fn = kernel_for(form, W);
    cudaError_t err = prepare(fn, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, fn, THREADS, smem);
    return (int)err;
}

// tab (n_rows, W) uint32, idx (>= n,) int32 -> out (W,) uint32, which the
// caller zeroes; the sums add into it.  The wrapper checks W is a power of
// two from 4 to 256, n_rows >= 1, tab 16-byte aligned, and plans grid >= 1
// and smem (exp_gather.py::gather_plan).
extern "C" int mg_gather(int32_t form, const void *tab, const void *idx,
                         void *out, int64_t n, int32_t n_rows, int32_t W,
                         int32_t grid, int32_t smem, void *stream) {
    const void *fn = kernel_for(form, W);
    cudaError_t err = prepare(fn, smem);
    if (err != cudaSuccess)
        return (int)err;
    void *args[] = {&tab, &idx, &out, &n, &n_rows};
    err = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(THREADS),
                           args, (size_t)smem, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
