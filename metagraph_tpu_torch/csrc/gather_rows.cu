// The gather micro-benchmark's kernels: out[0, :] = sum over i of
// tab[idx[i], :] mod 2^32, over nblocks * QB indices, one block per chunk of
// QB indices.
//
//   gather_loop replaces scripts/exp_pallas_gather.py::make_loop_kernel.run
//     (:54, pl.pallas_call :57): a fori_loop of dynamic one-row loads into a
//     (1, W) accumulator, carried in out_ref across a sequential grid.
//   gather_take replaces make_take_kernel.run (:82, pl.pallas_call :85):
//     jnp.take of the (QB, W) tile, then a sum over axis 0.
//
// What bounds them on an H100: the table (8.4 or 16.8 MB at the script's
// sizes) stays in the 50 MB L2, so device memory sees the indices and the
// table once; the gathered bytes (128 B per index at W = 32) come from L2,
// and the latency of dependent random row loads, not a byte rate, is what
// the design has to hide.  The TPU's sequential grid carried the sum from
// step to step; here blocks run in any order, so each block reduces its
// chunk and ends with one atomicAdd per word.  uint32 addition is
// associative mod 2^32, so the result is exact and independent of order.
//
// gather_loop: each warp loops over its share of the chunk's rows; the warp
// loads 32 indices at once and broadcasts them with __shfl_sync; lane l
// loads word l (+ 32 j) of the row, so a row of 32 words is one coalesced
// 128 B load; each lane sums in registers; the warps' sums meet in shared
// memory.
//
// gather_take: the chunk's rows are staged into a shared-memory tile with
// cp.async 16-byte copies, STAGES stages of 4 KB in flight, and each stage
// is column-reduced as it lands; this asks whether staging through shared
// memory beats register loads for random 128 B rows.
//
// Both take W a power of two from 4 to 256 and clamp indices to
// [0, n_rows), as a dynamic slice clamps its start.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXJ = 8;                 // words per lane: W <= 256
constexpr int STAGES = 4;
constexpr int STAGE_WORDS = 1024;       // 4 KB: 1024 / W rows per stage

__device__ __forceinline__ int clamp_row(int32_t r, int n_rows) {
    return min(max(r, 0), n_rows - 1);
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

__global__ void __launch_bounds__(THREADS)
gather_loop_kernel(const uint32_t *__restrict__ tab,
                   const int32_t *__restrict__ idx, uint32_t *__restrict__ out,
                   int n_rows, int W, int QB) {
    __shared__ uint32_t red[WARPS][256];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t base = (int64_t)blockIdx.x * QB;
    uint32_t acc[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
        acc[j] = 0;
    for (int i0 = warp * 32; i0 < QB; i0 += WARPS * 32) {
        const int n = min(32, QB - i0);
        const int mine = lane < n ? clamp_row(idx[base + i0 + lane], n_rows)
                                  : 0;
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
            const uint32_t *row = tab + (int64_t)__shfl_sync(FULL, mine, t) * W;
#pragma unroll
            for (int j = 0; j < MAXJ; ++j) {
                const int w = lane + 32 * j;
                if (w < W)
                    acc[j] += __ldg(row + w);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
        const int w = lane + 32 * j;
        if (w < W)
            red[warp][w] = acc[j];
    }
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += THREADS) {
        uint32_t s = 0;
#pragma unroll
        for (int k = 0; k < WARPS; ++k)
            s += red[k][w];
        if (s)
            atomicAdd(out + w, s);
    }
}

// cp.async the rows of row block rb (RT rows of W words) into stage rb % STAGES
__device__ __forceinline__ void stage_rows(uint32_t (*tile)[STAGE_WORDS],
                                           const uint32_t *__restrict__ tab,
                                           const int32_t *__restrict__ idx,
                                           int64_t base, int rb, int n_rows,
                                           int W, int QB) {
    const int RT = STAGE_WORDS / W, cpr = W / 4;    // rows, 16 B chunks a row
    uint32_t *dst = tile[rb % STAGES];
    for (int c = threadIdx.x; c < STAGE_WORDS / 4; c += THREADS) {
        const int r = c / cpr, q = c - r * cpr;
        const int i = rb * RT + r;
        if (i < QB) {
            const int row = clamp_row(idx[base + i], n_rows);
            cp_async16(dst + 4 * c, tab + (int64_t)row * W + 4 * q);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
gather_take_kernel(const uint32_t *__restrict__ tab,
                   const int32_t *__restrict__ idx, uint32_t *__restrict__ out,
                   int n_rows, int W, int QB) {
    __shared__ __align__(16) uint32_t tile[STAGES][STAGE_WORDS];
    __shared__ uint32_t red[THREADS];
    const int RT = STAGE_WORDS / W;
    const int64_t base = (int64_t)blockIdx.x * QB;
    const int nrb = (QB + RT - 1) / RT;
#pragma unroll
    for (int rb = 0; rb < STAGES - 1; ++rb) {
        if (rb < nrb)
            stage_rows(tile, tab, idx, base, rb, n_rows, W, QB);
        cp_async_commit();
    }
    // W divides THREADS, so element e = threadIdx.x + k * THREADS of a stage
    // is always word threadIdx.x % W
    uint32_t acc = 0;
    for (int rb = 0; rb < nrb; ++rb) {
        if (rb + STAGES - 1 < nrb)
            stage_rows(tile, tab, idx, base, rb + STAGES - 1, n_rows, W, QB);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();        // row block rb has landed
        __syncthreads();
        const uint32_t *src = tile[rb % STAGES];
        const int n = min(RT, QB - rb * RT) * W;
        for (int e = threadIdx.x; e < n; e += THREADS)
            acc += src[e];
        __syncthreads();                    // before the stage is refilled
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += THREADS) {
        uint32_t s = 0;
        for (int k = w; k < THREADS; k += W)
            s += red[k];
        if (s)
            atomicAdd(out + w, s);
    }
}

}  // namespace

// tab (n_rows, W) uint32, idx (>= nblocks * QB,) int32 -> out (W,) uint32,
// which the caller zeroes; the sums add into it.  The wrapper checks W is a
// power of two from 4 to 256, n_rows >= 1 and tab 16-byte aligned.
extern "C" int mg_gather_loop(const void *tab, const void *idx, void *out,
                              int64_t nblocks, int32_t n_rows, int32_t W,
                              int32_t QB, void *stream) {
    gather_loop_kernel<<<(unsigned)nblocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t *)tab, (const int32_t *)idx, (uint32_t *)out, n_rows,
        W, QB);
    return (int)cudaGetLastError();
}

extern "C" int mg_gather_take(const void *tab, const void *idx, void *out,
                              int64_t nblocks, int32_t n_rows, int32_t W,
                              int32_t QB, void *stream) {
    gather_take_kernel<<<(unsigned)nblocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t *)tab, (const int32_t *)idx, (uint32_t *)out, n_rows,
        W, QB);
    return (int)cudaGetLastError();
}
