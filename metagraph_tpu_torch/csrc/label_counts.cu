// Kernel 2 of the annotated batch query: node ids -> per-sequence label
// counts and presence, gather, tile count and fold in one pass.
//
// Replaces metagraph_tpu/annotation/ops.py::gather_anno_rows (:66) and
// query/device.py::_tile_label_counts/_csa_add (:89-149) and _fold_tiles
// (:152).  The JAX fold is an f32 matmul, exact only below 2^24; here every
// sum is an int32 atomic add, so counts stay exact up to 2^31 - 1.  With an
// offset (a primary graph seen through CanonicalDBG, canon 2) node ids above
// it are reverse-complement hits and fold back to their base node before the
// row gather, as rows_ct does in _wire_epoch_core (:374-378).
//
// What bounds it on an H100: each hit window reads its annotation row of Lw
// words (128 B at 1,000 labels) at a random place in a bitmap far larger
// than L2, and then counts its bits; at 3.2x the bytes' bound the split
// between the two is not measured (PERF.md).  A design that loaded one
// 4-byte word per lane at a time, and transposed every word any lane had
// non-zero, ran as slowly with every row in L2, and 5x slower than this
// one:
// * One block per (tile, chunk of <= 256 label words); the tile's T windows
//   all belong to one sequence (tile_seq).  A warp takes 32 windows.
// * Whole rows, coalesced: the warp copies its hit windows' rows into
//   shared memory 32 words (128 B) at a time with 16-byte cp.async (4-byte
//   copies where the row stride is not a multiple of 4 words), lanes
//   8r .. 8r+7 copying the 8 chunks of row r, so one warp instruction reads
//   4 whole rows.  Staged rows are XOR-swizzled by 16-byte chunk, so lane i
//   reads 16 B of row i with no bank conflict.
// * Sparse words walk their bits: when no lane's word has more than
//   WALK_BITS bits set, each lane takes its lowest set bit per step, and the
//   lanes that share a label add once (__match_any_sync; the leader adds the
//   popcount).  A read's windows mostly carry one label, so such a tile
//   costs one shared atomic per warp and step.  Denser words use the
//   32-ballot transpose (lane b keeps the popcount of ballot b).
// * Per-block int32 counters in shared memory; at the end the block adds
//   its non-zero counters to the sequence's row of the (S, L) counts with
//   global atomics, one per label the tile hit.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;            // at most; T when T is smaller
constexpr int CHUNK_WORDS = 256;        // label words per block (blockIdx.y)
constexpr int SUB = 32;                 // words of a row staged at a time
constexpr unsigned WALK_BITS = 4;

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                     "memory");
}

// Word w of staged row r: the 16-byte chunks of row r are XOR-swizzled by
// r % 8.
__device__ __forceinline__ int staged(int r, int w) {
    return r * SUB + (((w >> 2) ^ (r & 7)) << 2) + (w & 3);
}

// VEC16: rows start 16-byte aligned (the stride is a multiple of 4 words)
// and a row may be read up to the next multiple of 4 words.
template <bool VEC16>
__global__ void __launch_bounds__(THREADS)
label_counts_kernel(const int32_t *__restrict__ nodes,
                    const uint32_t *__restrict__ bitmap,
                    const int32_t *__restrict__ tile_seq,
                    int32_t *__restrict__ counts,
                    int32_t *__restrict__ present, int T, int64_t R,
                    int64_t stride, int Lw, int L, int32_t offset) {
    // per warp a stage of 32 rows x SUB words, then the counters of a chunk
    // and the present count
    extern __shared__ __align__(16) uint32_t sm[];
    const int nwarps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t *stage = sm + warp * 32 * SUB;
    int32_t *cnt = reinterpret_cast<int32_t *>(sm + nwarps * 32 * SUB);
    int32_t *sm_present = cnt + min(Lw, CHUNK_WORDS) * 32;
    const int64_t tile = blockIdx.x;
    const int w_lo = blockIdx.y * CHUNK_WORDS;
    const int nwords = min(Lw - w_lo, CHUNK_WORDS);
    for (int i = threadIdx.x; i < nwords * 32; i += blockDim.x)
        cnt[i] = 0;
    if (threadIdx.x == 0)
        *sm_present = 0;
    __syncthreads();

    int hits = 0;
    // blockDim.x and T are multiples of 32: whole warps run each iteration
    for (int j0 = warp * 32; j0 < T; j0 += blockDim.x) {
        int32_t node = nodes[tile * T + j0 + lane];
        const bool hit = node > 0;
        if (offset > 0 && node > offset)
            node -= offset;                     // rc hit -> its base node
        // node ids come from the hash index, whose ids are rows 1..R
        const bool have_row = hit && node <= R;
        if (blockIdx.y == 0)
            hits += __popc(__ballot_sync(FULL, hit));
        if (!__any_sync(FULL, have_row))
            continue;
        const int32_t row = have_row ? node - 1 : -1;
        for (int s0 = 0; s0 < nwords; s0 += SUB) {
            const int sw = min(SUB, nwords - s0);       // words staged
            const int nc = (sw + 3) >> 2;               // their 16-byte chunks
            const uint32_t *src = bitmap + w_lo + s0;
            if (VEC16) {
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int r = 4 * k + (lane >> 3), c = lane & 7;
                    const int32_t rr = __shfl_sync(FULL, row, r);
                    if (rr >= 0 && c < nc)
                        cp_async16(stage + staged(r, 4 * c),
                                   src + rr * stride + 4 * c);
                }
            } else {
#pragma unroll 4
                for (int r = 0; r < 32; ++r) {
                    const int32_t rr = __shfl_sync(FULL, row, r);
                    if (rr >= 0 && lane < sw)
                        cp_async4(stage + staged(r, lane),
                                  src + rr * stride + lane);
                }
            }
            cp_async_wait_all();
            __syncwarp();
            for (int c = 0; c < nc; ++c) {
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (have_row)
                    v = *reinterpret_cast<const uint4 *>(
                        stage + staged(lane, 4 * c));
                const uint32_t xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    uint32_t x = 4 * c + u < sw ? xs[u] : 0u;
                    if (!__any_sync(FULL, x != 0u))
                        continue;
                    const int lab0 = (s0 + 4 * c + u) * 32;
                    const unsigned bits =
                        __reduce_max_sync(FULL, (unsigned)__popc(x));
                    if (bits <= WALK_BITS) {
                        for (unsigned it = 0; it < bits; ++it) {
                            const int lab = x ? lab0 + __ffs(x) - 1 : -1;
                            const unsigned m = __match_any_sync(FULL, lab);
                            if (x && lane == __ffs(m) - 1)
                                atomicAdd(&cnt[lab], __popc(m));
                            x &= x - 1u;
                        }
                    } else {
                        int mine = 0;
#pragma unroll
                        for (int b = 0; b < 32; ++b) {
                            const unsigned m =
                                __ballot_sync(FULL, (x >> b) & 1u);
                            if (lane == b)
                                mine = __popc(m);
                        }
                        if (mine)
                            atomicAdd(&cnt[lab0 + lane], mine);
                    }
                }
            }
            __syncwarp();                       // before the stage refills
        }
    }
    if (lane == 0 && hits)
        atomicAdd(sm_present, hits);
    __syncthreads();

    const int64_t out = (int64_t)tile_seq[tile] * L;
    for (int i = threadIdx.x; i < nwords * 32; i += blockDim.x) {
        const int label = w_lo * 32 + i;
        const int32_t c = cnt[i];
        if (c && label < L)
            atomicAdd(&counts[out + label], c);
    }
    if (blockIdx.y == 0 && threadIdx.x == 0 && *sm_present)
        atomicAdd(&present[tile_seq[tile]], *sm_present);
}

template <bool VEC16>
int launch(dim3 grid, dim3 block, size_t smem, cudaStream_t st,
           const int32_t *nodes, const uint32_t *bitmap,
           const int32_t *tile_seq, int32_t *counts, int32_t *present, int T,
           int64_t R, int64_t stride, int Lw, int L, int32_t offset) {
    const cudaError_t e = cudaFuncSetAttribute(
        label_counts_kernel<VEC16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess)
        return (int)e;
    label_counts_kernel<VEC16><<<grid, block, smem, st>>>(
        nodes, bitmap, tile_seq, counts, present, T, R, stride, Lw, L, offset);
    return (int)cudaGetLastError();
}

}  // namespace

// nodes (n_tiles, T) int32, bitmap (R, Lw) uint32 rows ``stride`` words
// apart, tile_seq (n_tiles,) int32 -> counts (S, L) int32 and present (S,)
// int32, which the caller zeroes.  offset 0 means no fold.  vec16 != 0
// promises 16-byte aligned rows readable up to the next multiple of 4
// words.  The wrapper checks T % 32 == 0, Lw == ceil(L / 32) and
// stride >= Lw.
extern "C" int mg_label_counts(const void *nodes, const void *bitmap,
                               const void *tile_seq, void *counts,
                               void *present, int64_t n_tiles, int32_t T,
                               int64_t R, int64_t stride, int32_t Lw,
                               int32_t L, int32_t offset, int32_t vec16,
                               void *stream) {
    const int threads = T < THREADS ? T : THREADS;
    const int cw = Lw < CHUNK_WORDS ? Lw : CHUNK_WORDS;
    const size_t smem =
        ((size_t)threads * SUB + (size_t)cw * 32 + 1) * sizeof(int32_t);
    const dim3 grid((unsigned)n_tiles,
                    (unsigned)((Lw + CHUNK_WORDS - 1) / CHUNK_WORDS));
    const dim3 block(threads);
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t *n = (const int32_t *)nodes;
    const uint32_t *b = (const uint32_t *)bitmap;
    const int32_t *ts = (const int32_t *)tile_seq;
    int32_t *c = (int32_t *)counts, *p = (int32_t *)present;
    if (vec16)
        return launch<true>(grid, block, smem, st, n, b, ts, c, p, T, R,
                            stride, Lw, L, offset);
    return launch<false>(grid, block, smem, st, n, b, ts, c, p, T, R, stride,
                         Lw, L, offset);
}
