// Kernel 2 of the annotated batch query: node ids -> per-sequence label
// counts and presence, gather, tile count and fold in one pass.
//
// Replaces metagraph_tpu/annotation/ops.py::gather_anno_rows (:66) and
// query/device.py::_tile_label_counts/_csa_add (:89-149) and _fold_tiles
// (:152).  The JAX fold is an f32 matmul, exact only below 2^24; here every
// sum is an int32 atomic add, so counts stay exact up to 2^31 - 1.
//
// What bounds it on an H100: bytes.  Each hit window reads its annotation
// row of Lw words (128 B at 1,000 labels) at a random place in a bitmap far
// larger than L2.  Design: one block per (tile, chunk of <= 256 label
// words); the tile's T windows all belong to one sequence (tile_seq).  A
// warp takes 32 windows, one per lane; for each label word that any lane
// has non-zero, 32 ballots turn the warp's 32 words into per-bit counts
// (lane b keeps the popcount of ballot b), which go to per-block counters in
// shared memory.  At the end the block adds its non-zero counters to the
// sequence's row of the (S, L) counts with global atomics, so a tile costs
// one global atomic per label it hit rather than one per window.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void label_counts_kernel(const int32_t *__restrict__ nodes,
                                    const uint32_t *__restrict__ bitmap,
                                    const int32_t *__restrict__ tile_seq,
                                    int32_t *__restrict__ counts,
                                    int32_t *__restrict__ present, int T,
                                    int64_t R, int Lw, int L,
                                    int chunk_words) {
    extern __shared__ int32_t sm[];             // chunk_words * 32 + 1
    const int64_t tile = blockIdx.x;
    const int w_lo = blockIdx.y * chunk_words;
    const int nwords = min(Lw - w_lo, chunk_words);
    int32_t *sm_present = sm + chunk_words * 32;
    for (int i = threadIdx.x; i < nwords * 32; i += blockDim.x)
        sm[i] = 0;
    if (threadIdx.x == 0)
        *sm_present = 0;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    // blockDim.x and T are multiples of 32: whole warps run each iteration
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
        const int32_t node = nodes[tile * T + j];
        const bool hit = node > 0;
        // node ids come from the hash index, whose ids are rows 1..R
        const bool have_row = hit && node <= R;
        const uint32_t *row = bitmap + (int64_t)(node - 1) * Lw;
        if (blockIdx.y == 0) {
            const unsigned hm = __ballot_sync(FULL, hit);
            if (lane == 0 && hm)
                atomicAdd(sm_present, __popc(hm));
        }
        for (int w = 0; w < nwords; ++w) {
            const uint32_t x = have_row ? __ldg(row + w_lo + w) : 0u;
            if (!__any_sync(FULL, x != 0u))
                continue;
            int mine = 0;
#pragma unroll
            for (int b = 0; b < 32; ++b) {
                const unsigned m = __ballot_sync(FULL, (x >> b) & 1u);
                if (lane == b)
                    mine = __popc(m);
            }
            if (mine)
                atomicAdd(&sm[w * 32 + lane], mine);
        }
    }
    __syncthreads();

    const int64_t out = (int64_t)tile_seq[tile] * L;
    for (int i = threadIdx.x; i < nwords * 32; i += blockDim.x) {
        const int label = w_lo * 32 + i;
        const int32_t c = sm[i];
        if (c && label < L)
            atomicAdd(&counts[out + label], c);
    }
    if (blockIdx.y == 0 && threadIdx.x == 0 && *sm_present)
        atomicAdd(&present[tile_seq[tile]], *sm_present);
}

}  // namespace

// nodes (n_tiles, T) int32, bitmap (R, Lw) uint32, tile_seq (n_tiles,) int32
// -> counts (S, L) int32 and present (S,) int32, which the caller zeroes.
// The wrapper checks T % 32 == 0 and Lw == ceil(L / 32).
extern "C" int mg_label_counts(const void *nodes, const void *bitmap,
                               const void *tile_seq, void *counts,
                               void *present, int64_t n_tiles, int32_t T,
                               int64_t R, int32_t Lw, int32_t L,
                               void *stream) {
    const int chunk_words = Lw < 256 ? Lw : 256;
    const dim3 grid((unsigned)n_tiles, (unsigned)((Lw + 255) / 256));
    const dim3 block(T < 256 ? T : 256);
    const size_t smem = (size_t)(chunk_words * 32 + 1) * sizeof(int32_t);
    label_counts_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        (const int32_t *)nodes, (const uint32_t *)bitmap,
        (const int32_t *)tile_seq, (int32_t *)counts, (int32_t *)present, T,
        R, Lw, L, chunk_words);
    return (int)cudaGetLastError();
}
