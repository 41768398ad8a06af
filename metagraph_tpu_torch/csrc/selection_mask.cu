// Kernel 3 of the annotated batch query: the label selection mask.
//
// Replaces metagraph_tpu/query/device.py::_pack_selection_mask (:168): bit
// l % 32 of word l / 32 of row s is (counts[s, l] >= dsel[s]) &
// (present[s] >= selmin[s]), for l < L, and 0 in the padding bits.
//
// What bounds it on an H100: bytes.  It reads L int32 counts of every row
// whose presence passes, once, and writes 1/32 of that as the mask; a row
// whose presence fails (present < selmin, which covers selmin = INT32_MAX
// for rows without k-mers) needs none of its counts.
//
// Design (a redesign of one thread per label slot, which spent its time on
// a 64-bit division and index arithmetic a thread, not on bytes):
// * A persistent grid: as many blocks as the occupancy API fits on the SMs
//   (query/device.py::selection_plan), one warp a row at a time, warps
//   striding over the rows.  No division in the loop.
// * The three thresholds of a row are one broadcast load each; a row that
//   cannot be selected writes its zero words and reads no count.
// * A warp takes a row 1,024 labels (32 mask words) at a time and keeps all
//   of them in flight: V = 4 (16-byte int4 loads, when L % 4 == 0 and the
//   counts are 16-byte aligned) loads 8 x 16 B a lane; V = 1 (any L and
//   alignment) loads 32 x 4 B a lane.  Counts are read with __ldcs
//   (streamed: each is read once).
// * Packing, V = 4: a lane turns its 4 comparisons into a nibble and three
//   __shfl_xor_sync steps OR the 8 nibbles of each 8-lane group into a mask
//   word; V = 1: one __ballot_sync a word.  Lane k ends up holding word k of
//   the 32, so a row's words go out as one coalesced 128-byte store.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;           // 8 warps a block
constexpr int CHUNK = 1024;            // labels a warp step: 32 mask words

template <int V>
__global__ void __launch_bounds__(THREADS)
selection_mask_kernel(const int32_t *__restrict__ counts,
                      const int32_t *__restrict__ present,
                      const int32_t *__restrict__ dsel,
                      const int32_t *__restrict__ selmin,
                      uint32_t *__restrict__ mask, int64_t S, int L, int Lw) {
    const int lane = threadIdx.x & 31;
    const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
    for (int64_t s = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
         s < S; s += warps) {
        uint32_t *out = mask + s * Lw;
        if (__ldg(present + s) < __ldg(selmin + s)) {
            for (int w = lane; w < Lw; w += 32)
                out[w] = 0u;
            continue;
        }
        const int32_t d = __ldg(dsel + s);
        const int32_t *row = counts + s * (int64_t)L;
        for (int base = 0; base < L; base += CHUNK) {
            uint32_t word = 0;          // lane k: word base / 32 + k
            if constexpr (V == 4) {
                // group g: labels base + 128 g + 4 lane .. + 3
                int4 c[8];
#pragma unroll
                for (int g = 0; g < 8; ++g) {
                    const int l = base + 128 * g + 4 * lane;
                    c[g] = l < L ? __ldcs(reinterpret_cast<const int4 *>(
                                       row + l))
                                 : make_int4(0, 0, 0, 0);
                }
#pragma unroll
                for (int g = 0; g < 8; ++g) {
                    const int l = base + 128 * g + 4 * lane;
                    uint32_t nib = 0;
                    if (l < L)
                        nib = (uint32_t)(c[g].x >= d)
                              | (uint32_t)(c[g].y >= d) << 1
                              | (uint32_t)(c[g].z >= d) << 2
                              | (uint32_t)(c[g].w >= d) << 3;
                    uint32_t w = nib << (4 * (lane & 7));
                    w |= __shfl_xor_sync(FULL, w, 1);
                    w |= __shfl_xor_sync(FULL, w, 2);
                    w |= __shfl_xor_sync(FULL, w, 4);
                    // the 8-lane group q of g holds word 4 g + q
                    const uint32_t mine =
                        __shfl_sync(FULL, w, (lane & 3) * 8);
                    if ((lane >> 2) == g)
                        word = mine;
                }
            } else {
                int32_t c[32];
#pragma unroll
                for (int g = 0; g < 32; ++g) {
                    const int l = base + 32 * g + lane;
                    c[g] = l < L ? __ldcs(row + l) : 0;
                }
#pragma unroll
                for (int g = 0; g < 32; ++g) {
                    const int l = base + 32 * g + lane;
                    const uint32_t w = __ballot_sync(FULL, l < L && c[g] >= d);
                    if (lane == g)
                        word = w;
                }
            }
            const int w = base / 32 + lane;
            if (w < Lw)
                out[w] = word;
        }
        if (L == 0 && lane == 0)
            out[0] = 0u;                // Lw is 1 for L = 0
    }
}

const void *kernel_for(int vec) {
    return vec == 4 ? (const void *)selection_mask_kernel<4>
                    : (const void *)selection_mask_kernel<1>;
}

}  // namespace

// Blocks of variant `vec` (4 or 1) resident on one SM -> *blocks.
extern "C" int mg_selection_mask_occupancy(int32_t vec, int32_t *blocks) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel_for(vec), THREADS, 0);
}

// counts (S, L), present/dsel/selmin (S,) int32 -> mask (S, Lw) uint32.
// The wrapper plans vec (4 only with L % 4 == 0 and 16-byte aligned
// counts) and grid >= 1 (query/device.py::selection_plan).
extern "C" int mg_selection_mask(const void *counts, const void *present,
                                 const void *dsel, const void *selmin,
                                 void *mask, int64_t S, int32_t L, int32_t Lw,
                                 int32_t vec, int32_t grid, void *stream) {
    void *args[] = {&counts, &present, &dsel, &selmin, &mask, &S, &L, &Lw};
    cudaError_t err = cudaLaunchKernel(kernel_for(vec), dim3((unsigned)grid),
                                       dim3(THREADS), args, 0,
                                       (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
