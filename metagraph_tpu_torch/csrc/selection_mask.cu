// Kernel 3 of the annotated batch query: the label selection mask.
//
// Replaces metagraph_tpu/query/device.py::_pack_selection_mask (:168): bit
// l % 32 of word l / 32 of row s is (counts[s, l] >= dsel[s]) &
// (present[s] >= selmin[s]), for l < L.
//
// What bounds it on an H100: bytes (reading the (S, L) int32 counts once;
// the mask is 1/32 of that).  Design: one thread per (sequence, label slot),
// coalesced reads along the label axis, and one __ballot_sync per warp
// packs 32 comparisons into the word that lane 0 stores.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void selection_mask_kernel(const int32_t *__restrict__ counts,
                                      const int32_t *__restrict__ present,
                                      const int32_t *__restrict__ dsel,
                                      const int32_t *__restrict__ selmin,
                                      uint32_t *__restrict__ mask, int64_t S,
                                      int L, int Lw) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t row_slots = (int64_t)Lw * 32;
    // S * Lw * 32 and blockDim.x are multiples of 32: a warp is either all
    // inside or all past the end, and never straddles two mask words
    if (t >= S * row_slots)
        return;
    const int64_t s = t / row_slots;
    const int l = (int)(t - s * row_slots);
    bool sel = false;
    if (l < L && present[s] >= selmin[s])
        sel = counts[s * L + l] >= dsel[s];
    const unsigned m = __ballot_sync(0xFFFFFFFFu, sel);
    if ((threadIdx.x & 31) == 0)
        mask[s * Lw + l / 32] = m;
}

}  // namespace

// counts (S, L), present/dsel/selmin (S,) int32 -> mask (S, Lw) uint32.
extern "C" int mg_selection_mask(const void *counts, const void *present,
                                 const void *dsel, const void *selmin,
                                 void *mask, int64_t S, int32_t L, int32_t Lw,
                                 void *stream) {
    const int block = 256;
    const int64_t total = S * (int64_t)Lw * 32;
    const dim3 grid((unsigned)((total + block - 1) / block));
    selection_mask_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t *)counts, (const int32_t *)present,
        (const int32_t *)dsel, (const int32_t *)selmin, (uint32_t *)mask, S,
        L, Lw);
    return (int)cudaGetLastError();
}
