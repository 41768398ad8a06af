// Kernel 4: batched affine-gap local alignment scores (Gotoh
// Smith-Waterman), one best score per (query, reference) pair.
//
// Replaces the Pallas TPU kernel metagraph_tpu/align/pallas_sw.py::_sw_kernel
// (:35, launched by batch_local_align_scores :100).  It computes the same
// int32 recurrence, so the scores are bit-identical:
//   M[j] = S_prev[j-1] + sub(q[j], r_i)      (S_prev[-1] = 0; a negative
//                                             code makes sub = NEG)
//   F[j] = max(S_prev[j] + open, F_prev[j] + ext)
//   E[j] = max_{m<j} (max(M, F)[m] + open + (j-m-1) ext)   (valid for
//                                             open <= ext, as in the TPU)
//   S[j] = max(M[j], F[j], E[j], 0);  best = max(best, S)
//
// What bounds it on an H100: operations (LQ * LR cells of a dozen int32
// operations each against a few bytes of input per cell row).  Design: one
// warp per pair.  Query positions lie across the lanes, P = LQ/32 rounded up
// to a power of two consecutive positions per lane, and the rows of the
// reference run in a loop.  The S, F and query values stay in registers;
// the shift of S_prev by one position is one __shfl_up_sync, and E's
// max-plus prefix scan is a sequential scan inside the lane plus a 5-step
// __shfl_up_sync scan across lanes.  Where the TPU kernel keeps the batch in
// VMEM and rotates the reference through lanes, nothing here leaves
// registers but the final score.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int32_t NEG = -(1 << 30);

template <int P>
__global__ void sw_kernel(const int32_t *__restrict__ queries,
                          const int32_t *__restrict__ refs,
                          int32_t *__restrict__ out, int B, int LQ, int LR,
                          int match, int mismatch, int gap_open,
                          int gap_ext) {
    const int pair = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x)
                           >> 5);
    const int lane = threadIdx.x & 31;
    if (pair >= B)
        return;                                 // the whole warp leaves
    const int32_t *q = queries + (int64_t)pair * LQ;
    const int32_t *r = refs + (int64_t)pair * LR;
    const int j0 = lane * P;                    // first query position

    int32_t qv[P], s[P], f[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
        qv[k] = j0 + k < LQ ? q[j0 + k] : 0;
        s[k] = 0;
        f[k] = NEG;
    }
    int32_t best = 0;
    for (int i = 0; i < LR; ++i) {
        const int32_t ri = __ldg(r + i);
        int32_t left = __shfl_up_sync(FULL, s[P - 1], 1);
        if (lane == 0)
            left = 0;                           // local alignment: M[0] from 0
        int32_t sf[P], pm[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
            int32_t sub = qv[k] == ri ? match : mismatch;
            if (qv[k] < 0 || ri < 0)
                sub = NEG;
            const int32_t m = (k == 0 ? left : s[k > 0 ? k - 1 : 0]) + sub;
            f[k] = max(s[k] + gap_open, f[k] + gap_ext);
            sf[k] = max(m, f[k]);
            const int32_t c = sf[k] - (j0 + k) * gap_ext;
            pm[k] = k == 0 ? c : max(pm[k > 0 ? k - 1 : 0], c);  // prefix max
        }
        // inclusive scan of the lane totals across the warp
        int32_t tot = pm[P - 1];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t t = __shfl_up_sync(FULL, tot, d);
            if (lane >= d)
                tot = max(tot, t);
        }
        int32_t before = __shfl_up_sync(FULL, tot, 1);
        if (lane == 0)
            before = NEG;                       // max over no position
        int32_t rowbest = 0;
#pragma unroll
        for (int k = 0; k < P; ++k) {
            const int32_t excl =
                k == 0 ? before : max(before, pm[k > 0 ? k - 1 : 0]);
            const int32_t e = excl + gap_open + (j0 + k - 1) * gap_ext;
            s[k] = max(max(sf[k], e), 0);
            if (j0 + k < LQ)
                rowbest = max(rowbest, s[k]);
        }
        best = max(best, rowbest);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        best = max(best, __shfl_down_sync(FULL, best, d));
    if (lane == 0)
        out[pair] = best;
}

template <int P>
void launch(const int32_t *q, const int32_t *r, int32_t *o, int B, int LQ,
            int LR, int match, int mismatch, int gap_open, int gap_ext,
            cudaStream_t st) {
    const int block = 128;                      // 4 pairs per block
    const dim3 grid((unsigned)(((int64_t)B * 32 + block - 1) / block));
    sw_kernel<P><<<grid, block, 0, st>>>(q, r, o, B, LQ, LR, match, mismatch,
                                         gap_open, gap_ext);
}

}  // namespace

// queries (B, LQ), refs (B, LR) int32 codes (negative = padding) -> out
// (B,) int32.  The wrapper checks 1 <= LQ <= 1024.
extern "C" int mg_sw_scores(const void *queries, const void *refs, void *out,
                            int32_t B, int32_t LQ, int32_t LR, int32_t match,
                            int32_t mismatch, int32_t gap_open,
                            int32_t gap_ext, void *stream) {
    const int32_t *q = (const int32_t *)queries;
    const int32_t *r = (const int32_t *)refs;
    int32_t *o = (int32_t *)out;
    cudaStream_t st = (cudaStream_t)stream;
    const int need = (LQ + 31) / 32;
    if (need <= 1)
        launch<1>(q, r, o, B, LQ, LR, match, mismatch, gap_open, gap_ext, st);
    else if (need <= 2)
        launch<2>(q, r, o, B, LQ, LR, match, mismatch, gap_open, gap_ext, st);
    else if (need <= 4)
        launch<4>(q, r, o, B, LQ, LR, match, mismatch, gap_open, gap_ext, st);
    else if (need <= 8)
        launch<8>(q, r, o, B, LQ, LR, match, mismatch, gap_open, gap_ext, st);
    else if (need <= 16)
        launch<16>(q, r, o, B, LQ, LR, match, mismatch, gap_open, gap_ext, st);
    else if (need <= 32)
        launch<32>(q, r, o, B, LQ, LR, match, mismatch, gap_open, gap_ext, st);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
