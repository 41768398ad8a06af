// Kernel B11: the aligner's wave DP, N banded DP columns of width W.
//
// Replaces the XLA program metagraph_tpu/align/batch.py::_compute_wave_device
// (:91), the device form of metagraph_tpu/align/wave_extender.py::compute_wave
// (:24), which the flat engine runs once per global wave over the children
// of every active extension.  Row r is one child column, j its cells:
//   M[j] = j ? (SpM[j-1] == NINF ? NINF : SpM[j-1] + prof[j] + ns) : NINF
//   F[j] = has_del ? max(SpF[j] == NINF ? NINF : SpF[j] + open,
//                        Fp[j] == NINF ? NINF : Fp[j] + ext) (+ ns unless
//                    NINF) : NINF
//   M[j] = max(M[j], F[j]);  B[j] = M[j] + open - (j + 1) ext
//   E[j] = j ? (run[j-1] <= NINF - j ext ? NINF : run[j-1] + j ext) : NINF,
//          run[j] = max(B[0..j])
//   S[j] = max(M[j], E[j]), NINF below the row's cutoff
//   E[j] = NINF outside [band_lo, band_hi] unless S[j] != NINF
// with NINF = INT32_MIN + 100 and every sum in int32 two's complement
// (unsigned adds, no signed overflow), so the result is bit-equal to the
// numpy recurrence on int32 arrays, whatever the inputs.
//
// What bounds it on an H100: bytes.  A cell reads four int32 (SpM, SpF,
// Fp, prof) and writes three (S, E, F), 28 bytes for about twenty integer
// operations.  Design: one warp a row, lanes over columns, 32 columns a
// step; each lane loads its cells with coalesced 4-byte loads (SpM[j-1]
// is the same row read one column to the left).  E's running max is a
// warp max-scan by __shfl_up_sync over each step's 32 values, the carry
// from the step before held in a register by every lane; the exclusive
// value run[j-1] is the scan shifted up by one lane, lane 0 taking the
// carry.  Any W works, reads longer than 1,024 bp (W > 1,024) included:
// a warp takes ceil(W / 32) steps.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int32_t NINF = INT32_MIN + 100;
constexpr int WARPS = 8;                 // rows a block

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

__global__ void __launch_bounds__(WARPS * 32)
wave_dp_kernel(const int32_t *__restrict__ SpM,
               const int32_t *__restrict__ SpF,
               const int32_t *__restrict__ Fp,
               const int32_t *__restrict__ prof,
               const int32_t *__restrict__ node_score,
               const uint8_t *__restrict__ has_del,
               const int32_t *__restrict__ band_lo,
               const int32_t *__restrict__ band_hi,
               const int32_t *__restrict__ cutoff, int N, int W,
               int32_t go, int32_t ge, int32_t *__restrict__ S_out,
               int32_t *__restrict__ E_out, int32_t *__restrict__ F_out) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (row >= N) return;                 // whole warps leave together
    const int64_t base = (int64_t)row * W;
    const int32_t ns = node_score[row];
    const bool del = has_del[row] != 0;
    const int32_t lo = band_lo[row], hi = band_hi[row];
    const int32_t cut = cutoff[row];
    int32_t carry = INT32_MIN;            // run[] of the step before
    for (int c0 = 0; c0 < W; c0 += 32) {
        const int j = c0 + lane;
        const bool in = j < W;
        int32_t m = NINF, f = NINF, b = INT32_MIN;
        if (in) {
            if (j > 0) {
                const int32_t sp = SpM[base + j - 1];
                if (sp != NINF) m = wadd(wadd(sp, prof[base + j]), ns);
            }
            if (del) {
                const int32_t sf = SpF[base + j], fp = Fp[base + j];
                const int32_t d_open = sf == NINF ? NINF : wadd(sf, go);
                const int32_t d_ext = fp == NINF ? NINF : wadd(fp, ge);
                f = max(d_open, d_ext);
                if (f != NINF) f = wadd(f, ns);
            }
            m = max(m, f);
            b = wsub(wadd(m, go), wmul(j + 1, ge));
        }
        // inclusive max-scan of b over the warp, then the carry
        int32_t run = b;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t o = __shfl_up_sync(FULL, run, d);
            if (lane >= d) run = max(run, o);
        }
        run = max(run, carry);
        int32_t prev = __shfl_up_sync(FULL, run, 1);   // run[j - 1]
        if (lane == 0) prev = carry;
        carry = __shfl_sync(FULL, run, 31);
        if (!in) continue;
        int32_t e = NINF;
        if (j > 0) {
            const int32_t jge = wmul(j, ge);
            e = prev <= wsub(NINF, jge) ? NINF : wadd(prev, jge);
        }
        int32_t s = max(m, e);
        if (s < cut) s = NINF;
        if (!((j >= lo && j <= hi) || s != NINF)) e = NINF;
        S_out[base + j] = s;
        E_out[base + j] = e;
        F_out[base + j] = f;
    }
}

}  // namespace

// out holds S, E and F one after the other, each N x W.
extern "C" int mg_wave_dp(const int32_t *SpM, const int32_t *SpF,
                          const int32_t *Fp, const int32_t *prof,
                          const int32_t *node_score, const uint8_t *has_del,
                          const int32_t *band_lo, const int32_t *band_hi,
                          const int32_t *cutoff, int N, int W, int go,
                          int ge, int32_t *out, cudaStream_t stream) {
    const int64_t plane = (int64_t)N * W;
    const int blocks = (N + WARPS - 1) / WARPS;
    wave_dp_kernel<<<blocks, WARPS * 32, 0, stream>>>(
        SpM, SpF, Fp, prof, node_score, has_del, band_lo, band_hi, cutoff,
        N, W, go, ge, out, out + plane, out + 2 * plane);
    return (int)cudaGetLastError();
}
