// Kernel 4: batched affine-gap local alignment scores (Gotoh
// Smith-Waterman), one best score per (query, reference) pair.
//
// Replaces the Pallas TPU kernel metagraph_tpu/align/pallas_sw.py::_sw_kernel
// (:35, launched by batch_local_align_scores :100).  It computes the same
// int32 recurrence, so the scores are bit-identical.  Row i of the
// reference, column j of the query:
//   M[j]  = S_prev[j-1] + sub(q[j], r_i)   (S_prev[-1] = 0; a negative code
//                                          on either side makes sub = NEG)
//   F[j]  = max(S_prev[j] + open, F_prev[j] + ext)
//   SF[j] = max(M[j], F[j])
//   E[j]  = max_{m<j} (SF[m] + open + (j-m-1) ext)          (the TPU's form)
//   S[j]  = max(SF[j], E[j], 0);  best = max(best, S)
//
// The TPU evaluates E as a log-step max-plus prefix scan along the query,
// because its lanes cannot carry a dependency from one position to the
// next.  Unrolling the max by its last term gives, for every open and ext,
//   E[j] = max(E[j-1] + ext, SF[j-1] + open),  E[0] = "no gap",
// and this kernel walks that sequentially.  The sentinel is harmless: E[0]
// only has to be <= 0 (S is clamped at 0) and <= SF[0] + open - ext (so
// that E[1] = SF[0] + open).  F >= open after the first row and F starts at
// NEG, so SF >= open, and NEG = -2^30 satisfies both for any scores far
// below 2^29 in size; nothing overflows int32 (the most negative value
// formed is S + 2 NEG >= -2^31, below).
//
// What bounds it on an H100: operations, about ten int32 operations a cell
// against a few bytes a cell row.  Design: one warp per pair, a wavefront.
// Lane p owns the P = ceil(LQ / 32) consecutive query positions p P ..
// p P + P - 1 (P exactly, a template parameter from 1 to 32), and at step t
// it works on reference row t - p.  At the end of each step
// __shfl_up_sync hands lane p + 1 the E entering its first position and
// the S of this lane's last position (lane p + 1's diagonal one step
// later), and the reference code moves one lane up the same way; lane 0
// takes its code from 32 codes the warp loads with one coalesced load a
// chunk ahead.  LR + (active lanes - 1) steps, no scan.  The
// add-then-max pairs of F, E and S are Hopper's DPX instructions
// (__viaddmax_s32, __vimax_s32_relu).  The negative-code checks are
// hoisted: a padded query position gets a code no reference code equals
// and NEG as its mismatch score; a padded reference row adds NEG once more
// (so M >= S + 2 NEG >= -2^31, and SF = F, as in the TPU).  Positions
// past LQ in the last active lane compute like padded ones and are left out
// of the best score through one best a position, masked at the end.
//
// Queries longer than 1,024 positions (32 lanes of at most 32) run in query
// blocks, one launch a block, in order on the stream: n blocks of 32 P
// positions (the last one shorter), P = ceil(ceil(LQ / n0) / 32) with
// n0 = ceil(LQ / 1024), so every block but the last fills its 32 lanes.
// Block b's recurrence needs, for each reference row i, only the column
// just left of it: S[i][q0 - 1] (and S[i - 1][q0 - 1], the row before's,
// as the diagonal) and the E entering q0.  Block b - 1's last lane writes
// that pair for row i at its step i + 31, into a carry of B x LR int2
// (S, E); block b's lane 0 reads it at step i, from 32 rows loaded a chunk
// ahead as the reference codes are.  The carry is read and written in
// place: row i is read (and its value used) at step i, before it is
// written at step i + 31.  Each block adds its positions' best into the
// pair's score.  A single-block query (LQ <= 1024) runs the kernel without
// the carry, as before.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int32_t NEG = -(1 << 30);
constexpr int THREADS = 128;            // 4 pairs per block

// LQ is the block's length; the pair's query row holds q_stride codes and
// the block starts at q0.  CARRY: carry_in and carry_out say whether the
// block reads the boundary column's (S, E) of block b - 1 from ``carry``
// and writes its own there for block b + 1.
template <int P, bool CARRY>
__global__ void __launch_bounds__(THREADS)
sw_kernel(const int32_t *__restrict__ queries,
          const int32_t *__restrict__ refs, int32_t *__restrict__ out, int B,
          int LQ, int LR, int match, int mismatch, int gap_open,
          int gap_ext, int q_stride, int q0, int2 *carry, int carry_in,
          int carry_out) {
    const int pair = (int)(((int64_t)blockIdx.x * THREADS + threadIdx.x)
                           >> 5);
    const int lane = threadIdx.x & 31;
    if (pair >= B)
        return;                                 // the whole warp leaves
    const int32_t *q = queries + (int64_t)pair * q_stride + q0;
    const int32_t *r = refs + (int64_t)pair * LR;
    int2 *cr = CARRY ? carry + (int64_t)pair * LR : nullptr;
    const bool cin = CARRY && carry_in, cout = CARRY && carry_out;
    const int j0 = lane * P;                    // first query position
    const int last_lane = (LQ - 1) / P;         // lanes past it are idle
    const int nvalid = min(max(LQ - j0, 0), P); // positions < LQ

    // query codes: a padded or missing position gets -2, which no
    // reference code (>= 0, or -1 for a padded row) equals, and NEG as its
    // mismatch score
    int32_t qv[P], qx[P], s[P], f[P], bk[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const int32_t c = k < nvalid ? q[j0 + k] : -1;
        qv[k] = c < 0 ? -2 : c;
        qx[k] = c < 0 ? NEG : mismatch;
        s[k] = 0;
        f[k] = NEG;
        bk[k] = 0;
    }
    int32_t rcode = 0, sleft = 0, s_out = 0, e_out = NEG;
    // codes 32 c .. 32 c + 31 for the steps of chunk c, and the next chunk
    int32_t rbuf = lane < LR ? __ldg(r + lane) : 0;
    int32_t rnext = 32 + lane < LR ? __ldg(r + 32 + lane) : 0;
    // block b - 1's boundary column, loaded as the codes are
    int2 cbuf = make_int2(0, NEG), cnext = make_int2(0, NEG);
    if (cin) {
        if (lane < LR)
            cbuf = cr[lane];
        if (32 + lane < LR)
            cnext = cr[32 + lane];
    }
    const int steps = LR + last_lane;
    for (int t = 0; t < steps; ++t) {
        // the previous step's outputs of lane p - 1: the E entering this
        // lane's first position and S[j0 - 1] of its row, and its code
        const int32_t e_in = __shfl_up_sync(FULL, e_out, 1);
        const int32_t s_in = __shfl_up_sync(FULL, s_out, 1);
        const int32_t r_up = __shfl_up_sync(FULL, rcode, 1);
        const int32_t r_new = __shfl_sync(FULL, rbuf, t & 31);
        int32_t c_s = 0, c_e = NEG;              // lane 0's row t carry
        if (cin) {
            c_s = __shfl_sync(FULL, cbuf.x, t & 31);
            c_e = __shfl_sync(FULL, cbuf.y, t & 31);
        }
        if ((t & 31) == 31) {
            const int n = t + 33 + lane;
            rbuf = rnext;
            rnext = n < LR ? __ldg(r + n) : 0;
            if (cin) {
                cbuf = cnext;
                cnext = n < LR ? cr[n] : make_int2(0, NEG);
            }
        }
        const int32_t diag0 = lane == 0 && !cin ? 0 : sleft; // S[i-1][j0-1]
        sleft = lane == 0 ? c_s : s_in;                      // S[i][j0-1]
        rcode = lane == 0 ? r_new : r_up;
        const int i = t - lane;
        if (i < 0 || i >= LR)
            continue;
        const int32_t ri = rcode < 0 ? -1 : rcode;
        const int32_t rb = rcode < 0 ? NEG : 0;
        int32_t e = lane == 0 ? c_e : e_in;
        int32_t diag = diag0;
#pragma unroll
        for (int k = 0; k < P; ++k) {
            const int32_t sub = qv[k] == ri ? match : qx[k];
            const int32_t m = diag + sub + rb;
            diag = s[k];
            f[k] = __viaddmax_s32(s[k], gap_open, f[k] + gap_ext);
            const int32_t sf = max(m, f[k]);
            s[k] = __vimax_s32_relu(sf, e);
            e = __viaddmax_s32(sf, gap_open, e + gap_ext);
            bk[k] = max(bk[k], s[k]);
        }
        s_out = s[P - 1];
        e_out = e;
        if (cout && lane == 31)
            cr[i] = make_int2(s_out, e);
    }
    int32_t best = 0;
#pragma unroll
    for (int k = 0; k < P; ++k)
        if (k < nvalid)
            best = max(best, bk[k]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        best = max(best, __shfl_down_sync(FULL, best, d));
    if (lane == 0)
        out[pair] = cin ? max(out[pair], best) : best;
}

template <int P, bool CARRY>
const void *kernel() {
    return (const void *)sw_kernel<P, CARRY>;
}

// P = 1 .. 32 without the carry; with it, P = 17 .. 32 (a query of more
// than 1,024 positions splits into blocks of more than 512)
template <int... Ps>
const void *plain_for(int p, std::integer_sequence<int, Ps...>) {
    const void *fns[] = {kernel<Ps + 1, false>()...};
    return fns[p - 1];
}

template <int... Ps>
const void *carried_for(int p, std::integer_sequence<int, Ps...>) {
    const void *fns[] = {kernel<Ps + 17, true>()...};
    return fns[p - 17];
}

}  // namespace

// queries (B, LQ), refs (B, LR) int32 codes (negative = padding) -> out
// (B,) int32.  A query of more than 1,024 positions needs ``carry``, B x LR
// int2 of scratch, and launches one kernel a query block (see the top of
// this file; align/sw.py::query_blocks computes the same blocks).  The
// wrapper checks LQ >= 1 and B >= 1.
extern "C" int mg_sw_scores(const void *queries, const void *refs, void *out,
                            int32_t B, int32_t LQ, int32_t LR, int32_t match,
                            int32_t mismatch, int32_t gap_open,
                            int32_t gap_ext, void *carry, void *stream) {
    if (LQ < 1)
        return (int)cudaErrorInvalidValue;
    const int n0 = (LQ + 1023) / 1024;
    const int P = ((LQ + n0 - 1) / n0 + 31) / 32;
    const int BL = 32 * P;
    const int nb = (LQ + BL - 1) / BL;
    if (nb > 1 && carry == nullptr)
        return (int)cudaErrorInvalidValue;
    if (nb > 1 && P < 17)
        return (int)cudaErrorInvalidValue;
    const void *fn = nb > 1
        ? carried_for(P, std::make_integer_sequence<int, 16>{})
        : plain_for(P, std::make_integer_sequence<int, 32>{});
    const dim3 grid((unsigned)(((int64_t)B * 32 + THREADS - 1) / THREADS));
    for (int b = 0; b < nb; ++b) {
        int q0 = b * BL, lq = LQ - q0 < BL ? LQ - q0 : BL, cin = b > 0,
            cout = b < nb - 1;
        void *args[] = {&queries, &refs, &out, &B, &lq, &LR, &match,
                        &mismatch, &gap_open, &gap_ext, &LQ, &q0, &carry,
                        &cin, &cout};
        cudaError_t err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, 0,
                                           (cudaStream_t)stream);
        if (err != cudaSuccess)
            return (int)err;
    }
    return (int)cudaGetLastError();
}
