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
// Kernel B11 redesigned: align_wave, one launch a wave of the flat engine
// over its column store on the card (the card's form of the contract of
// native/fastio.cpp::align_wave, :960, with the port's int32 semantics).
// A child row c reads its packed row of the per-child vectors (PK_*), then
//   its parent's S and F rows straight from the store: the parent's hull
//     [first, last], the span of cells >= the cutoff (first 0, last W - 1
//     where none is; __ballot_sync over 32 columns a step), band_lo =
//     first, band_hi = min(last + 1, wsize);
//   SpM = S in [max(first - 1, 0), band_hi - 1], SpF = S and Fp = F in
//     [first, band_hi], NINF elsewhere: masks applied in registers, no
//     plane is formed;
//   the recurrence above on those values and its profile row, cells at or
//     past the job's WS set to NINF (the pad);
//   S, E and F written into the store row the host gives it, S once more
//     into the read-back rows, and, for a later sibling of a branch pop
//     (PK_SLOT >= 0), its E row and its parent's S row beside them;
//   the row statistics, reduced in the warp: Smax; mp, the first column
//     minimizing |j - diag| among cells equal to Smax (pad cells ranked
//     +inf, 0 where every such cell is pad); col_min over cells != NINF
//     (INT32_MAX where none is); has_ext, any wrapped int32 S + pss >= the
//     float64 ext_cut; S[wsize], parent S[max(mp - 1, 0)], parent
//     S[max(wsize - 1, 0)], prof[mp], band_lo, band_hi.
// What bounds it: bytes.  A wave reads each child's parent S and F rows,
// its profile and partial-sum rows (16 B a cell, the parent rows shared by
// siblings through L1 and L2) and writes 16 B a cell; the hull pass reads
// the parent's S row a second time, from L1.
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


// The per-child vectors, NPACK int32 a child (the float64 ext_cut in the
// last two, low word first), and the statistics, NSTAT int32 a child.
enum { PK_PARENT, PK_ROW, PK_PROF, PK_PSS, PK_SCORE, PK_DEL, PK_CUT, PK_WS,
       PK_WSIZE, PK_DIAG, PK_SLOT, PK_XCUT, NPACK = PK_XCUT + 2 };
enum { ST_SMAX, ST_MP, ST_COLMIN, ST_HASEXT, ST_SLP, ST_PMP, ST_PLP,
       ST_SCMP, ST_LO, ST_HI, NSTAT };
constexpr int32_t POS = INT32_MAX;

__global__ void __launch_bounds__(WARPS * 32)
align_wave_kernel(int32_t *G, const int32_t *__restrict__ T,
                  const int32_t *__restrict__ pack, int CH, int W, int Wp,
                  int32_t go, int32_t ge, int32_t *__restrict__ stats,
                  int32_t *__restrict__ srows, int32_t *__restrict__ brows) {
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (c >= CH) return;                  // whole warps leave together
    const int32_t *pk = pack + (int64_t)c * NPACK;
    // store rows: S, E, F one after the other, Wp int32 each
    const int32_t *Sp = G + (int64_t)pk[PK_PARENT] * 3 * Wp;
    const int32_t *Fq = Sp + 2 * (int64_t)Wp;
    int32_t *So = G + (int64_t)pk[PK_ROW] * 3 * Wp;
    int32_t *Eo = So + Wp, *Fo = So + 2 * (int64_t)Wp;
    const int32_t *pr = T + (int64_t)pk[PK_PROF] * Wp;
    const int32_t *ps = T + (int64_t)pk[PK_PSS] * Wp;
    const int32_t ns = pk[PK_SCORE], cut = pk[PK_CUT];
    const bool del = pk[PK_DEL] != 0;
    const int ws = pk[PK_WS], wsize = pk[PK_WSIZE], slot = pk[PK_SLOT];
    const int32_t diag = pk[PK_DIAG];
    const double xcut = __longlong_as_double(
        (long long)(((uint64_t)(uint32_t)pk[PK_XCUT + 1] << 32)
                    | (uint32_t)pk[PK_XCUT]));
    int32_t *sr = srows + (int64_t)c * W;
    int32_t *br = slot >= 0 ? brows + (int64_t)slot * 2 * W : nullptr;

    // the parent's hull
    int first = -1, last = -1;
    for (int c0 = 0; c0 < W; c0 += 32) {
        const int j = c0 + lane;
        const unsigned b = __ballot_sync(FULL, j < W && Sp[j] >= cut);
        if (b) {
            if (first < 0) first = c0 + __ffs(b) - 1;
            last = c0 + 31 - __clz(b);
        }
    }
    if (first < 0) first = 0, last = W - 1;
    const int lo = first, hi = min(last + 1, wsize);
    const int mlo = max(first - 1, 0), mhi = hi - 1;

    int32_t carry = INT32_MIN;            // run[] of the step before
    int32_t bs = 0, bd = 0, bj = -1;      // the lane's best cell so far
    int32_t cmin = POS, slp = 0;
    bool hx = false;
    for (int c0 = 0; c0 < W; c0 += 32) {
        const int j = c0 + lane;
        const bool in = j < W;
        int32_t m = NINF, f = NINF, b = INT32_MIN, sj = NINF;
        if (in) {
            // every load of the step issued before the scan
            sj = Sp[j];
            const int32_t sp = j > 0 ? Sp[j - 1] : NINF;
            const int32_t pj = pr[j], fj = Fq[j];
            if (j > 0 && j - 1 >= mlo && j - 1 <= mhi && sp != NINF)
                m = wadd(wadd(sp, pj), ns);
            if (del) {
                const bool inb = j >= lo && j <= hi;
                const int32_t sf = inb ? sj : NINF, fp = inb ? fj : NINF;
                const int32_t d_open = sf == NINF ? NINF : wadd(sf, go);
                const int32_t d_ext = fp == NINF ? NINF : wadd(fp, ge);
                f = max(d_open, d_ext);
                if (f != NINF) f = wadd(f, ns);
            }
            m = max(m, f);
            b = wsub(wadd(m, go), wmul(j + 1, ge));
        }
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
        if (j >= ws) s = e = f = NINF;
        So[j] = s;
        Eo[j] = e;
        Fo[j] = f;
        sr[j] = s;
        if (br) {
            br[j] = e;
            br[W + j] = sj;
        }
        // the statistics
        const int32_t dj = wsub(j, diag);
        const int32_t dist = j >= ws ? POS : (dj < 0 ? wsub(0, dj) : dj);
        if (bj < 0 || s > bs || (s == bs && dist < bd))
            bs = s, bd = dist, bj = j;
        if (s != NINF && s < cmin) cmin = s;
        hx |= (double)wadd(s, ps[j]) >= xcut;
        if (j == wsize) slp = s;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        const int32_t os = __shfl_xor_sync(FULL, bs, o);
        const int32_t od = __shfl_xor_sync(FULL, bd, o);
        const int32_t oj = __shfl_xor_sync(FULL, bj, o);
        if (oj >= 0 && (bj < 0 || os > bs || (os == bs && (od < bd
                        || (od == bd && oj < bj)))))
            bs = os, bd = od, bj = oj;
        cmin = min(cmin, __shfl_xor_sync(FULL, cmin, o));
    }
    hx = __any_sync(FULL, hx);
    slp = __shfl_sync(FULL, slp, wsize & 31);
    if (lane == 0) {
        const int mp = bd == POS ? 0 : bj;
        int32_t *st = stats + (int64_t)c * NSTAT;
        st[ST_SMAX] = bs;
        st[ST_MP] = mp;
        st[ST_COLMIN] = cmin;
        st[ST_HASEXT] = hx;
        st[ST_SLP] = slp;
        st[ST_PMP] = Sp[max(mp - 1, 0)];
        st[ST_PLP] = Sp[max(wsize - 1, 0)];
        st[ST_SCMP] = pr[mp];
        st[ST_LO] = lo;
        st[ST_HI] = hi;
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

// G: the store, R x 3 x Wp int32; T: the profile and partial-sum rows, Q x
// Wp; pack: CH x NPACK.  out holds the statistics (CH x NSTAT), S again
// (CH x W), then two rows a branch slot (E, the parent's S; W each).
extern "C" int mg_align_wave(int32_t *G, const int32_t *T,
                             const int32_t *pack, int CH, int W, int Wp,
                             int go, int ge, int32_t *out,
                             cudaStream_t stream) {
    int32_t *srows = out + (int64_t)CH * NSTAT;
    const int blocks = (CH + WARPS - 1) / WARPS;
    align_wave_kernel<<<blocks, WARPS * 32, 0, stream>>>(
        G, T, pack, CH, W, Wp, go, ge, out, srows, srows + (int64_t)CH * W);
    return (int)cudaGetLastError();
}
