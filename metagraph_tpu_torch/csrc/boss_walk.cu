// Kernels K2 (boss_rank_select) and K3 (boss_map): the BOSS table's blocked
// rank and select, and the node search and edge pick built on them.
//
// Replace the XLA programs of metagraph_tpu/succinct/ops.py::DeviceBOSS:
// K2 its four batched primitives rank_last (:550), rank_W (:558),
// select_last (:588) and select_W (:601) with _select_block (:570), the
// operation a template parameter; K3 index (:614), pick_edge (:642) and
// map_kmers (:656) fused, one walk a query: map_kmers is k - 1 steps of two
// rank_W and two select_last, then the pick's rank_last, select_last and
// at most two rounds of two rank_W and a select_W, all in registers.
//
// The table is DeviceBOSS's, as the JAX package lays it out: W and last in
// blocks of 128 int8 entries (W padded with -1), cum_W (nb + 1, 2 alph) and
// cum_last (nb + 1,) the counts before each block, F and NF.  Within a
// block a rank counts with byte compares (__vcmpeq4) and popcounts over the
// entries up to its place, 16 bytes a load; last holds 0 and 1, so its
// bytes' popcounts are its sum.  A select finds its block by JAX's binary
// search of the cum column (``steps`` = ceil(log2(nb + 1)) halvings, the
// read at mid + 1 clipped to nb, so a rank past the last entry lands where
// JAX's does), then the r-th matching entry of the block, 0 where none.
// Every gather clips its index as XLA's gather does (block rows to
// nb - 1, cum rows to nb, cum columns to 2 alph - 1), so out-of-range
// inputs give JAX's answers too.
//
// What bounds it on an H100: the latency of a chain of dependent reads a
// query (map_kmers at k = 31 makes about 4 (k - 1) block reads and
// 2 (k - 1) binary searches), not bandwidth.  One thread a query keeps
// the chain short; a simple exact kernel first.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BLOCK = 128;

struct Boss {
    const int8_t *Wb;        // (nb, 128)
    const int8_t *lb;        // (nb, 128)
    const int32_t *cumW;     // (nb + 1, A2)
    const int32_t *cuml;     // (nb + 1,)
    const int32_t *F;        // (alph,)
    const int32_t *NF;       // (alph,)
    int nb, A2, alph, M, steps;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// entries 0..within of a 128-byte row that equal byte pattern ``pat``
// (four copies of the value), or with last = true its set entries
__device__ __forceinline__ int count_row(const int8_t *row, uint32_t pat,
                                         bool last, int within) {
    const uint4 *r = reinterpret_cast<const uint4 *>(row);
    int cnt = 0;
    const int top = within >> 4;                  // the last 16-byte chunk
    for (int u = 0; u <= top; ++u) {
        const uint4 x = __ldg(r + u);
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int first = u * 16 + t * 4;     // entry of byte 0
            if (first > within)
                break;
            uint32_t m = last ? w[t] : (__vcmpeq4(w[t], pat) & 0x01010101u);
            const int n = within - first + 1;     // bytes to count, >= 1
            if (n < 4)
                m &= (1u << (8 * n)) - 1u;
            cnt += __popc(m);
        }
    }
    return cnt;
}

// the place (0..127) of the target-th matching entry of a row, 0 if none
__device__ __forceinline__ int find_row(const int8_t *row, uint32_t pat,
                                        bool last, int target) {
    if (target < 1)
        return 0;
    const uint4 *r = reinterpret_cast<const uint4 *>(row);
    int seen = 0;
    for (int u = 0; u < BLOCK / 16; ++u) {
        const uint4 x = __ldg(r + u);
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            uint32_t m = last ? w[t] : (__vcmpeq4(w[t], pat) & 0x01010101u);
            const int n = __popc(m);
            if (seen + n >= target) {
                for (int b = 0; b < 4; ++b, m >>= 8)
                    if ((m & 1u) && ++seen == target)
                        return u * 16 + t * 4 + b;
            }
            seen += n;
        }
    }
    return 0;
}

__device__ __forceinline__ uint32_t pattern(int c) {
    return (uint32_t)(uint8_t)(int8_t)c * 0x01010101u;
}

// i below 0 reads as 0 in both ranks
__device__ __forceinline__ int rank_last(const Boss &b, int i) {
    i = max(i, 0);
    const int blk = i >> 7;
    return __ldg(b.cuml + min(blk, b.nb))
        + count_row(b.lb + (int64_t)min(blk, b.nb - 1) * BLOCK, 0u, true,
                    i & 127);
}

__device__ __forceinline__ int rank_W(const Boss &b, int i, int c) {
    i = max(i, 0);
    const int blk = i >> 7;
    const int col = clampi(c, 0, b.A2 - 1);
    return __ldg(b.cumW + (int64_t)min(blk, b.nb) * b.A2 + col)
        + count_row(b.Wb + (int64_t)min(blk, b.nb - 1) * BLOCK, pattern(c),
                    false, i & 127)
        - (c == 0);
}

// the first block whose cum (read at column col of a row of ld entries)
// reaches r: JAX's loop, mid + 1 clipped to nb
__device__ __forceinline__ int select_block(const int32_t *cum, int ld,
                                            int col, int nb, int steps,
                                            int r) {
    int lo = 0, hi = nb;
    for (int s = 0; s < steps; ++s) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(cum + (int64_t)min(mid + 1, nb) * ld + col) >= r)
            hi = mid;
        else
            lo = mid + 1;
    }
    return lo;
}

__device__ __forceinline__ int select_last(const Boss &b, int r) {
    if (r <= 0)
        return 0;
    const int blk = select_block(b.cuml, 1, 0, b.nb, b.steps, r);
    const int base = __ldg(b.cuml + min(blk, b.nb));
    return blk * BLOCK
        + find_row(b.lb + (int64_t)clampi(blk, 0, b.nb - 1) * BLOCK, 0u,
                   true, r - base);
}

__device__ __forceinline__ int select_W(const Boss &b, int c, int r) {
    r += (c == 0);                                // W[0] = 0, the sentinel
    const int col = clampi(c, 0, b.A2 - 1);
    const int blk = select_block(b.cumW, b.A2, col, b.nb, b.steps, r);
    const int base = __ldg(b.cumW + (int64_t)min(blk, b.nb) * b.A2 + col);
    return blk * BLOCK
        + find_row(b.Wb + (int64_t)clampi(blk, 0, b.nb - 1) * BLOCK,
                   pattern(c), false, r - base);
}

// the last edge of the node spelt by codes[0..k), 0 where absent
__device__ __forceinline__ int index_node(const Boss &b,
                                          const int32_t *codes, int k) {
    bool alive = true;
    for (int p = 0; p < k; ++p)                   // a negative code too
        alive &= (unsigned)__ldg(codes + p) < (unsigned)b.alph;
    const int s0 = alive ? __ldg(codes) : 0;
    int rl = min(__ldg(b.F + s0) + 1, b.M);
    int ru = s0 + 1 < b.alph ? __ldg(b.F + s0 + 1) : b.M - 1;
    alive &= rl <= ru;
    for (int p = 1; p < k && alive; ++p) {
        const int s = __ldg(codes + p);
        const int rk_rl = rank_W(b, max(rl - 1, 0), s) + 1;
        const int rk_ru = rank_W(b, ru, s);
        alive = rk_rl <= rk_ru;
        if (alive) {
            const int nf = __ldg(b.NF + s);
            rl = select_last(b, nf + rk_rl - 1) + 1;
            ru = select_last(b, nf + rk_ru);
        }
    }
    return alive ? ru : 0;
}

// the edge labelled c (or c + alph) out of the node whose last edge is edge
__device__ __forceinline__ int pick_edge(const Boss &b, int edge, int c) {
    const int begin = select_last(b, rank_last(b, max(edge - 1, 0))) + 1;
    int res = 0;
    for (int t = 0; t < 2; ++t) {
        const int cand = c + t * b.alph;
        const int lo = rank_W(b, max(begin - 1, 0), cand);
        const int hi = rank_W(b, edge, cand);
        if (hi > lo && res == 0)
            res = select_W(b, cand, lo + 1);
    }
    return res;
}

// OP 0 rank_last(a), 1 rank_W(a, c = x), 2 select_last(a), 3
// select_W(c = a, r = x)
template <int OP>
__global__ void __launch_bounds__(THREADS)
rank_select_kernel(Boss b, const int32_t *__restrict__ a,
                   const int32_t *__restrict__ x, int32_t *__restrict__ out,
                   int64_t Q) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= Q)
        return;
    const int ai = __ldg(a + i);
    int v;
    if (OP == 0)
        v = rank_last(b, ai);
    else if (OP == 1)
        v = rank_W(b, ai, __ldg(x + i));
    else if (OP == 2)
        v = select_last(b, ai);
    else
        v = select_W(b, ai, __ldg(x + i));
    out[i] = v;
}

// MODE 0 index of (Q, width) node codes; 1 pick_edge(edge = a, c = x);
// 2 map_kmers of (Q, width) edge strings (width = k + 1)
template <int MODE>
__global__ void __launch_bounds__(THREADS)
map_kernel(Boss b, const int32_t *__restrict__ a,
           const int32_t *__restrict__ x, int32_t *__restrict__ out,
           int64_t Q, int width) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= Q)
        return;
    int v;
    if (MODE == 0) {
        v = index_node(b, a + i * width, width);
    } else if (MODE == 1) {
        v = pick_edge(b, __ldg(a + i), __ldg(x + i));
    } else {
        const int32_t *row = a + i * width;
        const int node = index_node(b, row, width - 1);
        const int label = __ldg(row + width - 1);
        v = (node > 0 && label > 0 && label < b.alph)
            ? pick_edge(b, node, label) : 0;
    }
    out[i] = v;
}

Boss make_boss(const void *Wb, const void *lb, const void *cumW,
               const void *cuml, const void *F, const void *NF, int nb,
               int A2, int alph, int M, int steps) {
    return Boss{(const int8_t *)Wb, (const int8_t *)lb,
                (const int32_t *)cumW, (const int32_t *)cuml,
                (const int32_t *)F, (const int32_t *)NF, nb, A2, alph, M,
                steps};
}

unsigned grid(int64_t Q) { return (unsigned)((Q + THREADS - 1) / THREADS); }

}  // namespace

// The table: W_blocks and last_blocks (nb, 128) int8 (16-byte aligned),
// cum_W (nb + 1, A2) and cum_last (nb + 1,) int32, F and NF (alph,) int32;
// M entries, ``steps`` halvings of a select's block search.  The wrapper
// checks nb >= 1, Q >= 1 and the alignment.
extern "C" int mg_boss_rank_select(const void *Wb, const void *lb,
                                   const void *cumW, const void *cuml,
                                   const void *F, const void *NF, int32_t nb,
                                   int32_t A2, int32_t alph, int32_t M,
                                   int32_t steps, int32_t op, const void *a,
                                   const void *x, void *out, int64_t Q,
                                   void *stream) {
    const Boss b = make_boss(Wb, lb, cumW, cuml, F, NF, nb, A2, alph, M,
                             steps);
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t *pa = (const int32_t *)a, *px = (const int32_t *)x;
    int32_t *po = (int32_t *)out;
    switch (op) {
    case 0: rank_select_kernel<0><<<grid(Q), THREADS, 0, st>>>(b, pa, px, po, Q); break;
    case 1: rank_select_kernel<1><<<grid(Q), THREADS, 0, st>>>(b, pa, px, po, Q); break;
    case 2: rank_select_kernel<2><<<grid(Q), THREADS, 0, st>>>(b, pa, px, po, Q); break;
    case 3: rank_select_kernel<3><<<grid(Q), THREADS, 0, st>>>(b, pa, px, po, Q); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// mode 0 index (a: (Q, width) codes), 1 pick_edge (a: edges, x: labels),
// 2 map_kmers (a: (Q, width) edge strings).
extern "C" int mg_boss_map(const void *Wb, const void *lb, const void *cumW,
                           const void *cuml, const void *F, const void *NF,
                           int32_t nb, int32_t A2, int32_t alph, int32_t M,
                           int32_t steps, int32_t mode, const void *a,
                           const void *x, void *out, int64_t Q,
                           int32_t width, void *stream) {
    const Boss b = make_boss(Wb, lb, cumW, cuml, F, NF, nb, A2, alph, M,
                             steps);
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t *pa = (const int32_t *)a, *px = (const int32_t *)x;
    int32_t *po = (int32_t *)out;
    switch (mode) {
    case 0: map_kernel<0><<<grid(Q), THREADS, 0, st>>>(b, pa, px, po, Q, width); break;
    case 1: map_kernel<1><<<grid(Q), THREADS, 0, st>>>(b, pa, px, po, Q, width); break;
    case 2: map_kernel<2><<<grid(Q), THREADS, 0, st>>>(b, pa, px, po, Q, width); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
