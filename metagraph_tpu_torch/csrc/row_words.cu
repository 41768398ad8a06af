// Kernels W1 and W2 of the annotated batch query on a compressed device
// annotation: each window's packed label words, read from a Multi-BRWT
// (W1) or through a row-diff successor walk (W2), for the counting kernel
// (label_counts.cu) to count as it counts the dense bitmap's rows.
//
// W1 (brwt_row_words) replaces metagraph_tpu/annotation/device_matrix.py::
// dyn_brwt_descend (:338), an XLA program that evaluates every node of
// every level for every query under fixed shapes, O(Q x nodes) (and
// brwt_row_words :123, the same function with the tree's shape static).
// W2 (rowdiff_row_words) replaces rowdiff_row_words (:190) with
// rowdiff_dyn_brwt_words_fn (:435) or rowdiff_dense_words_fn (:227): a
// fori_loop of max_depth steps that XORs each step's inner row words into
// the result and follows succ until an anchor.
//
// The tree (device_matrix.py::FlatBRWT) is one node table in breadth-first
// order, a node's children a contiguous run of it, and one word array:
// * node (int4): its first word, its label (a leaf; -1 for an inner node),
//   its first child and its number of children;
// * word (int2): 32 bits of a node's bitmap and the bits set in the node's
//   words before it (the exclusive rank directory).
// A set bit at local row r of an inner node sends the query to every child
// at local row rank1(r) - 1; a set bit of a leaf sets its label.
//
// What bounds them: chains of dependent loads at random addresses, a node
// and a word a level of the descent, and the instructions of each round,
// not bytes; the tree's nodes and upper levels' words stay in L2.
//
// The descent (W1, and every row that W2 reads from a tree) is output-
// sensitive: it evaluates only the children of live nodes, which a dead
// node's subtree cannot change (its bits are all clear), so the result is
// the XLA program's.  A warp descends `slots` windows (at most 8) at once:
// a window with 1-3 labels keeps 2-6 lanes of a round busy on an arity-2
// tree, so the rounds of several windows share the lanes and a warp waits
// on one chain of loads for all of them.  The warp keeps a stack of child
// runs (first child, count and slot, local row) in shared memory and, a round
// at a time, pops from the top as many runs as have at most 32 children in
// all (or 32 children of a larger run), a lane a child.  Each lane reads
// its node (16 B) and its word (8 B), tests the bit, sets a live leaf's
// label in its slot's row of words in shared memory, and pushes a live
// inner node's run.  Pushes keep stack order (a ballot), so the stack
// holds runs of non-decreasing depth from the bottom and every run of one
// depth was pushed by one round (the roots, at most 8, by the first):
// no depth holds more than 32 runs or more than slots x its inner nodes,
// and FlatBRWT.stack_cap = 8 + the sum over depths of min(32, 8 x inner
// nodes) bounds the stack of any slots <= 8.
//
// W2 walks each shared chain once.  A window q's walk XORs the inner rows
// of row(q), next_row[row(q)], ... (at most max_depth rows, -1 ends it);
// where next_row[row(q)] == row(q + 1) (q "links" forward, as the windows
// of a read along its reference do), q's walk is its own row and then
// q + 1's walk, unless max_depth cuts q's.  So:
// 1. own rows: every window's own inner row into out[q] (the descent above,
//    or the dense bitmap's row), and its link flag;
// 2. plan (a thread a window): a window that links to no next window (a
//    tail) follows its chain past its own row by 4-byte successor loads,
//    e rows (at most max_depth - 1), and puts them in a list beside its
//    own index; the windows of its run more than max_depth - 1 - e before
//    it (a cut walk: only where max_depth is cut short) are marked serial,
//    as is a tail whose chain does not fit the list;
// 3. chains: the list's rows are descended `slots` a warp in parallel and
//    XORed into their tails' rows (atomics on the few words they set); a
//    serial window's chain is followed and XORed in by one warp;
// 4. scan (a warp a tail and 32 word columns, the tails listed by step 2):
//    a suffix XOR back along its run, a word column a lane: out[p] ^=
//    out[p + 1], from the tail to the run's first window or to the first
//    serial one.
// Each row of a chunk's linked runs is descended once; only the tails'
// chains past the run are walked, and in parallel.  Links run forward
// only: a run against the successor direction (a reverse-complement read
// on a primary graph) is a run of tails, each walked in full (exact).
//
// Both fold canon 2's offset (an id above it is a reverse-complement hit
// of base node id - offset) and take row = id - 1; an id of 0, or a row
// past the annotation, is a miss with no labels.  No index that the data
// holds reads outside the arrays: a node's word index past the word array
// or a child past the node table is dead, a label past L is dropped, a
// successor outside the rows ends the walk (QueryIndex checks them once,
// when the index is made).
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef MG_ROW_WORDS_SPLIT
// The split build (library "row_words_split", scripts/kernel_times.py):
// each descent adds the cycles its lanes wait on the node load and on the
// word load, its rounds' cycles, its rounds and its node loads into
// split_cycles.
__device__ unsigned long long split_cycles[5];
#define SPLIT_CLOCK(t, dep) \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(dep) : "memory")
#endif

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint8_t LINK = 1, TAIL = 2, SERIAL = 4;   // W2's window flags

struct Tree {
    const int4 *nodes;
    int64_t n_nodes;
    const int2 *words;
    int64_t n_words;
    int cap;            // stack runs a warp
};

struct Walk {           // W2's successors and inner rows
    const int32_t *next_row;
    int max_depth;
    const uint32_t *bitmap;   // the dense inner rows, or null
    int64_t stride;
};

// A warp's shared memory: `slots` rows of Lw label words, then the stack
// of runs: first child, count << 3 | slot (FlatBRWT keeps counts below
// 2^28), local row.
struct Smem {
    uint32_t *acc;
    int *sf, *sc, *sr;

    __device__ Smem(int *sm, int warp, int slots, int Lw, int cap) {
        int *mine = sm + (size_t)warp * (slots * Lw + 3 * cap);
        acc = reinterpret_cast<uint32_t *>(mine);
        sf = mine + slots * Lw;
        sc = sf + cap;
        sr = sc + cap;
    }
};

// Sets the labels of local row `row` of the tree's root (lane s < slots:
// slot s's row, -1 for none) into row s of m.acc (Lw words a row).
__device__ void descend(const Tree &t, int32_t row, int slots, const Smem &m,
                        int L, int Lw, int lane) {
    // the roots, each the only child of a virtual run, in slot order
    const bool root = lane < slots && row >= 0;
    const unsigned rm = __ballot_sync(FULL, root);
    if (root) {
        const int pos = __popc(rm & ((1u << lane) - 1u));
        m.sf[pos] = 0;
        m.sc[pos] = 1 << 3 | lane;
        m.sr[pos] = row;
    }
    int sp = __popc(rm);
    __syncwarp();
#ifdef MG_ROW_WORDS_SPLIT
    unsigned long long s_node = 0, s_word = 0, s_round = 0, s_n = 0;
    unsigned long long s_loads = 0;
#endif
    while (sp > 0) {
#ifdef MG_ROW_WORDS_SPLIT
        unsigned long long r0;
        SPLIT_CLOCK(r0, sp);
#endif
        // lane j looks at run sp - 1 - j, the top first
        const int e = sp - 1 - lane;
        const int cs = e >= 0 ? m.sc[e] : 0;
        const int cnt = cs >> 3;
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, d);
            if (lane >= d)
                incl += v;
        }
        // the top k runs have at most 32 children in all (lanes 0..k-1)
        const int k = __popc(__ballot_sync(FULL, e >= 0 && incl <= 32));
        int node = -1, r = 0, slot = 0, base;
        if (k == 0) {
            // the top run has more than 32 children: take 32 of them
            const int top = sp - 1;
            node = m.sf[top] + lane;
            r = m.sr[top];
            slot = m.sc[top] & 7;
            __syncwarp();
            if (lane == 0) {
                m.sf[top] += 32;
                m.sc[top] -= 32 << 3;
            }
            base = sp;
        } else {
            // children in stack order, the lowest popped run's first: run
            // j's children take lanes [total - incl_j, total - incl_j + cnt)
            // (cnt >= 1), so lane l's run is j = k - (the runs that start
            // at or below l)
            const int total = __shfl_sync(FULL, incl, k - 1);
            const int f = e >= 0 ? m.sf[e] : 0, rk = e >= 0 ? m.sr[e] : 0;
            const int sl = cs & 7;
            const int start = total - incl;
            const unsigned heads =
                __reduce_or_sync(FULL, lane < k ? 1u << start : 0u);
            const int j = k - __popc(heads & (FULL >> (31 - lane)));
            const int sj = __shfl_sync(FULL, start, j & 31);
            const int fj = __shfl_sync(FULL, f, j & 31);
            const int rj = __shfl_sync(FULL, rk, j & 31);
            const int lj = __shfl_sync(FULL, sl, j & 31);
            if (lane < total) {
                node = fj + lane - sj;
                r = rj;
                slot = lj;
            }
            base = sp - k;
        }
        bool push = false;
        int4 nd = make_int4(0, -1, 0, 0);
        int rank = 0;
#ifdef MG_ROW_WORDS_SPLIT
        unsigned long long c0, c1 = 0, c2 = 0;
#endif
        if (node >= 0 && node < t.n_nodes && r >= 0) {
#ifdef MG_ROW_WORDS_SPLIT
            SPLIT_CLOCK(c0, node);
            ++s_loads;
#endif
            nd = t.nodes[node];
#ifdef MG_ROW_WORDS_SPLIT
            SPLIT_CLOCK(c1, nd.x);
            c1 -= c0;
#endif
            const int64_t wi = (int64_t)nd.x + (r >> 5);
            if (nd.x >= 0 && wi < t.n_words) {
                const int2 wr = t.words[wi];
#ifdef MG_ROW_WORDS_SPLIT
                SPLIT_CLOCK(c2, wr.x);
                c2 -= c0 + c1;
#endif
                const uint32_t w = (uint32_t)wr.x;
                const unsigned b = (unsigned)r & 31u;
                if ((w >> b) & 1u) {
                    if (nd.y >= 0) {
                        if (nd.y < L)
                            atomicOr(&m.acc[slot * Lw + (nd.y >> 5)],
                                     1u << (nd.y & 31));
                    } else if (nd.w > 0) {
                        push = true;
                        rank = wr.y + __popc(w & ((1u << b) - 1u));
                    }
                }
            }
        }
        const unsigned pm = __ballot_sync(FULL, push);
        const int pos = base + __popc(pm & ((1u << lane) - 1u));
        __syncwarp();          // every lane has read the runs it overwrites
        if (push && pos < t.cap) {
            m.sf[pos] = nd.z;
            m.sc[pos] = nd.w << 3 | slot;
            m.sr[pos] = rank;
        }
        sp = min(base + __popc(pm), t.cap);
        __syncwarp();
#ifdef MG_ROW_WORDS_SPLIT
        unsigned long long r1;
        SPLIT_CLOCK(r1, sp);
        s_node += c1;
        s_word += c2;
        s_round += r1 - r0;
        ++s_n;
#endif
    }
#ifdef MG_ROW_WORDS_SPLIT
    for (int d = 16; d > 0; d >>= 1) {
        s_node += __shfl_down_sync(FULL, s_node, d);
        s_word += __shfl_down_sync(FULL, s_word, d);
        s_loads += __shfl_down_sync(FULL, s_loads, d);
    }
    if (lane == 0) {
        atomicAdd(&split_cycles[0], s_node);
        atomicAdd(&split_cycles[1], s_word);
        atomicAdd(&split_cycles[2], s_round);
        atomicAdd(&split_cycles[3], s_n);
        atomicAdd(&split_cycles[4], s_loads);
    }
#endif
}

// id (0 = miss; canon 2: above offset, a reverse-complement hit) -> row,
// -1 for a miss or a row past R
__device__ __forceinline__ int32_t row_of(int32_t id, int32_t offset,
                                          int64_t R) {
    if (offset > 0 && id > offset)
        id -= offset;
    return id > 0 && (int64_t)id - 1 < R ? id - 1 : -1;
}

// W1, and W2's step 1: `slots` windows a warp, their own rows written
// whole into out (ld words apart); with LINKS, their flags.
template <bool DENSE, bool LINKS>
__global__ void own_rows_kernel(Tree t, Walk w,
                                const int32_t *__restrict__ ids, int64_t Q,
                                int32_t offset, int64_t R, int L, int Lw,
                                int slots, uint32_t *__restrict__ out,
                                int64_t ld, uint8_t *__restrict__ flags) {
    extern __shared__ int sm[];
    const int warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Smem m(sm, warp, slots, DENSE ? 0 : Lw, t.cap);
    if (!DENSE) {
        for (int j = lane; j < slots * Lw; j += 32)
            m.acc[j] = 0u;
        __syncwarp();
    }
    // group g holds windows g, g + G, g + 2G, ...: the heavy rows that a
    // read's consecutive windows share spread over the warps
    const int64_t G = (Q + slots - 1) / slots;
    for (int64_t g = (int64_t)blockIdx.x * warps + warp; g < G;
         g += (int64_t)gridDim.x * warps) {
        const int64_t q = g + lane * G;
        const bool mine = lane < slots && q < Q;
        // a walk of no steps (max_depth 0) reads no row
        const int32_t row = mine && (!LINKS || w.max_depth > 0)
                                ? row_of(ids[q], offset, R) : -1;
        if (LINKS && mine) {
            uint8_t f = 0;
            if (row >= 0) {
                const int32_t r1 =
                    q + 1 < Q ? row_of(ids[q + 1], offset, R) : -1;
                f = r1 >= 0 && w.next_row[row] == r1 ? LINK : TAIL;
            }
            flags[q] = f;
        }
        const int n = (int)((Q - 1 - g) / G) + 1;    // windows of group g
        if (DENSE) {
            for (int s = 0; s < n; ++s) {
                const int32_t rs = __shfl_sync(FULL, row, s);
                uint32_t *dst = out + (g + s * G) * ld;
                if (rs >= 0) {
                    const uint32_t *src = w.bitmap + (int64_t)rs * w.stride;
                    for (int j = lane; j < Lw; j += 32)
                        dst[j] = src[j];
                } else {
                    for (int j = lane; j < Lw; j += 32)
                        dst[j] = 0u;
                }
            }
        } else {
            descend(t, row, slots, m, L, Lw, lane);
            __syncwarp();
            for (int s = 0; s < n; ++s) {
                uint32_t *dst = out + (g + s * G) * ld, *a = m.acc + s * Lw;
                for (int j = lane; j < Lw; j += 32) {
                    dst[j] = a[j];
                    a[j] = 0u;
                }
            }
            __syncwarp();
        }
    }
}

// W2's step 2, a thread a window (see the header).
__global__ void plan_kernel(Walk w, const int32_t *__restrict__ ids,
                            int64_t Q, int32_t offset, int64_t R,
                            uint8_t *flags, int2 *__restrict__ list,
                            int64_t list_cap, unsigned long long *count,
                            int32_t *__restrict__ tails,
                            unsigned long long *n_tails) {
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < Q;
         q += (int64_t)gridDim.x * blockDim.x) {
        if (!(flags[q] & TAIL))
            continue;
        tails[atomicAdd(n_tails, 1ull)] = (int32_t)q;
        const int32_t row = row_of(ids[q], offset, R);
        int e = 0;      // the rows past its own that q's walk steps on
        for (int32_t r = row; e < w.max_depth - 1; ++e) {
            const int32_t nx = w.next_row[r];
            if (nx < 0 || nx >= R)
                break;
            r = nx;
        }
        // the windows of q's run whose walk max_depth cuts (only tails
        // write the flags of their runs' windows)
        const int64_t limit = (int64_t)w.max_depth - 1 - e;
        for (int64_t d = 1; d <= q && (flags[q - d] & LINK); ++d)
            if (d > limit)
                flags[q - d] |= SERIAL;
        if (e == 0)
            continue;
        // e slots of the list, or a walk by one warp if they do not fit
        // (the slots taken below list_cap then hold no row)
        const unsigned long long at = atomicAdd(count, (unsigned long long)e);
        if (at + e > (unsigned long long)list_cap) {
            for (unsigned long long i = at; i < (unsigned long long)list_cap;
                 ++i)
                list[i] = make_int2(-1, 0);
            flags[q] |= SERIAL;
            continue;
        }
        int32_t r = row;
        for (int i = 0; i < e; ++i) {
            r = w.next_row[r];
            list[at + i] = make_int2(r, (int)q);
        }
    }
}

// XORs inner row `row` (lane s < slots: slot s's, -1 for none) into row
// `target` of out, a slot at a time.
template <bool DENSE>
__device__ void xor_rows(const Tree &t, const Walk &w, int32_t row,
                         int32_t target, int slots, const Smem &m, int L,
                         int Lw, uint32_t *out, int64_t ld, int lane) {
    if (DENSE) {
        for (int s = 0; s < slots; ++s) {
            const int32_t rs = __shfl_sync(FULL, row, s);
            const int32_t ts = __shfl_sync(FULL, target, s);
            if (rs < 0)
                continue;
            const uint32_t *src = w.bitmap + (int64_t)rs * w.stride;
            uint32_t *dst = out + (int64_t)ts * ld;
            for (int j = lane; j < Lw; j += 32) {
                const uint32_t v = src[j];
                if (v)
                    atomicXor(&dst[j], v);
            }
        }
        return;
    }
    descend(t, row, slots, m, L, Lw, lane);
    __syncwarp();
    for (int s = 0; s < slots; ++s) {
        const int32_t ts = __shfl_sync(FULL, target, s);
        uint32_t *a = m.acc + s * Lw;
        for (int j = lane; j < Lw; j += 32) {
            const uint32_t v = a[j];
            if (v) {
                atomicXor(&out[(int64_t)ts * ld + j], v);
                a[j] = 0u;
            }
        }
    }
    __syncwarp();
}

// W2's step 3: the list's rows, then the serial windows' chains.
template <bool DENSE>
__global__ void chains_kernel(Tree t, Walk w, const int32_t *__restrict__ ids,
                              int64_t Q, int32_t offset, int64_t R, int L,
                              int Lw, int slots, uint32_t *out, int64_t ld,
                              const uint8_t *__restrict__ flags,
                              const int2 *__restrict__ list,
                              int64_t list_cap,
                              const unsigned long long *count) {
    extern __shared__ int sm[];
    const int warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Smem m(sm, warp, slots, DENSE ? 0 : Lw, t.cap);
    if (!DENSE) {
        for (int j = lane; j < slots * Lw; j += 32)
            m.acc[j] = 0u;
        __syncwarp();
    }
    const int64_t gw = (int64_t)blockIdx.x * warps + warp;
    const int64_t nw = (int64_t)gridDim.x * warps;
    const int64_t n = min(*count, (unsigned long long)list_cap);
    const int64_t G = (n + slots - 1) / slots;
    for (int64_t g = gw; g < G; g += nw) {   // entries g, g + G, ...
        int2 it = make_int2(-1, 0);
        if (lane < slots && g + lane * G < n)
            it = list[g + lane * G];
        xor_rows<DENSE>(t, w, it.x, it.y, slots, m, L, Lw, out, ld, lane);
    }
    for (int64_t q = gw; q < Q; q += nw) {
        if (!(flags[q] & SERIAL))
            continue;
        int32_t r = row_of(ids[q], offset, R);
        int left = w.max_depth - 1;
        while (left > 0 && r >= 0) {
            // the next (at most) `slots` rows of q's chain, lane s the s-th
            int32_t row = -1;
            for (int s = 0; s < slots && left > 0 && r >= 0; ++s) {
                const int32_t nx = w.next_row[r];
                r = nx >= 0 && nx < R ? nx : -1;
                if (r >= 0) {
                    --left;
                    if (lane == s)
                        row = r;
                }
            }
            xor_rows<DENSE>(t, w, row, (int32_t)q, slots, m, L, Lw, out, ld,
                            lane);
        }
    }
}

// W2's step 4, a warp a tail and 32 word columns (a column a lane).
__global__ void scan_kernel(const uint8_t *__restrict__ flags,
                            const int32_t *__restrict__ tails,
                            const unsigned long long *n_tails, int Lw,
                            uint32_t *out, int64_t ld) {
    const int warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t chunks = (Lw + 31) / 32;
    const int64_t items = (int64_t)*n_tails * chunks;
    for (int64_t it = (int64_t)blockIdx.x * warps + warp; it < items;
         it += (int64_t)gridDim.x * warps) {
        const int64_t q = tails[it / chunks];
        const int j = (int)(it % chunks) * 32 + lane;
        // n windows before q link into it, none of them serial
        int64_t n = 0;
        for (;;) {
            const int64_t p = q - 1 - n - lane;
            const bool on = p >= 0 && (flags[p] & (LINK | SERIAL)) == LINK;
            const unsigned b = __ballot_sync(FULL, on);
            const int c = b == FULL ? 32 : __ffs(~b) - 1;
            n += c;
            if (c < 32)
                break;
        }
        if (j >= Lw)
            continue;
        uint32_t *col = out + q * ld + j;
        uint32_t acc = col[0];
        int64_t i = 1;
        for (; i + 7 <= n; i += 8) {        // eight loads in flight
            uint32_t v[8];
#pragma unroll
            for (int a = 0; a < 8; ++a)
                v[a] = col[-(i + a) * ld];
#pragma unroll
            for (int a = 0; a < 8; ++a)
                col[-(i + a) * ld] = acc ^= v[a];
        }
        for (; i <= n; ++i)
            col[-i * ld] = acc ^= col[-i * ld];
    }
}

// the kernel's dynamic shared memory and a grid of at most `need` blocks
// that fills the card
cudaError_t plan(const void *fn, int threads, size_t smem, int64_t need,
                 int *grid) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess)
        return err;
    int dev = 0, sms = 0, blocks = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, fn, threads, smem)) != cudaSuccess)
        return err;
    if (blocks < 1)
        return cudaErrorInvalidConfiguration;
    const int64_t full = (int64_t)sms * blocks;
    *grid = (int)(need < full ? need : full);
    return cudaSuccess;
}

template <bool DENSE>
int rowdiff_launch(const Tree &t, const Walk &w, const int32_t *ids,
                   int64_t Q, int32_t offset, int64_t R, int L, int Lw,
                   uint32_t *out, int64_t ld, uint8_t *scratch,
                   int64_t list_cap, int slots, int warps,
                   cudaStream_t st) {
    unsigned long long *count = (unsigned long long *)scratch;
    unsigned long long *n_tails = count + 1;
    int2 *list = (int2 *)(scratch + 16);
    int32_t *tails = (int32_t *)(scratch + 16 + 8 * list_cap);
    uint8_t *flags = scratch + 16 + 8 * list_cap + 4 * Q;
    const int threads = warps * 32;
    const size_t smem =
        DENSE ? 0 : (size_t)warps * (slots * Lw + 3 * (size_t)t.cap) * 4;
    const int64_t per = (int64_t)warps * slots;
    int grid = 0;
    cudaError_t err;
    if ((err = plan((const void *)own_rows_kernel<DENSE, true>, threads,
                    smem, (Q + per - 1) / per, &grid)) != cudaSuccess)
        return (int)err;
    own_rows_kernel<DENSE, true><<<grid, threads, smem, st>>>(
        t, w, ids, Q, offset, R, L, Lw, slots, out, ld, flags);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = cudaMemsetAsync(count, 0, 16, st)) != cudaSuccess ||
        (err = plan((const void *)plan_kernel, 256, 0, (Q + 255) / 256,
                    &grid)) != cudaSuccess)
        return (int)err;
    plan_kernel<<<grid, 256, 0, st>>>(w, ids, Q, offset, R, flags, list,
                                      list_cap, count, tails, n_tails);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = plan((const void *)chains_kernel<DENSE>, threads, smem,
                    INT64_MAX, &grid)) != cudaSuccess)
        return (int)err;
    chains_kernel<DENSE><<<grid, threads, smem, st>>>(
        t, w, ids, Q, offset, R, L, Lw, slots, out, ld, flags, list,
        list_cap, count);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = plan((const void *)scan_kernel, 256, 0, INT64_MAX,
                    &grid)) != cudaSuccess)
        return (int)err;
    scan_kernel<<<grid, 256, 0, st>>>(flags, tails, n_tails, Lw, out, ld);
    return (int)cudaGetLastError();
}

}  // namespace

// W1.  nodes (n_nodes, 4) int32, words (n_words, 2) int32 (FlatBRWT), cap
// stack runs a warp, ids (Q,) int32 -> out (Q, ld) uint32, the first Lw
// words of each row written.  ``slots`` windows a warp, ``warps`` a block;
// the shared memory is warps * (slots * Lw + 3 cap) ints.
extern "C" int mg_brwt_row_words(const void *nodes, int64_t n_nodes,
                                 const void *words, int64_t n_words,
                                 int32_t cap, const void *ids, int64_t Q,
                                 int32_t offset, int64_t R, int32_t L,
                                 int32_t Lw, void *out, int64_t ld,
                                 int32_t slots, int32_t warps,
                                 void *stream) {
    const Tree t{(const int4 *)nodes, n_nodes, (const int2 *)words, n_words,
                 cap};
    const Walk w{nullptr, 0, nullptr, 0};
    const size_t smem = (size_t)warps * (slots * Lw + 3 * (size_t)cap) * 4;
    const int64_t per = (int64_t)warps * slots;
    int grid = 0;
    cudaError_t err = plan((const void *)own_rows_kernel<false, false>,
                           warps * 32, smem, (Q + per - 1) / per, &grid);
    if (err != cudaSuccess)
        return (int)err;
    own_rows_kernel<false, false><<<grid, warps * 32, smem,
                                    (cudaStream_t)stream>>>(
        t, w, (const int32_t *)ids, Q, offset, R, L, Lw, slots,
        (uint32_t *)out, ld, nullptr);
    return (int)cudaGetLastError();
}

// W2.  next_row (R,) int32 (-1: the walk stops after this row), max_depth
// steps at most; the inner rows from the tree (dense 0) or from bitmap
// (dense 1: (R, Lw) uint32, rows ``stride`` words apart) -> out as W1.
// scratch: 16 + 8 list_cap + 5 Q bytes (the list's and the tails'
// counts, the list, the tails, the windows' flags); Q < 2^31.
extern "C" int mg_rowdiff_row_words(const void *nodes, int64_t n_nodes,
                                    const void *words, int64_t n_words,
                                    int32_t cap, const void *bitmap,
                                    int64_t stride, int32_t dense,
                                    const void *next_row, int32_t max_depth,
                                    const void *ids, int64_t Q,
                                    int32_t offset, int64_t R, int32_t L,
                                    int32_t Lw, void *out, int64_t ld,
                                    void *scratch, int64_t list_cap,
                                    int32_t slots, int32_t warps,
                                    void *stream) {
    const Tree t{(const int4 *)nodes, n_nodes, (const int2 *)words, n_words,
                 dense ? 0 : cap};
    const Walk w{(const int32_t *)next_row, max_depth,
                 (const uint32_t *)bitmap, stride};
    const int32_t *id = (const int32_t *)ids;
    uint32_t *o = (uint32_t *)out;
    uint8_t *s = (uint8_t *)scratch;
    cudaStream_t st = (cudaStream_t)stream;
    return dense ? rowdiff_launch<true>(t, w, id, Q, offset, R, L, Lw, o, ld,
                                        s, list_cap, slots, warps, st)
                 : rowdiff_launch<false>(t, w, id, Q, offset, R, L, Lw, o,
                                         ld, s, list_cap, slots, warps, st);
}

#ifdef MG_ROW_WORDS_SPLIT
// The split build's counters (node wait, word wait, round cycles, rounds,
// node loads) into out[5], then zeroed.
extern "C" int mg_row_words_split(unsigned long long *out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, split_cycles,
                                           sizeof(split_cycles));
    if (err != cudaSuccess)
        return (int)err;
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(split_cycles, zero, sizeof(zero));
}
#endif
