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
// One warp a window.  The descent is output-sensitive: it evaluates only
// the children of live nodes, which a dead node's subtree cannot change
// (its bits are all clear), so the result is the XLA program's.  The warp
// keeps a stack of child runs (first child, count, local row) in shared
// memory and, a round at a time, pops from the top as many runs as have at
// most 32 children in all (or 32 children of a larger run), a lane a child.
// Each lane reads its node (16 B) and its word (8 B), tests the bit, ORs
// (W1) or XORs (W2) a live leaf's label into the warp's row of words in
// shared memory, and pushes a live inner node's run.  Pushes keep stack
// order (a ballot), so the stack holds runs of non-decreasing depth from
// the bottom, every run of one depth was pushed by one round, and no depth
// holds more than 32 runs or more runs than the tree has inner nodes
// there: FlatBRWT.stack_cap is that bound.  The row is written whole.
// W2 walks its window's chain: per step one 4-byte read of the successor
// (-1 where the walk stops: an anchor, or no successor) and the inner row,
// a BRWT descent (XOR) or a coalesced read of the dense bitmap's row (each
// lane XORs its own words).
//
// Both fold canon 2's offset (an id above it is a reverse-complement hit
// of base node id - offset) and take row = id - 1; an id of 0, or a row
// past the annotation, is a miss with no labels.  No index that the data
// holds reads outside the arrays: a node's word index past the word array
// or a child past the node table is dead, and a label past L is dropped
// (QueryIndex checks them once, when the index is made).
// What bounds them: dependent loads at random addresses, a node and a word
// a level of the descent (a chain step's successor and row for W2), not
// bytes; the tree's nodes and the upper levels' words stay in L2.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

struct Tree {
    const int4 *nodes;
    int64_t n_nodes;
    const int2 *words;
    int64_t n_words;
    int cap;            // stack runs a warp
};

// Adds (XOR) or sets (OR) the labels of local row ``row`` of the tree's
// root into ``acc``: the warp's row of label words in shared memory.  sf,
// sc and sr are the warp's stack of child runs (first, count, local row).
template <bool XOR>
__device__ void descend(const Tree &t, int32_t row, uint32_t *acc, int L,
                        int *sf, int *sc, int *sr, int lane) {
    if (lane == 0) {           // the root, as the only child of a virtual run
        sf[0] = 0;
        sc[0] = 1;
        sr[0] = row;
    }
    int sp = 1;
    __syncwarp();
    while (sp > 0) {
        // lane j looks at run sp - 1 - j, the top first
        const int e = sp - 1 - lane;
        const int cnt = e >= 0 ? sc[e] : 0;
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, d);
            if (lane >= d)
                incl += v;
        }
        // the top k runs have at most 32 children in all (lanes 0..k-1)
        const int k = __popc(__ballot_sync(FULL, e >= 0 && incl <= 32));
        int node = -1, r = 0, base;
        if (k == 0) {
            // the top run has more than 32 children: take 32 of them
            const int top = sp - 1;
            node = sf[top] + lane;
            r = sr[top];
            __syncwarp();
            if (lane == 0) {
                sf[top] += 32;
                sc[top] -= 32;
            }
            base = sp;
        } else {
            // children in stack order, the lowest popped run's first: run
            // j's children take lanes [total - incl_j, total - incl_j + cnt)
            const int total = __shfl_sync(FULL, incl, k - 1);
            const int f = e >= 0 ? sf[e] : 0, rk = e >= 0 ? sr[e] : 0;
            const int start = total - incl;
            for (int j = 0; j < k; ++j) {
                const int sj = __shfl_sync(FULL, start, j);
                const int cj = __shfl_sync(FULL, cnt, j);
                const int fj = __shfl_sync(FULL, f, j);
                const int rj = __shfl_sync(FULL, rk, j);
                if (lane >= sj && lane < sj + cj) {
                    node = fj + lane - sj;
                    r = rj;
                }
            }
            base = sp - k;
        }
        bool push = false;
        int4 nd = make_int4(0, -1, 0, 0);
        int rank = 0;
        if (node >= 0 && node < t.n_nodes && r >= 0) {
            nd = t.nodes[node];
            const int64_t wi = (int64_t)nd.x + (r >> 5);
            if (nd.x >= 0 && wi < t.n_words) {
                const int2 wr = t.words[wi];
                const uint32_t w = (uint32_t)wr.x;
                const unsigned b = (unsigned)r & 31u;
                if ((w >> b) & 1u) {
                    if (nd.y >= 0) {
                        if (nd.y < L) {
                            const uint32_t bit = 1u << (nd.y & 31);
                            if (XOR)
                                atomicXor(&acc[nd.y >> 5], bit);
                            else
                                atomicOr(&acc[nd.y >> 5], bit);
                        }
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
            sf[pos] = nd.z;
            sc[pos] = nd.w;
            sr[pos] = rank;
        }
        sp = min(base + __popc(pm), t.cap);
        __syncwarp();
    }
}

// id (0 = miss; canon 2: above offset, a reverse-complement hit) -> row,
// -1 for a miss or a row past R
__device__ __forceinline__ int32_t row_of(int32_t id, int32_t offset,
                                          int64_t R) {
    if (offset > 0 && id > offset)
        id -= offset;
    return id > 0 && (int64_t)id - 1 < R ? id - 1 : -1;
}

// the warp's row of Lw words out to row q of out (ld words apart), then
// zeroed for the next window
__device__ __forceinline__ void write_row(uint32_t *acc, uint32_t *out,
                                          int64_t q, int64_t ld, int Lw,
                                          int lane) {
    __syncwarp();
    for (int j = lane; j < Lw; j += 32) {
        out[q * ld + j] = acc[j];
        acc[j] = 0u;
    }
    __syncwarp();
}

__global__ void brwt_words_kernel(Tree t, const int32_t *__restrict__ ids,
                                  int64_t Q, int32_t offset, int64_t R,
                                  int L, int Lw, uint32_t *__restrict__ out,
                                  int64_t ld) {
    extern __shared__ int sm[];
    const int warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int *mine = sm + (size_t)warp * (Lw + 3 * t.cap);
    uint32_t *acc = reinterpret_cast<uint32_t *>(mine);
    int *sf = mine + Lw, *sc = sf + t.cap, *sr = sc + t.cap;
    for (int j = lane; j < Lw; j += 32)
        acc[j] = 0u;
    __syncwarp();
    for (int64_t q = (int64_t)blockIdx.x * warps + warp; q < Q;
         q += (int64_t)gridDim.x * warps) {
        const int32_t row = row_of(ids[q], offset, R);
        if (row >= 0)
            descend<false>(t, row, acc, L, sf, sc, sr, lane);
        write_row(acc, out, q, ld, Lw, lane);
    }
}

template <bool DENSE>
__global__ void rowdiff_words_kernel(Tree t,
                                     const uint32_t *__restrict__ bitmap,
                                     int64_t stride,
                                     const int32_t *__restrict__ next_row,
                                     int max_depth,
                                     const int32_t *__restrict__ ids,
                                     int64_t Q, int32_t offset, int64_t R,
                                     int L, int Lw,
                                     uint32_t *__restrict__ out,
                                     int64_t ld) {
    extern __shared__ int sm[];
    const int warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int *mine = sm + (size_t)warp * (Lw + 3 * t.cap);
    uint32_t *acc = reinterpret_cast<uint32_t *>(mine);
    int *sf = mine + Lw, *sc = sf + t.cap, *sr = sc + t.cap;
    for (int j = lane; j < Lw; j += 32)
        acc[j] = 0u;
    __syncwarp();
    for (int64_t q = (int64_t)blockIdx.x * warps + warp; q < Q;
         q += (int64_t)gridDim.x * warps) {
        int32_t row = row_of(ids[q], offset, R);
        for (int s = 0; s < max_depth && row >= 0; ++s) {
            const int32_t nxt = next_row[row];
            if (DENSE) {
                const uint32_t *src = bitmap + row * stride;
                for (int j = lane; j < Lw; j += 32)
                    acc[j] ^= src[j];
            } else {
                descend<true>(t, row, acc, L, sf, sc, sr, lane);
            }
            row = nxt >= 0 && nxt < R ? nxt : -1;
        }
        write_row(acc, out, q, ld, Lw, lane);
    }
}

// the kernel's dynamic shared memory and a grid that fills the card
cudaError_t plan(const void *fn, int threads, size_t smem, int64_t Q,
                 int warps, int *grid) {
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
    const int64_t need = (Q + warps - 1) / warps;
    const int64_t full = (int64_t)sms * blocks;
    *grid = (int)(need < full ? need : full);
    return cudaSuccess;
}

}  // namespace

// W1.  nodes (n_nodes, 4) int32, words (n_words, 2) int32 (FlatBRWT), cap
// stack runs a warp, ids (Q,) int32 -> out (Q, ld) uint32, the first Lw
// words of each row written.  ``warps`` a block; the shared memory is
// warps * (Lw + 3 cap) ints.
extern "C" int mg_brwt_row_words(const void *nodes, int64_t n_nodes,
                                 const void *words, int64_t n_words,
                                 int32_t cap, const void *ids, int64_t Q,
                                 int32_t offset, int64_t R, int32_t L,
                                 int32_t Lw, void *out, int64_t ld,
                                 int32_t warps, void *stream) {
    const Tree t{(const int4 *)nodes, n_nodes, (const int2 *)words, n_words,
                 cap};
    const size_t smem = (size_t)warps * (Lw + 3 * (size_t)cap) * 4;
    int grid = 0;
    cudaError_t err = plan((const void *)brwt_words_kernel, warps * 32, smem,
                           Q, warps, &grid);
    if (err != cudaSuccess)
        return (int)err;
    brwt_words_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
        t, (const int32_t *)ids, Q, offset, R, L, Lw, (uint32_t *)out, ld);
    return (int)cudaGetLastError();
}

// W2.  next_row (R,) int32 (-1: the walk stops after this row), max_depth
// steps at most; the inner rows from the tree (dense 0) or from bitmap
// (dense 1: (R, Lw) uint32, rows ``stride`` words apart) -> out as W1.
extern "C" int mg_rowdiff_row_words(const void *nodes, int64_t n_nodes,
                                    const void *words, int64_t n_words,
                                    int32_t cap, const void *bitmap,
                                    int64_t stride, int32_t dense,
                                    const void *next_row, int32_t max_depth,
                                    const void *ids, int64_t Q,
                                    int32_t offset, int64_t R, int32_t L,
                                    int32_t Lw, void *out, int64_t ld,
                                    int32_t warps, void *stream) {
    const Tree t{(const int4 *)nodes, n_nodes, (const int2 *)words, n_words,
                 dense ? 0 : cap};
    const size_t smem = (size_t)warps * (Lw + 3 * (size_t)t.cap) * 4;
    const void *fn = dense ? (const void *)rowdiff_words_kernel<true>
                           : (const void *)rowdiff_words_kernel<false>;
    int grid = 0;
    cudaError_t err = plan(fn, warps * 32, smem, Q, warps, &grid);
    if (err != cudaSuccess)
        return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t *b = (const uint32_t *)bitmap;
    const int32_t *nx = (const int32_t *)next_row, *id = (const int32_t *)ids;
    uint32_t *o = (uint32_t *)out;
    if (dense)
        rowdiff_words_kernel<true><<<grid, warps * 32, smem, st>>>(
            t, b, stride, nx, max_depth, id, Q, offset, R, L, Lw, o, ld);
    else
        rowdiff_words_kernel<false><<<grid, warps * 32, smem, st>>>(
            t, b, stride, nx, max_depth, id, Q, offset, R, L, Lw, o, ld);
    return (int)cudaGetLastError();
}
