// Kernel D4 of the device construction: the BOSS rows from the sorted
// edge stream.
//
// Replaces metagraph_tpu/succinct/device_build.py::_build_p2 :253-309
// (construct.emit_boss semantics; ref boss_chunk.cpp:33-133):
//
// * mg_emit_keys: each unique wire key becomes its 3-bit key
//   (_key3_from_key2, :136): the edge label (character K-1) at bits 0..2
//   and character j <= K-2 at bits 3(j+1), codes $=0, A..T=1..4, so that
//   integer order is BOSS order; a row that is not unique becomes the
//   sentinel 2^3K - 1, which no key equals (a code never reaches 7) and
//   every key sorts before.  The caller appends the host's dummy rows and
//   sorts the stream with D2; its first M rows are the real ones.
// * mg_build_emit, on the M sorted rows: node_last = bits 3(K-1)..,
//   first_char = bits 3..5, the node = the key >> 3; same_node_next, keep
//   (a $-labelled row whose node ends in a real character and goes on in
//   the next row is dropped), last = !same_node_next, the minus flag, W =
//   label (+ alph_size if minus), valid = a real label and first
//   character; F[c] = the kept rows whose node_last < c; the kept rows'
//   W, last and valid written in stream order behind the zero row 0.
//
// The minus flag needs no sort here.  The TPU sorted the stream stably by
// label and compared adjacent targets (:285-298).  Two rows with one
// label have one target node exactly when their keys agree above bit 5
// (characters 1..K-2), and rows that agree there are adjacent in the
// sorted stream, at most 25 of them (5 first characters x 5 labels).  So a
// row is a non-first incoming edge iff an earlier row of its group holds
// its label: a scan back over at most 24 rows.  The kept rows' partition
// (:310) becomes a count, an exclusive scan (block_scan.cuh) and a write.
//
// What bounds it on an H100: bytes: 8 a row read (its neighbours come from
// L1) and 3 written a kept row.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int ROWS = 4;                       // rows a thread
constexpr int TILE = THREADS * ROWS;          // rows a block

__global__ void __launch_bounds__(THREADS)
emit_keys_kernel(const long long *__restrict__ s,
                 const uint8_t *__restrict__ uniq, int64_t n, int K,
                 long long *__restrict__ k3) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    if (!uniq[i]) {
        k3[i] = (1ll << (3 * K)) - 1;
        return;
    }
    const long long k = __ldg(s + i);
    long long out = (((k >> (2 * (K - 1))) & 3) + 1);   // the label
    for (int j = 0; j < K - 1; ++j)
        out |= (((k >> (2 * j)) & 3) + 1) << (3 * (j + 1));
    k3[i] = out;
}

struct Row {
    bool keep;
    int node_last;
    uint8_t w, last, valid;
};

__device__ __forceinline__ Row row_of(const long long *__restrict__ S,
                                      int64_t i, int64_t M, int K,
                                      int alph, bool flags) {
    Row r;
    const long long s = __ldg(S + i);
    const int label = (int)(s & 7);
    r.node_last = (int)((s >> (3 * (K - 1))) & 7);
    const bool same_next = i + 1 < M && (__ldg(S + i + 1) >> 3) == (s >> 3);
    r.keep = !(same_next && label == 0 && r.node_last > 0);
    r.w = r.last = r.valid = 0;
    if (!flags) return r;
    bool minus = false;
    if (label > 0 && label < alph) {
        const long long g = s >> 6;
        for (int64_t j = i - 1; j >= 0; --j) {
            const long long t = __ldg(S + j);
            if ((t >> 6) != g) break;
            if ((int)(t & 7) == label) {
                minus = true;
                break;
            }
        }
    }
    const int first = (int)((s >> 3) & 7);
    r.w = (uint8_t)(label + (minus ? alph : 0));
    r.last = !same_next;
    r.valid = label > 0 && label < alph && first > 0;
    return r;
}

// Kept rows a block -> counts[b]; F[c] += the block's kept rows with
// node_last < c.
__global__ void __launch_bounds__(THREADS)
emit_count(const long long *__restrict__ S, int64_t M, int K, int alph,
           uint32_t *__restrict__ counts, u64 *__restrict__ F) {
    __shared__ unsigned hist[8];
    if (threadIdx.x < 8) hist[threadIdx.x] = 0;
    __syncthreads();
    unsigned kept = 0;
    for (int r = 0; r < ROWS; ++r) {
        const int64_t i = (int64_t)blockIdx.x * TILE + r * THREADS
                          + threadIdx.x;
        if (i >= M) break;
        const Row row = row_of(S, i, M, K, alph, false);
        if (row.keep) {
            ++kept;
            atomicAdd(hist + row.node_last, 1u);
        }
    }
    // the block's kept count (its rows' order does not matter here)
    unsigned total = kept;
#pragma unroll
    for (int d = 16; d; d >>= 1) total += __shfl_xor_sync(FULL, total, d);
    __shared__ unsigned warp_kept[THREADS / 32];
    if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned t = 0;
        for (int w = 0; w < THREADS / 32; ++w) t += warp_kept[w];
        counts[blockIdx.x] = t;
        unsigned below = 0;
        for (int c = 1; c < alph; ++c) {
            below += hist[c - 1];
            if (below) atomicAdd(F + c, (u64)below);
        }
    }
}

// The kept rows' W, last, valid at 1 + their offset; *kept = the total.
__global__ void __launch_bounds__(THREADS)
emit_write(const long long *__restrict__ S, int64_t M, int K, int alph,
           const uint32_t *__restrict__ offsets, uint8_t *__restrict__ W,
           uint8_t *__restrict__ last, uint8_t *__restrict__ valid,
           u64 *__restrict__ kept_total, int64_t nb) {
    uint32_t run = offsets[blockIdx.x];
    for (int r = 0; r < ROWS; ++r) {
        const int64_t i = (int64_t)blockIdx.x * TILE + r * THREADS
                          + threadIdx.x;
        Row row{};
        if (i < M) row = row_of(S, i, M, K, alph, true);
        uint32_t total;
        const uint32_t pos = run + mg_scan::block_exclusive(
            i < M && row.keep ? 1u : 0u, &total);
        if (i < M && row.keep) {
            W[1 + pos] = row.w;
            last[1 + pos] = row.last;
            valid[1 + pos] = row.valid;
        }
        run += total;
    }
    if (blockIdx.x == nb - 1 && threadIdx.x == 0) *kept_total = run;
}

}  // namespace

extern "C" {

// n sorted wire keys and their uniq flags -> k3[0..n) 3-bit keys.
int mg_emit_keys(const void *s, const void *uniq, int64_t n, int K, void *k3,
                 void *stream) {
    if (n <= 0) return 0;
    emit_keys_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const long long *)s, (const uint8_t *)uniq, n, K, (long long *)k3);
    return (int)cudaGetLastError();
}

// Scratch for M rows: counts ceil(M / 1024) uint32, sums
// ceil(that / 4096) uint32.
int64_t mg_emit_counts(int64_t M) { return (M + TILE - 1) / TILE; }

int64_t mg_emit_sums(int64_t M) {
    return mg_scan::scan_chunks(mg_emit_counts(M));
}

// M sorted rows (M < 2^31) -> W, last, valid (M + 1 uint8 each; row 0 and
// the rows past 1 + kept are left as they are), F (alph int64) and *kept
// (int64), both zeroed by the caller.  Five launches.
int mg_build_emit(const void *S, int64_t M, int K, int alph, void *W,
                  void *last, void *valid, void *F, void *kept,
                  void *counts, void *sums, void *stream) {
    if (M <= 0) return 0;
    if (M >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t nb = mg_emit_counts(M);
    auto *c = (uint32_t *)counts;
    emit_count<<<(unsigned)nb, THREADS, 0, st>>>((const long long *)S, M, K,
                                                 alph, c, (u64 *)F);
    cudaError_t err = cudaGetLastError();
    if (err) return (int)err;
    if ((err = mg_scan::exclusive_scan(c, nb, (uint32_t *)sums, st)))
        return (int)err;
    emit_write<<<(unsigned)nb, THREADS, 0, st>>>(
        (const long long *)S, M, K, alph, c, (uint8_t *)W, (uint8_t *)last,
        (uint8_t *)valid, (u64 *)kept, nb);
    return (int)cudaGetLastError();
}

}  // extern "C"
