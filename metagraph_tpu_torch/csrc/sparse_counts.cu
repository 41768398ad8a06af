// Kernels S1 and S2 of the annotated batch query on a block-sparse
// annotation: per-sequence label counts from the (R+1, tau) label-id table
// and the deduplicated overflow patterns.
//
// Replace metagraph_tpu/annotation/sparse_device.py::sparse_count_epoch
// (:268-307), an XLA program: a gather of tau label ids a window and a
// scalar segment sum into (S, L+1) counts, a second segment sum of the
// windows whose row has an overflow pattern into (S, Rd) multiplicities,
// and an f32 dot_general of those with the (Rd, L) int8 patterns.  The f32
// product rounds past 2^24 (and a TF32 one past 2^11); here every sum is an
// int32 add, exact up to 2^31 - 1.
//
// S1 (sparse_label_counts), one thread a window over a grid-stride loop.
// The ids arrive tiled, (N, T) with T % 32 == 0, and every tile belongs to
// one sequence (tile_seq), so a warp's 32 windows share a sequence.  Each
// window folds canon 2's offset (ids above it are reverse-complement hits
// of node id - offset), reads its row's tau label ids (the sentinel L marks
// an empty slot; row 0 is the miss row) and its pattern slot dmap[id].
// An id past the table counts as a miss, and a sequence outside this
// call's rows, a label id past L or a slot past P is dropped, as the XLA
// program's segment sums drop out-of-range segments: no index that the
// data holds writes outside counts, present or mult.  (QueryIndex checks
// entries and dmap once, when the index is made.)
// The lanes that hold the same label (or pattern) add once:
// __match_any_sync, and the leader adds the popcount with one global
// atomic.  A read's windows mostly share their labels, and a long
// sequence's windows its pattern, so the atomics fall by up to 32x.
// What bounds it: the random row reads (tau * 4 + 4 bytes a window) and
// the global atomics; the block does not yet sum its tile in shared memory
// before its global adds.
//
// S2 (overflow_counts): counts[seq_lo + s, l] += sum_d mult[s, d] *
// dense8[d, l] over the non-zero multiplicities only.  One block a
// sequence row at a time: it gathers the row's non-zero (d, m) pairs into
// shared memory, then each thread adds m * dense8[d, l] to its own columns
// l, so no two threads write one count and no atomics are needed.  Bound:
// the multiplicities read once, and each non-zero pair's pattern row and
// its sequence's counts row.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sparse_label_counts_kernel(const int32_t *__restrict__ nodes,
                           int64_t n_windows, int T,
                           const int32_t *__restrict__ tile_seq,
                           const uint32_t *__restrict__ entries,
                           int64_t n_entries, int tau,
                           const int32_t *__restrict__ dmap,
                           int32_t *__restrict__ counts, int L,
                           int32_t *__restrict__ present,
                           int32_t *__restrict__ mult, int P, int seq_lo,
                           int seq_hi, int offset) {
    const unsigned lane = threadIdx.x & 31;
    // n_windows and blockDim.x are multiples of 32: whole warps iterate
    // together, so the warp-wide votes below see every lane
    for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         w < n_windows; w += (int64_t)gridDim.x * blockDim.x) {
        int id = nodes[w];
        if (offset > 0 && id > offset)
            id -= offset;
        if (id < 0 || id >= n_entries)
            id = 0;
        // a warp's windows lie in one tile: the whole warp skips together
        const int seq = tile_seq[w / T];
        if (seq < seq_lo || seq >= seq_hi)
            continue;
        const unsigned hits = __ballot_sync(FULL, id > 0);
        if (lane == 0 && hits)
            atomicAdd(present + seq, __popc(hits));
        const uint32_t *row = entries + (int64_t)id * tau;
        int32_t *crow = counts + (int64_t)seq * L;
        for (int j = 0; j < tau; ++j) {
            const uint32_t lab = row[j];
            const unsigned same = __match_any_sync(FULL, lab);
            if (lab < (uint32_t)L && (int)lane == __ffs(same) - 1)
                atomicAdd(crow + lab, __popc(same));
        }
        const int d = dmap[id];
        const unsigned same = __match_any_sync(FULL, d);
        if (d > 0 && d < P && (int)lane == __ffs(same) - 1)
            atomicAdd(mult + (int64_t)(seq - seq_lo) * P + d, __popc(same));
    }
}

__global__ void __launch_bounds__(THREADS)
overflow_counts_kernel(int32_t *__restrict__ counts, int L,
                       const int32_t *__restrict__ mult, int64_t n_rows,
                       int P, const int8_t *__restrict__ dense8,
                       int64_t seq_lo) {
    __shared__ int s_d[THREADS];
    __shared__ int s_m[THREADS];
    __shared__ int s_n;
    for (int64_t s = blockIdx.x; s < n_rows; s += gridDim.x) {
        const int32_t *mrow = mult + s * P;
        int32_t *crow = counts + (seq_lo + s) * L;
        // pattern 0 is the all-zero row of the sparse rows
        for (int base = 1; base < P; base += THREADS) {
            if (threadIdx.x == 0)
                s_n = 0;
            __syncthreads();
            const int d = base + threadIdx.x;
            if (d < P) {
                const int m = mrow[d];
                if (m) {
                    const int at = atomicAdd(&s_n, 1);
                    s_d[at] = d;
                    s_m[at] = m;
                }
            }
            __syncthreads();
            const int n = s_n;
            for (int j = 0; j < n; ++j) {
                const int8_t *prow = dense8 + (int64_t)s_d[j] * L;
                const int m = s_m[j];
                for (int l = threadIdx.x; l < L; l += THREADS)
                    crow[l] += m * (int)prow[l];
            }
            __syncthreads();
        }
    }
}

}  // namespace

// S1.  nodes (n_windows / T, T) int32 ids (0 = miss), tile_seq (n_tiles,)
// int32, entries (n_entries = R+1, tau) uint32 label ids (L = empty slot),
// dmap (R+1,) int32 pattern slots; adds into counts (S, L), present (S,)
// and mult (seq_hi - seq_lo, P) at row seq - seq_lo, all int32, for the
// sequences in [seq_lo, seq_hi).  The wrapper checks the shapes, T % 32
// == 0 and seq_hi <= S.
extern "C" int mg_sparse_label_counts(const void *nodes, int64_t n_windows,
                                      int32_t T, const void *tile_seq,
                                      const void *entries, int64_t n_entries,
                                      int32_t tau, const void *dmap,
                                      void *counts, int32_t L, void *present,
                                      void *mult, int32_t P, int32_t seq_lo,
                                      int32_t seq_hi, int32_t offset,
                                      int32_t grid, void *stream) {
    sparse_label_counts_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t *)nodes, n_windows, T, (const int32_t *)tile_seq,
        (const uint32_t *)entries, n_entries, tau, (const int32_t *)dmap,
        (int32_t *)counts, L, (int32_t *)present, (int32_t *)mult, P, seq_lo,
        seq_hi, offset);
    return (int)cudaGetLastError();
}

// S2.  counts (S, L) int32, mult (n_rows, P) int32, dense8 (P, L) int8:
// counts[seq_lo + s, :] += sum_d mult[s, d] * dense8[d, :], in place.
extern "C" int mg_overflow_counts(void *counts, int32_t L, const void *mult,
                                  int64_t n_rows, int32_t P,
                                  const void *dense8, int64_t seq_lo,
                                  int32_t grid, void *stream) {
    overflow_counts_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t *)counts, L, (const int32_t *)mult, n_rows, P,
        (const int8_t *)dense8, seq_lo);
    return (int)cudaGetLastError();
}
