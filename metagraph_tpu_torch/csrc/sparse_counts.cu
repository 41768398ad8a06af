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
// S1 (sparse_label_counts).  The ids arrive tiled, (N, T) with T % 32 ==
// 0, and every tile belongs to one sequence (tile_seq).  Each window folds
// canon 2's offset (ids above it are reverse-complement hits of node id -
// offset) and reads its row's record: tau label ids (the sentinel L marks
// an empty slot; row 0 is the miss row), then its pattern slot, in W = 8
// ceil((tau + 1) / 8) words (sparse_device.py::row_records), so that for
// tau <= 7 a window reads one 32 B sector where the ids and the slot apart
// took two.  An id past the table counts as a miss, and a sequence outside
// this call's rows, a label id past L or a slot past P is dropped, as the
// XLA program's segment sums drop out-of-range segments: no index that the
// data holds writes outside counts, present or mult.  (QueryIndex checks
// the label ids and slots once, when the index is made.)
// A persistent grid; block b walks the contiguous tiles [N b / grid,
// N (b+1) / grid) in steps of min(T, 256) windows, a window a thread, the
// next step's ids loaded a step ahead.  It tallies in shared memory the
// keys of the sequence it is on: label l is key l, pattern d is key L + d,
// and present is one counter (a ballot a warp).  When the sequence
// changes, or at its range's end, the block flushes: one global atomic add
// for each distinct key and one for present, so a read's tile adds each of
// its labels once and a long sequence's run of tiles adds its pattern once
// a block.  A warp whose 32 windows share a pattern (a long sequence's)
// tallies it once.  Two forms of the tally, chosen by the wrapper from L +
// P (sparse_device.py::label_count_plan):
// * dense, L + P <= 8,192 bins: counts indexed by key;
// * hashed, past that: an open-addressed (key, count) table of C slots.
//   The block flushes before a step of its windows could take the table
//   past 3/4 full (each window brings at most tau + 1 keys), so a key
//   always finds a slot and no label is dropped.
// Either form lists the slots that went from 0 to non-zero, so a flush
// costs its distinct keys, not the table.
// What bounds it: device-memory traffic at random addresses, not bytes.
// Each hit window reads its record's sector, and each distinct (sequence,
// label) a flush adds is a read-modify-write of a counts sector that is
// not in L2 (the caller has just zeroed the S x L x 4 byte matrix, far
// larger than L2).  On the many-labels deployment these are about 17 M
// records at random rows and 15 M counts sectors, each a 64 B burst of
// device memory (PERF.md, section 6).
//
// S2 (overflow_counts): counts[seq_lo + s, l] += sum_d mult[s, d] *
// dense8[d, l] over the non-zero multiplicities only.  Each warp owns a
// contiguous run of sequence rows and scans their multiplicities as one
// flat stream, 4 x 32 ints in flight a warp, with a ballot of the
// non-zero ones: a row without multiplicities costs its share of that
// stream and nothing else (no barrier, no shared memory).  For each
// non-zero (s, d, m) the warp adds m * dense8[d, :] into counts row s, 16
// labels a lane a step (16-byte pattern loads and 16-byte counts
// read-modify-writes when L % 16 == 0 and both bases are aligned).  The
// warp owns its rows: no atomics.  Bound: the multiplicities read once, and
// each non-zero pair's pattern row and counts row (read and written).
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t NONE = 0xFFFFFFFFu;   // an empty hash slot; no key
constexpr int S1_THREADS = 256;
constexpr int S2_THREADS = 256;

// The block's tally: cnt (slots), keys (hashed only: slots), and the list
// of slots that went from 0 to non-zero since the last flush.
struct Tally {
    uint32_t *cnt;
    uint32_t *keys;
    uint16_t *list;
    int *len;
    int *present;
    uint32_t mask;      // hashed: slots - 1
    int shift;          // hashed: 32 - log2(slots)
};

template <bool HASHED>
__device__ __forceinline__ void tally(const Tally &t, uint32_t key,
                                      uint32_t add) {
    uint32_t slot = key;
    if (HASHED) {
        slot = (key * 2654435769u) >> t.shift;
        for (;;) {
            uint32_t k = ((volatile uint32_t *)t.keys)[slot];
            if (k == NONE) {
                k = atomicCAS(t.keys + slot, NONE, key);
                if (k == NONE) {
                    t.list[atomicAdd(t.len, 1)] = (uint16_t)slot;
                    break;
                }
            }
            if (k == key)
                break;
            slot = (slot + 1) & t.mask;
        }
        atomicAdd(t.cnt + slot, add);
    } else if (atomicAdd(t.cnt + slot, add) == 0) {
        t.list[atomicAdd(t.len, 1)] = (uint16_t)slot;
    }
}

// Every key tallied for sequence seq -> one global add each; the tally is
// left empty.  Called by the whole block.
template <bool HASHED>
__device__ void flush(const Tally &t, int seq, int32_t *__restrict__ counts,
                      int L, int32_t *__restrict__ present,
                      int32_t *__restrict__ mult, int P, int seq_lo) {
    __syncthreads();
    const int n = *t.len;
    const int pres = *t.present;
    __syncthreads();
    if (threadIdx.x == 0) {
        *t.len = 0;
        *t.present = 0;
        if (pres)
            atomicAdd(present + seq, pres);
    }
    int32_t *crow = counts + (int64_t)seq * L;
    int32_t *mrow = mult + (int64_t)(seq - seq_lo) * P;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint32_t slot = t.list[i];
        const uint32_t key = HASHED ? t.keys[slot] : slot;
        const int c = (int)t.cnt[slot];
        t.cnt[slot] = 0;
        if (HASHED)
            t.keys[slot] = NONE;
        atomicAdd(key < (uint32_t)L ? crow + key : mrow + (key - L), c);
    }
    __syncthreads();
}

// Tally one record word: k < tau a label id, k == tau the pattern slot.
template <bool HASHED>
__device__ __forceinline__ void take(const Tally &t, uint32_t word, int k,
                                     int tau, int L, uint32_t &d) {
    if (k < tau) {
        if (word < (uint32_t)L)
            tally<HASHED>(t, word, 1);
    } else if (k == tau) {
        d = word;
    }
}

template <bool HASHED>
__global__ void __launch_bounds__(S1_THREADS)
sparse_label_counts_kernel(const int32_t *__restrict__ nodes,
                           int64_t n_tiles, int T,
                           const int32_t *__restrict__ tile_seq,
                           const uint32_t *__restrict__ rec,
                           int64_t n_entries, int W, int tau,
                           int32_t *__restrict__ counts, int L,
                           int32_t *__restrict__ present,
                           int32_t *__restrict__ mult, int P, int seq_lo,
                           int seq_hi, int offset, int slots, int step_keys) {
    extern __shared__ uint32_t smem[];
    __shared__ int s_len, s_present;
    Tally t;
    t.cnt = smem;
    t.keys = HASHED ? smem + slots : nullptr;
    t.list = reinterpret_cast<uint16_t *>(smem + (HASHED ? 2 : 1) * slots);
    t.len = &s_len;
    t.present = &s_present;
    t.mask = (uint32_t)slots - 1;
    t.shift = 32 - __ffs(slots) + 1;
    for (int i = threadIdx.x; i < slots; i += blockDim.x) {
        t.cnt[i] = 0;
        if (HASHED)
            t.keys[i] = NONE;
    }
    if (threadIdx.x == 0)
        s_len = s_present = 0;
    __syncthreads();

    const unsigned lane = threadIdx.x & 31;
    // hashed: flush before a step could take the table past 3/4 full
    const int limit = slots / 4 * 3;
    const int64_t t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
    // steps of blockDim.x windows, (tile, base); the next step's id and
    // owner are loaded a step ahead
    int64_t tile = n_tiles * blockIdx.x / gridDim.x;
    int base = 0;
    int next = tile < t1 && (int)threadIdx.x < T
                   ? __ldg(nodes + tile * T + threadIdx.x) : 0;
    int next_seq = tile < t1 ? __ldg(tile_seq + tile) : 0;
    int cur = 0, used = 0;
    bool live = false;                  // cur is in range and tallied
    while (tile < t1) {
        int id = next;
        const int seq = next_seq;
        if (offset > 0 && id > offset)
            id -= offset;
        if (id < 0 || id >= n_entries)
            id = 0;
        // the record's first 8 words (W >= 8): labels, then the slot
        const uint32_t *row = rec + (int64_t)id * W;
        const uint4 a = __ldg(reinterpret_cast<const uint4 *>(row));
        const uint4 b = __ldg(reinterpret_cast<const uint4 *>(row + 4));
        const int at = base;                  // this step's first window
        const int w = at + threadIdx.x;
        base += blockDim.x;
        if (base >= T) {
            base = 0;
            ++tile;
        }
        if (tile < t1) {
            next = base + (int)threadIdx.x < T
                       ? __ldg(nodes + tile * T + base + threadIdx.x) : 0;
            next_seq = __ldg(tile_seq + tile);
        }
        if (at == 0 && (!live || seq != cur)) {
            if (live)
                flush<HASHED>(t, cur, counts, L, present, mult, P, seq_lo);
            used = 0;
            cur = seq;
            live = seq >= seq_lo && seq < seq_hi;
        }
        if (!live)
            continue;
        if (HASHED) {
            if (used + step_keys > limit) {
                flush<HASHED>(t, cur, counts, L, present, mult, P, seq_lo);
                used = 0;
            }
            used += step_keys;
        }
        // blockDim.x and T are multiples of 32: a warp is active or idle
        // as a whole in every step, so the warp votes see every lane
        if (w >= T)
            continue;
        uint32_t d = 0;
        take<HASHED>(t, a.x, 0, tau, L, d);
        take<HASHED>(t, a.y, 1, tau, L, d);
        take<HASHED>(t, a.z, 2, tau, L, d);
        take<HASHED>(t, a.w, 3, tau, L, d);
        take<HASHED>(t, b.x, 4, tau, L, d);
        take<HASHED>(t, b.y, 5, tau, L, d);
        take<HASHED>(t, b.z, 6, tau, L, d);
        take<HASHED>(t, b.w, 7, tau, L, d);
        for (int j = 8; j <= tau; j += 4) {
            const uint4 v = __ldg(reinterpret_cast<const uint4 *>(row + j));
            take<HASHED>(t, v.x, j, tau, L, d);
            take<HASHED>(t, v.y, j + 1, tau, L, d);
            take<HASHED>(t, v.z, j + 2, tau, L, d);
            take<HASHED>(t, v.w, j + 3, tau, L, d);
        }
        const uint32_t pkey = (int)d > 0 && (int)d < P ? (uint32_t)L + d
                                                       : NONE;
        const uint32_t first = __shfl_sync(FULL, pkey, 0);
        if (__all_sync(FULL, pkey == first)) {
            if (lane == 0 && first != NONE)
                tally<HASHED>(t, first, 32);
        } else if (pkey != NONE) {
            tally<HASHED>(t, pkey, 1);
        }
        const unsigned hits = __ballot_sync(FULL, id > 0);
        if (lane == 0 && hits)
            atomicAdd(&s_present, __popc(hits));
    }
    if (live)
        flush<HASHED>(t, cur, counts, L, present, mult, P, seq_lo);
}

// a lane's 16 labels of the counts row += m * the 16 int8 of the pattern
__device__ __forceinline__ void add16(int32_t *c, uint4 p, int m) {
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        int4 *at = reinterpret_cast<int4 *>(c + 4 * k);
        int4 v = *at;
        v.x += m * ((int32_t)(w[k] << 24) >> 24);
        v.y += m * ((int32_t)(w[k] << 16) >> 24);
        v.z += m * ((int32_t)(w[k] << 8) >> 24);
        v.w += m * ((int32_t)w[k] >> 24);
        *at = v;
    }
}

__global__ void __launch_bounds__(S2_THREADS)
overflow_counts_kernel(int32_t *__restrict__ counts, int L,
                       const int32_t *__restrict__ mult, int64_t n_rows,
                       int P, const int8_t *__restrict__ dense8,
                       int64_t seq_lo, int vec) {
    constexpr int AHEAD = 4;            // 32-int chunks a warp loads at once
    const int lane = threadIdx.x & 31;
    const int64_t warps = (int64_t)gridDim.x * (blockDim.x / 32);
    const int64_t warp =
        ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    // the warp's rows, as one flat run of mult: no other warp writes them
    const int64_t f1 = n_rows * (warp + 1) / warps * P;
    for (int64_t f = n_rows * warp / warps * P; f < f1; f += 32 * AHEAD) {
        int m[AHEAD];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
            const int64_t at = f + 32 * u + lane;
            m[u] = at < f1 ? __ldcs(mult + at) : 0;
        }
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
            // column 0 is pattern 0, the all-zero row: adding it is a no-op
            for (unsigned nz = __ballot_sync(FULL, m[u] != 0); nz;
                 nz &= nz - 1) {
                const int src = __ffs(nz) - 1;
                const int mm = __shfl_sync(FULL, m[u], src);
                const int64_t at = f + 32 * u + src;
                const int64_t s = at / P;
                const int8_t *prow = dense8 + (at - s * P) * L;
                int32_t *crow = counts + (seq_lo + s) * L;
                if (vec) {
#pragma unroll 4
                    for (int l = 16 * lane; l < L; l += 512)
                        add16(crow + l, __ldg(reinterpret_cast<const uint4 *>(
                                            prow + l)), mm);
                } else {
                    for (int l = lane; l < L; l += 32)
                        crow[l] += mm * (int)prow[l];
                }
            }
        }
    }
}

const void *s1_kernel(int hashed) {
    return hashed ? (const void *)sparse_label_counts_kernel<true>
                  : (const void *)sparse_label_counts_kernel<false>;
}

cudaError_t prepare(const void *fn, int smem) {
    if (smem > 48 * 1024)
        return cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return cudaSuccess;
}

}  // namespace

// Blocks of S1 (hashed or dense, `threads` a block, `smem` bytes of
// dynamic shared memory) resident on one SM -> *blocks.
extern "C" int mg_sparse_label_counts_occupancy(int32_t hashed,
                                                int32_t threads,
                                                int32_t smem,
                                                int32_t *blocks) {
    const void *fn = s1_kernel(hashed);
    cudaError_t err = prepare(fn, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            threads, smem);
    return (int)err;
}

// S1.  nodes (n_tiles, T) int32 ids (0 = miss), tile_seq (n_tiles,) int32,
// rec (n_entries = R+1, W) uint32 row records (W a multiple of 8 >= tau +
// 1, 32-byte aligned): tau label ids (L = empty slot), then the pattern
// slot; adds into counts (S, L), present (S,) and mult (seq_hi - seq_lo, P)
// at row seq - seq_lo, all int32, for the sequences in [seq_lo, seq_hi).
// The wrapper checks the shapes, T % 32 == 0 and seq_hi <= S, and plans
// (label_count_plan) hashed, slots (a power of two when hashed, else L +
// P), step_keys, threads (a multiple of 32), smem and grid.
extern "C" int mg_sparse_label_counts(
        const void *nodes, int64_t n_tiles, int32_t T, const void *tile_seq,
        const void *rec, int64_t n_entries, int32_t W, int32_t tau,
        void *counts, int32_t L, void *present, void *mult, int32_t P,
        int32_t seq_lo, int32_t seq_hi, int32_t offset, int32_t hashed,
        int32_t slots, int32_t step_keys, int32_t threads, int32_t smem,
        int32_t grid, void *stream) {
    const void *fn = s1_kernel(hashed);
    cudaError_t err = prepare(fn, smem);
    if (err != cudaSuccess)
        return (int)err;
    void *args[] = {&nodes, &n_tiles, &T, &tile_seq, &rec, &n_entries, &W,
                    &tau, &counts, &L, &present, &mult, &P, &seq_lo, &seq_hi,
                    &offset, &slots, &step_keys};
    err = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3((unsigned)threads),
                           args, (size_t)smem, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// S2.  counts (S, L) int32, mult (n_rows, P) int32, dense8 (P, L) int8:
// counts[seq_lo + s, :] += sum_d mult[s, d] * dense8[d, :], in place.
// vec (16-byte loads) needs L % 16 == 0 and 16-byte aligned counts and
// dense8.
extern "C" int mg_overflow_counts(void *counts, int32_t L, const void *mult,
                                  int64_t n_rows, int32_t P,
                                  const void *dense8, int64_t seq_lo,
                                  int32_t vec, int32_t grid, void *stream) {
    overflow_counts_kernel<<<grid, S2_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t *)counts, L, (const int32_t *)mult, n_rows, P,
        (const int8_t *)dense8, seq_lo, vec);
    return (int)cudaGetLastError();
}
