// Kernel D4 of the device construction: the BOSS rows from the sorted
// edge stream.
//
// Replaces metagraph_tpu/succinct/device_build.py::_build_p2 :253-309
// (construct.emit_boss semantics; ref boss_chunk.cpp:33-133):
//
// * mg_emit_keys: the unique wire keys, compacted in their order, each as
//   its 3-bit key (_key3_from_key2, :136): the edge label (character K-1)
//   at bits 0..2 and character j <= K-2 at bits 3(j+1), codes $=0,
//   A..T=1..4, so that integer order is BOSS order; then the host's dummy
//   rows.  The TPU kept its static shape by writing a sentinel for every
//   row that is not unique (:253-255); the order of the stream does not
//   matter before its sort, so the U + D real rows are all that is
//   written, and D2 sorts them alone.
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
// its label: a scan back over at most 24 rows.
//
// What bounds it on an H100: bytes.  The compaction must read each flag
// once (1 B a slot), the U set rows' keys and the dummy rows once, and
// write the U + D keys (8 B each); the emission must read each sorted row
// once (8 B) and write 3 B a kept row.
//
// Design (two kernels, each one pass, one memset of scratch before each):
// * Both claim 4,096-row tiles from an atomic counter (so every lower tile
//   has a running owner, which decoupled look-back needs: blocks start in
//   no set order), rank the tile's output rows by warp ballots (row r *
//   256 + thread: a warp's 32 rows are consecutive) and one warp's scan of
//   the 128 (item, warp) counts, then find the tile's output offset by a
//   decoupled look-back over 64-bit status words (lookback.cuh's
//   tile_prefix: 32 earlier tiles at a time).  The memset zeroes the words,
//   the counter, the total (the last tile writes the whole count: the
//   compaction's set flags, the emission's kept rows) and the emission's F.
// * The compaction loads its 4,096 flags 16 bytes a thread, loads a key
//   only where its flag is set (a run of duplicates that covers whole 32 B
//   sectors leaves them unfetched), builds the 3-bit key by a fixed
//   bit spread (SPREAD masks: five mask-and-shift steps move the 2-bit
//   fields into 3-bit ones, high to low; adding FIELD_ONES makes each code
//   + 1, no field reaching 8, so no carry crosses a field), places the keys
//   in shared memory in order and writes them contiguously, none at or
//   past U (the host checks the set flags' count against U).  Each block
//   also copies its share of the dummy rows behind the U keys.
// * The emission stages its tile of sorted rows (16 loads a thread in
//   flight at once) with 24 rows before it and 1 after it in shared
//   memory, and computes from there each row's keep, last and valid bits,
//   W without the minus flag, and F in a per-thread word of 8-bit fields
//   (reduced over the warp, added once a (block, c) to F).  While warp 0
//   looks back, the other warps add the minus flags: a row whose previous
//   row is of another group (most rows) has none; otherwise the scan goes
//   back through shared memory, and through global memory only where a
//   group runs past the 24 staged rows, which a stream of distinct rows
//   never does.  The kept rows' W, last and valid go out as 16-byte words
//   from shared memory, bytes only at the two ends of the tile's range.
//   S is read once.
// * Both measured at 3.0x (compaction) and 2.3x (emission) their bound on
//   the pan build (PERF.md §6).  A key comes in its 32 B sector, and there
//   most sectors hold a set flag, so the compaction fetches about 2.6x the
//   key bytes it needs.  Moving the key loads ahead of the flags, staging
//   no keys in shared memory, 6 blocks an SM and persistent blocks were
//   each no faster.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using lookback::lanemask_lt;
using lookback::tile_prefix;
typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                     // rows a thread
constexpr int TILE = THREADS * ITEMS;         // rows a block
constexpr int HALO = 24;                      // rows staged before a tile
constexpr int SPAN = 16;                      // bytes a vector store

// The bit spread of a node's 2-bit fields j < 21 into 3-bit fields: the
// step of move m shifts the fields whose index has bit m by m bits.
constexpr u64 SPREAD16 = 0x000003FF00000000ull;
constexpr u64 SPREAD8 = 0x00000000FFFF0000ull;
constexpr u64 SPREAD4 = 0x030000FF0000FF00ull;
constexpr u64 SPREAD2 = 0x00F00F00F00F00F0ull;
constexpr u64 SPREAD1 = 0x030C30C30C30C30Cull;
constexpr u64 FIELD_ONES = 0x1249249249249249ull;   // 1 in fields 0..20

// Scratch words: the compaction's tile counter and set-flag total, then a
// status word a tile; the emission's F (8), kept total and tile counter,
// then a status word a tile.
constexpr int64_t KEYS_HEAD = 2;
constexpr int64_t ROWS_HEAD = 10;

// A wire key (character j at bits 2j, K characters) -> its 3-bit key.
__device__ __forceinline__ u64 key3(u64 k, int K) {
    const int nb = 2 * (K - 1);
    u64 x = k & ((1ull << nb) - 1);
    x = (x & ~SPREAD16) | ((x & SPREAD16) << 16);
    x = (x & ~SPREAD8) | ((x & SPREAD8) << 8);
    x = (x & ~SPREAD4) | ((x & SPREAD4) << 4);
    x = (x & ~SPREAD2) | ((x & SPREAD2) << 2);
    x = (x & ~SPREAD1) | ((x & SPREAD1) << 1);
    const u64 ones = FIELD_ONES & ((1ull << (3 * (K - 1))) - 1);
    return ((x + ones) << 3) | (((k >> nb) & 3) + 1);
}

// Warp 0: the 128 (item, warp) counts of s_cnt -> their exclusive sums in
// row order, in place; -> the tile's total (every lane).
__device__ __forceinline__ uint32_t scan_counts(uint32_t *s_cnt) {
    static_assert(ITEMS * WARPS == 128, "four counts a lane");
    const int lane = threadIdx.x & 31;
    uint32_t c[4], s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        c[q] = s_cnt[lane * 4 + q];
        s += c[q];
    }
    uint32_t x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    uint32_t run = x - s;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        s_cnt[lane * 4 + q] = run;
        run += c[q];
    }
    return __shfl_sync(FULL, x, 31);
}

__global__ void __launch_bounds__(THREADS)
emit_keys_kernel(const u64 *__restrict__ skeys,
                 const uint8_t *__restrict__ uniq, int64_t n,
                 const u64 *__restrict__ dkeys, int64_t D, int64_t U, int K,
                 u64 *__restrict__ out, u64 *__restrict__ scratch,
                 int64_t grid) {
    __shared__ __align__(16) uint8_t s_flag[TILE];
    __shared__ u64 s_key[TILE];
    __shared__ uint32_t s_cnt[ITEMS * WARPS];
    __shared__ uint32_t s_tile, s_total;
    __shared__ u64 s_base;
    auto *counter = (unsigned *)scratch;
    u64 *set_total = scratch + 1;
    u64 *status = scratch + KEYS_HEAD;
    if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t base = tile * TILE;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the tile's flags, 16 a thread (zero past n)
    const int64_t f0 = base + threadIdx.x * SPAN;
    if (f0 + SPAN <= n && !((uintptr_t)(uniq + f0) & (SPAN - 1))) {
        *(uint4 *)(s_flag + threadIdx.x * SPAN) = *(const uint4 *)(uniq + f0);
    } else {
#pragma unroll
        for (int j = 0; j < SPAN; ++j)
            s_flag[threadIdx.x * SPAN + j] = f0 + j < n ? uniq[f0 + j] : 0;
    }
    __syncthreads();
    // the set rows' keys (only theirs loaded) and the warps' ballots
    unsigned ball[ITEMS];
    u64 key[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int l = r * THREADS + threadIdx.x;
        const bool set = s_flag[l] != 0;
        ball[r] = __ballot_sync(FULL, set);
        key[r] = set ? __ldcs(skeys + base + l) : 0;
        if (lane == 0) s_cnt[r * WARPS + warp] = __popc(ball[r]);
    }
    __syncthreads();
    if (warp == 0) {
        const uint32_t total = scan_counts(s_cnt);
        const u64 prefix = tile_prefix(status, tile, total);
        if (lane == 0) {
            s_total = total;
            s_base = prefix;
            if (tile == grid - 1) *set_total = prefix + total;
        }
    }
    __syncthreads();
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
        if (ball[r] >> lane & 1)
            s_key[s_cnt[r * WARPS + warp] + __popc(ball[r] & lt)] =
                key3(key[r], K);
    __syncthreads();
    const int64_t at = (int64_t)s_base;
    const int total = (int)s_total;
    for (int j = threadIdx.x; j < total; j += THREADS)
        if (at + j < U) out[at + j] = s_key[j];
    // the dummy rows behind the U keys, a share a block
    for (int64_t j = tile * THREADS + threadIdx.x; j < D;
         j += grid * THREADS)
        out[U + j] = __ldcs(dkeys + j);
}

// Whether an earlier row of row i's group (the rows whose keys agree above
// bit 5) holds its label: staged rows first (s[lj], lj = row i - 1's
// index there), then global memory past them.
__device__ __forceinline__ bool minus_of(const u64 *s, int lj,
                                         const u64 *__restrict__ S,
                                         int64_t i, u64 key, int label) {
    int64_t j = i - 1;
    for (; j >= 0 && lj >= 0; --j, --lj) {
        const u64 t = s[lj];
        if ((t ^ key) >= 64) return false;
        if ((int)(t & 7) == label) return true;
    }
    for (; j >= 0; --j) {
        const u64 t = __ldg(S + j);
        if ((t ^ key) >= 64) return false;
        if ((int)(t & 7) == label) return true;
    }
    return false;
}

__global__ void __launch_bounds__(THREADS)
emit_rows_kernel(const u64 *__restrict__ S, int64_t M, int K, int alph,
                 uint8_t *__restrict__ W, uint8_t *__restrict__ last,
                 uint8_t *__restrict__ valid, u64 *__restrict__ scratch,
                 int64_t tiles) {
    __shared__ u64 s_row[HALO + TILE + 1];
    __shared__ __align__(16) uint8_t s_out[3][TILE + SPAN];
    __shared__ uint32_t s_cnt[ITEMS * WARPS];
    __shared__ uint32_t s_hist[8];
    __shared__ uint32_t s_tile, s_total;
    __shared__ u64 s_base;
    u64 *F = scratch, *kept = scratch + 8;
    auto *counter = (unsigned *)(scratch + 9);
    u64 *status = scratch + ROWS_HEAD;
    if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
    if (threadIdx.x < 8) s_hist[threadIdx.x] = 0;
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t base = tile * TILE;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    {
        // the tile's rows, 16 loads a thread in flight at once, and the
        // rows [base - HALO, base) and base + TILE that exist
        u64 v[ITEMS];
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) {
            const int64_t i = base + r * THREADS + threadIdx.x;
            v[r] = i < M ? __ldcs(S + i) : 0;
        }
        if (threadIdx.x <= HALO) {
            const int j = threadIdx.x < HALO ? threadIdx.x : HALO + TILE;
            const int64_t i = base - HALO + j;
            if (i >= 0 && i < M) s_row[j] = __ldg(S + i);
        }
#pragma unroll
        for (int r = 0; r < ITEMS; ++r)
            s_row[HALO + r * THREADS + threadIdx.x] = v[r];
    }
    __syncthreads();
    // the tile's rows that exist; rows l < lim have a row l + 1
    const int rows = M - base < TILE ? (int)(M - base) : TILE;
    const int lim = base + TILE < M ? TILE : rows - 1;
    const int nl_shift = 3 * (K - 1);
    // each row's byte: W without the minus flag (bits 0-3), last (4),
    // valid (5), a real label (6); keep (a $-labelled row whose node goes
    // on in a real character is dropped) as the warps' ballots and counts;
    // the kept rows by node_last in 8-bit fields
    unsigned ball[ITEMS];
    uint32_t pk[ITEMS / 4] = {};
    u64 cnt = 0;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int l = r * THREADS + threadIdx.x;
        bool keep = false;
        if (l < rows) {
            const u64 s = s_row[HALO + l];
            const uint32_t label = (uint32_t)s & 7;
            const uint32_t nl = (uint32_t)(s >> nl_shift) & 7;
            const bool same_next = l < lim && (s_row[HALO + l + 1] ^ s) < 8;
            keep = label || !nl || !same_next;
            const bool real = label - 1 < (uint32_t)(alph - 1);
            pk[r >> 2] |= (label | (uint32_t)!same_next << 4
                           | (uint32_t)(real && (s & 0x38)) << 5
                           | (uint32_t)real << 6) << (8 * (r & 3));
            if (keep) cnt += 1ull << (8 * nl);
        }
        ball[r] = __ballot_sync(FULL, keep);
        if (lane == 0) s_cnt[r * WARPS + warp] = __popc(ball[r]);
    }
    // F: the warp's counts (even and odd fields in 16 bits), a shared add
    // a warp and value
    u64 ev = cnt & 0x00FF00FF00FF00FFull;
    u64 od = (cnt >> 8) & 0x00FF00FF00FF00FFull;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        ev += __shfl_xor_sync(FULL, ev, o);
        od += __shfl_xor_sync(FULL, od, o);
    }
    if (lane == 0)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const uint32_t v =
                (uint32_t)(((c & 1 ? od : ev) >> (16 * (c >> 1))) & 0xFFFF);
            if (v) atomicAdd(s_hist + c, v);
        }
    __syncthreads();
    // warp 0 finds the tile's offset while the other warps go on
    if (warp == 0) {
        const uint32_t total = scan_counts(s_cnt);
        const u64 prefix = tile_prefix(status, tile, total);
        if (lane == 0) {
            s_total = total;
            s_base = prefix;
            if (tile == tiles - 1) *kept = prefix + total;
        }
    }
    // the minus flags: W + alph where an earlier row of the group holds
    // the label (most rows' group starts at the row itself)
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int l = r * THREADS + threadIdx.x;
        if (pk[r >> 2] >> (8 * (r & 3)) & 64) {
            const u64 s = s_row[HALO + l];
            const int64_t i = base + l;
            if (i > 0 && (s_row[HALO + l - 1] ^ s) < 64
                && minus_of(s_row, HALO + l - 1, S, i, s, (int)(s & 7)))
                pk[r >> 2] += (uint32_t)alph << (8 * (r & 3));
        }
    }
    __syncthreads();
    if (threadIdx.x == 32) {
        uint32_t below = 0;
        for (int c = 1; c < alph; ++c) {
            below += s_hist[c - 1];
            if (below) atomicAdd(F + c, (u64)below);
        }
    }
    const int64_t dst = 1 + (int64_t)s_base;        // the first kept row's
    const int total = (int)s_total;
    uint8_t *const outs[3] = {W, last, valid};
    int mis[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        mis[a] = (int)((uintptr_t)(outs[a] + dst) & (SPAN - 1));
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
        if (ball[r] >> lane & 1) {
            const int pos = s_cnt[r * WARPS + warp] + __popc(ball[r] & lt);
            const uint32_t b = pk[r >> 2] >> (8 * (r & 3));
            s_out[0][mis[0] + pos] = b & 15;
            s_out[1][mis[1] + pos] = b >> 4 & 1;
            s_out[2][mis[2] + pos] = b >> 5 & 1;
        }
    if (tile == 0 && threadIdx.x < 3) outs[threadIdx.x][0] = 0;  // row 0
    __syncthreads();
    // whole 16-byte words inside [dst, dst + total), bytes at its ends
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        uint8_t *g = outs[a] + dst - mis[a];        // 16-byte aligned
        const int end = mis[a] + total;
        for (int q = threadIdx.x; q * SPAN < end; q += THREADS) {
            const int lo = q * SPAN, hi = lo + SPAN;
            if (lo >= mis[a] && hi <= end) {
                *(uint4 *)(g + lo) = *(const uint4 *)(s_out[a] + lo);
            } else {
                for (int b = lo > mis[a] ? lo : mis[a]; b < (hi < end ? hi
                                                             : end); ++b)
                    g[b] = s_out[a][b];
            }
        }
    }
}

}  // namespace

extern "C" {

// int64 words of the compaction's scratch for n wire keys: the tile
// counter, the set flags' total, then a status word a tile.
int64_t mg_emit_keys_scratch(int64_t n) {
    const int64_t tiles = (n + TILE - 1) / TILE;
    return KEYS_HEAD + (tiles ? tiles : 1);
}

// n sorted wire keys and their uniq flags (U of them set), D dummy 3-bit
// keys -> k3[0..U + D): the set rows' 3-bit keys in order (none written
// at or past U), then the dummy keys; the count of set flags in scratch
// word 1, for the caller to hold against U.  One memset of the scratch,
// one kernel.  Returns the first error, 0 if none.
int mg_emit_keys(const void *s, const void *uniq, int64_t n,
                 const void *dkeys, int64_t D, int64_t U, int K, void *k3,
                 void *scratch, void *stream) {
    if (n < 0 || D < 0 || U < 0 || U > n || K < 3 || K > 21
        || n >= (int64_t(1) << 31) || U + D >= (int64_t(1) << 31))
        return (int)cudaErrorInvalidValue;
    if (n + D == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t words = mg_emit_keys_scratch(n);
    cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * words, st);
    if (err) return (int)err;
    const int64_t grid = words - KEYS_HEAD;
    emit_keys_kernel<<<(unsigned)grid, THREADS, 0, st>>>(
        (const u64 *)s, (const uint8_t *)uniq, n, (const u64 *)dkeys, D, U,
        K, (u64 *)k3, (u64 *)scratch, grid);
    return (int)cudaGetLastError();
}

// int64 words of the emission's scratch for M rows: F (8), the kept
// total, the tile counter, then a status word a tile.
int64_t mg_emit_rows_scratch(int64_t M) {
    return ROWS_HEAD + (M + TILE - 1) / TILE;
}

// M >= 1 sorted rows (M < 2^31) -> W, last, valid (M + 1 uint8 each: row
// 0 and the kept rows behind it; the bytes past them are not written),
// and in the scratch F (words 0..alph) and the kept total (word 8).  One
// memset of the scratch, one kernel.  Returns the first error, 0 if none.
int mg_build_emit(const void *S, int64_t M, int K, int alph, void *W,
                  void *last, void *valid, void *scratch, void *stream) {
    if (M <= 0 || M >= (int64_t(1) << 31) || K < 3 || K > 21 || alph < 2
        || alph > 8)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t words = mg_emit_rows_scratch(M);
    cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * words, st);
    if (err) return (int)err;
    const int64_t tiles = words - ROWS_HEAD;
    emit_rows_kernel<<<(unsigned)tiles, THREADS, 0, st>>>(
        (const u64 *)S, M, K, alph, (uint8_t *)W, (uint8_t *)last,
        (uint8_t *)valid, (u64 *)scratch, tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
