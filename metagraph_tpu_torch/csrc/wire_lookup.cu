// Kernel 1 of the annotated batch query: 2-bit wire words -> node ids.
//
// Replaces the XLA programs that metagraph_tpu/query/device.py::
// _wire_epoch_core (:319-393) chains:
//   succinct/ops.py extract_windows2 (:181), window_valid2 (:247),
//   keys2_to_keys4 (:215), _hash_words (:345) and _hash_lookup_flat (:439),
//   and for canonical and primary graphs (canon 1 and 2, :356-384)
//   rc_keys2 (:126), boss_rot2 (:151) and keys2_greater (:173).
//
// What bounds it on an H100: per-window work and load latency, not bytes.
// Against a table held in L2 it keeps about 77% of its time (PERF.md): the
// key arithmetic, the block barriers around the staged copy and the later
// groups a thread reads alone.  A design that read all 16 slots of a bucket
// row (320 B at K = 31), one lane a window, issued 20 16-byte loads a probe,
// each warp load touching 32 unrelated rows, and was 4x slower.  This
// design:
// * Stops early.  The builders fill a bucket's slots from slot 0
//   (convert.QueryIndex checks it) and insert each key once, so a probe
//   stops after the first group of 4 slots that holds its key or an empty
//   slot: about nine probes in ten read only group 0 (80 B at K = 31).
// * Coalesces.  A block takes 256 consecutive windows; each thread computes
//   its window's key and bucket, then the block copies every probed row's
//   group 0 into shared memory with 16-byte cp.async, consecutive threads
//   copying consecutive chunks of one row, so a warp instruction touches
//   about 7 rows rather than 32.  Each thread scans its group there; a
//   probe that needs a later group reads it directly, its W + 1 16-byte
//   loads issued before the compare.
// * Splits canon 2 in two passes.  Pass 1 probes every window's forward key
//   and lists the valid misses (one atomicAdd per block); pass 2 probes the
//   listed windows' reverse complements with full blocks, so no thread
//   waits on another thread's second probe.
// The window key is two funnel shifts of the tile's words; its validity one
// 64-bit shift of the valid words; the reverse complement, the BOSS-order
// comparison, the nibble key and the hash stay in registers.  Invalid
// windows read no row.  Canon 1 makes one probe, of the strand that comes
// first in BOSS order.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BUCKET = 16;      // slots per bucket row
constexpr int GROUP = 4;        // slots per group
constexpr int THREADS = 256;    // windows per block
constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;

__constant__ uint32_t HASH_C[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0x9E3779B9u,
                                   0x85EBCA6Bu, 0xC2B2AE35u};

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                     "memory");
}

// Reverse complement of a 2K-bit key (char i at bits 2i): complement is NOT
// (A/T and C/G pair across the 2-bit code); __brevll reverses the 64 bits,
// which reverses the 32 groups and the words but also flips the two bits
// inside each group, so those are swapped back; the key then sits in the
// top 2K bits and a 64-bit shift by 64 - 2K (2 .. 60, always defined)
// realigns it, shifting the complemented padding out.
__device__ __forceinline__ uint64_t rc_key(uint64_t key, int K) {
    uint64_t r = __brevll(~key);
    r = ((r & 0x5555555555555555ull) << 1) | ((r >> 1) & 0x5555555555555555ull);
    return r >> (64 - 2 * K);
}

// BOSS priority order compares chars K-2 .. 0, then K-1: on the 2K-bit key
// that is a 2-bit rotate left (the top char moves to the bottom group).
__device__ __forceinline__ uint64_t boss_rot(uint64_t key, int K) {
    return ((key << 2) & ((1ull << (2 * K)) - 1ull)) | (key >> (2 * K - 2));
}

// Window j of a tile: bits [2j, 2j + 2K) of its 2-bit stream ...
__device__ __forceinline__ uint64_t window_key(const uint32_t *__restrict__ wd,
                                               int j, int K) {
    const int g = j >> 4, sh = 2 * (j & 15);
    const uint32_t w0 = wd[g], w1 = wd[g + 1], w2 = wd[g + 2];
    uint32_t lo = __funnelshift_r(w0, w1, sh);
    uint32_t hi = __funnelshift_r(w1, w2, sh);
    lo &= K >= 16 ? 0xFFFFFFFFu : (1u << (2 * K)) - 1u;
    hi &= K > 16 ? (1u << (2 * K - 32)) - 1u : 0u;
    return (uint64_t)lo | ((uint64_t)hi << 32);
}

// ... which is valid iff bits j .. j+K-1 of the tile's valid bits are set.
__device__ __forceinline__ bool window_valid(const uint32_t *__restrict__ vw,
                                             int nv, int j, int K) {
    const int b = j >> 5;
    uint64_t v = vw[b];
    if (b + 1 < nv)
        v |= (uint64_t)vw[b + 1] << 32;
    const uint64_t need = (1ull << K) - 1;
    return ((v >> (j & 31)) & need) == need;
}

// A probe: the nibble key in BOSS priority order and its bucket (-1: none).
template <int W>
struct Probe {
    uint32_t k4[W];
    int32_t bucket = -1;
};

template <int W>
__device__ __forceinline__ void make_probe(uint64_t key, int K, uint32_t nb,
                                           Probe<W> &p) {
    const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
    // chars K-2 .. 0, then K-1, four bits each, the first in the top nibble
#pragma unroll
    for (int w = 0; w < W; ++w) {
        uint32_t acc = 0;
#pragma unroll
        for (int slot = 0; slot < 8; ++slot) {
            const int pos = w * 8 + slot;
            if (pos < K) {
                const int c = pos < K - 1 ? K - 2 - pos : K - 1;
                const uint32_t src = c < 16 ? lo : hi;
                acc |= (((src >> ((2 * c) & 31)) & 3u) + 1u)
                       << (28 - 4 * slot);
            }
        }
        p.k4[w] = acc;
    }
    uint32_t h = 1u;                            // salt
#pragma unroll
    for (int w = 0; w < W; ++w) {
        h = (h ^ (p.k4[w] * HASH_C[w % 8])) * 0x9E3779B1u;
        h ^= h >> 15;
    }
    p.bucket = (int32_t)(h % nb);
}

// Scan one group of slots (GROUP * (W + 1) words); true when the probe
// stops here, because the group holds the key or an empty slot.  A key sits
// in one slot at most; the id is the max over matching slots, as in
// _hash_lookup_flat.
template <int W>
__device__ __forceinline__ bool scan_group(const uint32_t *r,
                                           const uint32_t (&k4)[W],
                                           uint32_t &id) {
    bool stop = false;
#pragma unroll
    for (int s = 0; s < GROUP; ++s) {
        const uint32_t *slot = r + s * (W + 1);
        bool eq = true;
#pragma unroll
        for (int w = 0; w < W; ++w)
            eq &= slot[w] == k4[w];
        if (eq)
            id = max(id, slot[W]);
        stop |= eq || slot[0] == EMPTY;
    }
    return stop;
}

// One probe per thread of the block -> its id (0 = miss).  Every thread of
// the block calls it.  Group 0 of each probed row is staged by the whole
// block; later groups are read by the thread that needs them.
template <int W>
__device__ __forceinline__ uint32_t
probe_block(const uint32_t *__restrict__ table, const Probe<W> &p) {
    constexpr int GC = W + 1;                   // 16-byte chunks of a group
    constexpr int GW = GROUP * (W + 1);         // words of a group
    constexpr int ROW = BUCKET * (W + 1);       // words of a bucket row
    __shared__ __align__(16) uint32_t stage[THREADS * GW];
    __shared__ int32_t s_bucket[THREADS];
    s_bucket[threadIdx.x] = p.bucket;
    __syncthreads();
    for (int c = threadIdx.x; c < THREADS * GC; c += THREADS) {
        const int t = c / GC, u = c - t * GC;
        const int32_t b = s_bucket[t];
        if (b >= 0)
            cp_async16(stage + t * GW + 4 * u,
                       table + (int64_t)b * ROW + 4 * u);
    }
    cp_async_wait_all();
    __syncthreads();
    uint32_t id = 0;
    if (p.bucket < 0)
        return id;
    uint32_t r[GW];
    const uint4 *s4 = reinterpret_cast<const uint4 *>(stage)
        + threadIdx.x * GC;
#pragma unroll
    for (int u = 0; u < GC; ++u) {
        const uint4 x = s4[u];
        r[4 * u] = x.x;
        r[4 * u + 1] = x.y;
        r[4 * u + 2] = x.z;
        r[4 * u + 3] = x.w;
    }
    bool stop = scan_group<W>(r, p.k4, id);
    const uint4 *row = reinterpret_cast<const uint4 *>(
        table + (int64_t)p.bucket * ROW);
    for (int g = 1; !stop && g < BUCKET / GROUP; ++g) {
#pragma unroll
        for (int u = 0; u < GC; ++u) {
            const uint4 x = __ldg(row + g * GC + u);
            r[4 * u] = x.x;
            r[4 * u + 1] = x.y;
            r[4 * u + 2] = x.z;
            r[4 * u + 3] = x.w;
        }
        stop = scan_group<W>(r, p.k4, id);
    }
    return id;
}

// Append flat window f to the miss list where ``miss``: one atomicAdd on the
// count per block.  Every thread of the block calls it.
__device__ __forceinline__ void list_misses(bool miss, int f,
                                            int32_t *__restrict__ list,
                                            int32_t *__restrict__ count) {
    __shared__ int32_t s_off[THREADS / 32 + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(FULL, miss);
    if (lane == 0)
        s_off[warp] = __popc(m);
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t n = 0;
        for (int w = 0; w < THREADS / 32; ++w) {
            const int32_t c = s_off[w];
            s_off[w] = n;
            n += c;
        }
        s_off[THREADS / 32] = n ? atomicAdd(count, n) : 0;
    }
    __syncthreads();
    if (miss)
        list[s_off[THREADS / 32] + s_off[warp]
             + __popc(m & ((1u << lane) - 1u))] = f;
}

// One thread per window of the flat (n_tiles * T) batch.  CANON 0 probes
// the key, 1 the strand first in BOSS order, 2 the forward key (pass 1:
// valid misses are listed for rc_kernel).  CANON is a template parameter:
// a run-time branch on it cost canon 0 20% (PERF.md).
template <int W, int CANON>
__global__ void __launch_bounds__(THREADS)
wire_lookup_kernel(const uint32_t *__restrict__ words,
                   const uint32_t *__restrict__ vwords,
                   const uint32_t *__restrict__ table,
                   int32_t *__restrict__ nodes, int nw, int nv, uint32_t nb,
                   int K, int T, int total, int32_t offset,
                   int32_t *__restrict__ miss_list,
                   int32_t *__restrict__ miss_count) {
    const int f = blockIdx.x * THREADS + threadIdx.x;
    const int tile = f / T, j = f - tile * T;
    const bool valid = f < total
        && window_valid(vwords + (int64_t)tile * nv, nv, j, K);
    Probe<W> p;
    if (valid) {
        uint64_t key = window_key(words + (int64_t)tile * nw, j, K);
        if (CANON == 1) {
            const uint64_t rc = rc_key(key, K);
            if (boss_rot(key, K) > boss_rot(rc, K))
                key = rc;
        }
        make_probe<W>(key, K, nb, p);
    }
    const int32_t node = (int32_t)probe_block<W>(table, p);
    if (f < total)
        nodes[f] = node;
    if (CANON == 2)
        list_misses(valid && node == 0, f, miss_list, miss_count);
}

// Canon 2, pass 2: the reverse complement of each listed window; a hit is
// emitted as id + offset.  The grid covers every window; blocks past the
// list's length return at once.
template <int W>
__global__ void __launch_bounds__(THREADS)
rc_kernel(const uint32_t *__restrict__ words,
          const uint32_t *__restrict__ table, int32_t *__restrict__ nodes,
          int nw, uint32_t nb, int K, int T, int32_t offset,
          const int32_t *__restrict__ miss_list,
          const int32_t *__restrict__ miss_count) {
    const int n = *miss_count;
    if ((int)blockIdx.x * THREADS >= n)
        return;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const int f = i < n ? miss_list[i] : -1;
    Probe<W> p;
    if (f >= 0) {
        const int tile = f / T, j = f - tile * T;
        make_probe<W>(rc_key(window_key(words + (int64_t)tile * nw, j, K), K),
                      K, nb, p);
    }
    const uint32_t id = probe_block<W>(table, p);
    if (f >= 0 && id)
        nodes[f] = (int32_t)id + offset;
}

template <int W>
int launch(unsigned blocks, cudaStream_t st, const uint32_t *w,
           const uint32_t *v, const uint32_t *t, int32_t *o, int nw, int nv,
           uint32_t nb, int K, int T, int total, int canon, int32_t offset,
           int32_t *list, int32_t *count) {
    switch (canon) {
    case 0:
        wire_lookup_kernel<W, 0><<<blocks, THREADS, 0, st>>>(
            w, v, t, o, nw, nv, nb, K, T, total, offset, list, count);
        break;
    case 1:
        wire_lookup_kernel<W, 1><<<blocks, THREADS, 0, st>>>(
            w, v, t, o, nw, nv, nb, K, T, total, offset, list, count);
        break;
    case 2: {
        wire_lookup_kernel<W, 2><<<blocks, THREADS, 0, st>>>(
            w, v, t, o, nw, nv, nb, K, T, total, offset, list, count);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess)
            return (int)e;
        rc_kernel<W><<<blocks, THREADS, 0, st>>>(w, t, o, nw, nb, K, T,
                                                 offset, list, count);
        break;
    }
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// words (n_tiles, nw), vwords (n_tiles, nv), table (n_buckets,
// 16 * (W + 1)) uint32 -> nodes (n_tiles, T) int32.  canon 0, 1 or 2 as in
// succinct/ops.py::wire_lookup_plain; offset is added to canon 2's
// reverse-complement hits.
// Canon 2 takes miss_list (n_tiles * T int32) and miss_count (one int32,
// zeroed by the caller) as scratch and launches two kernels.  The wrapper
// checks 2 <= K <= 31, T % 32 == 0, T <= 1024, nw >= T / 16 + 2,
// nv * 32 >= T, n_tiles * T + 256 < 2^31 and n_buckets < 2^31; the caller
// keeps ids + offset below 2^31 (convert.QueryIndex checks
// 2 * offset < 2^31).
extern "C" int mg_wire_lookup(const void *words, const void *vwords,
                              const void *table, void *nodes, int64_t n_tiles,
                              int32_t nw, int32_t nv, int64_t n_buckets,
                              int32_t K, int32_t T, int32_t canon,
                              int32_t offset, void *miss_list,
                              void *miss_count, void *stream) {
    const int total = (int)(n_tiles * T);
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t *w = (const uint32_t *)words;
    const uint32_t *v = (const uint32_t *)vwords;
    const uint32_t *t = (const uint32_t *)table;
    int32_t *o = (int32_t *)nodes;
    int32_t *list = (int32_t *)miss_list, *count = (int32_t *)miss_count;
    const uint32_t nb = (uint32_t)n_buckets;
    switch ((K + 7) / 8) {
    case 1:
        return launch<1>(blocks, st, w, v, t, o, nw, nv, nb, K, T, total,
                         canon, offset, list, count);
    case 2:
        return launch<2>(blocks, st, w, v, t, o, nw, nv, nb, K, T, total,
                         canon, offset, list, count);
    case 3:
        return launch<3>(blocks, st, w, v, t, o, nw, nv, nb, K, T, total,
                         canon, offset, list, count);
    case 4:
        return launch<4>(blocks, st, w, v, t, o, nw, nv, nb, K, T, total,
                         canon, offset, list, count);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
