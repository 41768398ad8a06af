// Kernel 1 of the annotated batch query: 2-bit wire words -> node ids.
//
// Replaces the XLA programs that metagraph_tpu/query/device.py::
// _wire_epoch_core (:319-393) chains:
//   succinct/ops.py extract_windows2 (:181), window_valid2 (:247),
//   keys2_to_keys4 (:215), _hash_words (:345) and _hash_lookup_flat (:439),
//   and for canonical and primary graphs (canon 1 and 2, :356-384)
//   rc_keys2 (:126), boss_rot2 (:151) and keys2_greater (:173).
//
// What bounds it on an H100: bytes.  Every valid window reads one bucket row
// of 16 * (W + 1) words (320 B at K = 31) at a random place in a table far
// larger than the 50 MB L2; the key work is a few dozen integer operations.
// Design: one thread per window and one block per tile of T windows.  The
// window key is two funnel shifts of the tile's words, held as one 64-bit
// integer; its validity is one 64-bit shift of the valid words; the reverse
// complement, the BOSS-order comparison, the nibble key and the hash stay in
// registers, so the only device-memory traffic besides the bucket rows is a
// few words per window (shared by the warp) and the int32 node id.  A row is
// read with 16-byte loads (a row is 64 * (W + 1) bytes, so it starts 16-byte
// aligned).  Invalid windows read no row.  Canon 1 makes one probe, of the
// strand that comes first in BOSS order.  Canon 2 reads the reverse
// complement's row only where the forward probe missed (the JAX program
// probes both strands always; the result is the same).
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BUCKET = 16;

__constant__ uint32_t HASH_C[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0x9E3779B9u,
                                   0x85EBCA6Bu, 0xC2B2AE35u};

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

// One probe of the hash table: node id of the 2K-bit key, 0 on a miss.
template <int W>
__device__ __forceinline__ int32_t probe(uint64_t key, int K,
                                         const uint32_t *__restrict__ table,
                                         uint32_t n_buckets) {
    const uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
    // nibble key in BOSS priority order: chars K-2 .. 0, then K-1
    uint32_t k4[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        uint32_t acc = 0;
#pragma unroll
        for (int slot = 0; slot < 8; ++slot) {
            const int p = w * 8 + slot;
            if (p < K) {
                const int c = p < K - 1 ? K - 2 - p : K - 1;
                const uint32_t src = c < 16 ? lo : hi;
                acc |= (((src >> ((2 * c) & 31)) & 3u) + 1u)
                       << (28 - 4 * slot);
            }
        }
        k4[w] = acc;
    }

    uint32_t h = 1u;                            // salt
#pragma unroll
    for (int w = 0; w < W; ++w) {
        h = (h ^ (k4[w] * HASH_C[w % 8])) * 0x9E3779B1u;
        h ^= h >> 15;
    }
    const uint4 *row = reinterpret_cast<const uint4 *>(
        table + (int64_t)(h % n_buckets) * (BUCKET * (W + 1)));

    // 4 slots = (W + 1) 16-byte loads; exactly one slot can match, the id is
    // the max over matching slots as in _hash_lookup_flat
    bool hit = false;
    uint32_t id = 0;
#pragma unroll
    for (int q = 0; q < BUCKET / 4; ++q) {
        uint32_t r[4 * (W + 1)];
#pragma unroll
        for (int u = 0; u < W + 1; ++u) {
            const uint4 x = __ldg(row + q * (W + 1) + u);
            r[4 * u] = x.x;
            r[4 * u + 1] = x.y;
            r[4 * u + 2] = x.z;
            r[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            bool eq = true;
#pragma unroll
            for (int w = 0; w < W; ++w)
                eq &= r[s * (W + 1) + w] == k4[w];
            if (eq) {
                hit = true;
                id = max(id, r[s * (W + 1) + W]);
            }
        }
    }
    return hit ? (int32_t)id : 0;
}

// CANON is a template parameter so that canon 0 and 1 carry one inlined
// probe, not canon 2's two (registers, hence occupancy).
template <int W, int CANON>
__global__ void wire_lookup_kernel(const uint32_t *__restrict__ words,
                                   const uint32_t *__restrict__ vwords,
                                   const uint32_t *__restrict__ table,
                                   int32_t *__restrict__ nodes, int nw, int nv,
                                   uint32_t n_buckets, int K, int T,
                                   int32_t offset) {
    const int64_t tile = blockIdx.x;
    const int j = threadIdx.x;                  // window within the tile

    // validity: bits j .. j+K-1 of the tile's valid bitstream all set
    const uint32_t *vw = vwords + tile * nv;
    const int b = j >> 5;
    uint64_t v = vw[b];
    if (b + 1 < nv)
        v |= (uint64_t)vw[b + 1] << 32;
    const uint64_t need = (1ull << K) - 1;
    int32_t node = 0;
    if (((v >> (j & 31)) & need) == need) {
        // window key: bits [2j, 2j + 2K) of the 2-bit stream
        const uint32_t *wd = words + tile * nw;
        const int g = j >> 4, sh = 2 * (j & 15);
        const uint32_t w0 = wd[g], w1 = wd[g + 1], w2 = wd[g + 2];
        uint32_t lo = __funnelshift_r(w0, w1, sh);
        uint32_t hi = __funnelshift_r(w1, w2, sh);
        lo &= K >= 16 ? 0xFFFFFFFFu : (1u << (2 * K)) - 1u;
        hi &= K > 16 ? (1u << (2 * K - 32)) - 1u : 0u;
        uint64_t key = (uint64_t)lo | ((uint64_t)hi << 32);
        if (CANON == 1) {
            const uint64_t rc = rc_key(key, K);
            if (boss_rot(key, K) > boss_rot(rc, K))
                key = rc;
        }
        node = probe<W>(key, K, table, n_buckets);
        if (CANON == 2 && node == 0) {
            const int32_t r = probe<W>(rc_key(key, K), K, table, n_buckets);
            node = r > 0 ? r + offset : 0;
        }
    }
    nodes[tile * T + j] = node;
}

template <int W>
int launch(dim3 grid, dim3 block, cudaStream_t st, const uint32_t *w,
           const uint32_t *v, const uint32_t *t, int32_t *o, int nw, int nv,
           uint32_t nb, int K, int T, int canon, int32_t offset) {
    switch (canon) {
    case 0:
        wire_lookup_kernel<W, 0><<<grid, block, 0, st>>>(w, v, t, o, nw, nv,
                                                         nb, K, T, offset);
        break;
    case 1:
        wire_lookup_kernel<W, 1><<<grid, block, 0, st>>>(w, v, t, o, nw, nv,
                                                         nb, K, T, offset);
        break;
    case 2:
        wire_lookup_kernel<W, 2><<<grid, block, 0, st>>>(w, v, t, o, nw, nv,
                                                         nb, K, T, offset);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// words (n_tiles, nw), vwords (n_tiles, nv), table (n_buckets,
// 16 * (W + 1)) uint32 -> nodes (n_tiles, T) int32.  canon 0, 1 or 2 as in
// succinct/ops.py::wire_lookup_plain; offset is added to canon 2's reverse-
// complement hits.  The wrapper checks 2 <= K <= 31, T % 32 == 0, T <= 1024,
// nw >= T / 16 + 2 and nv * 32 >= T; the caller keeps ids + offset below
// 2^31 (convert.QueryIndex checks 2 * offset < 2^31).
extern "C" int mg_wire_lookup(const void *words, const void *vwords,
                              const void *table, void *nodes, int64_t n_tiles,
                              int32_t nw, int32_t nv, int64_t n_buckets,
                              int32_t K, int32_t T, int32_t canon,
                              int32_t offset, void *stream) {
    const dim3 grid((unsigned)n_tiles), block(T);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t *w = (const uint32_t *)words;
    const uint32_t *v = (const uint32_t *)vwords;
    const uint32_t *t = (const uint32_t *)table;
    int32_t *o = (int32_t *)nodes;
    const uint32_t nb = (uint32_t)n_buckets;
    switch ((K + 7) / 8) {
    case 1:
        return launch<1>(grid, block, st, w, v, t, o, nw, nv, nb, K, T, canon,
                         offset);
    case 2:
        return launch<2>(grid, block, st, w, v, t, o, nw, nv, nb, K, T, canon,
                         offset);
    case 3:
        return launch<3>(grid, block, st, w, v, t, o, nw, nv, nb, K, T, canon,
                         offset);
    case 4:
        return launch<4>(grid, block, st, w, v, t, o, nw, nv, nb, K, T, canon,
                         offset);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
