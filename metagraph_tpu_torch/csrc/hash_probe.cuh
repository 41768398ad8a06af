// The hash-table probe that kernels A (key_lookup.cu) and B
// (codes_lookup.cu) share.
//
// The table is metagraph_tpu/succinct/ops.py::DeviceHashIndex's: bucket b is
// one row of BUCKET slots, each W key words and an id; empty slots hold
// EMPTY in every word.  The bucket of a key is ops.py::_hash_words (:345)
// with salt 1.  A probe reads the row group by group (4 slots, W + 1 16-byte
// loads a group) and stops after the first group that holds its key or an
// empty slot: the builders fill a bucket's slots from slot 0 and insert a
// key once (convert.QueryIndex checks the first), so no later slot can hold
// the key.  The id is the max over matching slots, as in _hash_lookup_flat
// (:439); a miss is 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_probe {

constexpr int BUCKET = 16;      // slots per bucket row
constexpr int GROUP = 4;        // slots per group
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

__constant__ uint32_t HASH_C[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0x9E3779B9u,
                                   0x85EBCA6Bu, 0xC2B2AE35u};

template <int W>
__device__ __forceinline__ uint32_t bucket_of(const uint32_t (&key)[W],
                                              uint32_t n_buckets) {
    uint32_t h = 1u;                            // salt
#pragma unroll
    for (int w = 0; w < W; ++w) {
        h = (h ^ (key[w] * HASH_C[w % 8])) * 0x9E3779B1u;
        h ^= h >> 15;
    }
    return h % n_buckets;
}

// One group of slots (GROUP * (W + 1) words); true when the probe stops
// here, because the group holds the key or an empty slot.
template <int W>
__device__ __forceinline__ bool scan_group(const uint32_t *r,
                                           const uint32_t (&key)[W],
                                           uint32_t &id) {
    bool stop = false;
#pragma unroll
    for (int s = 0; s < GROUP; ++s) {
        const uint32_t *slot = r + s * (W + 1);
        bool eq = true;
#pragma unroll
        for (int w = 0; w < W; ++w)
            eq &= slot[w] == key[w];
        if (eq)
            id = max(id, slot[W]);
        stop |= eq || slot[0] == EMPTY;
    }
    return stop;
}

// The id of ``key`` (0 = miss).  A bucket row is BUCKET * (W + 1) words =
// 64 (W + 1) bytes, so with a 16-byte aligned table every group starts on a
// 16-byte boundary.
template <int W>
__device__ __forceinline__ uint32_t probe(const uint32_t *__restrict__ table,
                                          const uint32_t (&key)[W],
                                          uint32_t n_buckets) {
    constexpr int GC = W + 1;                   // 16-byte chunks of a group
    const uint4 *row = reinterpret_cast<const uint4 *>(
        table + (int64_t)bucket_of<W>(key, n_buckets) * BUCKET * (W + 1));
    uint32_t id = 0;
    uint32_t r[GROUP * (W + 1)];
#pragma unroll 1
    for (int g = 0; g < BUCKET / GROUP; ++g) {
#pragma unroll
        for (int u = 0; u < GC; ++u) {
            const uint4 x = __ldg(row + g * GC + u);
            r[4 * u] = x.x;
            r[4 * u + 1] = x.y;
            r[4 * u + 2] = x.z;
            r[4 * u + 3] = x.w;
        }
        if (scan_group<W>(r, key, id))
            break;
    }
    return id;
}

}  // namespace hash_probe
