// The hash-table probe that kernels A (key_lookup.cu) and B
// (codes_lookup.cu) share.
//
// The table is metagraph_tpu/succinct/ops.py::DeviceHashIndex's: bucket b is
// one row of BUCKET slots, each W key words and an id; empty slots hold
// EMPTY in every word.  The bucket of a key is ops.py::_hash_words (:345)
// with salt 1.  A probe reads the row group by group (4 slots, W + 1 16-byte
// chunks a group) and stops after the first group that holds its key or an
// empty slot: the builders fill a bucket's slots from slot 0 and insert a
// key once (convert.QueryIndex checks the first), so no later slot can hold
// the key.  The id is the max over matching slots, as in _hash_lookup_flat
// (:439); a miss is 0.
//
// What bounds a probe on an H100: the latency of one random row read after
// another and the work around it, and where little work surrounds it (kernel
// A), device memory: against tables held in L2, kernel 1, whose probe this
// is, keeps about 77% of its time, kernel B 70%, kernel A 40% (PERF.md).
// So the probe is block-wide (probe_block), as kernel 1's:
// * every thread of a block of THREADS names its bucket (-1: no probe);
// * the block copies every probed row's group 0 into shared memory with
//   16-byte cp.async, consecutive threads on consecutive chunks of one row,
//   so a warp instruction touches a few rows rather than 32 and all of a
//   block's first reads are in flight at once;
// * each thread scans its own group there; a probe that needs a later group
//   loads it itself, its W + 1 loads issued before the compare, under the
//   same stop rule.
// A thread's group sits in the stage with its chunks in a swizzled order, so
// that the scan's 16-byte reads hit no bank twice for any W.
//
// probe_block keeps its key in registers and stages THREADS groups of
// 16 (W + 1) bytes in static shared memory, which fits 48 KB up to W = 17.
// Wider keys (k > 136 at 4 bits a code, k > 68 at 8 bits; the JAX package
// builds and queries any k) take probe_warp: a warp takes 32 keys, each
// lane hashes one (bucket_of_words: the hash is a chain over the words, so
// a lane a key keeps all 32 lanes busy), then the 32 lanes probe each key
// together: they read a group as consecutive words, each lane comparing
// its words with the key's words at the same place, and OR their
// mismatches and empty slots across the warp.  No lane holds a whole key,
// and no shared memory grows with W, so one kernel serves every width.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_probe {

constexpr int BUCKET = 16;      // slots per bucket row
constexpr int GROUP = 4;        // slots per group
// Probes per block: 128 beat 256 on kernel B by 4% and tied on A; 64, two
// probes a thread and a persistent grid did no better (PERF.md).
constexpr int THREADS = 128;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

__constant__ uint32_t HASH_C[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0x9E3779B9u,
                                   0x85EBCA6Bu, 0xC2B2AE35u};

// h % n_buckets; a power-of-two count, the only kind the builders make,
// takes a mask instead of a division.
template <int W>
__device__ __forceinline__ uint32_t bucket_of(const uint32_t (&key)[W],
                                              uint32_t n_buckets) {
    uint32_t h = 1u;                            // salt
#pragma unroll
    for (int w = 0; w < W; ++w) {
        h = (h ^ (key[w] * HASH_C[w % 8])) * 0x9E3779B1u;
        h ^= h >> 15;
    }
    return (n_buckets & (n_buckets - 1u)) ? h % n_buckets
                                          : h & (n_buckets - 1u);
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

// Where chunk u of thread t's group sits among its GC chunks.  Shared memory
// serves a warp's 16-byte reads 8 threads at a time; unswizzled, D =
// gcd(GC, 8) of those 8 groups start on the same bank.  XOR-ing u with the
// thread's rank among those D keeps u below GC (D divides GC) and gives
// each of them other banks.
template <int GC>
__device__ __forceinline__ int swizzle(int t, int u) {
    constexpr int D = GC % 8 == 0 ? 8 : GC % 4 == 0 ? 4 : GC % 2 == 0 ? 2 : 1;
    return u ^ ((t & 7) / (8 / D));
}

// One probe per thread of the block -> its id (0 = miss); bucket -1 reads no
// row and returns 0.  Every thread of the block calls it.
template <int W>
__device__ __forceinline__ uint32_t probe_block(
    const uint32_t *__restrict__ table, const uint32_t (&key)[W],
    int32_t bucket) {
    constexpr int GC = W + 1;                   // 16-byte chunks of a group
    constexpr int ROW = BUCKET * (W + 1);       // words of a bucket row
    __shared__ uint4 stage[THREADS * GC];
    __shared__ int32_t s_bucket[THREADS];
    s_bucket[threadIdx.x] = bucket;
    __syncthreads();
    for (int c = threadIdx.x; c < THREADS * GC; c += THREADS) {
        const int t = c / GC, u = c - t * GC;
        const int32_t b = s_bucket[t];
        if (b >= 0)
            cp_async16(stage + t * GC + swizzle<GC>(t, u),
                       table + (int64_t)b * ROW + 4 * u);
    }
    cp_async_wait_all();
    __syncthreads();
    uint32_t id = 0;
    if (bucket < 0)
        return id;
    uint32_t r[GROUP * GC];
#pragma unroll
    for (int u = 0; u < GC; ++u) {
        const uint4 x = stage[threadIdx.x * GC + swizzle<GC>(threadIdx.x, u)];
        r[4 * u] = x.x;
        r[4 * u + 1] = x.y;
        r[4 * u + 2] = x.z;
        r[4 * u + 3] = x.w;
    }
    bool stop = scan_group<W>(r, key, id);
    const uint4 *row = reinterpret_cast<const uint4 *>(
        table + (int64_t)bucket * ROW);
    for (int g = 1; !stop && g < BUCKET / GROUP; ++g) {
#pragma unroll
        for (int u = 0; u < GC; ++u) {
            const uint4 x = __ldg(row + g * GC + u);
            r[4 * u] = x.x;
            r[4 * u + 1] = x.y;
            r[4 * u + 2] = x.z;
            r[4 * u + 3] = x.w;
        }
        stop = scan_group<W>(r, key, id);
    }
    return id;
}

// The bucket of a key of W words, hashed by one thread; ``word(w)`` gives
// key word w.
template <class KeyWord>
__device__ __forceinline__ uint32_t bucket_of_words(const KeyWord &word,
                                                    int W,
                                                    uint32_t n_buckets) {
    uint32_t h = 1u;                            // salt
    for (int w = 0; w < W; ++w) {
        h = (h ^ (word(w) * HASH_C[w & 7])) * 0x9E3779B1u;
        h ^= h >> 15;
    }
    return (n_buckets & (n_buckets - 1u)) ? h % n_buckets
                                          : h & (n_buckets - 1u);
}

// One probe by a whole warp, for keys of any W: every lane of the warp
// calls it with the same bucket and key; ``word(w)`` gives key word w
// (0 <= w < W) to any lane that asks.  Lane l reads words l, l + 32, ...
// of each group it scans.  Returns the id (0 = miss) to every lane, under
// the stop rule of probe_block.
template <class KeyWord>
__device__ __forceinline__ uint32_t probe_warp(
    const uint32_t *__restrict__ table, uint32_t bucket, int W,
    const KeyWord &word) {
    constexpr unsigned FULL = 0xFFFFFFFFu;
    const int lane = threadIdx.x & 31;
    const int SW = W + 1, GW = GROUP * SW;      // words of a slot, a group
    const uint32_t *grp = table + (int64_t)bucket * BUCKET * SW;
    uint32_t id = 0;
    for (int g = 0; g < BUCKET / GROUP; ++g, grp += GW) {
        unsigned miss = 0u, empty = 0u;         // bit s: slot s of the group
        for (int p = lane, s = lane / SW, w = lane % SW; p < GW;
             p += 32, w += 32) {
            while (w >= SW) {
                w -= SW;
                ++s;
            }
            if (w < W) {
                const uint32_t x = __ldg(grp + p);
                if (x != word(w))
                    miss |= 1u << s;
                if (w == 0 && x == EMPTY)
                    empty |= 1u << s;
            }
        }
        const unsigned eq = ~__reduce_or_sync(FULL, miss) & 0xFu;
        empty = __reduce_or_sync(FULL, empty);
        for (int s = 0; s < GROUP; ++s)
            if (eq >> s & 1u)
                id = max(id, __ldg(grp + s * SW + W));
        if (eq | empty)
            break;
    }
    return id;
}

}  // namespace hash_probe
