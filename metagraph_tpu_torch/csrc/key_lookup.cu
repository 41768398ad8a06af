// Kernel A: packed k-mer keys -> node ids.
//
// Replaces the XLA program of metagraph_tpu/succinct/ops.py::
// DeviceHashIndex.lookup (:433) -> _hash_lookup_flat (:439), which the JAX
// query's execute_batch route runs on the keys that query/pipeline.py::
// _map_windows (:175-191) packs on the host: 4 bits a code for the DNA
// family, 8 bits for Protein, W words a key.
//
// What bounds it on an H100: device memory, read at random.  Every probe
// reads its bucket's group 0, 16 (W + 1) bytes (96 at W = 5, three 32-byte
// sectors) that no other probe nearby shares, and the keys stream once;
// against a table held in L2 it keeps only about 40% of its time (PERF.md).
// Design: a block takes THREADS consecutive keys and copies their THREADS x
// W words into shared memory in one coalesced pass, so each warp load
// instruction reads 128 contiguous bytes rather than 32 strided keys; each
// thread then hashes its key and the block probes with probe_block, which
// has group 0 of every probed row in flight at once.  A ragged last block
// probes with its first Q mod THREADS threads.  W is a template parameter
// (1 .. 17: the stage, the keys and a thread's key fit static shared memory
// and registers).
//
// Wider keys (W >= 18: k > 136 DNA, k > 68 Protein) take a second form
// (hash_probe.cuh's probe_warp), 32 consecutive keys a warp, 4 warps a
// block: each lane hashes one key, then the warp probes them one after
// another and lane j writes key j's id.  The lanes read a key's words from
// device memory when they need them, where L1 keeps its few lines, so no
// array grows with W and any W runs.
//
// A shard window serves parallel/sharding.py's query steps (:91, :177,
// :409), whose table is one shard's range of bucket rows: a key hashes
// modulo the index's true bucket count n_hash, and only a bucket in
// [row0, row0 + n_buckets) is probed, at row bucket - row0; any other key
// answers 0 (the step's ``in_range``).  The whole table is the window
// n_hash = n_buckets, row0 = 0.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include "hash_probe.cuh"

namespace {

using hash_probe::THREADS;

template <int W>
__global__ void __launch_bounds__(THREADS)
key_lookup_kernel(const uint32_t *__restrict__ keys,
                  const uint32_t *__restrict__ table,
                  int32_t *__restrict__ out, int64_t Q, uint32_t n_hash,
                  uint32_t row0, uint32_t n_buckets) {
    __shared__ uint32_t s_keys[THREADS * W];
    const int64_t base = (int64_t)blockIdx.x * THREADS;
    const int n = (int)min((int64_t)THREADS, Q - base);
    const uint32_t *src = keys + base * W;
    for (int i = threadIdx.x; i < n * W; i += THREADS)
        s_keys[i] = __ldg(src + i);
    __syncthreads();
    uint32_t key[W] = {};
    int32_t bucket = -1;
    if (threadIdx.x < n) {
#pragma unroll
        for (int w = 0; w < W; ++w)
            key[w] = s_keys[threadIdx.x * W + w];
        const uint32_t b = hash_probe::bucket_of<W>(key, n_hash) - row0;
        bucket = b < n_buckets ? (int32_t)b : -1;   // outside the window
    }
    const uint32_t id = hash_probe::probe_block<W>(table, key, bucket);
    if (threadIdx.x < n)
        out[base + threadIdx.x] = (int32_t)id;
}

struct KeyRow {
    const uint32_t *key;
    __device__ __forceinline__ uint32_t operator()(int w) const {
        return __ldg(key + w);
    }
};

constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
key_lookup_wide_kernel(const uint32_t *__restrict__ keys,
                       const uint32_t *__restrict__ table,
                       int32_t *__restrict__ out, int64_t Q, int W,
                       uint32_t n_hash, uint32_t row0, uint32_t n_buckets) {
    const int lane = threadIdx.x & 31;
    const int64_t q0 = ((int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5))
        * 32;
    if (q0 >= Q)
        return;                                 // the whole warp
    const int n = (int)min((int64_t)32, Q - q0);
    // a bucket outside the window wraps past n_buckets: no probe
    const uint32_t bucket = lane < n ? hash_probe::bucket_of_words(
        KeyRow{keys + (q0 + lane) * W}, W, n_hash) - row0 : 0u;
    uint32_t mine = 0;
    for (int j = 0; j < n; ++j) {
        const uint32_t b = __shfl_sync(0xFFFFFFFFu, bucket, j);
        if (b >= n_buckets)
            continue;                           // the whole warp
        const uint32_t id = hash_probe::probe_warp(
            table, b, W, KeyRow{keys + (q0 + j) * W});
        if (lane == j)
            mine = id;
    }
    if (lane < n)
        out[q0 + lane] = (int32_t)mine;
}

template <int W>
int launch(const void *keys, const void *table, void *out, int64_t Q,
           uint32_t nh, uint32_t r0, uint32_t nb, cudaStream_t st) {
    const unsigned blocks = (unsigned)((Q + THREADS - 1) / THREADS);
    key_lookup_kernel<W><<<blocks, THREADS, 0, st>>>(
        (const uint32_t *)keys, (const uint32_t *)table, (int32_t *)out, Q,
        nh, r0, nb);
    return (int)cudaGetLastError();
}

}  // namespace

// keys (Q, W) uint32, table (n_buckets, 16 * (W + 1)) uint32 -> out (Q,)
// int32; keys hash modulo n_hash and probe row bucket - row0 where that
// lies in the table (the window above).  The wrapper checks W >= 1, Q >= 1,
// a 16-byte aligned table, n_buckets and n_hash < 2^31 and 0 <= row0.
extern "C" int mg_key_lookup(const void *keys, const void *table, void *out,
                             int64_t Q, int32_t W, int64_t n_buckets,
                             int64_t n_hash, int64_t row0, void *stream) {
    const uint32_t nb = (uint32_t)n_buckets, nh = (uint32_t)n_hash,
                   r0 = (uint32_t)row0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (W) {
    case 1: return launch<1>(keys, table, out, Q, nh, r0, nb, st);
    case 2: return launch<2>(keys, table, out, Q, nh, r0, nb, st);
    case 3: return launch<3>(keys, table, out, Q, nh, r0, nb, st);
    case 4: return launch<4>(keys, table, out, Q, nh, r0, nb, st);
    case 5: return launch<5>(keys, table, out, Q, nh, r0, nb, st);
    case 6: return launch<6>(keys, table, out, Q, nh, r0, nb, st);
    case 7: return launch<7>(keys, table, out, Q, nh, r0, nb, st);
    case 8: return launch<8>(keys, table, out, Q, nh, r0, nb, st);
    case 9: return launch<9>(keys, table, out, Q, nh, r0, nb, st);
    case 10: return launch<10>(keys, table, out, Q, nh, r0, nb, st);
    case 11: return launch<11>(keys, table, out, Q, nh, r0, nb, st);
    case 12: return launch<12>(keys, table, out, Q, nh, r0, nb, st);
    case 13: return launch<13>(keys, table, out, Q, nh, r0, nb, st);
    case 14: return launch<14>(keys, table, out, Q, nh, r0, nb, st);
    case 15: return launch<15>(keys, table, out, Q, nh, r0, nb, st);
    case 16: return launch<16>(keys, table, out, Q, nh, r0, nb, st);
    case 17: return launch<17>(keys, table, out, Q, nh, r0, nb, st);
    default:
        if (W < 18)
            return (int)cudaErrorInvalidValue;
        key_lookup_wide_kernel<<<(unsigned)((Q + 32 * WARPS - 1)
                                            / (32 * WARPS)), THREADS,
                                 0, st>>>((const uint32_t *)keys,
                                          (const uint32_t *)table,
                                          (int32_t *)out, Q, W, nh, r0,
                                          nb);
        return (int)cudaGetLastError();
    }
}
