// Kernel A: packed k-mer keys -> node ids.
//
// Replaces the XLA program of metagraph_tpu/succinct/ops.py::
// DeviceHashIndex.lookup (:433) -> _hash_lookup_flat (:439), which the JAX
// query's execute_batch route runs on the keys that query/pipeline.py::
// _map_windows (:175-191) packs on the host: 4 bits a code for the DNA
// family, 8 bits for Protein, W words a key.
//
// What bounds it on an H100: the table's bytes, read at random, one bucket
// group of 64 (W + 1) / 4 bytes at least a probe, plus the keys and ids.
// Design, simple first: one thread a key; its W words, then the row's
// groups with 16-byte loads until the stop rule of hash_probe.cuh holds.
// W is a template parameter (1 .. 8).
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include "hash_probe.cuh"

namespace {

constexpr int THREADS = 256;

template <int W>
__global__ void __launch_bounds__(THREADS)
key_lookup_kernel(const uint32_t *__restrict__ keys,
                  const uint32_t *__restrict__ table,
                  int32_t *__restrict__ out, int64_t Q, uint32_t n_buckets) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= Q)
        return;
    uint32_t key[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
        key[w] = __ldg(keys + i * W + w);
    out[i] = (int32_t)hash_probe::probe<W>(table, key, n_buckets);
}

template <int W>
int launch(const void *keys, const void *table, void *out, int64_t Q,
           uint32_t nb, cudaStream_t st) {
    const unsigned blocks = (unsigned)((Q + THREADS - 1) / THREADS);
    key_lookup_kernel<W><<<blocks, THREADS, 0, st>>>(
        (const uint32_t *)keys, (const uint32_t *)table, (int32_t *)out, Q,
        nb);
    return (int)cudaGetLastError();
}

}  // namespace

// keys (Q, W) uint32, table (n_buckets, 16 * (W + 1)) uint32 -> out (Q,)
// int32.  The wrapper checks 1 <= W <= 8, Q >= 1, a 16-byte aligned table
// and n_buckets < 2^31.
extern "C" int mg_key_lookup(const void *keys, const void *table, void *out,
                             int64_t Q, int32_t W, int64_t n_buckets,
                             void *stream) {
    const uint32_t nb = (uint32_t)n_buckets;
    cudaStream_t st = (cudaStream_t)stream;
    switch (W) {
    case 1: return launch<1>(keys, table, out, Q, nb, st);
    case 2: return launch<2>(keys, table, out, Q, nb, st);
    case 3: return launch<3>(keys, table, out, Q, nb, st);
    case 4: return launch<4>(keys, table, out, Q, nb, st);
    case 5: return launch<5>(keys, table, out, Q, nb, st);
    case 6: return launch<6>(keys, table, out, Q, nb, st);
    case 7: return launch<7>(keys, table, out, Q, nb, st);
    case 8: return launch<8>(keys, table, out, Q, nb, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
