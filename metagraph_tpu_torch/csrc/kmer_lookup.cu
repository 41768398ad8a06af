// Kernel K1: sorted multiword k-mer keys -> ids, by binary search.
//
// Replaces the XLA program of metagraph_tpu/succinct/ops.py::_kmer_lookup
// (:313), which DeviceKmerIndex.lookup (:303) and each shard of
// parallel/sharding.py::sharded_lookup_fn (:233) run: a lower-bound search
// of the (Q, W) packed queries over the (N, W) keys, sorted as rows of
// unsigned 32-bit words, ``steps`` = ceil(log2(N + 1)) halvings (at least
// one) in lockstep, then the equality test at the clipped position and its
// id (0 where absent).
//
// Design: one thread a query, its W words in registers (W <= 8, a template
// parameter; wider keys read the query's words from device memory, where
// L1 keeps them).  Every step reads one key row at a data-dependent place,
// so the search is a chain of ``steps`` dependent loads a query; the first
// steps of all queries read the same few rows, which L2 and L1 serve.  The
// loop keeps JAX's arithmetic exactly (mid clipped to [0, N - 1], lo
// running past N where the query sorts after every key), so the answer is
// the JAX answer for every input, duplicates and unsorted keys included.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// a < b as rows of unsigned words; ``q(w)`` gives query word w
template <class Query>
__device__ __forceinline__ bool row_less(const uint32_t *__restrict__ a,
                                         const Query &q, int W) {
    for (int w = 0; w < W; ++w) {
        const uint32_t x = __ldg(a + w), y = q(w);
        if (x != y)
            return x < y;
    }
    return false;
}

template <class Query>
__device__ __forceinline__ bool row_eq(const uint32_t *__restrict__ a,
                                       const Query &q, int W) {
    for (int w = 0; w < W; ++w)
        if (__ldg(a + w) != q(w))
            return false;
    return true;
}

template <int W>
struct RegQuery {
    uint32_t v[W];
    __device__ __forceinline__ uint32_t operator()(int w) const {
        return v[w];
    }
};

struct MemQuery {
    const uint32_t *p;
    __device__ __forceinline__ uint32_t operator()(int w) const {
        return __ldg(p + w);
    }
};

template <class Query>
__device__ __forceinline__ int32_t search(const uint32_t *__restrict__ keys,
                                          const int32_t *__restrict__ ids,
                                          const Query &q, int64_t N, int W,
                                          int steps) {
    int64_t lo = 0, hi = N;
    for (int s = 0; s < steps; ++s) {
        const int64_t mid = (lo + hi) >> 1;
        const int64_t m = mid < 0 ? 0 : (mid > N - 1 ? N - 1 : mid);
        if (row_less(keys + m * W, q, W))
            lo = mid + 1;
        else
            hi = mid;
    }
    const int64_t pos = lo < 0 ? 0 : (lo > N - 1 ? N - 1 : lo);
    return (lo < N && row_eq(keys + pos * W, q, W)) ? __ldg(ids + pos) : 0;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
kmer_lookup_kernel(const uint32_t *__restrict__ keys,
                   const int32_t *__restrict__ ids,
                   const uint32_t *__restrict__ queries,
                   int32_t *__restrict__ out, int64_t N, int64_t Q,
                   int steps) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= Q)
        return;
    RegQuery<W> q;
#pragma unroll
    for (int w = 0; w < W; ++w)
        q.v[w] = __ldg(queries + i * W + w);
    out[i] = search(keys, ids, q, N, W, steps);
}

__global__ void __launch_bounds__(THREADS)
kmer_lookup_wide_kernel(const uint32_t *__restrict__ keys,
                        const int32_t *__restrict__ ids,
                        const uint32_t *__restrict__ queries,
                        int32_t *__restrict__ out, int64_t N, int64_t Q,
                        int W, int steps) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= Q)
        return;
    out[i] = search(keys, ids, MemQuery{queries + i * W}, N, W, steps);
}

template <int W>
int launch(const void *keys, const void *ids, const void *queries, void *out,
           int64_t N, int64_t Q, int steps, cudaStream_t st) {
    kmer_lookup_kernel<W><<<(unsigned)((Q + THREADS - 1) / THREADS), THREADS,
                            0, st>>>((const uint32_t *)keys,
                                     (const int32_t *)ids,
                                     (const uint32_t *)queries,
                                     (int32_t *)out, N, Q, steps);
    return (int)cudaGetLastError();
}

}  // namespace

// keys (N, W) uint32 sorted, ids (N,) int32, queries (Q, W) uint32 ->
// out (Q,) int32.  The wrapper checks N >= 1, Q >= 1, W >= 1 and steps.
extern "C" int mg_kmer_lookup(const void *keys, const void *ids,
                              const void *queries, void *out, int64_t N,
                              int64_t Q, int32_t W, int32_t steps,
                              void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (W) {
    case 1: return launch<1>(keys, ids, queries, out, N, Q, steps, st);
    case 2: return launch<2>(keys, ids, queries, out, N, Q, steps, st);
    case 3: return launch<3>(keys, ids, queries, out, N, Q, steps, st);
    case 4: return launch<4>(keys, ids, queries, out, N, Q, steps, st);
    case 5: return launch<5>(keys, ids, queries, out, N, Q, steps, st);
    case 6: return launch<6>(keys, ids, queries, out, N, Q, steps, st);
    case 7: return launch<7>(keys, ids, queries, out, N, Q, steps, st);
    case 8: return launch<8>(keys, ids, queries, out, N, Q, steps, st);
    default:
        if (W < 1)
            return (int)cudaErrorInvalidValue;
        kmer_lookup_wide_kernel<<<(unsigned)((Q + THREADS - 1) / THREADS),
                                  THREADS, 0, st>>>(
            (const uint32_t *)keys, (const int32_t *)ids,
            (const uint32_t *)queries, (int32_t *)out, N, Q, W, steps);
        return (int)cudaGetLastError();
    }
}
