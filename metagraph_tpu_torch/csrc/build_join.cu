// Kernel D3 of the device construction: dedupe and the sort-join that
// finds the dummy sink and level-1 source nodes.
//
// Replaces metagraph_tpu/succinct/device_build.py::_build_p1 :195-229.
// Its two launches sit on either side of the join sort (kernel D2):
//
// * mg_join_entries, on the sorted wire keys s (the sentinel 1 << 2K
//   last): uniq[i] = s[i] is no sentinel and differs from s[i-1]; U = the
//   number of such rows; and the join entries of each unique edge, its
//   source node (characters 0..K-2: s & (4^(K-1) - 1)) with tag 0 at i
//   and its target node (characters 1..K-1: s >> 2) with tag 1 at n + i,
//   each as one int64 node << 2 | tag.  A row that is not unique gives
//   the sentinel 1 << 2K twice, which sorts after every entry.
// * mg_join_nodes, on the sorted entries: a run is the entries of one
//   node, at most 4 sources and 4 targets, sources first.  A run that
//   starts with a target has no source: its node is a dummy SINK (the
//   TPU's first_tgt & ~has_src).  A run that ends with a source has no
//   target: its node is a level-1 dummy SOURCE (src1).  Neither needs the
//   TPU's cummax/cummin over the whole stream: each is one neighbour
//   test.  Each such node is appended to its list by a warp-aggregated
//   atomic (the list's order is the caller's: it sorts them with D2), up
//   to ``cap`` entries; the counts are exact past it.
//
// What bounds it on an H100: bytes.  The first launch reads 8 bytes and
// writes 17 a key; the second reads 8 an entry (and its neighbours from
// L1) and writes only the few nodes found.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using lookback::lanemask_lt;
typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
join_entries_kernel(const long long *__restrict__ s, int64_t n, int K,
                    uint8_t *__restrict__ uniq, long long *__restrict__ J,
                    u64 *__restrict__ U) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    const long long sent = 1ll << (2 * K);
    bool u = false;
    if (i < n) {
        const long long k = __ldg(s + i);
        u = k != sent && (i == 0 || __ldg(s + i - 1) != k);
        uniq[i] = u;
        const long long node_mask = (1ll << (2 * (K - 1))) - 1;
        J[i] = u ? (k & node_mask) << 2 : sent;
        J[n + i] = u ? ((k >> 2) << 2) | 1 : sent;
    }
    __shared__ unsigned block_u;
    if (threadIdx.x == 0) block_u = 0;
    __syncthreads();
    const unsigned b = __ballot_sync(FULL, u);
    if ((threadIdx.x & 31) == 0 && b) atomicAdd(&block_u, __popc(b));
    __syncthreads();
    if (threadIdx.x == 0 && block_u) atomicAdd(U, (u64)block_u);
}

// Append ``node`` where ``take``: one atomic a warp on counts[which].
__device__ __forceinline__ void append(bool take, long long node,
                                       u64 *count, long long *list,
                                       int64_t cap) {
    const unsigned b = __ballot_sync(FULL, take);
    if (!b) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(b) - 1;
    u64 base = 0;
    if (lane == leader) base = atomicAdd(count, (u64)__popc(b));
    base = __shfl_sync(FULL, base, leader);
    if (take) {
        const u64 slot = base + __popc(b & lanemask_lt());
        if (slot < (u64)cap) list[slot] = node;
    }
}

__global__ void __launch_bounds__(THREADS)
join_nodes_kernel(const long long *__restrict__ J, int64_t m, int K,
                  int64_t cap, long long *__restrict__ sink,
                  long long *__restrict__ src1, u64 *__restrict__ counts) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    const long long sent = 1ll << (2 * K);
    bool is_sink = false, is_src1 = false;
    long long node = 0;
    if (i < m) {
        const long long e = __ldg(J + i);
        if (e != sent) {
            node = e >> 2;
            const int tag = (int)(e & 3);
            const bool starts = i == 0 || (__ldg(J + i - 1) >> 2) != node;
            const bool ends = i == m - 1 || (__ldg(J + i + 1) >> 2) != node;
            is_sink = tag == 1 && starts;
            is_src1 = tag == 0 && ends;
        }
    }
    append(is_sink, node, counts, sink, cap);
    append(is_src1, node, counts + 1, src1, cap);
}

}  // namespace

extern "C" {

// n sorted wire keys -> uniq (n,) uint8, J (2n,) int64 entries; adds the
// unique count to *U (an int64 the caller zeroed).
int mg_join_entries(const void *s, int64_t n, int K, void *uniq, void *J,
                    void *U, void *stream) {
    if (n <= 0) return 0;
    join_entries_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                          0, (cudaStream_t)stream>>>(
        (const long long *)s, n, K, (uint8_t *)uniq, (long long *)J,
        (u64 *)U);
    return (int)cudaGetLastError();
}

// m sorted join entries -> up to ``cap`` sink and src1 nodes each, and
// counts[0] / counts[1] (int64, zeroed by the caller) = their exact counts.
int mg_join_nodes(const void *J, int64_t m, int K, int64_t cap, void *sink,
                  void *src1, void *counts, void *stream) {
    if (m <= 0) return 0;
    join_nodes_kernel<<<(unsigned)((m + THREADS - 1) / THREADS), THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const long long *)J, m, K, cap, (long long *)sink,
        (long long *)src1, (u64 *)counts);
    return (int)cudaGetLastError();
}

}  // extern "C"
