// Kernel B: 2-bit code tiles -> node ids, for basic DNA graphs of any k up
// to 64.
//
// Replaces the front end of metagraph_tpu/query/device.py::
// query_epoch_codes2 (:297-306): the unpack of the 2-bit codes and valid
// bits, succinct/ops.py::device_pack_windows (:462-490: each window's
// nibble key in BOSS priority order, chars K-2 .. 0 then K-1, code + 1 a
// nibble; an invalid position invalidates its windows) and the probe of
// _hash_lookup_flat (:439).  Label counting and selection stay with kernels
// 2 and 3.
//
// What bounds it on an H100: the table's bytes at random, as kernel A; the
// tiles are 2.25 bits a position.  Design, simple first: one block a tile,
// one thread a window.  The block copies its tile's code bytes and valid
// bytes into shared memory; each thread checks its K valid bits, builds
// its key from shared memory and probes as kernel A does (hash_probe.cuh).
// Invalid windows read no row.  W = ceil(K / 8) is a template parameter
// (1 .. 8).
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include "hash_probe.cuh"

namespace {

// K positions from j: true iff each one's valid bit is set
__device__ __forceinline__ bool window_valid(const uint8_t *vb, int j, int K) {
    for (int p = j; p < j + K; ++p)
        if (!((vb[p >> 3] >> (p & 7)) & 1))
            return false;
    return true;
}

template <int W>
__global__ void codes_lookup_kernel(const uint8_t *__restrict__ packed2,
                                    const uint8_t *__restrict__ validb,
                                    const uint32_t *__restrict__ table,
                                    int32_t *__restrict__ nodes, int pb,
                                    int vbn, uint32_t n_buckets, int K,
                                    int T) {
    extern __shared__ uint8_t smem[];
    uint8_t *codes = smem;                      // pb bytes
    uint8_t *vb = smem + pb;                    // vbn bytes
    const int64_t tile = blockIdx.x;
    for (int i = threadIdx.x; i < pb; i += blockDim.x)
        codes[i] = packed2[tile * pb + i];
    for (int i = threadIdx.x; i < vbn; i += blockDim.x)
        vb[i] = validb[tile * vbn + i];
    __syncthreads();
    const int j = threadIdx.x;                  // blockDim.x == T
    uint32_t id = 0;
    if (window_valid(vb, j, K)) {
        uint32_t key[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
            uint32_t acc = 0;
#pragma unroll
            for (int slot = 0; slot < 8; ++slot) {
                const int p = w * 8 + slot;     // priority index
                if (p < K) {
                    const int c = j + (p < K - 1 ? K - 2 - p : K - 1);
                    const uint32_t code = (codes[c >> 2] >> (2 * (c & 3))) & 3u;
                    acc |= (code + 1u) << (28 - 4 * slot);
                }
            }
            key[w] = acc;
        }
        id = hash_probe::probe<W>(table, key, n_buckets);
    }
    nodes[tile * T + j] = (int32_t)id;
}

template <int W>
int launch(const void *p2, const void *vb, const void *table, void *nodes,
           int64_t n_tiles, int pb, int vbn, uint32_t nb, int K, int T,
           cudaStream_t st) {
    codes_lookup_kernel<W><<<(unsigned)n_tiles, T, pb + vbn, st>>>(
        (const uint8_t *)p2, (const uint8_t *)vb, (const uint32_t *)table,
        (int32_t *)nodes, pb, vbn, nb, K, T);
    return (int)cudaGetLastError();
}

}  // namespace

// packed2 (n_tiles, pb) and validb (n_tiles, vbn) uint8 (tile_pack2's
// layout), table (n_buckets, 16 * (W + 1)) uint32 with W = ceil(K / 8) ->
// nodes (n_tiles, T) int32.  The wrapper checks 2 <= K, 1 <= W <= 8,
// T % 32 == 0, 32 <= T <= 1024, 4 pb >= T + K - 1, 8 vbn >= T + K - 1,
// 1 <= n_tiles < 2^31, a 16-byte aligned table and n_buckets < 2^31.
extern "C" int mg_codes_lookup(const void *packed2, const void *validb,
                               const void *table, void *nodes,
                               int64_t n_tiles, int32_t pb, int32_t vbn,
                               int64_t n_buckets, int32_t K, int32_t T,
                               void *stream) {
    const uint32_t nb = (uint32_t)n_buckets;
    cudaStream_t st = (cudaStream_t)stream;
    switch ((K + 7) / 8) {
    case 1: return launch<1>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 2: return launch<2>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 3: return launch<3>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 4: return launch<4>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 5: return launch<5>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 6: return launch<6>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 7: return launch<7>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 8: return launch<8>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
