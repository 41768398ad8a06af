// Kernel B: 2-bit code tiles -> node ids, for basic DNA graphs of any k.
//
// Replaces the front end of metagraph_tpu/query/device.py::
// query_epoch_codes2 (:297-306): the unpack of the 2-bit codes and valid
// bits, succinct/ops.py::device_pack_windows (:462-490: each window's
// nibble key in BOSS priority order, chars K-2 .. 0 then K-1, code + 1 a
// nibble; an invalid position invalidates its windows) and the probe of
// _hash_lookup_flat (:439).  Label counting and selection stay with kernels
// 2 and 3.
//
// What bounds it on an H100: per-window work and the latency of the random
// bucket reads, not bytes: against a table held in L2 it keeps about 70% of
// its time (PERF.md).  So each window costs O(1) arithmetic whatever K (a
// first version with loops over the K positions and a probe of its own took
// 1.7x as long), and the probe is block-wide:
// * One block a tile.  The block copies the tile's code bytes and valid
//   bytes into word-aligned shared memory as the aligned 4-byte words that
//   hold them (rows of TKp/4 and ceil(TK/8) bytes start at any byte); the
//   row's misalignment is added to every bit offset instead of shifting the
//   bytes.
// * Validity: bits j .. j+K-1 of the valid words, taken into 64 bits with
//   two funnel shifts, against the K-bit mask (K <= 64 on the card).
// * Key: the 128 stream bits that end with char K-2, taken with four funnel
//   shifts, hold chars K-2 .. 0 from the top down, the BOSS priority order of
//   key positions 0 .. K-2; so key word w is one 16-bit half of them, spread
//   to nibbles by three shift-and-mask steps, plus 1 in each nibble.  Char
//   K-1 goes to slot (K-1) mod 8 of the last word.
// * Probe: the tile's THREADS windows probe together (hash_probe.cuh's
//   probe_block: group 0 of every probed row staged by cp.async).  Invalid
//   windows read no row.  Tiles wider than THREADS windows take rounds.
// W = ceil(K / 8) is a template parameter (1 .. 17).
//
// 64 < K <= 136 (W = 9 .. 17) keeps this form with two steps that grow with
// K: validity over ceil(K / 64) 64-bit masks (window_valid_long), and the
// key a word at a time (WideKeyWord: word w is chars K-2-8w .. K-9-8w, one
// 16-bit run of the stream taken by one funnel shift and spread to nibbles
// as above; the last word takes char K-1 as in window_key), W funnel shifts
// in all.  The static stage holds TK <= 1,159 (T <= 1024, K <= 136).
//
// K > 136 takes a third form, a warp a window (hash_probe.cuh's
// probe_warp), whose shared memory and registers do not grow with K:
// * Stage: the same rows, in dynamic shared memory sized for TK
//   (codes_stage_words); above 48 KB (K past about 130,000) the launch asks
//   for more, up to the SM's 227 KB.
// * The block's 4 warps take the tile's windows 32 at a time: lane l tests
//   window l's validity (32 valid bits at a time) and hashes its key, a word
//   at a time (WideKeyWord), then the warp probes the valid windows one
//   after another, a lane computing word w of the key when the probe asks
//   for it, so no lane holds a key.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include "hash_probe.cuh"

namespace {

using hash_probe::THREADS;

constexpr int LEAD = 4;            // zero words before a tile's codes
// Words of a staged tile at T <= 1024, K <= 136 (TK <= 1,159), any
// alignment: LEAD + 74 words of codes + the words that window T-1's key
// reads last.
constexpr int CODE_WORDS = 80;
constexpr int VALID_WORDS = 40;    // 37 words of valid bits + 2 read past

// The aligned 4-byte words that hold ``nbytes`` bytes from ``row`` (any
// alignment) -> dst[lead ..], zeros before and after, up to ``cap`` words;
// returns the row's offset in bytes from its first word.  Every word read
// holds a byte of the row, so no read leaves the tensor's allocation.
__device__ __forceinline__ int stage_row(const uint8_t *row, int nbytes,
                                         uint32_t *dst, int lead, int cap) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row);
    const uint32_t *src =
        reinterpret_cast<const uint32_t *>(a & ~(uintptr_t)3);
    const int mis = (int)(a & 3);
    const int n = (mis + nbytes + 3) >> 2;
    for (int i = threadIdx.x; i < cap; i += THREADS) {
        const int k = i - lead;
        dst[i] = (k >= 0 && k < n) ? __ldg(src + k) : 0u;
    }
    return mis;
}

// Window at valid bit ``vo``: true iff bits vo .. vo+K-1 are all set.
__device__ __forceinline__ bool window_valid(const uint32_t *__restrict__ sv,
                                             int vo, int K) {
    const int g = vo >> 5, sh = vo & 31;
    const uint64_t v = (uint64_t)__funnelshift_r(sv[g], sv[g + 1], sh)
        | (uint64_t)__funnelshift_r(sv[g + 1], sv[g + 2], sh) << 32;
    const uint64_t need = K >= 64 ? ~0ull : (1ull << K) - 1ull;
    return (v & need) == need;
}

// The nibble key, in BOSS priority order, of the window whose char 0 sits at
// bit ``b0`` of the staged codes (char i at bits b0 + 2i).
template <int W>
__device__ __forceinline__ void window_key(const uint32_t *__restrict__ sc,
                                           int b0, int K, uint32_t (&key)[W]) {
    // u[3]:u[2]:u[1]:u[0] = bits o .. o+127, char K-2 at the top two bits,
    // then K-3 .. 0 down to bit 130 - 2K; the bits below belong to earlier
    // chars (LEAD keeps o >= 0) and land in the last word's empty slots
    const int o = b0 + 2 * K - 130;
    const int g = o >> 5, sh = o & 31;
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        u[i] = __funnelshift_r(sc[g + i], sc[g + i + 1], sh);
    const uint32_t last = (sc[g + 4] >> sh) & 3u;   // char K-1, just above
    const int r = (K - 1) & 7;                      // its slot
#pragma unroll
    for (int w = 0; w < W; ++w) {
        // positions 8w .. 8w+7: chars K-2-8w .. K-9-8w, one 16-bit half
        uint32_t x = (u[3 - (w >> 1)] >> ((w & 1) ? 0 : 16)) & 0xFFFFu;
        x = (x | x << 8) & 0x00FF00FFu;
        x = (x | x << 4) & 0x0F0F0F0Fu;
        x = (x | x << 2) & 0x33333333u;            // 2-bit code a nibble
        x += 0x11111111u;                           // code + 1
        if (w == W - 1) {
            // only positions < K-1 hold chars K-2 .. 0; then char K-1
            const uint32_t keep = r ? 0xFFFFFFFFu << (32 - 4 * r) : 0u;
            x = (x & keep) | (last + 1u) << (28 - 4 * r);
        }
        key[w] = x;
    }
}

// One 32-bit key word of the window whose char 0 sits at bit ``b0`` of the
// staged codes (W = ceil(K / 8) words).
struct WideKeyWord {
    const uint32_t *sc;
    int b0, K, W;
    __device__ __forceinline__ uint32_t operator()(int w) const {
        // positions 8w .. 8w+7: chars K-2-8w down to K-9-8w, char K-9-8w at
        // the run's low bits (LEAD keeps the last word's offset >= 0)
        const int o = b0 + 2 * (K - 9 - 8 * w);
        uint32_t x = __funnelshift_r(sc[o >> 5], sc[(o >> 5) + 1], o & 31)
            & 0xFFFFu;
        x = (x | x << 8) & 0x00FF00FFu;
        x = (x | x << 4) & 0x0F0F0F0Fu;
        x = (x | x << 2) & 0x33333333u;
        x += 0x11111111u;
        if (w == W - 1) {
            const int r = K - 1 - 8 * w;            // char K-1's slot
            const uint32_t keep = r ? 0xFFFFFFFFu << (32 - 4 * r) : 0u;
            const int ol = b0 + 2 * (K - 1);
            const uint32_t last = (sc[ol >> 5] >> (ol & 31)) & 3u;
            x = (x & keep) | (last + 1u) << (28 - 4 * r);
        }
        return x;
    }
};

// Window at valid bit ``vo``, K > 64: true iff bits vo .. vo+K-1 are all
// set, 64 at a time.
__device__ __forceinline__ bool window_valid_long(
    const uint32_t *__restrict__ sv, int vo, int K) {
    bool ok = true;
    for (int c = 0; c < K; c += 64) {
        const int g = (vo + c) >> 5, sh = (vo + c) & 31;
        const uint64_t v = (uint64_t)__funnelshift_r(sv[g], sv[g + 1], sh)
            | (uint64_t)__funnelshift_r(sv[g + 1], sv[g + 2], sh) << 32;
        const uint64_t need = K - c >= 64 ? ~0ull : (1ull << (K - c)) - 1ull;
        ok &= (v & need) == need;
    }
    return ok;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
codes_lookup_kernel(const uint8_t *__restrict__ packed2,
                    const uint8_t *__restrict__ validb,
                    const uint32_t *__restrict__ table,
                    int32_t *__restrict__ nodes, int pb, int vbn,
                    uint32_t n_buckets, int K, int T) {
    __shared__ uint32_t sc[CODE_WORDS];
    __shared__ uint32_t sv[VALID_WORDS];
    const int64_t tile = blockIdx.x;
    const int TK = T + K - 1;
    const int cmis = stage_row(packed2 + tile * pb, (TK + 3) >> 2, sc, LEAD,
                               CODE_WORDS);
    const int vmis = stage_row(validb + tile * vbn, (TK + 7) >> 3, sv, 0,
                               VALID_WORDS);
    __syncthreads();
    for (int j0 = 0; j0 < T; j0 += THREADS) {
        const int j = j0 + threadIdx.x;
        uint32_t key[W] = {};
        int32_t bucket = -1;
        const int b0 = 32 * LEAD + 8 * cmis + 2 * j;
        if constexpr (W <= 8) {
            if (j < T && window_valid(sv, 8 * vmis + j, K)) {
                window_key<W>(sc, b0, K, key);
                bucket = (int32_t)hash_probe::bucket_of<W>(key, n_buckets);
            }
        } else if (j < T && window_valid_long(sv, 8 * vmis + j, K)) {
            const WideKeyWord word{sc, b0, K, W};
#pragma unroll
            for (int w = 0; w < W; ++w)
                key[w] = word(w);
            bucket = (int32_t)hash_probe::bucket_of<W>(key, n_buckets);
        }
        const uint32_t id = hash_probe::probe_block<W>(table, key, bucket);
        if (j < T)
            nodes[tile * T + j] = (int32_t)id;
    }
}

constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
codes_lookup_wide_kernel(const uint8_t *__restrict__ packed2,
                         const uint8_t *__restrict__ validb,
                         const uint32_t *__restrict__ table,
                         int32_t *__restrict__ nodes, int pb, int vbn,
                         uint32_t n_buckets, int K, int T, int code_words,
                         int valid_words) {
    extern __shared__ uint32_t smem[];
    uint32_t *sc = smem, *sv = smem + code_words;
    const int64_t tile = blockIdx.x;
    const int TK = T + K - 1, W = (K + 7) / 8, lane = threadIdx.x & 31;
    const int cmis = stage_row(packed2 + tile * pb, (TK + 3) >> 2, sc, LEAD,
                               code_words);
    const int vmis = stage_row(validb + tile * vbn, (TK + 7) >> 3, sv, 0,
                               valid_words);
    __syncthreads();
    for (int j0 = 32 * (threadIdx.x >> 5); j0 < T; j0 += 32 * WARPS) {
        const int j = j0 + lane;
        bool ok = j < T;
        for (int c = 0; ok && c < K; c += 32) {
            const int o = 8 * vmis + j + c;
            const int n = min(32, K - c);
            const uint32_t need = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
            ok = (__funnelshift_r(sv[o >> 5], sv[(o >> 5) + 1], o & 31)
                  & need) == need;
        }
        const int b0 = 32 * LEAD + 8 * cmis + 2 * j;
        const uint32_t bucket = ok ? hash_probe::bucket_of_words(
            WideKeyWord{sc, b0, K, W}, W, n_buckets) : 0u;
        unsigned todo = __ballot_sync(0xFFFFFFFFu, ok);
        uint32_t mine = 0;
        while (todo) {
            const int i = __ffs(todo) - 1;
            todo &= todo - 1;
            const uint32_t id = hash_probe::probe_warp(
                table, __shfl_sync(0xFFFFFFFFu, bucket, i), W,
                WideKeyWord{sc, b0 - 2 * lane + 2 * i, K, W});
            if (lane == i)
                mine = id;
        }
        if (j < T)
            nodes[tile * T + j] = (int32_t)mine;
    }
}

// Staged words of the warp form: (codes, valid bits) for any alignment,
// with the words that the last window reads past its row.
__host__ __device__ inline void codes_stage_words(int T, int K, int *code,
                                                  int *valid) {
    const int TK = T + K - 1;
    *code = LEAD + (3 + (TK + 3) / 4 + 3) / 4 + 2;
    *valid = (3 + (TK + 7) / 8 + 3) / 4 + 2;
}

template <int W>
int launch(const void *p2, const void *vb, const void *table, void *nodes,
           int64_t n_tiles, int pb, int vbn, uint32_t nb, int K, int T,
           cudaStream_t st) {
    codes_lookup_kernel<W><<<(unsigned)n_tiles, THREADS, 0, st>>>(
        (const uint8_t *)p2, (const uint8_t *)vb, (const uint32_t *)table,
        (int32_t *)nodes, pb, vbn, nb, K, T);
    return (int)cudaGetLastError();
}

}  // namespace

// packed2 (n_tiles, pb) and validb (n_tiles, vbn) uint8 (tile_pack2's
// layout), table (n_buckets, 16 * (W + 1)) uint32 with W = ceil(K / 8) ->
// nodes (n_tiles, T) int32.  The wrapper checks 2 <= K, T % 32 == 0,
// 32 <= T <= 1024, 4 pb >= T + K - 1, 8 vbn >= T + K - 1, 1 <= n_tiles <
// 2^31, a 16-byte aligned table, n_buckets < 2^31 and, for K > 136, that
// the stage fits (mg_codes_lookup_smem).
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
    case 9: return launch<9>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 10: return launch<10>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 11: return launch<11>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 12: return launch<12>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 13: return launch<13>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 14: return launch<14>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 15: return launch<15>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 16: return launch<16>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    case 17: return launch<17>(packed2, validb, table, nodes, n_tiles, pb, vbn, nb, K, T, st);
    default: break;
    }
    if (K <= 136)
        return (int)cudaErrorInvalidValue;
    int cw, vw;
    codes_stage_words(T, K, &cw, &vw);
    const size_t smem = (size_t)(cw + vw) * 4;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            codes_lookup_wide_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    codes_lookup_wide_kernel<<<(unsigned)n_tiles, THREADS, smem, st>>>(
        (const uint8_t *)packed2, (const uint8_t *)validb,
        (const uint32_t *)table, (int32_t *)nodes, pb, vbn, nb, K, T, cw, vw);
    return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory the K > 136 form asks for at (T, K).
extern "C" int64_t mg_codes_lookup_smem(int32_t T, int32_t K) {
    int cw, vw;
    codes_stage_words(T, K, &cw, &vw);
    return (int64_t)(cw + vw) * 4;
}
