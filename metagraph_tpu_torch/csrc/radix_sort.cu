// Kernel D2 of the device construction: a stable LSD radix sort of int64
// keys over their low ``bits`` bits (unsigned order), with an optional
// int32 or int64 payload.
//
// Replaces every lax.sort of metagraph_tpu/succinct/device_build.py:
// sort_kmers_device (:33, a multiword sort: the caller runs one stable
// 32-bit pass a word, last word first), the edge sort of _build_p1 (:194),
// the join sort (:210), the sink/source node lists (the category partition
// of :231 then sorts them) and the 3-bit key sort of _build_p2 (:258).
// _build_p2's label sort (:290), its permutation back (:297) and the
// kept-row partition (:310) need no sort on this card (build_emit.cu).
// A key is one int64 (the wire key has at most 42 bits, the 3-bit key at
// most 63), not the TPU's uint32 pair, and a pass reads only live bits:
// ceil(bits / 8) passes of 8 bits.
//
// What bounds it on an H100: bytes.  A pass reads each key twice (the
// histogram and the scatter) and writes it once, the payload once each
// way; the digit counts (1 KB a 4,096-key tile) are small beside them.
//
// Design: a pass is a histogram kernel (per tile of 4,096 keys, a warp's
// keys counted with __match_any_sync and one shared atomic a distinct
// digit), a device-wide exclusive scan of the digit-major counts
// (block_scan.cuh), and a scatter kernel: each lane holds 16 keys in
// registers (a warp a contiguous run of 512), the warps count their
// digits in order, a thread a digit turns the counts into each warp's
// offsets, and each warp then writes its keys in order, a key's place
// being its digit's offset plus its rank among the lanes of the same digit
// (__match_any_sync, __popc of the lower lanes) - stable by construction.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                 // keys a lane
constexpr int TILE = THREADS * ITEMS;     // keys a block
constexpr int RADIX = 256;
constexpr int DIGIT_BITS = 8;

__device__ __forceinline__ unsigned lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

__global__ void __launch_bounds__(THREADS)
radix_hist(const u64 *__restrict__ keys, int64_t n, int shift,
           unsigned mask, uint32_t *__restrict__ counts, int64_t nb) {
    __shared__ uint32_t cnt[RADIX];
    for (int d = threadIdx.x; d < RADIX; d += THREADS) cnt[d] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t base = (int64_t)blockIdx.x * TILE
                         + (int64_t)warp * 32 * ITEMS + lane;
#pragma unroll 4
    for (int r = 0; r < ITEMS; ++r) {
        const int64_t i = base + r * 32;
        const bool ok = i < n;
        const unsigned d = ok ? (unsigned)(__ldg(keys + i) >> shift) & mask
                              : RADIX;
        const unsigned peers = __match_any_sync(FULL, d);
        if (ok && lane == __ffs(peers) - 1)
            atomicAdd(cnt + d, (uint32_t)__popc(peers));
    }
    __syncthreads();
    for (int d = threadIdx.x; d < RADIX; d += THREADS)
        counts[(int64_t)d * nb + blockIdx.x] = cnt[d];
}

template <typename P, bool HAS>
__global__ void __launch_bounds__(THREADS)
radix_scatter(const u64 *__restrict__ kin, u64 *__restrict__ kout,
              const P *__restrict__ pin, P *__restrict__ pout, int64_t n,
              int shift, unsigned mask,
              const uint32_t *__restrict__ offsets, int64_t nb) {
    __shared__ uint32_t wcnt[WARPS][RADIX];
    for (int x = threadIdx.x; x < WARPS * RADIX; x += THREADS)
        (&wcnt[0][0])[x] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t base = (int64_t)blockIdx.x * TILE
                         + (int64_t)warp * 32 * ITEMS + lane;
    u64 k[ITEMS];
    unsigned d[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int64_t i = base + r * 32;
        k[r] = i < n ? __ldcs(kin + i) : 0;
        d[r] = i < n ? (unsigned)(k[r] >> shift) & mask : RADIX;
    }
    // each warp's digit counts, in order
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const unsigned peers = __match_any_sync(FULL, d[r]);
        if (d[r] < RADIX && lane == __ffs(peers) - 1)
            wcnt[warp][d[r]] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    // a thread a digit: the block's offset, then each warp's
    for (int dg = threadIdx.x; dg < RADIX; dg += THREADS) {
        uint32_t run = offsets[(int64_t)dg * nb + blockIdx.x];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const uint32_t c = wcnt[w][dg];
            wcnt[w][dg] = run;
            run += c;
        }
    }
    __syncthreads();
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const unsigned peers = __match_any_sync(FULL, d[r]);
        const bool ok = d[r] < RADIX;
        uint32_t pos = 0;
        if (ok) pos = wcnt[warp][d[r]] + __popc(peers & lt);
        __syncwarp();
        if (ok && lane == __ffs(peers) - 1)
            wcnt[warp][d[r]] += __popc(peers);
        __syncwarp();
        if (ok) {
            kout[pos] = k[r];
            if (HAS) pout[pos] = pin[base + r * 32];
        }
    }
}

template <typename P, bool HAS>
cudaError_t sort_passes(const u64 *keys, u64 *ka, u64 *kb,
                        const P *pay, P *pa, P *pb, int64_t n, int bits,
                        uint32_t *counts, uint32_t *sums,
                        cudaStream_t stream) {
    const int64_t nb = (n + TILE - 1) / TILE;
    const int passes = (bits + DIGIT_BITS - 1) / DIGIT_BITS;
    for (int p = 0; p < passes; ++p) {
        const int shift = p * DIGIT_BITS;
        const int width = bits - shift < DIGIT_BITS ? bits - shift
                                                    : DIGIT_BITS;
        const unsigned mask = (1u << width) - 1u;
        // pass p reads the input or the buffer the last pass wrote, and
        // writes ka on even passes, kb on odd ones
        const u64 *src = p == 0 ? keys : (p & 1 ? ka : kb);
        u64 *dst = p & 1 ? kb : ka;
        const P *psrc = p == 0 ? pay : (p & 1 ? pa : pb);
        P *pdst = p & 1 ? pb : pa;
        radix_hist<<<(unsigned)nb, THREADS, 0, stream>>>(src, n, shift, mask,
                                                         counts, nb);
        cudaError_t err = cudaGetLastError();
        if (err) return err;
        if ((err = mg_scan::exclusive_scan(counts, RADIX * nb, sums, stream)))
            return err;
        radix_scatter<P, HAS><<<(unsigned)nb, THREADS, 0, stream>>>(
            src, dst, psrc, pdst, n, shift, mask, counts, nb);
        if ((err = cudaGetLastError())) return err;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

// Scratch sizes for n keys: counts 256 * ceil(n / 4096) uint32, sums
// ceil(that / 4096) uint32.
int64_t mg_radix_counts(int64_t n) { return RADIX * ((n + TILE - 1) / TILE); }

int64_t mg_radix_sums(int64_t n) {
    return mg_scan::scan_chunks(mg_radix_counts(n));
}

// Sort n keys (n < 2^31) by their low ``bits`` bits (1..64).  Pass p
// writes ka (p even) or kb (p odd), so the result is in ka when the number
// of passes ceil(bits / 8) is odd, else in kb; ``keys`` is only read.  A
// payload of pay_bytes 4 or 8 (0: none) moves with its key.  Returns the
// first launch error, 0 if none.
int mg_radix_sort(const void *keys, void *ka, void *kb, const void *pay,
                  void *pa, void *pb, int pay_bytes, int64_t n, int bits,
                  void *counts, void *sums, void *stream) {
    if (n <= 0) return 0;
    if (bits < 1 || bits > 64 || n >= (int64_t(1) << 31))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    auto *k = (const u64 *)keys;
    auto *a = (u64 *)ka;
    auto *b = (u64 *)kb;
    auto *c = (uint32_t *)counts;
    auto *u = (uint32_t *)sums;
    if (pay_bytes == 8)
        return (int)sort_passes<u64, true>(
            k, a, b, (const u64 *)pay, (u64 *)pa, (u64 *)pb,
            n, bits, c, u, s);
    if (pay_bytes == 4)
        return (int)sort_passes<uint32_t, true>(
            k, a, b, (const uint32_t *)pay, (uint32_t *)pa, (uint32_t *)pb,
            n, bits, c, u, s);
    if (pay_bytes == 0)
        return (int)sort_passes<uint32_t, false>(
            k, a, b, nullptr, nullptr, nullptr, n, bits, c, u, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
