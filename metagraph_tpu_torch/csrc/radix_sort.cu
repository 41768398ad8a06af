// Kernel D2 of the device construction: a stable LSD radix sort of int64
// keys over their low ``bits`` bits (unsigned order), with an optional
// int32 or int64 payload.
//
// Replaces every lax.sort of metagraph_tpu/succinct/device_build.py:
// sort_kmers_device (:33, a multiword sort: the caller runs one stable
// 32-bit sort a word, last word first), the edge sort of _build_p1 (:194),
// the join sort (:210), the sink/source node lists (the category partition
// of :231 then sorts them) and the 3-bit key sort of _build_p2 (:258).
// _build_p2's label sort (:290), its permutation back (:297) and the
// kept-row partition (:310) need no sort on this card (build_emit.cu).
// A key is one int64 (the wire key has at most 42 bits, the 3-bit key at
// most 63), not the TPU's uint32 pair, and a pass reads only live bits.
//
// What bounds it on an H100: bytes.  A pass that runs must read each key
// once and write it once (the payload too): 16 B a key a pass.
//
// Design (onesweep, one launch a pass):
// * mg_radix_hist: one memset of the scratch (histograms, tile counters,
//   look-back status), then one kernel that reads each key once and counts
//   the digit of every pass at once, in per-block shared bins (a shared
//   atomic a key, or one a warp whose keys are all one key), and adds
//   each non-zero bin to the global histogram.  The host reads the
//   histograms back once a sort and skips every pass whose digit has one
//   bin holding all keys (device_build.radix_plan).
// * mg_radix_pass: a block takes its tile number from a global atomic
//   counter (so every tile before it has been claimed, which decoupled
//   look-back needs: blocks start in no set order), loads its 4,096 keys
//   coalesced (a warp a contiguous run of 512), ranks them by digit stably
//   (lane order within a warp, the lanes of one digit found by a ballot a
//   digit bit; then warp order), posts each digit's count to a
//   per-(tile, digit) status word, then walks back
//   over earlier tiles' words until one holds an inclusive prefix (tile 0
//   posts the digit starts from the histogram).  It then places its keys
//   in shared memory in digit order and writes each digit's run to its
//   place, consecutive threads to consecutive addresses; the payload moves
//   the same way with the same ranks.
// * A status word (lookback.cuh's load and store; this file's own walk, a
//   thread a digit) is 64 bits: the pass number + 1 (bits 48-55), the kind
//   (bits 40-41: a tile's count, or the inclusive prefix) and the value
//   (n < 2^31).  The memset zeroes it once a sort; a word of an earlier
//   pass carries another pass number and reads as not yet posted, so no
//   reset is needed between passes.
// * With a sentinel (a key the caller promises is the largest under
//   ``bits``) the histogram counts the other keys only, the first pass
//   that runs drops the sentinel keys, later passes sort the m live keys
//   alone, and the last pass fills [m, n) with the sentinel.
// * Digits are 8 bits: 11-bit ones (fewer passes, 8x the status words
//   and per-warp counters, one block an SM) measured 2-3x slower.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using lookback::lanemask_lt;
using lookback::load_status;
using lookback::store_status;
typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                 // keys a lane
constexpr int MIN_BLOCKS = 3;             // a pass's blocks an SM (80 regs)
constexpr int WARP_KEYS = 32 * ITEMS;     // a warp's contiguous run
constexpr int TILE = THREADS * ITEMS;     // keys a block
constexpr int HIST_ITEMS = 8;             // keys a thread a histogram step
constexpr int DIGIT_BITS = 8;
constexpr int R = 1 << DIGIT_BITS;        // bins a digit: one a thread
constexpr int MAX_PASSES = 8;             // 64 bits
// int32 entries of the histogram: a row of R counts a pass, then the
// number of sentinel keys dropped; then a tile counter a pass
constexpr int HIST_LEN = MAX_PASSES * R + 1;
constexpr int64_t HEAD_WORDS = (HIST_LEN + MAX_PASSES + 1) / 2;  // int64

constexpr u64 KIND_AGG = 1ull << 40;      // a tile's own count
constexpr u64 KIND_INC = 2ull << 40;      // the inclusive prefix
constexpr u64 VALUE = (1ull << 40) - 1;

static_assert(R == THREADS, "a thread a digit");

// The lanes whose value has the same low NB bits as this lane's: NB
// ballots (__match_any_sync is several times slower on this card).
template <int NB>
__device__ __forceinline__ unsigned match_low_bits(unsigned v) {
    unsigned m = FULL;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const unsigned bit = (v >> b) & 1u;
        const unsigned set = __ballot_sync(FULL, bit);
        m &= bit ? set : ~set;
    }
    return m;
}

// Exclusive sum of one value a thread over the block; every thread calls.
__device__ __forceinline__ uint32_t block_exclusive(uint32_t v,
                                                    uint32_t *tmp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) tmp[warp] = x;
    __syncthreads();
    uint32_t before = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
        if (w < warp) before += tmp[w];
    __syncthreads();                      // tmp is reused by the next call
    return before + x - v;
}

__host__ __device__ __forceinline__ unsigned digit_mask(int bits,
                                                        int shift) {
    const int width = bits - shift < DIGIT_BITS ? bits - shift : DIGIT_BITS;
    return (1u << width) - 1u;
}

// Every pass's digit counts of the keys (those != sentinel when ``drop``),
// added to hist; hist[MAX_PASSES * R] += the keys dropped.
__global__ void __launch_bounds__(THREADS)
radix_hist(const u64 *__restrict__ keys, int64_t n, int bits, int drop,
           u64 sentinel, uint32_t *__restrict__ hist) {
    __shared__ uint32_t bins[MAX_PASSES * R];
    const int npass = (bits + DIGIT_BITS - 1) / DIGIT_BITS;
    for (int i = threadIdx.x; i < npass * R; i += THREADS) bins[i] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    uint32_t dropped = 0;
    constexpr int STEP = THREADS * HIST_ITEMS;
    for (int64_t lo = (int64_t)blockIdx.x * STEP; lo < n;
         lo += (int64_t)gridDim.x * STEP) {
        u64 k[HIST_ITEMS];
        bool ok[HIST_ITEMS], one[HIST_ITEMS];
#pragma unroll
        for (int r = 0; r < HIST_ITEMS; ++r) {
            const int64_t i = lo + r * THREADS + threadIdx.x;
            ok[r] = i < n;
            k[r] = ok[r] ? __ldcs(keys + i) : 0;
            if (drop && ok[r] && k[r] == sentinel) {
                ok[r] = false;
                ++dropped;
            }
            // a warp whose keys are all one key (a run of the sentinel,
            // say) adds 32 with one atomic a pass
            const u64 k0 = __shfl_sync(FULL, k[r], 0);
            const bool ok0 = __shfl_sync(FULL, ok[r], 0);
            one[r] = __all_sync(FULL, k[r] == k0 && ok[r] == ok0);
        }
        for (int p = 0; p < npass; ++p) {
            const int shift = p * DIGIT_BITS;
            const unsigned mask = digit_mask(bits, shift);
            uint32_t *b = bins + p * R;
#pragma unroll
            for (int r = 0; r < HIST_ITEMS; ++r) {
                const unsigned d = (unsigned)(k[r] >> shift) & mask;
                if (one[r]) {
                    if (lane == 0 && ok[r]) atomicAdd(b + d, 32u);
                } else if (ok[r]) {
                    atomicAdd(b + d, 1u);
                }
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < npass * R; i += THREADS)
        if (bins[i]) atomicAdd(hist + i, bins[i]);
#pragma unroll
    for (int o = 16; o; o >>= 1) dropped += __shfl_xor_sync(FULL, dropped, o);
    if (lane == 0 && dropped) atomicAdd(hist + MAX_PASSES * R, dropped);
}

// Shared memory of a pass: the tile's keys in digit order, then a region
// that holds the warps' 16-bit digit counts and later the payload in
// digit order, then two ints a digit.
template <typename P, bool HAS>
__host__ __device__ constexpr int region_bytes() {
    return WARPS * R * 2 > (HAS ? TILE * (int)sizeof(P) : 0)
               ? WARPS * R * 2 : (HAS ? TILE * (int)sizeof(P) : 0);
}

template <typename P, bool HAS>
__host__ __device__ constexpr int pass_smem() {
    return TILE * 8 + region_bytes<P, HAS>() + 8 * R;
}

// One pass over n keys: digit (key >> shift) & mask of pass ``pass``.
template <typename P, bool HAS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
radix_pass(const u64 *__restrict__ kin, u64 *__restrict__ kout,
           const P *__restrict__ pin, P *__restrict__ pout, int64_t n,
           int pass, int shift, unsigned mask, int drop, u64 sentinel,
           const uint32_t *__restrict__ hist, u64 *__restrict__ status,
           uint32_t *__restrict__ counter, int64_t fill_lo,
           int64_t fill_hi) {
    constexpr int REGION = region_bytes<P, HAS>();
    extern __shared__ __align__(16) unsigned char smem[];
    u64 *s_keys = (u64 *)smem;
    uint16_t *wcnt = (uint16_t *)(smem + TILE * 8);   // WARPS x R
    P *s_pay = (P *)(smem + TILE * 8);
    uint32_t *s_start = (uint32_t *)(smem + TILE * 8 + REGION);
    int32_t *s_base = (int32_t *)(s_start + R);
    __shared__ uint32_t s_tile, tmp[WARPS];

    if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
    for (int i = threadIdx.x; i < WARPS * R / 2; i += THREADS)
        ((uint32_t *)wcnt)[i] = 0;
    __syncthreads();
    const int64_t tile = s_tile;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t base = tile * TILE + (int64_t)warp * WARP_KEYS + lane;
    const u64 tag = (u64)(pass + 1) << 48;

    // load: x holds the digit (high half, R where the slot holds no key)
    // and then the key's rank among its warp's keys of that digit
    u64 k[ITEMS];
    uint32_t x[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int64_t i = base + r * 32;
        bool ok = i < n;
        k[r] = ok ? __ldcs(kin + i) : 0;
        if (drop && k[r] == sentinel) ok = false;
        x[r] = (ok ? (unsigned)(k[r] >> shift) & mask : (unsigned)R) << 16;
    }
    // rank within the warp, in lane order, item after item
    uint16_t *wc = wcnt + warp * R;
    const unsigned lt = lanemask_lt();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const unsigned d = x[r] >> 16;
        const unsigned peers = match_low_bits<DIGIT_BITS + 1>(d);
        if (d < R) x[r] |= wc[d] + __popc(peers & lt);
        __syncwarp();
        if (d < R && lane == __ffs(peers) - 1)
            wc[d] += (uint16_t)__popc(peers);
        __syncwarp();
    }
    __syncthreads();
    // this thread's digit: the warps' exclusive starts and the tile's count
    const int dg = threadIdx.x;
    uint32_t tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const uint32_t c = wcnt[w * R + dg];
        wcnt[w * R + dg] = (uint16_t)tot;
        tot += c;
    }
    u64 *st = status + tile * R + dg;
    int64_t excl;
    if (tile == 0) {
        // the digit starts: an exclusive sum of the pass's histogram
        const uint32_t h = hist[dg];
        excl = block_exclusive(h, tmp);
        store_status(st, tag | KIND_INC | (u64)(excl + tot));
    } else {
        store_status(st, tag | KIND_AGG | (u64)tot);
    }
    // the tile's local digit start
    const uint32_t start = block_exclusive(tot, tmp);
    if (threadIdx.x == THREADS - 1) tmp[0] = start + tot;  // keys in tile
    if (tile != 0) {
        // decoupled look-back over the earlier tiles' words (tile 0 posts
        // inclusive ones)
        u64 acc = 0;
        const u64 *p = st;
#pragma unroll 1
        for (;;) {
            p -= R;
            u64 w;
            do {
                w = load_status(p);
            } while ((w & ~((1ull << 48) - 1)) != tag);
            acc += w & VALUE;
            if (w & KIND_INC) break;
        }
        store_status(st, tag | KIND_INC | (acc + tot));
        excl = (int64_t)acc;
    }
    s_start[dg] = start;
    s_base[dg] = (int32_t)(excl - (int64_t)start);
    __syncthreads();
    const int count = (int)tmp[0];
    // the keys in shared memory in digit order; x becomes the place
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const unsigned d = x[r] >> 16;
        if (d < R) {
            x[r] = s_start[d] + wcnt[warp * R + d] + (x[r] & 0xFFFFu);
            s_keys[x[r]] = k[r];
        } else {
            x[r] = 0xFFFFFFFFu;
        }
    }
    __syncthreads();
    // each digit's run to its place: consecutive threads, consecutive
    // addresses
    for (int i = threadIdx.x; i < count; i += THREADS) {
        const u64 key = s_keys[i];
        kout[s_base[(unsigned)(key >> shift) & mask] + i] = key;
    }
    if constexpr (HAS) {
        // the payload by the same places (wcnt is no longer read)
#pragma unroll
        for (int r = 0; r < ITEMS; ++r)
            if (x[r] != 0xFFFFFFFFu) s_pay[x[r]] = pin[base + r * 32];
        __syncthreads();
        for (int i = threadIdx.x; i < count; i += THREADS)
            pout[s_base[(unsigned)(s_keys[i] >> shift) & mask] + i] =
                s_pay[i];
    }
    // the last pass of a sort with a sentinel: the dropped keys' places
    for (int64_t i = fill_lo + (int64_t)blockIdx.x * THREADS + threadIdx.x;
         i < fill_hi; i += (int64_t)gridDim.x * THREADS)
        kout[i] = sentinel;
}

int sm_count() {
    static int sms = 0;
    if (!sms) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 132;
    }
    return sms;
}

template <typename P, bool HAS>
cudaError_t pass_launch(const u64 *kin, u64 *kout, const P *pin, P *pout,
                        int64_t n, int pass, int bits, int drop,
                        u64 sentinel, u64 *scratch, int64_t fill_lo,
                        int64_t fill_hi, cudaStream_t s) {
    constexpr int smem = pass_smem<P, HAS>();
    cudaError_t err = cudaFuncSetAttribute(
        radix_pass<P, HAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err) return err;
    const int shift = pass * DIGIT_BITS;
    const int64_t tiles = (n + TILE - 1) / TILE;
    auto *hist = (uint32_t *)scratch;
    radix_pass<P, HAS><<<(unsigned)(tiles ? tiles : 1), THREADS, smem, s>>>(
        kin, kout, pin, pout, n, pass, shift, digit_mask(bits, shift), drop,
        sentinel, hist + pass * R, scratch + HEAD_WORDS,
        hist + HIST_LEN + pass, fill_lo, fill_hi);
    return cudaGetLastError();
}

cudaError_t pass_any(const void *kin, void *kout, const void *pin,
                     void *pout, int pay_bytes, int64_t n, int pass,
                     int bits, int drop, u64 sentinel, u64 *scratch,
                     int64_t fill_lo, int64_t fill_hi, cudaStream_t s) {
    auto *ki = (const u64 *)kin;
    auto *ko = (u64 *)kout;
    if (pay_bytes == 8)
        return pass_launch<u64, true>(
            ki, ko, (const u64 *)pin, (u64 *)pout, n, pass, bits, drop,
            sentinel, scratch, fill_lo, fill_hi, s);
    if (pay_bytes == 4)
        return pass_launch<uint32_t, true>(
            ki, ko, (const uint32_t *)pin, (uint32_t *)pout, n, pass, bits,
            drop, sentinel, scratch, fill_lo, fill_hi, s);
    if (pay_bytes == 0)
        return pass_launch<uint32_t, false>(
            ki, ko, nullptr, nullptr, n, pass, bits, drop, sentinel,
            scratch, fill_lo, fill_hi, s);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// int64 words of scratch for a sort of n keys: the histograms (HIST_LEN
// int32 entries first), the tile counters, then a status word a (tile,
// digit).
int64_t mg_radix_scratch(int64_t n) {
    const int64_t tiles = (n + TILE - 1) / TILE;
    return HEAD_WORDS + (tiles ? tiles : 1) * R;
}

// Zero the scratch (one memset), then count every pass's digits of the n
// keys in one kernel (with ``drop``, the keys equal to ``sentinel`` are
// counted apart).  Returns the first error, 0 if none.
int mg_radix_hist(const void *keys, int64_t n, int bits, int drop,
                  int64_t sentinel, void *scratch, void *stream) {
    if (n <= 0 || bits < 1 || bits > 64 || n >= (int64_t(1) << 31))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(scratch, 0,
                                      8 * mg_radix_scratch(n), s);
    if (err) return (int)err;
    const int64_t steps = (n + THREADS * HIST_ITEMS - 1)
                          / (THREADS * HIST_ITEMS);
    const int64_t cap = 4 * (int64_t)sm_count();
    radix_hist<<<(unsigned)(steps < cap ? steps : cap), THREADS, 0, s>>>(
        (const u64 *)keys, n, bits, drop, (u64)sentinel,
        (uint32_t *)scratch);
    return (int)cudaGetLastError();
}

// The passes ``run[0..nrun)`` (digit indices, in order) of a sort whose
// scratch mg_radix_hist filled: the first reads the n keys of ``keys``
// (and a payload of pay_bytes 4 or 8 from ``pay``; 0: none), pass i
// writes ka and pa (i even) or kb and pb (i odd), so the result is in ka
// when nrun is odd, else in kb.  With ``drop`` the first pass leaves out
// the keys equal to ``sentinel``, the later ones read the m that remain,
// and the last sets [m, n) of its output to the sentinel.  Returns the
// first launch error, 0 if none.
int mg_radix_passes(const void *keys, void *ka, void *kb, const void *pay,
                    void *pa, void *pb, int pay_bytes, int64_t n, int64_t m,
                    int bits, int drop, int64_t sentinel, const int *run,
                    int nrun, void *scratch, void *stream) {
    if (n < 0 || m < 0 || m > n || bits < 1 || bits > 64
        || n >= (int64_t(1) << 31))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    for (int i = 0; i < nrun; ++i) {
        const int pass = run[i];
        if (pass < 0 || pass * DIGIT_BITS >= bits)
            return (int)cudaErrorInvalidValue;
        const bool last = i == nrun - 1;
        const cudaError_t err = pass_any(
            i == 0 ? keys : (i & 1 ? ka : kb), i & 1 ? kb : ka,
            i == 0 ? pay : (i & 1 ? pa : pb), i & 1 ? pb : pa, pay_bytes,
            i == 0 ? n : m, pass, bits, drop, (u64)sentinel,
            (u64 *)scratch, last ? m : 0, last ? n : 0, s);
        if (err) return (int)err;
    }
    return 0;
}

}  // extern "C"
