// Kernel D1 of the device construction: the 2-bit key of every window of
// the wire tiles.
//
// Replaces extract_windows2 + window_valid2 and the sentinel select of
// metagraph_tpu/succinct/device_build.py::_build_p1 (:190-193): window j
// of tile n is bits [2j, 2j + 2K) of the tile's 2-bit stream (character i
// at bits 2i), kept as one int64 (2K <= 42 bits) where the K valid bits
// j .. j+K-1 are all set, else the sentinel 1 << 2K, which sorts after
// every key (the TPU kept a (lo, hi) uint32 pair with 0xFFFFFFFF
// sentinels).  With two strands (a canonical graph holds both), slot
// N * T + idx holds the key of window idx's reverse complement: the K
// 2-bit groups reversed and each XORed with 3 (the wire code's complement
// is 3 - c), the sentinel where the window is invalid.
//
// What bounds it on an H100: bytes.  It reads the tiles' words once (a
// tile's 18 words serve its 256 windows from L1) and writes 8 bytes a
// window a strand.
//
// Design: a thread a window, consecutive threads on consecutive windows
// of a tile, so that the int64 stores coalesce; the key is a 64-bit
// funnel of three words, the validity a mask test on two valid words
// (K <= 21, so j % 32 + K < 64); the reverse complement a bit reversal,
// a swap of the bits inside each group, a shift and an XOR.
//
// Built with nvcc for sm_90a into a plain C library (see _build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int THREADS = 256;

// the 2-bit key of the reverse complement of a K-character key
__device__ __forceinline__ u64 rc_key(u64 key, int K) {
    u64 r = __brevll(key);                   // group i -> 31 - i, swapped
    r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull)
                                              << 1);
    return (r >> (64 - 2 * K)) ^ ((1ull << (2 * K)) - 1ull);
}

__global__ void __launch_bounds__(THREADS)
build_windows_kernel(const uint32_t *__restrict__ words,
                     const uint32_t *__restrict__ vwords, int64_t N, int NW,
                     int NV, int K, int T, int strands,
                     long long *__restrict__ out) {
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= N * T) return;
    const int64_t n = idx / T;
    const int j = (int)(idx - n * T);
    const uint32_t *w = words + n * NW;
    const int g = j >> 4, sh = 2 * (j & 15);
    u64 key = ((u64)__ldg(w + g) | (u64)__ldg(w + g + 1) << 32) >> sh;
    if (sh) key |= (u64)__ldg(w + g + 2) << (64 - sh);
    key &= (1ull << (2 * K)) - 1ull;
    const uint32_t *v = vwords + n * NV;
    const int vg = j >> 5, vs = j & 31;
    u64 vb = __ldg(v + vg);
    if (vg + 1 < NV) vb |= (u64)__ldg(v + vg + 1) << 32;
    const u64 need = (1ull << K) - 1ull;
    const bool ok = ((vb >> vs) & need) == need;
    const long long sent = 1ll << (2 * K);
    out[idx] = ok ? (long long)key : sent;
    if (strands == 2)
        out[N * T + idx] = ok ? (long long)rc_key(key, K) : sent;
}

}  // namespace

extern "C" {

// (N, NW) wire words and (N, NV) valid words (uint32) -> (strands * N *
// T,) int64 keys, the forward strand's, then (strands == 2) the reverse
// complements', sentinel 1 << 2K for an invalid window.  Needs 3 <= K <=
// 21, NW >= T / 16 + 2, NV * 32 >= T + K - 1, strands 1 or 2.  Returns
// cudaGetLastError().
int mg_build_windows(const void *words, const void *vwords, void *out,
                     int64_t N, int NW, int NV, int K, int T, int strands,
                     void *stream) {
    const int64_t total = N * T;
    if (total <= 0) return 0;
    build_windows_kernel<<<(unsigned)((total + THREADS - 1) / THREADS),
                           THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)words, (const uint32_t *)vwords, N, NW, NV, K, T,
        strands, (long long *)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
