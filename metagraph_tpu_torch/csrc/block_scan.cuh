// A device-wide exclusive prefix sum of uint32 counts, in place, for the
// construction kernel build_emit.cu (the kept rows' output offsets).
//
// Three launches: each block of SCAN_THREADS sums its SCAN_CHUNK counts;
// one block scans those sums, SCAN_CHUNK at a time with a carry; each
// block then scans its chunk from its sum's offset.  Totals must stay
// below 2^32 (the callers hold fewer than 2^31 elements).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mg_scan {

constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;

// Exclusive scan of one value a thread over a block of blockDim.x threads
// (a multiple of 32, at most 1024); *total gets the block's sum.
__device__ __forceinline__ uint32_t block_exclusive(uint32_t v,
                                                    uint32_t *total) {
    __shared__ uint32_t warp_sums[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    uint32_t x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        uint32_t s = lane < warps ? warp_sums[lane] : 0u;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, s, d);
            if (lane >= d) s += y;
        }
        warp_sums[lane] = s;          // inclusive over warps
    }
    __syncthreads();
    const uint32_t before = warp ? warp_sums[warp - 1] : 0u;
    *total = warp_sums[warps - 1];
    __syncthreads();                  // warp_sums is reused by the next call
    return before + x - v;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_reduce(const uint32_t *__restrict__ data, int64_t n,
            uint32_t *__restrict__ sums) {
    const int64_t base = (int64_t)blockIdx.x * SCAN_CHUNK
                         + (int64_t)threadIdx.x * SCAN_ITEMS;
    uint32_t s = 0;
#pragma unroll
    for (int r = 0; r < SCAN_ITEMS; ++r)
        if (base + r < n) s += data[base + r];
    uint32_t total;
    block_exclusive(s, &total);
    if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_top(uint32_t *__restrict__ sums, int64_t n) {
    uint32_t carry = 0;
    for (int64_t lo = 0; lo < n; lo += SCAN_CHUNK) {
        const int64_t base = lo + (int64_t)threadIdx.x * SCAN_ITEMS;
        uint32_t v[SCAN_ITEMS], s = 0;
#pragma unroll
        for (int r = 0; r < SCAN_ITEMS; ++r) {
            v[r] = base + r < n ? sums[base + r] : 0u;
            s += v[r];
        }
        uint32_t total;
        uint32_t run = carry + block_exclusive(s, &total);
#pragma unroll
        for (int r = 0; r < SCAN_ITEMS; ++r) {
            if (base + r < n) sums[base + r] = run;
            run += v[r];
        }
        carry += total;
    }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_down(uint32_t *__restrict__ data, int64_t n,
          const uint32_t *__restrict__ sums) {
    const int64_t base = (int64_t)blockIdx.x * SCAN_CHUNK
                         + (int64_t)threadIdx.x * SCAN_ITEMS;
    uint32_t v[SCAN_ITEMS], s = 0;
#pragma unroll
    for (int r = 0; r < SCAN_ITEMS; ++r) {
        v[r] = base + r < n ? data[base + r] : 0u;
        s += v[r];
    }
    uint32_t total;
    uint32_t run = sums[blockIdx.x] + block_exclusive(s, &total);
#pragma unroll
    for (int r = 0; r < SCAN_ITEMS; ++r) {
        if (base + r < n) data[base + r] = run;
        run += v[r];
    }
}

// Blocks of the first and third launches for n counts: the length of the
// caller's ``sums`` scratch.
inline int64_t scan_chunks(int64_t n) {
    return (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
}

// The three launches; returns cudaGetLastError() after each.
inline cudaError_t exclusive_scan(uint32_t *data, int64_t n, uint32_t *sums,
                                  cudaStream_t stream) {
    const int64_t chunks = scan_chunks(n);
    scan_reduce<<<(unsigned)chunks, SCAN_THREADS, 0, stream>>>(data, n, sums);
    cudaError_t err = cudaGetLastError();
    if (err) return err;
    scan_top<<<1, SCAN_THREADS, 0, stream>>>(sums, chunks);
    if ((err = cudaGetLastError())) return err;
    scan_down<<<(unsigned)chunks, SCAN_THREADS, 0, stream>>>(data, n, sums);
    return cudaGetLastError();
}

}  // namespace mg_scan
