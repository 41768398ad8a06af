// Decoupled look-back, shared by the kernels that find a tile's output
// offset in one pass (radix_sort.cu's onesweep passes, build_emit.cu's
// compaction and emission), and the lane mask the warp ballots rank by
// (build_join.cu too).
//
// A tile posts a 64-bit status word: its own count (KIND_AGG) as soon as
// it has it, its inclusive prefix (KIND_INC) once it knows its offset.  A
// zero word is not yet posted.  The words are read and written relaxed at
// gpu scope: a word is one 64-bit access, so its kind and value arrive
// together.  Tiles must be claimed in order (an atomic counter), so that
// every earlier tile has a running owner and the walk back ends.
//
// tile_prefix walks 32 earlier tiles at a time, one a lane, and stops at
// the nearest inclusive word.  radix_sort.cu keeps its own walk: a thread
// a digit, its words tagged with the pass so that one memset serves every
// pass; it uses the load and store here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr u64 KIND_AGG = 1ull << 62;          // a tile's own count
constexpr u64 KIND_INC = 2ull << 62;          // its inclusive prefix
constexpr u64 VALUE = (1ull << 62) - 1;

// The lanes below this one.
__device__ __forceinline__ unsigned lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

__device__ __forceinline__ u64 load_status(const u64 *p) {
    u64 v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_status(u64 *p, u64 v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// One warp of a block: the exclusive prefix of tile ``tile``'s ``count``
// over the earlier tiles (every lane gets it), its own words posted in
// ``status`` (a word a tile, zeroed before the launch).
__device__ u64 tile_prefix(u64 *status, int64_t tile, u64 count) {
    const int lane = threadIdx.x & 31;
    if (tile == 0) {
        if (lane == 0) store_status(status, KIND_INC | count);
        return 0;
    }
    if (lane == 0) store_status(status + tile, KIND_AGG | count);
    u64 acc = 0;
#pragma unroll 1
    for (int64_t end = tile - 1;; end -= 32) {
        const int64_t t = end - lane;        // lane 0 the nearest tile
        u64 w = KIND_INC;                    // before tile 0: nothing
        if (t >= 0) {
            do {
                w = load_status(status + t);
            } while (!(w >> 62));
        }
        const unsigned inc = __ballot_sync(FULL, (w & KIND_INC) != 0);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        u64 v = lane <= stop ? (w & VALUE) : 0;
#pragma unroll
        for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
        acc += v;
        if (inc) break;
    }
    if (lane == 0) store_status(status + tile, KIND_INC | (acc + count));
    return acc;
}

}  // namespace lookback
