// The probe tile the join kernels share (hash_join.cu, merge_join.cu): a
// block of JOIN_THREADS threads takes JOIN_TILE consecutive probe keys,
// JOIN_PER_THREAD a thread, read and written with streaming (evict-first)
// hints, since each probe key is read once and each result written once.
//
// Layout of a thread's slots j = 0..JOIN_PER_THREAD-1 in a tile at base:
// with 16-byte access (VEC: probe and out 16-byte aligned) element
//     base + 4 * JOIN_THREADS * (j / 4) + 4 * t + j % 4,
// so each int4 a thread moves is four neighbouring keys and a warp's int4s
// are 512 contiguous bytes; without it (a slice whose data pointer is not
// 16-byte aligned) element base + JOIN_THREADS * j + t.  Either way the
// load and the store of one tile use one layout.  The last tile, when S is
// not a multiple of JOIN_TILE, moves 4 bytes at a time and masks the slots
// at or past S.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define JOIN_THREADS 256
#define JOIN_PER_THREAD 8
#define JOIN_TILE (JOIN_THREADS * JOIN_PER_THREAD)     // 2,048 probes

template <bool VEC>
__device__ __forceinline__ int64_t tile_slot(int64_t base, int j) {
    return VEC ? base + (int64_t)(4 * JOIN_THREADS) * (j >> 2) +
                     4 * threadIdx.x + (j & 3)
               : base + (int64_t)JOIN_THREADS * j + threadIdx.x;
}

template <bool VEC>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ src,
                                          int64_t S, int64_t base,
                                          int32_t (&k)[JOIN_PER_THREAD]) {
    if (VEC && base + JOIN_TILE <= S) {
        const int4* p = reinterpret_cast<const int4*>(src + base) +
                        threadIdx.x;
#pragma unroll
        for (int i = 0; i < JOIN_PER_THREAD / 4; ++i) {
            const int4 q = __ldcs(p + i * JOIN_THREADS);
            k[4 * i] = q.x; k[4 * i + 1] = q.y;
            k[4 * i + 2] = q.z; k[4 * i + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < JOIN_PER_THREAD; ++j) {
            const int64_t e = tile_slot<VEC>(base, j);
            k[j] = e < S ? __ldcs(src + e) : 0;
        }
    }
}

template <bool VEC>
__device__ __forceinline__ void store_tile(int32_t* __restrict__ dst,
                                           int64_t S, int64_t base,
                                           const int32_t (&v)[JOIN_PER_THREAD]) {
    if (VEC && base + JOIN_TILE <= S) {
        int4* p = reinterpret_cast<int4*>(dst + base) + threadIdx.x;
#pragma unroll
        for (int i = 0; i < JOIN_PER_THREAD / 4; ++i)
            __stcs(p + i * JOIN_THREADS,
                   make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                             v[4 * i + 3]));
    } else {
#pragma unroll
        for (int j = 0; j < JOIN_PER_THREAD; ++j) {
            const int64_t e = tile_slot<VEC>(base, j);
            if (e < S) __stcs(dst + e, v[j]);
        }
    }
}

// 16-byte access for both streams: their pointers on a 16-byte boundary
static inline bool aligned16(const void* a, const void* b) {
    return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}
