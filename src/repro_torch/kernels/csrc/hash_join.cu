// Broadcast hash join (BHJ) on Hopper: a build kernel and a probe kernel
// over one open-addressing table in device memory.
//
// Replaces the reference's Pallas kernel _kernel in
// src/repro/kernels/hash_join.py (grid (probe tiles, build tiles): every
// probe tile compared with every build tile held in VMEM, a masked max per
// tile, the running value in VMEM scratch), an O(S x R) compare.  Here the
// join is a hash join, O(S + R): the build kernel inserts the R build rows
// into the table, the probe kernel looks each probe key up.
//
// Semantics (kernels/ref.py hash_join_ref, after the reference's oracle
// repro.kernels.ref.hash_join_ref): for each probe key, the value of the
// FIRST build row (the smallest row index) whose key equals it, or -1.
// Every int32 key is legal and every int32 value is returned as it is.
//
// Table: cap slots of 64 bits, cap a power of two >= 2R (load factor at
// most 1/2), linear probing from a murmur3-finalizer hash of the key.  A
// slot packs
//     (uint32(key) << 32) | row,        row < 2^31,
// and the empty marker is all ones, which no packed slot can equal (its
// low word would exceed every row), so no key value is reserved.  Build:
// atomicCAS into an empty slot; where the slot already holds the key, an
// atomicMin on the whole word keeps the smaller row (the high words are
// equal, so the min compares rows): the first match, in whatever order the
// threads run.  A slot never changes key once set, and every thread that
// inserts a key walks the same slot sequence from the same start, so each
// key owns exactly one slot.  The wrapper allocates the table; the C entry
// point fills it with the empty marker (cudaMemsetAsync) before the build.
//
// What bounds it on this card: the bytes of the probe keys read and the
// values written (8 bytes a probe) when the table fits the 50 MB L2 (at
// R = 1M it is 16 MB, the values 4 MB); each probe adds a table load and a
// dependent value load at L2 latency, hidden by the many probes in flight
// (one thread per probe key in a grid-stride loop).  A shared-memory table
// for small build sides is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define JOIN_THREADS 256
#define MAX_BLOCKS 8192            // grid-stride loops beyond this

typedef unsigned long long u64;

#define EMPTY_SLOT (~0ull)         // all ones: no packed slot equals it

__device__ __forceinline__ uint32_t mix32(uint32_t k) {
    k ^= k >> 16;
    k *= 0x85ebca6bu;
    k ^= k >> 13;
    k *= 0xc2b2ae35u;
    k ^= k >> 16;
    return k;
}

__global__ void __launch_bounds__(JOIN_THREADS)
hash_build_kernel(const int32_t* __restrict__ keys, int64_t R,
                  u64* __restrict__ table, uint32_t mask) {
    const int64_t stride = (int64_t)gridDim.x * JOIN_THREADS;
    for (int64_t i = (int64_t)blockIdx.x * JOIN_THREADS + threadIdx.x; i < R;
         i += stride) {
        const uint32_t k = (uint32_t)keys[i];
        const u64 packed = ((u64)k << 32) | (u64)i;
        uint32_t h = mix32(k) & mask;
        while (true) {
            const u64 prev = atomicCAS(&table[h], EMPTY_SLOT, packed);
            if (prev == EMPTY_SLOT) break;
            if ((uint32_t)(prev >> 32) == k) {
                atomicMin(&table[h], packed);
                break;
            }
            h = (h + 1) & mask;
        }
    }
}

__global__ void __launch_bounds__(JOIN_THREADS)
hash_probe_kernel(const int32_t* __restrict__ probe, int64_t S,
                  const int32_t* __restrict__ vals,
                  const u64* __restrict__ table, uint32_t mask,
                  int32_t* __restrict__ out) {
    const int64_t stride = (int64_t)gridDim.x * JOIN_THREADS;
    for (int64_t i = (int64_t)blockIdx.x * JOIN_THREADS + threadIdx.x; i < S;
         i += stride) {
        const uint32_t k = (uint32_t)probe[i];
        uint32_t h = mix32(k) & mask;
        int32_t v = -1;
        while (true) {
            const u64 slot = table[h];
            if (slot == EMPTY_SLOT) break;
            if ((uint32_t)(slot >> 32) == k) {
                v = vals[(uint32_t)slot];
                break;
            }
            h = (h + 1) & mask;
        }
        out[i] = v;
    }
}

static unsigned blocks_for(int64_t n) {
    const int64_t b = (n + JOIN_THREADS - 1) / JOIN_THREADS;
    return (unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

extern "C" {

// probe (S,), build keys and values (R,), out (S,): int32; table: cap
// 64-bit slots of scratch (cap a power of two, 2 <= cap <= 2^32, cap >= 2R,
// R < 2^31).  S > 0.  Returns the first CUDA error, or 0.
int hash_join(const void* probe, int64_t S, const void* bkeys,
              const void* bvals, int64_t R, void* table, int64_t cap,
              void* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(table, 0xFF, (size_t)cap * sizeof(u64),
                                      st);
    if (err != cudaSuccess) return (int)err;
    const uint32_t mask = (uint32_t)(cap - 1);
    if (R > 0) {
        hash_build_kernel<<<blocks_for(R), JOIN_THREADS, 0, st>>>(
            (const int32_t*)bkeys, R, (u64*)table, mask);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    hash_probe_kernel<<<blocks_for(S), JOIN_THREADS, 0, st>>>(
        (const int32_t*)probe, S, (const int32_t*)bvals,
        (const u64*)table, mask, (int32_t*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
