// Broadcast hash join (BHJ) on Hopper: four kernels over one scratch
// buffer in device memory, choosing on the device between a direct-
// addressed array (dense key ranges) and an open-addressing hash table.
//
// Replaces the reference's Pallas kernel _kernel in
// src/repro/kernels/hash_join.py (grid (probe tiles, build tiles): every
// probe tile compared with every build tile held in VMEM, a masked max per
// tile, the running value in VMEM scratch), an O(S x R) compare.  Here the
// join is O(S + R).
//
// Semantics (kernels/ref.py hash_join_ref, after the reference's oracle
// repro.kernels.ref.hash_join_ref): for each probe key, the value of the
// FIRST build row (the smallest row index) whose key equals it, or -1.
// Every int32 key is legal and every int32 value is returned as it is.
//
// Scratch: a 16-byte header and cap 64-bit slots (cap a power of two >= 2R),
// all filled with ones (cudaMemsetAsync) before the first kernel.  Keys are
// compared in u = uint32(key) ^ 2^31, which orders them as int32 does.
//   1. hash_minmax_kernel: the build keys' least and greatest u, into the
//      header by atomicMin (of u and of ~u).  The span max - min + 1 is
//      taken in 64 bits, so INT_MIN and INT_MAX together cannot overflow.
//   2. hash_build_kernel: where the span fits dense_cap 32-bit words (the
//      same memory as the table: dense_cap <= 2 cap), DENSE: an atomicMin
//      of the row into word u - min, so it holds the first row.  Otherwise
//      HASH: linear probing from a murmur3-finalizer hash of the key; a
//      slot packs (uint32(key) << 32) | row and is claimed by atomicCAS, a
//      key already there keeps the smaller row by atomicMin on the whole
//      word (the high words are equal, so the min compares rows).  A slot
//      never changes key once set and every thread inserting a key walks
//      the same sequence, so each key owns one slot.
//   3. hash_finalize_kernel: replaces every first row by its value, so a
//      probe reads key and value in ONE random access (a 4-byte word
//      DENSE, an 8-byte slot HASH) and never a second, dependent one.
//   4. hash_probe_kernel: JOIN_PER_THREAD probes a thread (join_tile.cuh:
//      16-byte streaming loads and stores), their lookups issued together.
//
// The empty marker stays unambiguous.  DENSE: an empty word is all ones,
// i.e. -1 as int32, which is what a miss returns, so no row is ever
// confused with it (rows < 2^31) and a word that stays empty reads as a
// miss.  HASH: an empty slot is all ones.  While building, a slot's low
// word is a row < 2^31, so no slot equals it.  After finalize the low word
// is any int32 value, so key -1 with value -1 would pack to all ones; key
// -1 therefore never enters the table: its first row, then its value,
// lives in the header (minus1), and the probe answers key -1 from there.
// Every slot in the table then has a high word other than all ones.
//
// What bounds it on this card: the L2's rate for random sectors.  The
// array or table (16 bytes a build row at most; 4 MB of array for TPC-H's
// 1M suppliers) stays in the 50 MB L2 (the streaming hints keep the probe
// stream from evicting it), but each lookup moves a 32-byte sector for a
// 4- or 8-byte read: 600M probes ask the L2 for 19.2 GB.  On an H100 that
// costs ~3.2 ms beyond the ~1.7 ms the probe stream takes alone (PERF.md
// §6), so the byte bound (8 bytes a probe) is out of reach while the
// lookups are random; how many probes a thread keeps in flight (4, 8, 16)
// and the cache hints moved the time by under 1%.

#include "join_tile.cuh"

typedef unsigned long long u64;

#define EMPTY_SLOT (~0ull)         // an empty table slot: all ones
#define NO_ROW 0xFFFFFFFFu         // an empty dense word or header row
#define MAX_BLOCKS 8192            // grid-stride loops beyond this

struct Header {
    uint32_t min_u;                // least u of the build keys
    uint32_t not_max_u;            // ~(greatest u)
    uint32_t minus1;               // key -1's first row, then its value
    uint32_t pad;
};

__device__ __forceinline__ uint32_t order_u(int32_t k) {
    return (uint32_t)k ^ 0x80000000u;
}

__device__ __forceinline__ uint32_t mix32(uint32_t k) {
    k ^= k >> 16;
    k *= 0x85ebca6bu;
    k ^= k >> 13;
    k *= 0xc2b2ae35u;
    k ^= k >> 16;
    return k;
}

// the key range the header holds: its least u, its width - 1, and whether
// the build takes the dense array (no keys: not dense, an empty table)
struct Range {
    uint32_t lo, width;
    bool dense;
};

__device__ __forceinline__ Range key_range(const Header* h, u64 dense_cap) {
    const uint32_t lo = h->min_u, hi = ~h->not_max_u;
    const bool any = lo <= hi;
    return {lo, hi - lo, any && (u64)(hi - lo) + 1 <= dense_cap};
}

__global__ void __launch_bounds__(JOIN_THREADS)
hash_minmax_kernel(const int32_t* __restrict__ keys, int64_t R,
                   Header* h) {
    uint32_t lo = NO_ROW, not_hi = NO_ROW;
    const int64_t stride = (int64_t)gridDim.x * JOIN_THREADS;
    for (int64_t i = (int64_t)blockIdx.x * JOIN_THREADS + threadIdx.x; i < R;
         i += stride) {
        const uint32_t u = order_u(__ldg(&keys[i]));
        lo = min(lo, u);
        not_hi = min(not_hi, ~u);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    not_hi = __reduce_min_sync(0xffffffffu, not_hi);
    if ((threadIdx.x & 31) == 0 && lo != NO_ROW) atomicMin(&h->min_u, lo);
    if ((threadIdx.x & 31) == 0 && not_hi != NO_ROW)
        atomicMin(&h->not_max_u, not_hi);
}

__global__ void __launch_bounds__(JOIN_THREADS)
hash_build_kernel(const int32_t* __restrict__ keys, int64_t R,
                  Header* h, u64* __restrict__ table, uint32_t mask,
                  u64 dense_cap) {
    const Range rg = key_range(h, dense_cap);
    uint32_t* dense = reinterpret_cast<uint32_t*>(table);
    const int64_t stride = (int64_t)gridDim.x * JOIN_THREADS;
    for (int64_t i = (int64_t)blockIdx.x * JOIN_THREADS + threadIdx.x; i < R;
         i += stride) {
        const int32_t key = __ldg(&keys[i]);
        if (rg.dense) {
            atomicMin(&dense[order_u(key) - rg.lo], (uint32_t)i);
            continue;
        }
        if (key == -1) {
            atomicMin(&h->minus1, (uint32_t)i);
            continue;
        }
        const uint32_t k = (uint32_t)key;
        const u64 packed = ((u64)k << 32) | (u64)i;
        uint32_t s = mix32(k) & mask;
        while (true) {
            const u64 prev = atomicCAS(&table[s], EMPTY_SLOT, packed);
            if (prev == EMPTY_SLOT) break;
            if ((uint32_t)(prev >> 32) == k) {
                atomicMin(&table[s], packed);
                break;
            }
            s = (s + 1) & mask;
        }
    }
}

__global__ void __launch_bounds__(JOIN_THREADS)
hash_finalize_kernel(const int32_t* __restrict__ vals, Header* h,
                     u64* __restrict__ table, int64_t cap, u64 dense_cap) {
    const Range rg = key_range(h, dense_cap);
    const int64_t stride = (int64_t)gridDim.x * JOIN_THREADS;
    const int64_t i0 = (int64_t)blockIdx.x * JOIN_THREADS + threadIdx.x;
    if (rg.dense) {
        uint32_t* dense = reinterpret_cast<uint32_t*>(table);
        for (int64_t i = i0; i <= (int64_t)rg.width; i += stride) {
            const uint32_t row = dense[i];
            if (row != NO_ROW) dense[i] = (uint32_t)__ldg(&vals[row]);
        }
        return;
    }
    if (i0 == 0 && h->minus1 != NO_ROW)
        h->minus1 = (uint32_t)__ldg(&vals[h->minus1]);
    for (int64_t i = i0; i < cap; i += stride) {
        const u64 slot = table[i];
        if (slot != EMPTY_SLOT)
            table[i] = (slot & 0xFFFFFFFF00000000ull) |
                       (uint32_t)__ldg(&vals[(uint32_t)slot]);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(JOIN_THREADS)
hash_probe_kernel(const int32_t* __restrict__ probe, int64_t S,
                  const Header* __restrict__ h,
                  const u64* __restrict__ table, uint32_t mask,
                  u64 dense_cap, int32_t* __restrict__ out) {
    const Range rg = key_range(h, dense_cap);
    const int32_t minus1 = (int32_t)h->minus1;
    const uint32_t* dense = reinterpret_cast<const uint32_t*>(table);
    const int64_t tiles = (S + JOIN_TILE - 1) / JOIN_TILE;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int64_t base = tile * JOIN_TILE;
        int32_t k[JOIN_PER_THREAD], v[JOIN_PER_THREAD];
        load_tile<VEC>(probe, S, base, k);
        if (rg.dense) {
#pragma unroll
            for (int j = 0; j < JOIN_PER_THREAD; ++j) {
                const uint32_t d = order_u(k[j]) - rg.lo;
                v[j] = d <= rg.width ? (int32_t)__ldg(&dense[d]) : -1;
            }
        } else {
            uint32_t s[JOIN_PER_THREAD];
            u64 slot[JOIN_PER_THREAD];
#pragma unroll
            for (int j = 0; j < JOIN_PER_THREAD; ++j) {
                s[j] = mix32((uint32_t)k[j]) & mask;
                slot[j] = __ldg(&table[s[j]]);
            }
#pragma unroll
            for (int j = 0; j < JOIN_PER_THREAD; ++j) {
                v[j] = -1;
                if (k[j] == -1) {
                    v[j] = minus1;
                    continue;
                }
                while (slot[j] != EMPTY_SLOT) {
                    if ((uint32_t)(slot[j] >> 32) == (uint32_t)k[j]) {
                        v[j] = (int32_t)(uint32_t)slot[j];
                        break;
                    }
                    s[j] = (s[j] + 1) & mask;
                    slot[j] = __ldg(&table[s[j]]);
                }
            }
        }
        store_tile<VEC>(out, S, base, v);
    }
}

static unsigned blocks_for(int64_t n) {
    const int64_t b = (n + JOIN_THREADS - 1) / JOIN_THREADS;
    return (unsigned)(b < 1 ? 1 : b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

extern "C" {

// probe (S,), build keys and values (R,), out (S,): int32, any alignment;
// scratch: cap + 2 64-bit words, 16-byte aligned (the header, then the
// table; cap a power of two, 2 <= cap <= 2^32, cap >= 2R, R < 2^31);
// dense_cap <= 2 cap: the widest key range the dense array takes.  S > 0.
// Returns the first CUDA error, or 0.
int hash_join(const void* probe, int64_t S, const void* bkeys,
              const void* bvals, int64_t R, void* scratch, int64_t cap,
              int64_t dense_cap, void* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(scratch, 0xFF,
                                      (size_t)(cap + 2) * sizeof(u64), st);
    if (err != cudaSuccess) return (int)err;
    Header* h = (Header*)scratch;
    u64* table = (u64*)scratch + 2;
    const uint32_t mask = (uint32_t)(cap - 1);
    const int32_t *p = (const int32_t*)probe, *k = (const int32_t*)bkeys,
                  *v = (const int32_t*)bvals;
    int32_t* o = (int32_t*)out;
    hash_minmax_kernel<<<blocks_for(R < 1024 * JOIN_THREADS
                                        ? R : 1024 * JOIN_THREADS),
                         JOIN_THREADS, 0, st>>>(k, R, h);
    hash_build_kernel<<<blocks_for(R), JOIN_THREADS, 0, st>>>(
        k, R, h, table, mask, (u64)dense_cap);
    hash_finalize_kernel<<<blocks_for(cap), JOIN_THREADS, 0, st>>>(
        v, h, table, cap, (u64)dense_cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = blocks_for((S + JOIN_PER_THREAD - 1) /
                                       JOIN_PER_THREAD);
    if (aligned16(p, o))
        hash_probe_kernel<true><<<blocks, JOIN_THREADS, 0, st>>>(
            p, S, h, table, mask, (u64)dense_cap, o);
    else
        hash_probe_kernel<false><<<blocks, JOIN_THREADS, 0, st>>>(
            p, S, h, table, mask, (u64)dense_cap, o);
    return (int)cudaGetLastError();
}

}  // extern "C"
