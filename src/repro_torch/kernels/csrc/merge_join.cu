// Sort-merge join (SMJ) on sorted runs on Hopper: a block takes a tile of
// consecutive probe keys, finds the build keys its range spans, stages them
// in shared memory and ranks every probe key there; one launch does the
// rank, the key check and the gather.
//
// Replaces the reference's Pallas kernel _rank_kernel in
// src/repro/kernels/merge_join.py (grid (probe tiles, build tiles): every
// probe tile compared with every build tile, the counts of build keys <=
// key summed in VMEM scratch, an O(S x R) count) and the clip, key check
// and gather that merge_join does after it in XLA.  Here the rank is a
// lower-bound search, O(S log R) at worst.
//
// Semantics (kernels/ref.py merge_join_ref, after the reference's oracle
// repro.kernels.ref.merge_join_ref): build_keys ascending (not checked, as
// in the reference); for each probe key, the value at the FIRST build row
// whose key equals it, or -1.  The Pallas kernel's rank (#(keys <= key) - 1)
// picks the last equal row instead; on distinct build keys the two agree.
//
// What bounds it on this card: the bytes (8 a probe for the key read and
// the value written, and the build keys and values a tile spans) once the
// dependent loads of the searches are off the critical path; it stays
// above that bound by the chain of latencies each tile waits for.  A
// search from the top of a 72M-key array is ~27 dependent global loads;
// here a persistent block takes a run of consecutive tiles of JOIN_TILE
// probes (join_tile.cuh: 16-byte streaming loads and stores) and per tile:
//   * reduces the probes' min and max, and finds the build rows [lo, hi)
//     they span, warp 0 and warp 1 one end each, by 32-way warp searches
//     (a ballot over 32 pivots a step).  Clustered probes (lineitem's come
//     by order) make the previous tile's range predict this one's: lo in
//     a 32-row window at the previous hi, hi among 32 pivots 16 rows apart
//     around the previous hi plus the previous span, one or two steps on
//     lines the block has just read.  When the prediction misses, a
//     strided sample of MJ_SAMPLE build keys held in shared memory (the
//     search's top levels) brackets the search to R / MJ_SAMPLE rows;
//   * when hi - lo <= MJ_STAGE, stages keys[lo, hi) in shared memory with
//     cp.async, indexes them by MJ_BUCKETS buckets of the tile's key range
//     (a scatter: each staged key opens the buckets up to its own), and
//     ranks each probe by its bucket and a short search inside it, checks
//     the key and gathers the value from global memory (rows of one narrow
//     range, cached);
//   * otherwise (unclustered probes, or a range over the budget) narrows
//     each probe's own search with the sample, intersected with [lo, hi),
//     and finishes it with at most log2(R / MJ_SAMPLE) global loads, a
//     thread's 8 probes interleaved.
// The tiles are pipelined: the next tile's probe keys load while this
// one's are ranked, and its range is searched while this one's gathers
// are in flight.  Shared memory holds one tile's staged keys (8 KB), the
// sample (16 KB) and the index, so 6 blocks (48 warps) fit an SM, and the
// registers are capped for 6 (MJ_BLOCKS_PER_SM).

#include <limits.h>

#include "join_tile.cuh"

#define MJ_STAGE 2048      // build keys a tile may stage: 8 KB
#define MJ_SAMPLE 4096     // sampled build keys a block holds: 16 KB
#define MJ_LOG2_BUCKETS 7  // the staged keys' index: 128 buckets
#define MJ_BUCKETS (1 << MJ_LOG2_BUCKETS)
#define MJ_WARPS (JOIN_THREADS / 32)
#define MJ_BLOCKS_PER_SM 6 // registers capped for 6 blocks (48 warps) an SM
#define MJ_HI_WINDOW 512   // build rows the hi window spans (32 x 16)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the largest power of two <= n, 0 for n <= 0
__device__ __forceinline__ int64_t floor_pow2(int64_t n) {
    return n > 0 ? 1ll << (63 - __clzll(n)) : 0;
}

// The number of build keys below x (x up to INT_MAX + 1), searched by the
// whole warp (every lane returns it).  With a hint (w0 >= 0) the first step
// reads the window of pivots w0 - 1 + stride * lane: when x lies inside it
// (some pivot below x, some not) the rank is bracketed to stride - 1 rows
// in one step.  Otherwise the sample (keys[j * st], j < ns) brackets it to
// st - 1 rows.  Then each step reads 32 pivots a step apart and keeps the
// bucket the ballot's count names.
__device__ __forceinline__ int64_t warp_rank(
        const int32_t* __restrict__ keys, int64_t R,
        const int32_t* sample, int ns, int64_t st, int64_t x, int64_t w0,
        int stride) {
    const int lane = threadIdx.x & 31;
    int64_t a = 0, b = -1;
    if (w0 >= 0) {
        const int64_t q = w0 - 1 + (int64_t)stride * lane;
        const bool less = q < 0 || (q < R && (int64_t)__ldg(&keys[q]) < x);
        const int c = __popc(__ballot_sync(0xffffffffu, less));
        if (c > 0 && c < 32) {                       // keys[a - 1] < x
            a = w0 + (int64_t)stride * (c - 1);      // x <= keys[b]
            b = min(w0 - 1 + (int64_t)stride * c, R);
        }
    }
    if (b < 0) {
        int j = 0;                                   // sampled keys < x
        for (int s = (int)floor_pow2(ns); s > 0; s >>= 1)
            if (j + s <= ns && (int64_t)sample[j + s - 1] < x) j += s;
        // keys[(j - 1) st] < x <= keys[j st]: the rank is in [a, b]
        a = j ? (int64_t)(j - 1) * st + 1 : 0;
        b = j < ns ? (int64_t)j * st : R;
    }
    while (a < b) {
        const int64_t step = (b - a + 31) >> 5;
        const int64_t q = a + (lane + 1) * step - 1;
        const bool less = q < b && (int64_t)__ldg(&keys[q]) < x;
        const int c = __popc(__ballot_sync(0xffffffffu, less));
        const int64_t a0 = a;
        a = a0 + c * step;                           // keys[a - 1] < x
        b = min(a0 + (c + 1) * step - 1, b);         // keys[b] >= x
    }
    return a;
}

// the bucket of key k in a tile whose min is mn: (k - mn) >> shift, taken
// in 32-bit unsigned arithmetic (k - mn < 2^32 for k >= mn)
__device__ __forceinline__ int bucket(int32_t k, int32_t mn, int shift) {
    return (int)min(((uint32_t)k - (uint32_t)mn) >> shift,
                    (uint32_t)MJ_BUCKETS);
}

struct MjShared {
    int32_t sample[MJ_SAMPLE];       // keys[j * st], j < ns
    int32_t staged[MJ_STAGE];        // keys[lo, hi) of the tile in hand
    int32_t first[MJ_BUCKETS + 1];   // staged keys below each bucket
    int32_t ends[2][MJ_WARPS];       // each warp's min and max
    int32_t tile_ends[2];            // the tile's min and max
    int64_t range[2];                // lo, hi
};

// A tile's min and max (slots at or past S left out) and the build rows
// [lo, hi) they span, into sm.tile_ends and sm.range; within the budget,
// the copies of keys[lo, hi) into sm.staged are issued (cp.async) and left
// in flight.  The previous tile's [lo, hi) (hint_lo < 0: none) predicts
// this one's: lo near the previous hi, hi one previous span further, as
// clustered probes give them.  Called by every thread; two barriers.
template <bool VEC>
__device__ __forceinline__ void prepare(
        MjShared& sm, const int32_t (&k)[JOIN_PER_THREAD], int64_t base,
        int64_t S, const int32_t* __restrict__ keys, int64_t R, int ns,
        int64_t st, int64_t hint_lo, int64_t hint_hi) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int j = 0; j < JOIN_PER_THREAD; ++j)
        if (tile_slot<VEC>(base, j) < S) {
            mn = min(mn, k[j]);
            mx = max(mx, k[j]);
        }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) {
        sm.ends[0][warp] = mn;
        sm.ends[1][warp] = mx;
    }
    __syncthreads();
    if (warp < 2) {              // warp 0: lo = rank(min); 1: hi = rank(max + 1)
        int32_t e = sm.ends[warp][lane < MJ_WARPS ? lane : 0];
        e = warp ? __reduce_max_sync(0xffffffffu, e)
                 : __reduce_min_sync(0xffffffffu, e);
        // lo: a 32-row window from 8 rows before the previous hi; hi: 32
        // pivots MJ_HI_WINDOW / 32 rows apart around the predicted hi
        const int64_t w0 = hint_lo < 0 ? -1
            : max(warp ? 2 * hint_hi - hint_lo - MJ_HI_WINDOW / 2
                       : hint_hi - 8, (int64_t)0);
        const int64_t r = warp_rank(keys, R, sm.sample, ns, st,
                                    (int64_t)e + warp, w0,
                                    warp ? MJ_HI_WINDOW / 32 : 1);
        if (lane == 0) {
            sm.tile_ends[warp] = e;
            sm.range[warp] = r;
        }
    }
    __syncthreads();
    const int64_t lo = sm.range[0], n = sm.range[1] - lo;
    if (n <= MJ_STAGE)
        for (int j = threadIdx.x; j < n; j += JOIN_THREADS)
            cp_async4(&sm.staged[j], keys + lo + j);
}

// The values of a prepared tile's probe keys k into v (gathers left in
// flight).  Called by every thread; holds one or two barriers.
__device__ __forceinline__ void join_tile(
        MjShared& sm, const int32_t (&k)[JOIN_PER_THREAD],
        int32_t (&v)[JOIN_PER_THREAD], const int32_t* __restrict__ keys,
        const int32_t* __restrict__ vals, int64_t R, int ns, int64_t st) {
    cp_async_wait_all();
    __syncthreads();
    // every probe of the tile ranks in [lo, hi]; keys[hi] > the max
    const int64_t lo = sm.range[0], hi = sm.range[1];
    const int32_t mn = sm.tile_ends[0];
    if (hi - lo <= MJ_STAGE) {
        // buckets of 2^shift key values from the tile's min, the last
        // holding its max; first[b]: staged keys below bucket b, i.e. the
        // staged index i whose key opens bucket b or the first one after
        // it (every staged key lies in [min, max]: a bucket of its own)
        const int n = (int)(hi - lo);
        const int shift = max(0, 64 - __clzll((int64_t)sm.tile_ends[1] - mn)
                                     - MJ_LOG2_BUCKETS);
        for (int i = threadIdx.x; i <= n; i += JOIN_THREADS) {
            const int b0 = i ? bucket(sm.staged[i - 1], mn, shift) + 1 : 0;
            const int b1 = i < n ? bucket(sm.staged[i], mn, shift)
                                 : MJ_BUCKETS;
            for (int b = b0; b <= b1; ++b) sm.first[b] = i;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < JOIN_PER_THREAD; ++j) {
            // slots past S hold 0, which may lie below the min: clamp
            const int b = min(bucket(k[j], mn, shift), MJ_BUCKETS - 1);
            int c = sm.first[b], len = sm.first[b + 1] - c;
            while (len > 0) {
                const int half = len >> 1;
                if (sm.staged[c + half] < k[j]) {
                    c += half + 1;
                    len -= half + 1;
                } else {
                    len = half;
                }
            }
            v[j] = c < n && sm.staged[c] == k[j] ? __ldg(&vals[lo + c]) : -1;
        }
        return;
    }
    int js[JOIN_PER_THREAD] = {};
    for (int s = (int)floor_pow2(ns); s > 0; s >>= 1) {
#pragma unroll
        for (int j = 0; j < JOIN_PER_THREAD; ++j)
            if (js[j] + s <= ns && sm.sample[js[j] + s - 1] < k[j]) js[j] += s;
    }
    int64_t a[JOIN_PER_THREAD];
    int len[JOIN_PER_THREAD], c[JOIN_PER_THREAD] = {};
#pragma unroll
    for (int j = 0; j < JOIN_PER_THREAD; ++j) {
        a[j] = max(lo, js[j] ? (int64_t)(js[j] - 1) * st + 1 : 0);
        len[j] = (int)(min(hi, js[j] < ns ? (int64_t)js[j] * st : R) - a[j]);
    }
    for (int64_t s = floor_pow2(st - 1); s > 0; s >>= 1) {
#pragma unroll
        for (int j = 0; j < JOIN_PER_THREAD; ++j)
            if (c[j] + s <= len[j] && __ldg(&keys[a[j] + c[j] + s - 1]) < k[j])
                c[j] += (int)s;
    }
#pragma unroll
    for (int j = 0; j < JOIN_PER_THREAD; ++j) {
        const int64_t pos = a[j] + c[j];
        v[j] = pos < R && __ldg(&keys[pos]) == k[j] ? __ldg(&vals[pos]) : -1;
    }
}

// A persistent grid; each block takes a run of consecutive tiles and
// pipelines them: the next tile's probe keys load while the current one's
// staged keys are ranked, and its range is searched while the current
// one's value gathers are in flight; its keys are staged after the
// current tile is done with the buffer.  Every barrier is reached by all
// threads (the branches around them are uniform over the block).
template <bool VEC>
__global__ void __launch_bounds__(JOIN_THREADS, MJ_BLOCKS_PER_SM)
merge_join_kernel(const int32_t* __restrict__ probe, int64_t S,
                  const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ vals, int64_t R,
                  int32_t* __restrict__ out) {
    __shared__ MjShared sm;
    // st = 1 holds every key (R <= MJ_SAMPLE); ns = 0 when R = 0
    const int64_t st = R <= MJ_SAMPLE ? 1 : (R + MJ_SAMPLE - 1) / MJ_SAMPLE;
    const int ns = (int)((R + st - 1) / st);
    for (int j = threadIdx.x; j < ns; j += JOIN_THREADS)
        sm.sample[j] = __ldg(&keys[j * st]);
    __syncthreads();
    const int64_t tiles = (S + JOIN_TILE - 1) / JOIN_TILE;
    const int64_t run = (tiles + gridDim.x - 1) / gridDim.x;
    int64_t tile = blockIdx.x * run;
    const int64_t end = min(tile + run, tiles);
    if (tile >= end) return;                         // the whole block
    int32_t k[JOIN_PER_THREAD];
    load_tile<VEC>(probe, S, tile * JOIN_TILE, k);
    prepare<VEC>(sm, k, tile * JOIN_TILE, S, keys, R, ns, st, -1, -1);
    for (; tile < end; ++tile) {
        const int64_t next = tile + 1;
        int32_t kn[JOIN_PER_THREAD], v[JOIN_PER_THREAD];
        if (next < end) load_tile<VEC>(probe, S, next * JOIN_TILE, kn);
        const int64_t lo = sm.range[0], hi = sm.range[1];   // the next hint
        join_tile(sm, k, v, keys, vals, R, ns, st);
        if (next < end)
            prepare<VEC>(sm, kn, next * JOIN_TILE, S, keys, R, ns, st, lo, hi);
        store_tile<VEC>(out, S, tile * JOIN_TILE, v);
#pragma unroll
        for (int j = 0; j < JOIN_PER_THREAD; ++j) k[j] = kn[j];
    }
}

template <bool VEC>
static int launch(const int32_t* probe, int64_t S, const int32_t* keys,
                  const int32_t* vals, int64_t R, int32_t* out,
                  cudaStream_t st) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, merge_join_kernel<VEC>, JOIN_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    // a persistent grid: each block loads its sample once
    const int64_t tiles = (S + JOIN_TILE - 1) / JOIN_TILE;
    const int64_t full = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    merge_join_kernel<VEC><<<(unsigned)(tiles < full ? tiles : full),
                             JOIN_THREADS, 0, st>>>(probe, S, keys, vals, R,
                                                    out);
    return (int)cudaGetLastError();
}

extern "C" {

// probe (S,), build keys ascending and values (R,), out (S,): int32; any
// alignment.  S > 0.  Returns the first CUDA error, or 0.
int merge_join(const void* probe, int64_t S, const void* bkeys,
               const void* bvals, int64_t R, void* out, void* stream) {
    const int32_t *p = (const int32_t*)probe, *k = (const int32_t*)bkeys,
                  *v = (const int32_t*)bvals;
    int32_t* o = (int32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    return aligned16(p, o) ? launch<true>(p, S, k, v, R, o, st)
                           : launch<false>(p, S, k, v, R, o, st);
}

// the compiled sizes: probes a tile, build keys a tile may stage, sampled
// build keys a block holds (the wrapper's TILE, STAGE and SAMPLE)
void merge_join_sizes(int32_t* sizes) {
    sizes[0] = JOIN_TILE;
    sizes[1] = MJ_STAGE;
    sizes[2] = MJ_SAMPLE;
}

}  // extern "C"
