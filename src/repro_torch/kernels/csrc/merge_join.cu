// Sort-merge join (SMJ) on sorted runs on Hopper: one thread per probe key
// finds its rank in the sorted build keys by binary search, checks the key
// there and gathers the value, all in one launch.
//
// Replaces the reference's Pallas kernel _rank_kernel in
// src/repro/kernels/merge_join.py (grid (probe tiles, build tiles): every
// probe tile compared with every build tile, the counts of build keys <=
// key summed in VMEM scratch, an O(S x R) count) and the clip, key check
// and gather that merge_join does after it in XLA.  Here the rank is a
// lower-bound search, O(S log R).
//
// Semantics (kernels/ref.py merge_join_ref, after the reference's oracle
// repro.kernels.ref.merge_join_ref): build_keys ascending (not checked, as
// in the reference); for each probe key, the value at the FIRST build row
// whose key equals it, or -1.  The Pallas kernel's rank (#(keys <= key) - 1)
// picks the last equal row instead; on distinct build keys the two agree.
//
// What bounds it on this card: the latency of the search's dependent loads,
// about log2(R) of them a probe (27 at R = 72M), not its bytes (8 bytes a
// probe for the keys read and the values written).  Probe keys that come
// clustered (lineitem by order) send a warp's 32 searches down nearly one
// path, so most of those loads hit the same L1/L2 lines; the top levels of
// the search stay in cache for every warp.  Many probes in flight (one
// thread each in a grid-stride loop) hide the rest.  A shared-memory copy
// of the search tree's top levels is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define JOIN_THREADS 256
#define MAX_BLOCKS 8192            // grid-stride loops beyond this

__global__ void __launch_bounds__(JOIN_THREADS)
merge_join_kernel(const int32_t* __restrict__ probe, int64_t S,
                  const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ vals, int64_t R,
                  int32_t* __restrict__ out) {
    const int64_t stride = (int64_t)gridDim.x * JOIN_THREADS;
    for (int64_t i = (int64_t)blockIdx.x * JOIN_THREADS + threadIdx.x; i < S;
         i += stride) {
        const int32_t k = probe[i];
        int64_t lo = 0, hi = R;          // first row with keys[row] >= k
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (__ldg(&keys[mid]) < k) lo = mid + 1;
            else hi = mid;
        }
        out[i] = (lo < R && __ldg(&keys[lo]) == k) ? __ldg(&vals[lo]) : -1;
    }
}

extern "C" {

// probe (S,), build keys and values (R,), out (S,): int32.  S > 0.
// Returns cudaGetLastError() after the launch.
int merge_join(const void* probe, int64_t S, const void* bkeys,
               const void* bvals, int64_t R, void* out, void* stream) {
    const int64_t b = (S + JOIN_THREADS - 1) / JOIN_THREADS;
    merge_join_kernel<<<(unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS),
                        JOIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)probe, S, (const int32_t*)bkeys,
        (const int32_t*)bvals, R, (int32_t*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
