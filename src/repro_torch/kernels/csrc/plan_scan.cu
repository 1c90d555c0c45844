// Fused decode + cost + argmin kernels for RAQO resource planning on Hopper.
//
// scan_argmin    replaces the reference's Pallas kernels _scan_kernel and
//                _scan_many_unrolled_kernel (src/repro/kernels/plan_scan.py):
//                decode flat row ids of the (containers x container-GB) grid
//                into configurations, evaluate a cost surface for every
//                request, and keep the first strict minimum per request.
// neighbor_step  replaces _neighbor_kernel: one step of the ensemble hill
//                climb (centre and 2*D +-1 neighbours of every start).
//
// What bounds them: FP32 ALU and SFU work.  A row reads nothing from device
// memory (its configuration is decoded from the row id, the request's
// params sit in shared memory), so the kernels move almost no bytes; each
// row costs a 32-bit divmod, a handful of IEEE divisions and, for the SMJ
// surface, one logf.  The first design keeps it simple: no config array or
// cost vector ever reaches device memory, every thread folds its rows in
// registers, and one 64-bit atomicMin per block and request combines the
// blocks.  Making it fast (fewer divisions, per-request hoisting of the
// request-only terms, a persistent grid) is later work.
//
// Order: TPU grids run in order, so the reference carried its (cost, index)
// accumulator across blocks.  CUDA blocks run in any order, so each thread
// keeps a strict-< running best over its rows in ascending order, a block
// reduction takes the lexicographic min of (cost, flat id), and the block
// result is folded with atomicMin on a key whose high 32 bits are the
// order-preserving bits of the cost and whose low 32 bits are the flat id:
// the lowest cost wins and a tie goes to the lowest flat id, which is the
// first minimum in enumerate_configs order whatever the block order.
//
// Arithmetic: built with -fmad=false and IEEE division, so every float32
// operation rounds as the plain PyTorch version's does on the card.  Each
// surface keeps the operation order of its Python expression
// (repro_torch/core/cost_model.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CONSTS 12
#define MAX_PARAMS 4
#define MAX_Q_PER_BLOCK 64
#define ROWS_PER_THREAD 8
#define SCAN_THREADS 256

enum { SURF_REGRESSION = 0, SURF_SMJ = 1, SURF_BHJ = 2 };
enum { OBJ_TIME = 0, OBJ_MONEY = 1, OBJ_SLA = 2 };

struct Dim {                       // one grid dimension's decode recipe
    int64_t lo, step, size;        // value = lo + step * idx (affine) ...
    const int64_t* values;         // ... or values[idx] when not null
};

struct Surface {
    int kind, objective, oom, n_params;
    float c[MAX_CONSTS];           // constants, rounded to float32 once
};

struct ScanArgs {
    Dim dim[2];                    // (num_containers, container_gb)
    Surface s;
    int64_t total;                 // rows of the grid (< 2**32)
    int64_t n_queries;
    int q_per_block;
};

struct NeighborArgs {
    Dim dim[2];
    Surface s;
    int64_t n_starts;
};

// np.maximum / torch.clamp_min: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

__device__ __forceinline__ float value_of(const Dim& d, int64_t idx) {
    int64_t v = d.values ? d.values[idx] : d.lo + d.step * idx;
    return (float)v;                                 // round to nearest
}

// RegressionModel.cost_grid: the linear form, floor clamp, OOM mask
__device__ __forceinline__ float regression(const float* c, int oom,
                                            float ss, float nc, float cs) {
    float v = c[0] * ss + c[1] * (ss * ss);
    v = v + c[2] * cs;
    v = v + c[3] * (cs * cs);
    v = v + c[4] * nc;
    v = v + c[5] * (nc * nc);
    v = v + c[6] * (cs * nc);
    float out = max_nan(v, c[7]);
    if (oom && ss > c[8] * cs) out = INFINITY;
    return out;
}

// HiveSimulator.smj_grid with ls = max(ls, ss)
// c = (startup, net_gbps, sort_const, disk_gbps * 80, probe_gbps)
__device__ __forceinline__ float smj(const float* c, float ss, float ls,
                                     float nc, float cs) {
    float big = max_nan(ls, ss);
    float total = ss + big;
    float shuffle = total / (c[1] * nc);
    float per_c = total / nc;
    float spill = max_nan(per_c / max_nan(cs * 0.5f, 1e-3f), 1.0f);
    float lg = logf(max_nan(total * 8.0f, 2.0f)) / 0.693147182464599609375f;
    float sort = c[2] * total * lg * spill / (c[3] * nc);
    float merge = total / (c[4] * nc);
    return c[0] + shuffle + sort + merge;
}

// HiveSimulator.bhj_grid with ls = max(ls, ss)
// c = (startup, net_gbps, build_gbps, probe_gbps, bhj_mem_frac)
__device__ __forceinline__ float bhj(const float* c, float ss, float ls,
                                     float nc, float cs) {
    float big = max_nan(ls, ss);
    float broadcast = ss * nc / (c[1] * nc) + ss / c[1] * 0.1f;
    float build = ss / c[2];
    float probe = big / (c[3] * nc);
    float out = c[0] + broadcast + build + probe;
    return ss > c[4] * cs ? INFINITY : out;
}

// one configuration's cost for one request's params p
__device__ __forceinline__ float surface_cost(const Surface& s,
                                              const float* p,
                                              float nc, float cs) {
    float ss = p[0], ls = p[1];
    float t;
    if (s.kind == SURF_REGRESSION) t = regression(s.c, s.oom, ss, nc, cs);
    else if (s.kind == SURF_SMJ) t = smj(s.c, ss, ls, nc, cs);
    else t = bhj(s.c, ss, ls, nc, cs);
    if (s.objective == OBJ_TIME) return t;
    // monetary_cost: exec_time_s / 3600.0 * cs * nc * 0.05
    float money = t / 3600.0f * cs * nc * 0.05f;
    if (s.objective == OBJ_MONEY) return isfinite(t) ? money : INFINITY;
    return t <= p[2] ? money : INFINITY;             // SLA: p[2] = target
}

// order-preserving unsigned bits of a float (-0.0 folded into +0.0)
__device__ __forceinline__ uint32_t ordered_bits(float x) {
    uint32_t u = __float_as_uint(x + 0.0f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// lexicographic (cost, flat) min, the reduction of every fold below
__device__ __forceinline__ void take_min(float& c, uint32_t& f,
                                         float oc, uint32_t of) {
    if (oc < c || (oc == c && of < f)) { c = oc; f = of; }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_argmin_kernel(ScanArgs a, const float* __restrict__ params,
                   unsigned long long* __restrict__ out) {
    __shared__ float sp[MAX_Q_PER_BLOCK * MAX_PARAMS];
    __shared__ float red_c[SCAN_THREADS / 32];
    __shared__ uint32_t red_f[SCAN_THREADS / 32];

    const int64_t q0 = (int64_t)blockIdx.y * a.q_per_block;
    int64_t nq = a.n_queries - q0;
    if (nq > a.q_per_block) nq = a.q_per_block;
    const int P = a.s.n_params;
    for (int i = threadIdx.x; i < nq * P; i += blockDim.x)
        sp[i] = params[q0 * P + i];

    // decode this thread's rows once: ascending flat ids, strided by the
    // block so a warp's rows are neighbours
    const int64_t tile = (int64_t)blockIdx.x * SCAN_THREADS * ROWS_PER_THREAD;
    float nc[ROWS_PER_THREAD], cs[ROWS_PER_THREAD];
    uint32_t flat[ROWS_PER_THREAD];
    int n_rows = 0;
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        int64_t r = tile + (int64_t)k * SCAN_THREADS + threadIdx.x;
        flat[k] = (uint32_t)r;
        if (r < a.total) {
            // row-major, first dim slowest: 32-bit divmod (total < 2**32)
            uint32_t s1 = (uint32_t)a.dim[1].size;
            uint32_t i0 = (uint32_t)r / s1, i1 = (uint32_t)r - i0 * s1;
            nc[k] = value_of(a.dim[0], i0);
            cs[k] = value_of(a.dim[1], i1);
            n_rows = k + 1;
        } else {
            nc[k] = cs[k] = 0.0f;
        }
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int64_t q = 0; q < nq; ++q) {
        const float* p = sp + q * P;
        float best = INFINITY;
        uint32_t best_f = 0xFFFFFFFFu;
#pragma unroll
        for (int k = 0; k < ROWS_PER_THREAD; ++k) {
            if (k < n_rows) {
                float c = surface_cost(a.s, p, nc[k], cs[k]);
                if (c < best) { best = c; best_f = flat[k]; }  // strict <
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            float oc = __shfl_down_sync(0xFFFFFFFFu, best, off);
            uint32_t of = __shfl_down_sync(0xFFFFFFFFu, best_f, off);
            take_min(best, best_f, oc, of);
        }
        if (lane == 0) { red_c[warp] = best; red_f[warp] = best_f; }
        __syncthreads();
        if (warp == 0) {
            best = lane < SCAN_THREADS / 32 ? red_c[lane] : INFINITY;
            best_f = lane < SCAN_THREADS / 32 ? red_f[lane] : 0xFFFFFFFFu;
            for (int off = 16; off > 0; off >>= 1) {
                float oc = __shfl_down_sync(0xFFFFFFFFu, best, off);
                uint32_t of = __shfl_down_sync(0xFFFFFFFFu, best_f, off);
                take_min(best, best_f, oc, of);
            }
            if (lane == 0 && best < INFINITY) {
                unsigned long long key =
                    ((unsigned long long)ordered_bits(best) << 32) | best_f;
                atomicMin(out + q0 + q, key);
            }
        }
        __syncthreads();             // red_* is reused by the next request
    }
}

__global__ void neighbor_step_kernel(NeighborArgs a,
                                     const int64_t* __restrict__ cur,
                                     const float* __restrict__ params,
                                     float* __restrict__ center,
                                     float* __restrict__ best_cost,
                                     int32_t* __restrict__ best_slot) {
    int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= a.n_starts) return;
    float p[MAX_PARAMS];
    for (int k = 0; k < a.s.n_params; ++k) p[k] = params[k];
    int64_t idx[2] = {cur[2 * s], cur[2 * s + 1]};
    center[s] = surface_cost(a.s, p, value_of(a.dim[0], idx[0]),
                             value_of(a.dim[1], idx[1]));
    // slots in _neighbor_offsets order: (dim 0, -1), (dim 0, +1),
    // (dim 1, -1), (dim 1, +1); first strict minimum wins, off-grid = inf
    float best = INFINITY;
    int32_t slot = 0;
    for (int j = 0; j < 4; ++j) {
        int d = j >> 1;
        int64_t n[2] = {idx[0], idx[1]};
        n[d] += (j & 1) ? 1 : -1;
        float c = INFINITY;
        if (n[d] >= 0 && n[d] < a.dim[d].size)
            c = surface_cost(a.s, p, value_of(a.dim[0], n[0]),
                             value_of(a.dim[1], n[1]));
        if (c < best) { best = c; slot = j; }
    }
    best_cost[s] = best;
    best_slot[s] = slot;
}

extern "C" {

// out: (n_queries,) uint64 keys, preset to all ones by the caller
int scan_argmin(const ScanArgs* args, const void* params, void* out,
                void* stream) {
    const ScanArgs& a = *args;
    const int64_t rows = (int64_t)SCAN_THREADS * ROWS_PER_THREAD;
    dim3 grid((unsigned)((a.total + rows - 1) / rows),
              (unsigned)((a.n_queries + a.q_per_block - 1) / a.q_per_block));
    scan_argmin_kernel<<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        a, (const float*)params, (unsigned long long*)out);
    return (int)cudaGetLastError();
}

int neighbor_step(const NeighborArgs* args, const void* cur,
                  const void* params, void* center, void* best_cost,
                  void* best_slot, void* stream) {
    const NeighborArgs& a = *args;
    const int threads = 128;
    unsigned blocks = (unsigned)((a.n_starts + threads - 1) / threads);
    neighbor_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        a, (const int64_t*)cur, (const float*)params, (float*)center,
        (float*)best_cost, (int32_t*)best_slot);
    return (int)cudaGetLastError();
}

}  // extern "C"
