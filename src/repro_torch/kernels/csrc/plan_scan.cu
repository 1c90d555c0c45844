// Fused decode + cost + argmin kernels for RAQO resource planning on Hopper.
//
// scan_argmin    replaces the reference's Pallas kernels _scan_kernel (K1),
//                _scan_many_unrolled_kernel (K2) and _scan_kernel_dyn (K4)
//                (src/repro/kernels/plan_scan.py): evaluate a cost surface
//                on every configuration of a resource grid of 1..MAX_DIMS
//                dimensions for every request, and keep the first strict
//                minimum per request.  The rows are a run-time range [row0,
//                row0 + nrows): the whole grid for K1/K2, one shard's span
//                for K4, so ONE compiled kernel serves every shard (the
//                reference passed the shard's block offset in as a traced
//                scalar for the same reason).  q_per_block requests share a
//                block: 1 is K1's geometry, up to MAX_Q_PER_BLOCK K2's.
// neighbor_step  replaces _neighbor_kernel (K3): one step of the ensemble
//                hill climb (centre and 2*D +-1 neighbours of every start).
// ensemble_climb the whole ensemble climb of K3 on the device: Q requests x
//                S starts, each climbing to convergence (or max_iters) in
//                one launch, where the reference's host loop launched one
//                neighbour step and synced once per iteration.  Both K3
//                kernels cost a slot through one __device__ function
//                (slot_cost), so their trajectories are the same by
//                construction.
//
// What bounds the scan: instruction issue.  A row reads nothing from device
// memory (its configuration is decoded from the row id, the requests'
// params sit in shared memory), so the scan moves almost no bytes; its time
// is the FP32 and SFU instructions of the surface, and an IEEE division is
// ~10 of them, logf ~20.  Most of the DB surfaces' work does not depend on
// the row: SMJ's log2 and its (request, num_containers) quotients, all of
// BHJ but its OOM mask, the regression's per-request and per-dimension
// terms.  So the DB surfaces (regression, SMJ, BHJ over (nc, cs)) run
// scan_db_kernel: a block takes a tile of whole dim-0 values (k values of
// nc x a window of dim 1, about TILE_ROWS rows, the last tile ragged),
// computes every request's (request, nc) terms once into shared memory and
// each row's (nc, cs) terms once into registers, and then evaluates per
// row and request only what needs both: SMJ two divisions (from six and a
// logf), BHJ a compare and a select, the regression five adds.  Each
// hoisted term is computed with exactly the float32 operations and
// operands of the row expression, and a hoisted partial sum is always a
// prefix of the expression's left-to-right order, so every cost is the
// same bits as before.  The objective wrap (money, SLA) stays per row.
// Table and roofline surfaces (small grids, bound by the wrapper's host
// work) keep the per-row scan_argmin_kernel.  ensemble_climb is a
// dependent chain (each step starts where the last one moved), so latency
// bounds it: it runs one group of lanes per (request, start), the next
// power of two >= 2*D + 1 lanes, one neighbour slot (or the centre) a
// lane, and a shuffle reduction picks the first strict minimum in slot
// order.
//
// Order: TPU grids run in order, so the reference carried its (cost, index)
// accumulator across blocks.  CUDA blocks run in any order, so each thread
// keeps a strict-< running best over its rows in ascending order, each
// warp reduces every request with shuffles to the lexicographic min of
// (cost, flat id) and parks it in shared memory, and after ONE barrier a
// thread per request folds the warps and issues one 64-bit atomicMin on a
// key whose high 32 bits are the order-preserving bits of the cost and
// whose low 32 bits are the GLOBAL flat id: the lowest cost wins and a tie
// goes to the lowest flat id, which is the first minimum in
// enumerate_configs order whatever the block order or tiling.  The same
// key folds K4's shards (repro_torch/kernels/plan_scan.py).
//
// Arithmetic: built with -fmad=false and IEEE division, so every float32
// operation rounds as the plain PyTorch version's does on the card.  Each
// surface keeps the operation order of its Python expression
// (repro_torch/core/cost_model.py, repro_torch/core/roofline.py); the host
// folds every resource-independent term to one constant in float64, in
// Python's order, and the kernel rounds it to float32 where the Python
// expression meets a tensor.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DIMS 8
#define MAX_CONSTS 16
#define MAX_PARAMS 4
#define MAX_Q_PER_BLOCK 64
#define ROWS_PER_THREAD 8
#define SCAN_THREADS 256
#define SCAN_WARPS (SCAN_THREADS / 32)
#define TILE_ROWS (SCAN_THREADS * ROWS_PER_THREAD)
#define DB_TILE_K 32               // dim-0 values a DB tile holds at most

enum { SURF_REGRESSION = 0, SURF_SMJ = 1, SURF_BHJ = 2, SURF_TABLE = 3,
       SURF_TRAIN = 4, SURF_PREFILL = 5, SURF_DECODE = 6 };
enum { OBJ_TIME = 0, OBJ_MONEY = 1, OBJ_SLA = 2, OBJ_CHIP_SECONDS = 3 };
// roofline switches (Surface.flags)
enum { F_REMAT = 1, F_FSDP = 2, F_SEQ_SHARD = 4, F_MOE = 8, F_GATHERED = 16 };

struct Dim {                       // one grid dimension's decode recipe
    int64_t lo, step, size;        // value = lo + step * idx (affine) ...
    const int64_t* values;         // ... or values[idx] when not null
};

struct Surface {
    int kind, objective, oom, n_params;
    int flags;                     // roofline switches
    int64_t batch;                 // roofline train: the global batch
    float c[MAX_CONSTS];           // constants, rounded to float32 once
};

struct ScanArgs {
    Dim dim[MAX_DIMS];             // first dim slowest
    int n_dims;
    Surface s;
    const float* table;            // SURF_TABLE: cost by flat row id
    int64_t total;                 // rows of the grid (< 2**32)
    int64_t row0, nrows;           // the rows this launch scans
    int64_t n_queries;
    int q_per_block;
};

struct NeighborArgs {
    Dim dim[MAX_DIMS];
    int n_dims;
    Surface s;
    const float* table;
    int64_t n_starts;
};

struct ClimbArgs {
    Dim dim[MAX_DIMS];
    int n_dims;
    Surface s;
    const float* table;
    int64_t n_queries, n_starts;
    int64_t max_iters;
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

// The DB surfaces over (nc, cs), split by what each term depends on: per
// request (per_q), per (request, nc) (per_qn, QN terms), per (nc, cs) (row),
// and what needs the row and the request (cost).  Each term is the
// Python expression's own operation on its own operands, and every partial
// sum is a prefix of the expression's left-to-right order.  db_cost puts
// them together for one row (neighbor_step, ensemble_climb); scan_db_kernel
// hoists each out of its loops; so both compute each surface with the same
// float32 operations, by construction.
template <int KIND> struct DbTerms;

// HiveSimulator.smj_grid with ls = max(ls, ss),
// c = (startup, net_gbps, sort_const, disk_gbps * 80, probe_gbps):
// ((c0 + shuffle) + sort) + merge with
// sort = (((c2 * total) * lg) * spill) / (c3 * nc) and
// spill = max(per_c / max(cs * 0.5, 1e-3), 1)
template <> struct DbTerms<SURF_SMJ> {
    static constexpr int QN = 3;                 // c0 + shuffle, per_c, merge
    struct Row { float c3nc, half_cs; };
    __device__ static float per_q(const float* c, float ss, float ls) {
        float total = ss + max_nan(ls, ss);
        float lg = logf(max_nan(total * 8.0f, 2.0f)) /
                   0.693147182464599609375f;
        return c[2] * total * lg;
    }
    __device__ static void per_qn(const float* c, float ss, float ls,
                                  float nc, float* t) {
        float total = ss + max_nan(ls, ss);
        t[0] = c[0] + total / (c[1] * nc);
        t[1] = total / nc;
        t[2] = total / (c[4] * nc);
    }
    __device__ static Row row(const Surface& s, float nc, float cs) {
        return {s.c[3] * nc, max_nan(cs * 0.5f, 1e-3f)};
    }
    template <bool>
    __device__ static float cost(const Surface&, float, float pq,
                                 const float* t, const Row& r) {
        float spill = max_nan(t[1] / r.half_cs, 1.0f);
        float sort = pq * spill / r.c3nc;
        return t[0] + sort + t[2];
    }
};

// HiveSimulator.bhj_grid with ls = max(ls, ss),
// c = (startup, net_gbps, build_gbps, probe_gbps, bhj_mem_frac):
// everything but the OOM mask is per (request, nc)
template <> struct DbTerms<SURF_BHJ> {
    static constexpr int QN = 1;                 // the cost before the mask
    struct Row { float mem; };
    __device__ static float per_q(const float*, float, float) { return 0.f; }
    __device__ static void per_qn(const float* c, float ss, float ls,
                                  float nc, float* t) {
        float big = max_nan(ls, ss);
        float broadcast = ss * nc / (c[1] * nc) + ss / c[1] * 0.1f;
        float build = ss / c[2];
        float probe = big / (c[3] * nc);
        t[0] = c[0] + broadcast + build + probe;
    }
    __device__ static Row row(const Surface& s, float, float cs) {
        return {s.c[4] * cs};
    }
    template <bool>
    __device__ static float cost(const Surface&, float ss, float,
                                 const float* t, const Row& r) {
        return ss > r.mem ? INFINITY : t[0];
    }
};

// RegressionModel.cost_grid: c0 ss + c1 ss^2 per request, then the cs, nc
// and cs * nc terms added in order, the floor and the OOM mask
template <> struct DbTerms<SURF_REGRESSION> {
    static constexpr int QN = 0;
    struct Row { float c2cs, c3cs2, c4nc, c5nc2, c6csnc, oom_cs; };
    __device__ static float per_q(const float* c, float ss, float) {
        return c[0] * ss + c[1] * (ss * ss);
    }
    __device__ static void per_qn(const float*, float, float, float,
                                  float*) {}
    __device__ static Row row(const Surface& s, float nc, float cs) {
        const float* c = s.c;
        return {c[2] * cs, c[3] * (cs * cs), c[4] * nc, c[5] * (nc * nc),
                c[6] * (cs * nc), c[8] * cs};
    }
    template <bool OOM>
    __device__ static float cost(const Surface& s, float ss, float pq,
                                 const float*, const Row& r) {
        float v = pq + r.c2cs;
        v = v + r.c3cs2;
        v = v + r.c4nc;
        v = v + r.c5nc2;
        v = v + r.c6csnc;
        float out = max_nan(v, s.c[7]);
        if (OOM && ss > r.oom_cs) out = INFINITY;
        return out;
    }
};

// the objective's wrap of a time t (Surface.objective, p[2] the SLA target)
__device__ __forceinline__ float objective(int obj, float t, float nc,
                                           float cs, const float* p) {
    if (obj == OBJ_TIME) return t;
    // monetary_cost: exec_time_s / 3600.0 * cs * nc * 0.05
    float money = t / 3600.0f * cs * nc * 0.05f;
    if (obj == OBJ_MONEY) return isfinite(t) ? money : INFINITY;
    return t <= p[2] ? money : INFINITY;
}

// one row of a DB surface, wrapped in its objective
template <int KIND>
__device__ __forceinline__ float db_cost(const Surface& s, const float* p,
                                         float nc, float cs) {
    using T = DbTerms<KIND>;
    float ss = p[0], ls = p[1];
    float tqn[T::QN > 0 ? T::QN : 1];
    T::per_qn(s.c, ss, ls, nc, tqn);
    const float pq = T::per_q(s.c, ss, ls);
    const typename T::Row r = T::row(s, nc, cs);
    float t = s.oom ? T::template cost<true>(s, ss, pq, tqn, r)
                    : T::template cost<false>(s, ss, pq, tqn, r);
    return objective(s.objective, t, nc, cs, p);
}

// ---------------------------- roofline surfaces ---------------------------- //
// repro_torch/core/roofline.py's *_terms_grid in float32, wrapped in
// ShardingPlanner._grid_fn's objective and masks.  Row values (pods, dp,
// tp, mb); constants as RooflineCost.consts() lists them.  Each line keeps
// its Python expression's order; "0.0f + x" is the Python "wire = 0.0;
// wire = wire + x".

enum { R_N = 0, R_N2, R_HBM, R_FLOPS, R_PEAK, R_BW, R_LINK, R_TOKENS,
       R_TOPK, R_A, R_B, R_C, R_D, R_E };

// step time (or chip-seconds) of one configuration, inf where masked
__device__ __forceinline__ float roofline_finish(
        const Surface& s, const float* p, float chips, float compute_s,
        float traffic, float wire, float hbm, bool bad) {
    const float* c = s.c;
    float memory_s = traffic / c[R_BW];
    float collective_s = wire / c[R_LINK];
    float step = compute_s + memory_s + collective_s;
    float cost = s.objective == OBJ_CHIP_SECONDS ? step * chips : step;
    bad = bad || !(hbm < c[R_HBM]) || chips > p[0] || chips > p[1];
    return bad ? INFINITY : cost;
}

// train_terms_grid; R_A = 12.0 * L, R_B = 6.0 * L, R_C = d_model * 2,
// R_D = 2 * 2 * blocks * L, R_E = L
__device__ __forceinline__ float roofline_train(
        const Surface& s, const float* p, const float* v) {
    const float* c = s.c;
    const bool remat = s.flags & F_REMAT, fsdp = s.flags & F_FSDP,
               seq = s.flags & F_SEQ_SHARD;
    const float pods = v[0], dp = v[1], tp = v[2], mb = v[3];
    float chips = pods * dp * tp;
    float dp_total = pods * dp;
    float param_shard = c[R_N] / (fsdp ? tp * dp : tp * 1.0f);
    float weight_read = c[R_N] / tp * 3.0f * 2.0f;
    float opt_rw = param_shard * 5.0f * 4.0f;
    float grad_rw = param_shard * 2.0f * 4.0f;
    float tok_local = c[R_TOKENS] / dp_total;
    float sp_div = seq ? tok_local / tp : tok_local / 1.0f;
    float act_rw = c[R_A] * sp_div * c[R_C] +
                   c[R_B] * tok_local * c[R_C] / tp;
    float traffic = weight_read + opt_rw + grad_rw + act_rw;
    traffic = traffic + (mb - 1.0f) * weight_read * 0.5f;
    float wire = 0.0f + c[R_D] * (tok_local * c[R_C]) * (tp - 1.0f) / tp;
    if (fsdp) {
        wire = wire + c[R_N2] / tp * 3.0f * (dp - 1.0f) / dp * mb;
        wire = wire + c[R_N2] / tp * (dp - 1.0f) / dp;
    }
    float red = fsdp ? pods : dp_total;
    wire = wire + c[R_N2] / (fsdp ? tp * dp : tp * 1.0f) * 2.0f *
                  (red - 1.0f) / red;
    if (s.flags & F_MOE)
        wire = wire + c[R_TOKENS] / chips * 6.0f * c[R_TOPK] * c[R_C];
    float act_saved = c[R_E] * (tok_local / (seq ? tp * mb : mb)) * c[R_C];
    if (!remat) act_saved = act_saved * 8.0f;
    float hbm = param_shard * 16.0f + act_saved + c[R_N] / tp * 2.0f;
    float compute_s = c[R_FLOPS] / (chips * c[R_PEAK]);
    // the grid's values are small integers, exact in float32
    bool bad = s.batch % ((int64_t)pods * (int64_t)dp * (int64_t)mb) != 0;
    return roofline_finish(s, p, chips, compute_s, traffic, wire, hbm, bad);
}

// prefill_terms_grid; R_A = 6.0 * L, R_B = d_model, R_C = 4 * L,
// R_D = the KV/state cache bytes
__device__ __forceinline__ float roofline_prefill(
        const Surface& s, const float* p, const float* v) {
    const float* c = s.c;
    const float pods = v[0], dp = v[1], tp = v[2];
    float chips = pods * dp * tp;
    float dp_total = pods * dp;
    float tok_local = c[R_TOKENS] / dp_total;
    float traffic = c[R_N2] / tp + c[R_A] * tok_local * c[R_B] * 2.0f +
                    c[R_D] / chips;
    float wire = 0.0f + tok_local * c[R_C] * c[R_B] * 2.0f * (tp - 1.0f) / tp;
    if (s.flags & F_MOE)
        wire = wire + c[R_TOKENS] / chips * 3.0f * c[R_TOPK] * c[R_B] * 2.0f;
    float hbm = c[R_N2] / tp + c[R_D] / chips +
                tok_local * c[R_B] * 2.0f * 4.0f;
    float compute_s = c[R_FLOPS] / (chips * c[R_PEAK]);
    return roofline_finish(s, p, chips, compute_s, traffic, wire, hbm, false);
}

// decode_terms_grid; R_A = the cache bytes, R_B = 2 * L * B * d_model * 2,
// R_C = B, R_D = d_model
__device__ __forceinline__ float roofline_decode(
        const Surface& s, const float* p, const float* v) {
    const float* c = s.c;
    const bool gathered = s.flags & F_GATHERED;
    const float pods = v[0], dp = v[1], tp = v[2];
    float chips = pods * dp * tp;
    float weights = gathered ? c[R_N2] / chips : c[R_N2] / tp;
    float traffic = weights + c[R_A] / chips;
    float wire = 0.0f + (tp - 1.0f) * c[R_B] / tp /
                        max_nan(pods * dp, 1.0f);
    if (gathered)
        wire = wire + c[R_N2] / tp * (dp - 1.0f) / max_nan(dp, 1.0f);
    if (s.flags & F_MOE)
        wire = wire + c[R_C] / chips * 6.0f * c[R_TOPK] * c[R_D] * 2.0f;
    float hbm = weights + c[R_A] / chips;
    float compute_s = c[R_FLOPS] / (chips * c[R_PEAK]);
    return roofline_finish(s, p, chips, compute_s, traffic, wire, hbm, false);
}

// one configuration's cost for one request's params p: v holds its ND
// grid values, flat its row id (for the table surface)
template <int KIND, int ND>
__device__ __forceinline__ float surface_cost(const Surface& s,
                                              const float* table,
                                              const float* p,
                                              const float* v,
                                              uint32_t flat) {
    if constexpr (KIND == SURF_TABLE) return table[flat] + p[0];
    else if constexpr (KIND == SURF_TRAIN) return roofline_train(s, p, v);
    else if constexpr (KIND == SURF_PREFILL)
        return roofline_prefill(s, p, v);
    else if constexpr (KIND == SURF_DECODE) return roofline_decode(s, p, v);
    else return db_cost<KIND>(s, p, v[0], v[1]);
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

// the block's end of a scan: every warp has parked its (cost, flat) min of
// each of the nq requests in red_*[warp][q]; after one barrier a thread per
// request folds the warps in order and issues the request's one atomicMin
__device__ __forceinline__ void fold_block(
        float (*red_c)[MAX_Q_PER_BLOCK], uint32_t (*red_f)[MAX_Q_PER_BLOCK],
        int64_t nq, unsigned long long* out) {
    __syncthreads();
    for (int q = threadIdx.x; q < nq; q += SCAN_THREADS) {
        float best = red_c[0][q];
        uint32_t best_f = red_f[0][q];
#pragma unroll
        for (int w = 1; w < SCAN_WARPS; ++w)
            take_min(best, best_f, red_c[w][q], red_f[w][q]);
        if (best < INFINITY) {
            unsigned long long key =
                ((unsigned long long)ordered_bits(best) << 32) | best_f;
            atomicMin(out + q, key);
        }
    }
}

// a warp's (cost, flat) min of one request, parked in red_*[warp][q]
__device__ __forceinline__ void warp_min(
        float best, uint32_t best_f, int q,
        float (*red_c)[MAX_Q_PER_BLOCK], uint32_t (*red_f)[MAX_Q_PER_BLOCK]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        float oc = __shfl_down_sync(0xFFFFFFFFu, best, off);
        uint32_t of = __shfl_down_sync(0xFFFFFFFFu, best_f, off);
        take_min(best, best_f, oc, of);
    }
    if ((threadIdx.x & 31) == 0) {
        red_c[threadIdx.x >> 5][q] = best;
        red_f[threadIdx.x >> 5][q] = best_f;
    }
}

// the per-row scan of any surface (tables and rooflines)
template <int KIND, int ND>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_argmin_kernel(ScanArgs a, const float* __restrict__ params,
                   unsigned long long* __restrict__ out) {
    __shared__ float sp[MAX_Q_PER_BLOCK * MAX_PARAMS];
    __shared__ float red_c[SCAN_WARPS][MAX_Q_PER_BLOCK];
    __shared__ uint32_t red_f[SCAN_WARPS][MAX_Q_PER_BLOCK];

    const int64_t q0 = (int64_t)blockIdx.y * a.q_per_block;
    int64_t nq = a.n_queries - q0;
    if (nq > a.q_per_block) nq = a.q_per_block;
    const int P = a.s.n_params;
    for (int i = threadIdx.x; i < nq * P; i += blockDim.x)
        sp[i] = params[q0 * P + i];

    // decode this thread's rows once: ascending flat ids, strided by the
    // block so a warp's rows are neighbours; the last tile of a span (and
    // of the grid) is ragged
    int64_t end = a.row0 + a.nrows;
    if (end > a.total) end = a.total;
    const int64_t tile = a.row0 + (int64_t)blockIdx.x * TILE_ROWS;
    float v[ROWS_PER_THREAD][ND];
    uint32_t flat[ROWS_PER_THREAD];
    int n_rows = 0;
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        int64_t r = tile + (int64_t)k * SCAN_THREADS + threadIdx.x;
        flat[k] = (uint32_t)r;
        if (r < end) {
            // row-major, first dim slowest: 32-bit divmods (total < 2**32)
            uint32_t rem = (uint32_t)r;
#pragma unroll
            for (int d = ND - 1; d > 0; --d) {
                uint32_t sz = (uint32_t)a.dim[d].size;
                uint32_t q = rem / sz;
                v[k][d] = value_of(a.dim[d], rem - q * sz);
                rem = q;
            }
            v[k][0] = value_of(a.dim[0], rem);
            n_rows = k + 1;
        } else {
#pragma unroll
            for (int d = 0; d < ND; ++d) v[k][d] = 0.0f;
        }
    }
    __syncthreads();

    for (int q = 0; q < nq; ++q) {
        const float* p = sp + q * P;
        float best = INFINITY;
        uint32_t best_f = 0xFFFFFFFFu;
#pragma unroll
        for (int k = 0; k < ROWS_PER_THREAD; ++k) {
            if (k < n_rows) {
                float c = surface_cost<KIND, ND>(a.s, a.table, p, v[k],
                                                 flat[k]);
                if (c < best) { best = c; best_f = flat[k]; }  // strict <
            }
        }
        warp_min(best, best_f, q, red_c, red_f);
    }
    fold_block(red_c, red_f, nq, out + q0);
}

// ------------------------- the DB surfaces' scan ---------------------------- //
// A tile: k consecutive dim-0 (nc) values x a window of w dim-1 (cs) values,
// k * w <= TILE_ROWS, k <= DB_TILE_K; block x is window x % n_w of dim-0
// group x / n_w.  first / n0: the dim-0 values the row range touches.
struct DbTile {
    int64_t first, n0;
    int k, w, n_w;
};

// OOM: the regression's memory mask is on (RegressionModel.oom_frac)
template <int KIND, int OBJ, bool OOM>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_db_kernel(ScanArgs a, DbTile t, const float* __restrict__ params,
               unsigned long long* __restrict__ out) {
    using T = DbTerms<KIND>;
    constexpr int QN = T::QN > 0 ? T::QN : 1;
    __shared__ float sp[MAX_Q_PER_BLOCK * MAX_PARAMS];
    __shared__ float spq[MAX_Q_PER_BLOCK];
    __shared__ float sqn[MAX_Q_PER_BLOCK * DB_TILE_K * QN];
    __shared__ float red_c[SCAN_WARPS][MAX_Q_PER_BLOCK];
    __shared__ uint32_t red_f[SCAN_WARPS][MAX_Q_PER_BLOCK];

    const int64_t q0 = (int64_t)blockIdx.y * a.q_per_block;
    int64_t nq = a.n_queries - q0;
    if (nq > a.q_per_block) nq = a.q_per_block;
    const int P = a.s.n_params;
    const float* pg = params + q0 * P;

    const int64_t s1 = a.dim[1].size;
    const int64_t i0 = t.first + (int64_t)(blockIdx.x / t.n_w) * t.k;
    const int64_t j0 = (int64_t)(blockIdx.x % t.n_w) * t.w;
    const int kn = (int)min((int64_t)t.k, t.first + t.n0 - i0);
    const int wn = (int)min((int64_t)t.w, s1 - j0);

    // the block's hoisted terms, from the params in device memory (the
    // shared copy is not ready before the barrier)
    for (int i = threadIdx.x; i < nq * P; i += SCAN_THREADS) sp[i] = pg[i];
    for (int q = threadIdx.x; q < nq; q += SCAN_THREADS)
        spq[q] = T::per_q(a.s.c, pg[q * P], pg[q * P + 1]);
    if constexpr (T::QN > 0) {
        for (int e = threadIdx.x; e < nq * kn; e += SCAN_THREADS) {
            const int q = e / kn, kk = e - q * kn;
            T::per_qn(a.s.c, pg[q * P], pg[q * P + 1],
                      value_of(a.dim[0], i0 + kk),
                      sqn + (q * DB_TILE_K + kk) * QN);
        }
    }

    // this thread's rows: tile rows tid, tid + SCAN_THREADS, ..., the cs
    // window fastest, so flat ids ascend and a warp's rows are neighbours;
    // rows outside [row0, end) (a shard's edges) are masked
    int64_t end = a.row0 + a.nrows;
    if (end > a.total) end = a.total;
    typename T::Row rv[ROWS_PER_THREAD];
    float ncv[ROWS_PER_THREAD], csv[ROWS_PER_THREAD];
    int kkv[ROWS_PER_THREAD];
    uint32_t flat[ROWS_PER_THREAD];
    uint32_t live = 0;
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int i = k * SCAN_THREADS + threadIdx.x;
        const int kk = i / wn, ci = i - kk * wn;
        const int64_t r = (i0 + kk) * s1 + j0 + ci;
        const bool ok = kk < kn && r >= a.row0 && r < end;
        kkv[k] = ok ? kk : 0;
        flat[k] = (uint32_t)r;
        ncv[k] = ok ? value_of(a.dim[0], i0 + kk) : 0.0f;
        csv[k] = ok ? value_of(a.dim[1], j0 + ci) : 0.0f;
        rv[k] = T::row(a.s, ncv[k], csv[k]);
        live |= (uint32_t)ok << k;
    }
    __syncthreads();

    for (int q = 0; q < nq; ++q) {
        const float* p = sp + q * P;
        const float ss = p[0], pq = spq[q];
        const float* tq = sqn + q * DB_TILE_K * QN;
        float best = INFINITY;
        uint32_t best_f = 0xFFFFFFFFu;
        // every row is evaluated (a masked row's terms are those of
        // (0, 0)) and a masked one never wins: no branch a row
#pragma unroll
        for (int k = 0; k < ROWS_PER_THREAD; ++k) {
            float c = T::template cost<OOM>(a.s, ss, pq, tq + kkv[k] * QN,
                                            rv[k]);
            c = objective(OBJ, c, ncv[k], csv[k], p);
            if (((live >> k) & 1) && c < best) {      // strict <
                best = c;
                best_f = flat[k];
            }
        }
        warp_min(best, best_f, q, red_c, red_f);
    }
    fold_block(red_c, red_f, nq, out + q0);
}

// the cost of slot j of a start at grid indices idx (values v): slots 0 ..
// 2ND - 1 are its +-1 neighbours in _neighbor_offsets order ((dim 0, -1),
// (dim 0, +1), (dim 1, -1), ...), inf off the grid; slot 2ND is the centre
template <int KIND, int ND>
__device__ __forceinline__ float slot_cost(const Dim* dim, const Surface& s,
                                           const float* table,
                                           const float* p,
                                           const int64_t* idx,
                                           const float* v, int j) {
    const int d = j >> 1;                      // the centre moves no dim
    float nv[ND];
    uint32_t flat = 0;
#pragma unroll
    for (int e = 0; e < ND; ++e) {
        int64_t i = idx[e];
        nv[e] = v[e];
        if (e == d) {
            i += (j & 1) ? 1 : -1;
            if (i < 0 || i >= dim[e].size) return INFINITY;
            nv[e] = value_of(dim[e], i);
        }
        flat = flat * (uint32_t)dim[e].size + (uint32_t)i;
    }
    return surface_cost<KIND, ND>(s, table, p, nv, flat);
}

template <int ND>
__device__ __forceinline__ int in_grid_neighbours(const Dim* dim,
                                                  const int64_t* idx) {
    int n = 0;
#pragma unroll
    for (int d = 0; d < ND; ++d)
        n += (idx[d] > 0) + (idx[d] < dim[d].size - 1);
    return n;
}

template <int KIND, int ND>
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
    int64_t idx[ND];
    float v[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
        idx[d] = cur[ND * s + d];
        v[d] = value_of(a.dim[d], idx[d]);
    }
    center[s] = slot_cost<KIND, ND>(a.dim, a.s, a.table, p, idx, v, 2 * ND);
    // first strict minimum over the neighbour slots, off-grid = inf
    float best = INFINITY;
    int32_t slot = 0;
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j) {
        float c = slot_cost<KIND, ND>(a.dim, a.s, a.table, p, idx, v, j);
        if (c < best) { best = c; slot = j; }
    }
    best_cost[s] = best;
    best_slot[s] = slot;
}

#define CLIMB_THREADS 128

// lanes a (request, start) climbs on: the next power of two >= 2ND + 1
template <int ND>
struct ClimbLanes {
    static constexpr int value = 2 * ND + 1 <= 4 ? 4 : 2 * ND + 1 <= 8 ? 8 :
                                 2 * ND + 1 <= 16 ? 16 : 32;
};

// out_idx (Q, S, ND) int64, out_cost (Q, S) float32 at the final index,
// iters (Q, S): iterations the start evaluated (moves + 1, at most
// max_iters), valid_sum (Q, S): in-grid neighbours summed over them,
// valid_final (Q, S): in-grid neighbours at the final index
template <int KIND, int ND>
__global__ void __launch_bounds__(CLIMB_THREADS)
ensemble_climb_kernel(ClimbArgs a, const int64_t* __restrict__ starts,
                      const float* __restrict__ params,
                      int64_t* __restrict__ out_idx,
                      float* __restrict__ out_cost,
                      int64_t* __restrict__ iters,
                      int64_t* __restrict__ valid_sum,
                      int64_t* __restrict__ valid_final) {
    constexpr int L = ClimbLanes<ND>::value;
    const int64_t g = ((int64_t)blockIdx.x * CLIMB_THREADS + threadIdx.x) / L;
    const int j = threadIdx.x % L;
    const bool live = g < a.n_queries * a.n_starts;
    const int64_t q = live ? g / a.n_starts : 0;
    const int64_t st = live ? g % a.n_starts : 0;
    float p[MAX_PARAMS];                     // in registers
#pragma unroll
    for (int k = 0; k < MAX_PARAMS; ++k)
        p[k] = k < a.s.n_params ? params[q * a.s.n_params + k] : 0.0f;
    int64_t idx[ND];
    float v[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
        idx[d] = starts[ND * st + d];
        v[d] = value_of(a.dim[d], idx[d]);
    }
    float cost = INFINITY;
    int64_t it = 0, vsum = 0;
    bool done = !live || a.max_iters <= 0;
    // the whole warp iterates until its last group is done, so every
    // shuffle has all 32 lanes; a finished group idles
    while (__any_sync(0xFFFFFFFFu, !done)) {
        float c = INFINITY;
        if (!done && j <= 2 * ND)
            c = slot_cost<KIND, ND>(a.dim, a.s, a.table, p, idx, v, j);
        const float centre = __shfl_sync(0xFFFFFFFFu, c, 2 * ND, L);
        // (cost, slot) over the neighbour slots, first strict minimum:
        // NaN, inf and the padding lanes never win, all of them -> slot 0
        float best = j < 2 * ND && c < INFINITY ? c : INFINITY;
        int slot = j < 2 * ND ? j : L;
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(0xFFFFFFFFu, best, off, L);
            const int os = __shfl_xor_sync(0xFFFFFFFFu, slot, off, L);
            if (ob < best || (ob == best && os < slot)) {
                best = ob;
                slot = os;
            }
        }
        if (!done) {
            ++it;
            vsum += in_grid_neighbours<ND>(a.dim, idx);
            cost = centre;
            if (best < centre) {           // strict <: Algorithm 1's stop
#pragma unroll
                for (int d = 0; d < ND; ++d)
                    if (d == (slot >> 1)) {
                        idx[d] += (slot & 1) ? 1 : -1;
                        v[d] = value_of(a.dim[d], idx[d]);
                    }
                cost = best;
            } else {
                done = true;
            }
            if (it >= a.max_iters) done = true;
        }
    }
    if (live && j == 0) {
#pragma unroll
        for (int d = 0; d < ND; ++d) out_idx[g * ND + d] = idx[d];
        out_cost[g] = cost;
        iters[g] = it;
        valid_sum[g] = vsum;
        valid_final[g] = in_grid_neighbours<ND>(a.dim, idx);
    }
}

// the (kind, dimension count) pairs a surface can take: the DB surfaces on
// 2-D grids, the rooflines on 4-D ones, a table on any; F<KIND, ND>::run
// for the pair, or false for any other
template <template <int, int> class F, typename... A>
static bool dispatch(int kind, int nd, A... args) {
    if (kind == SURF_TABLE) {
        switch (nd) {
            case 1: F<SURF_TABLE, 1>::run(args...); return true;
            case 2: F<SURF_TABLE, 2>::run(args...); return true;
            case 3: F<SURF_TABLE, 3>::run(args...); return true;
            case 4: F<SURF_TABLE, 4>::run(args...); return true;
            case 5: F<SURF_TABLE, 5>::run(args...); return true;
            case 6: F<SURF_TABLE, 6>::run(args...); return true;
            case 7: F<SURF_TABLE, 7>::run(args...); return true;
            case 8: F<SURF_TABLE, 8>::run(args...); return true;
        }
    } else if (nd == 2) {
        switch (kind) {
            case SURF_REGRESSION: F<SURF_REGRESSION, 2>::run(args...);
                return true;
            case SURF_SMJ: F<SURF_SMJ, 2>::run(args...); return true;
            case SURF_BHJ: F<SURF_BHJ, 2>::run(args...); return true;
        }
    } else if (nd == 4) {
        switch (kind) {
            case SURF_TRAIN: F<SURF_TRAIN, 4>::run(args...); return true;
            case SURF_PREFILL: F<SURF_PREFILL, 4>::run(args...); return true;
            case SURF_DECODE: F<SURF_DECODE, 4>::run(args...); return true;
        }
    }
    return false;
}

// the DB surfaces' tile geometry over rows [row0, row0 + nrows)
static DbTile db_tile(const ScanArgs& a) {
    const int64_t s1 = a.dim[1].size;
    int64_t end = a.row0 + a.nrows;
    if (end > a.total) end = a.total;
    DbTile t;
    t.first = a.row0 / s1;
    t.n0 = (end - 1) / s1 - t.first + 1;
    t.w = (int)(s1 < TILE_ROWS ? s1 : TILE_ROWS);
    t.n_w = (int)((s1 + t.w - 1) / t.w);
    t.k = TILE_ROWS / t.w;
    if (t.k > DB_TILE_K) t.k = DB_TILE_K;
    return t;
}

template <int KIND, int OBJ>
static void launch_db(unsigned qblocks, cudaStream_t st, const ScanArgs* a,
                      const float* params, unsigned long long* out) {
    const DbTile t = db_tile(*a);
    dim3 grid((unsigned)((t.n0 + t.k - 1) / t.k * t.n_w), qblocks);
    if constexpr (KIND == SURF_REGRESSION) {
        if (a->s.oom) {
            scan_db_kernel<KIND, OBJ, true><<<grid, SCAN_THREADS, 0, st>>>(
                *a, t, params, out);
            return;
        }
    }
    scan_db_kernel<KIND, OBJ, false><<<grid, SCAN_THREADS, 0, st>>>(
        *a, t, params, out);
}

template <int KIND, int ND>
struct LaunchScan {
    static void run(unsigned qblocks, cudaStream_t st, const ScanArgs* a,
                    const float* params, unsigned long long* out) {
        if constexpr (KIND == SURF_REGRESSION || KIND == SURF_SMJ ||
                      KIND == SURF_BHJ) {
            switch (a->s.objective) {
                case OBJ_MONEY:
                    launch_db<KIND, OBJ_MONEY>(qblocks, st, a, params, out);
                    return;
                case OBJ_SLA:
                    launch_db<KIND, OBJ_SLA>(qblocks, st, a, params, out);
                    return;
                default:
                    launch_db<KIND, OBJ_TIME>(qblocks, st, a, params, out);
                    return;
            }
        } else {
            dim3 grid((unsigned)((a->nrows + TILE_ROWS - 1) / TILE_ROWS),
                      qblocks);
            scan_argmin_kernel<KIND, ND><<<grid, SCAN_THREADS, 0, st>>>(
                *a, params, out);
        }
    }
};

template <int KIND, int ND>
struct LaunchNeighbor {
    static void run(unsigned blocks, unsigned threads, cudaStream_t st,
                    const NeighborArgs* a, const int64_t* cur,
                    const float* params, float* center, float* best,
                    int32_t* slot) {
        neighbor_step_kernel<KIND, ND><<<blocks, threads, 0, st>>>(
            *a, cur, params, center, best, slot);
    }
};

template <int KIND, int ND>
struct LaunchClimb {
    static void run(cudaStream_t st, const ClimbArgs* a,
                    const int64_t* starts, const float* params,
                    int64_t* idx, float* cost, int64_t* iters,
                    int64_t* valid_sum, int64_t* valid_final) {
        constexpr int L = ClimbLanes<ND>::value;
        const int64_t lanes = a->n_queries * a->n_starts * L;
        const unsigned blocks =
            (unsigned)((lanes + CLIMB_THREADS - 1) / CLIMB_THREADS);
        ensemble_climb_kernel<KIND, ND><<<blocks, CLIMB_THREADS, 0, st>>>(
            *a, starts, params, idx, cost, iters, valid_sum, valid_final);
    }
};

extern "C" {

// out: (n_queries,) uint64 keys, preset to all ones by the caller; scans
// rows [row0, row0 + nrows) of the grid, nrows > 0
int scan_argmin(const ScanArgs* args, const void* params, void* out,
                void* stream) {
    const ScanArgs& a = *args;
    const unsigned qblocks =
        (unsigned)((a.n_queries + a.q_per_block - 1) / a.q_per_block);
    if (!dispatch<LaunchScan>(a.s.kind, a.n_dims, qblocks,
                              (cudaStream_t)stream, args,
                              (const float*)params, (unsigned long long*)out))
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

int neighbor_step(const NeighborArgs* args, const void* cur,
                  const void* params, void* center, void* best_cost,
                  void* best_slot, void* stream) {
    const NeighborArgs& a = *args;
    const unsigned threads = 128;
    unsigned blocks = (unsigned)((a.n_starts + threads - 1) / threads);
    if (!dispatch<LaunchNeighbor>(
            a.s.kind, a.n_dims, blocks, threads, (cudaStream_t)stream, args,
            (const int64_t*)cur, (const float*)params, (float*)center,
            (float*)best_cost, (int32_t*)best_slot))
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// starts (S, n_dims) int64 shared by the Q requests of params (Q, P)
int ensemble_climb(const ClimbArgs* args, const void* starts,
                   const void* params, void* idx, void* cost, void* iters,
                   void* valid_sum, void* valid_final, void* stream) {
    const ClimbArgs& a = *args;
    if (!dispatch<LaunchClimb>(
            a.s.kind, a.n_dims, (cudaStream_t)stream, args,
            (const int64_t*)starts, (const float*)params, (int64_t*)idx,
            (float*)cost, (int64_t*)iters, (int64_t*)valid_sum,
            (int64_t*)valid_final))
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
