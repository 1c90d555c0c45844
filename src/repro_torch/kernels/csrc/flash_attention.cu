// Forward flash attention on Hopper: causal / sliding-window / softcapped
// GQA attention with an online softmax.  Two kernels, one for each
// (dtype, head dim); no run-time fallback between them:
//
//   flash_attention_tc    bfloat16 with hd in {64, 128}: the tensor cores
//                         (wgmma), tiles brought in by TMA;
//   flash_attention_kernel float32 (any head dim) and bfloat16 with hd in
//                         {16, 32, 80, 256}: float32 FMAs on the CUDA cores.
//
// Both replace the reference's Pallas kernel _kernel in
// src/repro/kernels/flash_attention.py (grid (B, H, nq, nkv), whose minor kv
// axis ran in order on the TPU with the running max, denominator and
// accumulator in VMEM scratch).  Here one block owns one (batch, head,
// query tile) and loops over the 64-row kv tiles itself, so the running
// statistics stay in registers; no score matrix reaches device memory.
//
// Semantics (those of the Pallas kernel and of kernels/ref.py
// attention_ref): q (B, S, H, hd), k and v (B, Skv, KV, hd), float32 or
// bfloat16.  Query head h reads kv head h / (H / KV).  Scores are float32
// dot products times hd^-1/2, then the optional tanh softcap, then the
// causal mask by index (kpos <= qpos) with the optional window (qpos - kpos
// < window); masked scores are -1e30.  The running max, denominator and
// accumulator are float32; p is rounded to v's type before the PV product
// (as the Pallas kernel does) while the denominator sums the unrounded p;
// the output is acc / max(l, 1e-30) in q's type.  Ragged S and Skv are
// masked in the kernel: columns past Skv get p = 0 exactly and rows past S
// are not stored.  Causal tiles wholly above the diagonal or wholly left of
// the window are skipped; they would add p = 0 exactly.
//
// Masking by positions (AttnArgs.q_pos / kv_pos non-null: contiguous int64
// (B, S) and (B, Skv), -1 an invalid slot), as the reference's jnp
// _block_update in src/repro/models/attention.py: a score is kept where
// kv_pos >= 0 and, under causal, 0 <= q_pos - kv_pos < window.  Positions
// need not be arange, so no tile can be skipped and no tile is known to be
// unmasked: every kv tile is visited and every score goes through the
// mask.  A row with no kept key (a query at -1) then has every score at
// -1e30, p = 1 on each of them, and returns the mean of V over all Skv keys,
// as the reference does when Skv fits its one kv block; columns past Skv
// stay at p = 0.  With null pointers the kernels compute exactly what they
// did before positions existed.
//
// What bounds it on this card: tensor-core FLOPs (4 * S * Skv * hd * H,
// about half of that under the causal mask, at 989 TFLOP/s in bf16) for
// long sequences, and beside them one exp per score on the SFUs.
//
// flash_attention_tc (the bfloat16 path the served models take) has the
// usual shape of a fast Hopper kernel, cut to what one pass needs:
//   - one producer warp issues every copy by TMA (cp.async.bulk.tensor):
//     the block's Q tile once, and each 64-row K and V tile into a ring
//     of 3 stages (hd 64) or 2 (hd 128) guarded by "full" (transaction
//     bytes) and "empty" (consumer warps) mbarriers, so the copies run
//     ahead of the math;
//   - one consumer warpgroup owns the block's 64 query rows; S = Q K^T is
//     wgmma m64n64k16 with both
//     operands in shared memory (K-major, 128-byte swizzle: hd = 64 bf16 is
//     one 128-byte row; hd = 128 is two 64-column halves);
//   - the online softmax runs on the accumulator fragment (rows reduced
//     across the quad by shuffles, ex2.approx on log2e-prescaled scores),
//     and p is packed to bf16 straight into the register A operand of the
//     second wgmma, O += P V, which reads V from shared memory through the
//     B-transpose bit (a kv x hd tile is MN-major for B);
//   - the tensor maps are 4-D (hd, heads, rows, batch), so rows past S or
//     Skv are zero-filled by the copy engine instead of being read from the
//     next batch (a V row of another batch times p = 0 could be 0 * inf).
// Tried on the card and left out, all slower here: issuing the next tile's
// S before this tile's softmax (ptxas then serialises the wgmma around the
// barrier waits), kv tiles of 128 rows, rings deeper than 3 stages, and
// 128 query rows a block (two consumer warpgroups sharing each K/V tile).
// The maps are encoded on the host (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint) once per (pointer, shape).
//
// Float32 stays on the CUDA cores on purpose: TF32 or bf16 tensor-core
// products would break the float32 parity (1e-5) and the float32 serve
// token identity that chip_smoke.py holds.  flash_attention_kernel: 256
// threads, 4 per query row, 16 scores and hd/4 accumulator columns per
// thread, Q/K/V upcast to float32 in shared memory (rows of Q and K padded
// by one float so the 4-thread row groups hit distinct banks).
//
// The source is built with -fmad=false (kernels/build.py): the float32
// kernel's products and sums round as written; the tensor-core kernel's
// products run in the tensor cores and its few softmax multiply-adds stay
// unfused.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define BQ 64              // query rows per block
#define BKV 64             // kv rows per tile
#define TPR 4              // threads per query row
#define THREADS (BQ * TPR)
#define NEG_INF (-1e30f)

struct AttnArgs {
    int64_t B, S, Skv, H, KV, hd;
    int causal;
    int window;            // <= 0: no window
    int has_cap;
    float cap;
    float scale;           // hd^-1/2, rounded to float32 once
    const int64_t* q_pos;  // (B, S) query positions, or null: by index
    const int64_t* kv_pos; // (B, Skv) key positions (null with q_pos)
};

// a score kept by the positional mask (the reference's _block_update)
__device__ __forceinline__ bool pos_keep(const AttnArgs& a, int64_t qp,
                                         int64_t kp) {
    bool keep = kp >= 0;
    if (a.causal) {
        const int64_t rel = qp - kp;
        keep = keep && rel >= 0;
        if (a.window > 0) keep = keep && rel < a.window;
    }
    return keep;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);          // round to nearest even
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(AttnArgs a, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o) {
    constexpr int QS = HD + 1;            // padded row stride of Q and K
    constexpr int PS = BKV + 1;           // padded row stride of P
    constexpr int NS = BKV / TPR;         // scores per thread
    constexpr int NA = HD / TPR;          // accumulator columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                     // BQ x QS
    float* Ks = Qs + BQ * QS;             // BKV x QS
    float* Vs = Ks + BKV * QS;            // BKV x HD
    float* Ps = Vs + BKV * HD;            // BQ x PS

    const int tid = threadIdx.x;
    const int r = tid / TPR, c4 = tid % TPR;
    const int64_t q0 = (int64_t)blockIdx.x * BQ;
    const int64_t h = blockIdx.y, b = blockIdx.z;
    const int64_t kvh = h / (a.H / a.KV);
    const int64_t qpos = q0 + r;
    const bool by_pos = a.q_pos != nullptr;
    const int64_t qp = by_pos && qpos < a.S ? a.q_pos[b * a.S + qpos] : -1;

    for (int i = tid; i < BQ * HD; i += THREADS) {
        const int rr = i / HD, d = i % HD;
        const int64_t s = q0 + rr;
        Qs[rr * QS + d] =
            s < a.S ? to_f(q[((b * a.S + s) * a.H + h) * HD + d]) : 0.f;
    }

    float m = NEG_INF, l = 0.f;
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;

    int64_t kv_begin = 0, kv_end = a.Skv;
    if (a.causal && !by_pos) {
        const int64_t q_last = (q0 + BQ < a.S ? q0 + BQ : a.S) - 1;
        if (q_last + 1 < kv_end) kv_end = q_last + 1;
        if (a.window > 0 && q0 - a.window + 1 > 0) kv_begin = q0 - a.window + 1;
    }

    for (int64_t k0 = (kv_begin / BKV) * BKV; k0 < kv_end; k0 += BKV) {
        __syncthreads();                  // the last tile's reads are done
        for (int i = tid; i < BKV * HD; i += THREADS) {
            const int rr = i / HD, d = i % HD;
            const int64_t s = k0 + rr;
            const bool in = s < a.Skv;
            const int64_t off = ((b * a.Skv + s) * a.KV + kvh) * HD + d;
            Ks[rr * QS + d] = in ? to_f(k[off]) : 0.f;
            Vs[rr * HD + d] = in ? to_f(v[off]) : 0.f;
        }
        __syncthreads();

        float sc[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] = 0.f;
        for (int d = 0; d < HD; ++d) {
            const float qd = Qs[r * QS + d];
#pragma unroll
            for (int j = 0; j < NS; ++j)
                sc[j] += qd * Ks[(c4 + TPR * j) * QS + d];
        }

        float rowmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int64_t kpos = k0 + c4 + TPR * j;
            float s = sc[j] * a.scale;
            if (a.has_cap) s = tanhf(s / a.cap) * a.cap;
            if (by_pos) {
                const int64_t kp =
                    kpos < a.Skv ? a.kv_pos[b * a.Skv + kpos] : -1;
                if (!pos_keep(a, qp, kp)) s = NEG_INF;
            } else if (a.causal) {
                bool keep = kpos <= qpos;
                if (a.window > 0) keep = keep && (qpos - kpos < a.window);
                if (!keep) s = NEG_INF;
            }
            if (kpos >= a.Skv) s = -INFINITY;      // ragged edge: p = 0
            sc[j] = s;
            rowmax = fmaxf(rowmax, s);
        }
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, 1));
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, 2));
        const float m_new = fmaxf(m, rowmax);
        const float corr = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const float p = expf(sc[j] - m_new);
            psum += p;
            Ps[r * PS + c4 + TPR * j] = to_f(from_f<T>(p));
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l = l * corr + psum;
        m = m_new;
        __syncwarp();                     // P row r is read by its 4 lanes

#pragma unroll
        for (int i = 0; i < NA; ++i) acc[i] *= corr;
        for (int c = 0; c < BKV; ++c) {
            const float p = Ps[r * PS + c];
#pragma unroll
            for (int i = 0; i < NA; ++i)
                acc[i] += p * Vs[c * HD + c4 + TPR * i];
        }
    }

    if (qpos < a.S) {
        const float denom = fmaxf(l, 1e-30f);
        T* orow = o + ((b * a.S + qpos) * a.H + h) * HD;
#pragma unroll
        for (int i = 0; i < NA; ++i)
            orow[c4 + TPR * i] = from_f<T>(acc[i] / denom);
    }
}

template <typename T, int HD>
static int launch(const AttnArgs& a, const void* q, const void* k,
                  const void* v, void* o, cudaStream_t stream) {
    const size_t smem =
        sizeof(float) * (2 * BQ * (HD + 1) + BKV * HD + BQ * (BKV + 1));
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((a.S + BQ - 1) / BQ), (unsigned)a.H, (unsigned)a.B);
    flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        a, (const T*)q, (const T*)k, (const T*)v, (T*)o);
    return (int)cudaGetLastError();
}


// ------------------------- the tensor-core kernel ------------------------- //

namespace tc {

constexpr int TILE = 64;                // query rows a warpgroup, kv rows a
                                        // tile
constexpr int CHUNK = 64 * 64;          // bf16 elements of a 64 x 64 box
constexpr int CHUNK_BYTES = CHUNK * 2;  // 8 KB: 64 rows of 128 bytes
constexpr float LOG2E = 1.4426950408889634f;

// K/V ring depth: a third stage hides more of each copy at hd 64; at hd
// 128 its shared memory would cost an SM one of its two blocks
__host__ __device__ constexpr int stages(int hd) { return hd == 64 ? 3 : 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity ``parity`` has completed (the loop stays
// inside the asm, so the compiler sees no divergent branch around it)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile("{\n.reg .pred p;\nLAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 "@!p bra LAB_WAIT;\n}\n"
                 :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one 64 x 64 bf16 box of a 4-D map (hd, heads, rows, batch) into smem
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int head,
                                         int row, int batch) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(d), "r"(head), "r"(row), "r"(batch), "r"(smem_u32(bar))
        : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
    uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
    d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
    d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
    d |= (uint64_t)1 << 62;
    return d;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (m64n64, float32) = A (smem, K-major) * B (smem, K-major)
// + d if scale_d, else + 0
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64n64, float32) += A (registers, bf16) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d,
                                             const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {     // 2^x, -inf -> 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

struct Maps {
    CUtensorMap q, k, v;
};

// one consumer warpgroup (64 query rows) and one producer warp
template <int HD>
__global__ void __launch_bounds__(128 + 32)
flash_attention_tc(const __grid_constant__ Maps maps, AttnArgs a,
                   __nv_bfloat16* __restrict__ o) {
    constexpr int NC = HD / 64;                 // 64-column chunks of hd
    constexpr int ST = stages(HD);
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* ks = qs + NC * CHUNK;        // [stage][chunk]
    __nv_bfloat16* vs = ks + ST * NC * CHUNK;
    uint64_t* full = reinterpret_cast<uint64_t*>(vs + ST * NC * CHUNK);
    uint64_t* empty = full + ST;
    uint64_t* qbar = empty + ST;

    // heavy (late, causal) query tiles first
    const int tile = gridDim.x - 1 - blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (int)(a.H / a.KV);
    const int64_t q0 = (int64_t)tile * TILE;
    const int64_t q_last = (q0 + TILE < a.S ? q0 + TILE : a.S) - 1;
    const bool by_pos = a.q_pos != nullptr;
    int64_t kv_begin = 0, kv_end = a.Skv;
    if (a.causal && !by_pos) {
        if (q_last + 1 < kv_end) kv_end = q_last + 1;
        if (a.window > 0 && q0 - a.window + 1 > 0)
            kv_begin = q0 - a.window + 1;
    }
    const int t_begin = (int)(kv_begin / TILE);
    const int n_tiles = kv_end > kv_begin ?
        (int)((kv_end + TILE - 1) / TILE) - t_begin : 0;

    if (threadIdx.x == 0) {
        for (int st = 0; st < ST; ++st) {
            mbar_init(&full[st], 1);
            mbar_init(&empty[st], 4);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 128) {                   // the producer warp
        if (threadIdx.x == 128) {
            mbar_expect_tx(qbar, NC * CHUNK_BYTES);
            for (int c = 0; c < NC; ++c)
                tma_load(qs + c * CHUNK, &maps.q, qbar, c * 64, h, (int)q0,
                         b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % ST;
                mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
                mbar_expect_tx(&full[s], 2 * NC * CHUNK_BYTES);
                const int row = (t_begin + i) * TILE;
                for (int c = 0; c < NC; ++c) {
                    tma_load(ks + (s * NC + c) * CHUNK, &maps.k, &full[s],
                             c * 64, kvh, row, b);
                    tma_load(vs + (s * NC + c) * CHUNK, &maps.v, &full[s],
                             c * 64, kvh, row, b);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: rows q0 .. q_last, this thread's r0, r0 + 8
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
    // this thread's two rows' positions (read once; rows past S are not
    // stored)
    const int64_t qp0 = by_pos && r0 < a.S ? a.q_pos[b * a.S + r0] : -1;
    const int64_t qp1 = by_pos && r1 < a.S ? a.q_pos[b * a.S + r1] : -1;
    // the softmax runs in the log2 domain: y = score * log2(e), masked
    // scores at -1e30 * log2(e), so p = exp2(y - m) is exp(score - max)
    const float sl2 = a.scale * LOG2E, capl2 = a.cap * LOG2E;
    const float mask2 = NEG_INF * LOG2E;

    float acc[NC][32], sc[32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    float m0 = mask2, m1 = mask2, l0 = 0.f, l1 = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const int64_t k0 = (int64_t)(t_begin + i) * TILE;
        mbar_wait(&full[s], (i / ST) & 1);
        const __nv_bfloat16* kt = ks + s * NC * CHUNK;
        const __nv_bfloat16* vt = vs + s * NC * CHUNK;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const int c = kk / 4, off = (kk % 4) * 16;
            wgmma_ss_n64(sc, desc(qs + c * CHUNK + off, 16, 1024),
                         desc(kt + c * CHUNK + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();

        // scale, softcap and masks: register 4j + e holds row r0 (e < 2)
        // or r1 = r0 + 8, column k0 + c with c = 8j + 2 (lane % 4) +
        // (e & 1); each branch is taken for the whole tile, so the
        // softcap and the masks cost nothing on the tiles without them
        if (a.has_cap) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
                sc[i] = tanhf(sc[i] * a.scale / a.cap) * capl2;
        } else {
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] *= sl2;
        }
        if (by_pos) {
            // every tile through the positional mask; each column's
            // position read from global memory (64 of them a tile, shared
            // by the warpgroup through L1)
            const int lim = (int)(a.Skv - k0 < TILE ? a.Skv - k0 : TILE);
            const int64_t* kpt = a.kv_pos + b * a.Skv + k0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = j * 8 + (lane % 4) * 2 + e;
                    const int64_t kp = c < lim ? kpt[c] : -1;
                    if (!pos_keep(a, qp0, kp)) sc[j * 4 + e] = mask2;
                    if (!pos_keep(a, qp1, kp)) sc[j * 4 + e + 2] = mask2;
                    if (c >= lim) {                     // p = 0
                        sc[j * 4 + e] = -INFINITY;
                        sc[j * 4 + e + 2] = -INFINITY;
                    }
                }
            }
        } else if (k0 + TILE > a.Skv || (a.causal && (k0 + TILE - 1 > q0 ||
                (a.window > 0 && k0 < q_last - a.window + 1)))) {
            const int dq = (int)(k0 - r0);      // kpos - qpos at c = 0
            const int lim = (int)(a.Skv - k0 < TILE ? a.Skv - k0 : TILE);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = j * 8 + (lane % 4) * 2 + (e & 1);
                    const int d = dq + c - (e < 2 ? 0 : 8);
                    if (a.causal && (d > 0 || (a.window > 0 &&
                                               -d >= a.window)))
                        sc[j * 4 + e] = mask2;
                    if (c >= lim) sc[j * 4 + e] = -INFINITY;  // p = 0
                }
            }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(sc[j * 4], sc[j * 4 + 1]));
            mx1 = fmaxf(mx1, fmaxf(sc[j * 4 + 2], sc[j * 4 + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
        float ps0 = 0.f, ps1 = 0.f;
        uint32_t pa[4][4];   // the A operand of P V, one k16 step a row
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                // registers 8kk + 2r and + 1: row r0 for even r, else r1
                const int i0 = 8 * kk + 2 * r;
                const float mr = (r & 1) ? mn1 : mn0;
                const float p0 = ex2(sc[i0] - mr);
                const float p1 = ex2(sc[i0 + 1] - mr);
                if (r & 1) ps1 += p0 + p1; else ps0 += p0 + p1;
                pa[kk][r] = pack_bf16(p0, p1);
            }
        }
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
        l0 = l0 * corr0 + ps0;
        l1 = l1 * corr1 + ps1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                acc[c][j * 4 + 0] *= corr0;
                acc[c][j * 4 + 1] *= corr0;
                acc[c][j * 4 + 2] *= corr1;
                acc[c][j * 4 + 3] *= corr1;
            }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int c = 0; c < NC; ++c)
                wgmma_rs_n64(acc[c], pa[kk],
                             desc(vt + c * CHUNK + kk * 16 * 64,
                                  1024, 1024));
        wgmma_commit();
        wgmma_wait();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
    }

    const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = c * 64 + j * 8 + (lane % 4) * 2;
            if (r0 < a.S)
                *reinterpret_cast<__nv_bfloat162*>(
                    o + ((b * a.S + r0) * a.H + h) * HD + col) =
                    __floats2bfloat162_rn(acc[c][j * 4] * d0,
                                          acc[c][j * 4 + 1] * d0);
            if (r1 < a.S)
                *reinterpret_cast<__nv_bfloat162*>(
                    o + ((b * a.S + r1) * a.H + h) * HD + col) =
                    __floats2bfloat162_rn(acc[c][j * 4 + 2] * d1,
                                          acc[c][j * 4 + 3] * d1);
        }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = (EncodeTiled)p;
    }
    return fn;
}

// the 4-D map (hd, heads, rows, batch) of a contiguous (batch, rows, heads,
// hd) bf16 tensor, in 64 x 64 boxes; cached by (pointer, shape)
struct MapKey {
    const void* ptr;
    int64_t rows, heads, hd, batch;
};
struct MapEntry {
    MapKey key;
    CUtensorMap map;
    bool used;
};

static int encode(CUtensorMap* out, const void* ptr, int64_t batch,
                  int64_t rows, int64_t heads, int64_t hd) {
    static MapEntry cache[16];
    static int next = 0;
    for (auto& e : cache)
        if (e.used && e.key.ptr == ptr && e.key.rows == rows &&
            e.key.heads == heads && e.key.hd == hd && e.key.batch == batch) {
            *out = e.map;
            return 0;
        }
    EncodeTiled fn = encoder();
    if (!fn) return (int)cudaErrorNotSupported;
    cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                          (cuuint64_t)rows, (cuuint64_t)batch};
    cuuint64_t strides[3] = {(cuuint64_t)(hd * 2),
                             (cuuint64_t)(heads * hd * 2),
                             (cuuint64_t)(rows * heads * hd * 2)};
    cuuint32_t box[4] = {64, 1, 64, 1};
    cuuint32_t estr[4] = {1, 1, 1, 1};
    CUresult r = fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                    const_cast<void*>(ptr), dims, strides, box, estr,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    MapEntry& e = cache[next];
    next = (next + 1) % 16;
    e.key = MapKey{ptr, rows, heads, hd, batch};
    e.map = *out;
    e.used = true;
    return 0;
}

template <int HD>
static int launch(const AttnArgs& a, const void* q, const void* k,
                  const void* v, void* o, cudaStream_t stream) {
    Maps maps;
    int err = encode(&maps.q, q, a.B, a.S, a.H, HD);
    if (!err) err = encode(&maps.k, k, a.B, a.Skv, a.KV, HD);
    if (!err) err = encode(&maps.v, v, a.B, a.Skv, a.KV, HD);
    if (err) return err;
    constexpr int NC = HD / 64;
    constexpr int ST = stages(HD);
    const size_t smem = 1024 + (size_t)(1 + 2 * ST) * NC * CHUNK_BYTES +
                        (2 * ST + 1) * sizeof(uint64_t);
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((a.S + TILE - 1) / TILE), (unsigned)a.H,
              (unsigned)a.B);
    flash_attention_tc<HD><<<grid, 128 + 32, smem, stream>>>(
        maps, a, (__nv_bfloat16*)o);
    return (int)cudaGetLastError();
}

static int dispatch(const AttnArgs& a, const void* q, const void* k,
                    const void* v, void* o, cudaStream_t stream) {
    if (a.Skv == 0)                  // nothing to attend to: zeros
        return (int)cudaMemsetAsync(o, 0, a.B * a.S * a.H * a.hd * 2, stream);
    if (a.hd == 64) return launch<64>(a, q, k, v, o, stream);
    if (a.hd == 128) return launch<128>(a, q, k, v, o, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace tc

template <typename T>
static int dispatch(const AttnArgs& a, const void* q, const void* k,
                    const void* v, void* o, cudaStream_t stream) {
    switch (a.hd) {
        case 16: return launch<T, 16>(a, q, k, v, o, stream);
        case 32: return launch<T, 32>(a, q, k, v, o, stream);
        case 64: return launch<T, 64>(a, q, k, v, o, stream);
        case 80: return launch<T, 80>(a, q, k, v, o, stream);
        case 128: return launch<T, 128>(a, q, k, v, o, stream);
        case 256: return launch<T, 256>(a, q, k, v, o, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it); bfloat16 with hd
// 64 or 128 takes the tensor-core kernel, everything else the CUDA-core
// kernel
int flash_attention(const AttnArgs* args, int dtype, const void* q,
                    const void* k, const void* v, void* o, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return dispatch<float>(*args, q, k, v, o, st);
    if (dtype == 1 && (args->hd == 64 || args->hd == 128))
        return tc::dispatch(*args, q, k, v, o, st);
    if (dtype == 1) return dispatch<__nv_bfloat16>(*args, q, k, v, o, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
