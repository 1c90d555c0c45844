// Forward flash attention on Hopper: causal / sliding-window / softcapped
// GQA attention with an online softmax.
//
// Replaces the reference's Pallas kernel _kernel in
// src/repro/kernels/flash_attention.py (grid (B, H, nq, nkv), whose minor kv
// axis ran in order on the TPU with the running max, denominator and
// accumulator in VMEM scratch).  Here one block owns one (batch, head,
// 64-row query tile) and loops over the 64-row kv tiles itself, so the
// running statistics stay in registers; no score matrix reaches device
// memory.
//
// Semantics (those of the Pallas kernel and of kernels/ref.py
// attention_ref): q (B, S, H, hd), k and v (B, Skv, KV, hd), float32 or
// bfloat16, upcast to float32 in shared memory.  Query head h reads kv head
// h / (H / KV).  Scores are float32 dot products times hd^-1/2, then the
// optional tanh softcap, then the causal mask by index (kpos <= qpos) with
// the optional window (qpos - kpos < window); masked scores are -1e30.  The
// running max, denominator and accumulator are float32; p is rounded to v's
// type before the PV product (as the Pallas kernel does) while the
// denominator sums the unrounded p; the output is acc / max(l, 1e-30) in
// q's type.  Ragged S and Skv are masked in the kernel: columns past Skv
// get p = 0 exactly and rows past S are not stored.  Causal tiles wholly
// above the diagonal or wholly left of the window are skipped; they would
// add p = 0 exactly.
//
// What bounds it on this card: tensor-core FLOPs (4 * S * Skv * hd * H,
// about half of that under the causal mask, at 989 TFLOP/s in bf16) for
// long sequences.  This first kernel does not reach the tensor cores: the
// two products are float32 FMAs on the CUDA cores, each fed by a
// shared-memory load (256 threads, 4 per query row, 16 scores and hd/4
// accumulator columns per thread; rows of Q and K padded by one float so
// the 4-thread row groups hit distinct banks).  wgmma/TMA tiles are later
// work.

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
};

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
    if (a.causal) {
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
            if (a.causal) {
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

template <typename T>
static int dispatch(const AttnArgs& a, const void* q, const void* k,
                    const void* v, void* o, cudaStream_t stream) {
    switch (a.hd) {
        case 16: return launch<T, 16>(a, q, k, v, o, stream);
        case 32: return launch<T, 32>(a, q, k, v, o, stream);
        case 64: return launch<T, 64>(a, q, k, v, o, stream);
        case 128: return launch<T, 128>(a, q, k, v, o, stream);
        case 256: return launch<T, 256>(a, q, k, v, o, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it)
int flash_attention(const AttnArgs* args, int dtype, const void* q,
                    const void* k, const void* v, void* o, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return dispatch<float>(*args, q, k, v, o, st);
    if (dtype == 1) return dispatch<__nv_bfloat16>(*args, q, k, v, o, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
