// Mamba1 selective scan on Hopper.
//
// Replaces the reference's Pallas kernel _kernel in
// src/repro/kernels/mamba_scan.py (grid (B, D blocks, time chunks), whose
// minor time-chunk axis ran in order on the TPU with the (bd, N) state in
// VMEM scratch).
//
// Semantics (those of the Pallas kernel and of kernels/ref.py
// selective_scan_ref): u (B, S, D) and B, C (B, S, N) in float32 or
// bfloat16 (one type), dt (B, S, D) and A (D, N) in float32, optional h0
// (B, D, N) float32.  Per step
//     h <- exp(dt * A) * h + (dt * u) * B_t,    y_t = sum_n h * C_t
// in float32 with expf (no fast math, -fmad=false); outputs y (B, S, D)
// and h_last (B, D, N) in float32.  The reference sums y over n in
// another order, so results agree to a tolerance, not to the bit.
//
// What bounds it on this card: instruction issue.  The byte bound is small
// (u, dt, y: 10-12 bytes per (t, d)) against ~15 float32 instructions per
// (t, d, n) update, expf's 9 included, so a full card runs at the rate it
// issues them and an emptier one at the latency of the step chain (the
// first design, one thread a channel, ran 2 warps an SM at B = 1).  The
// design:
// - a channel's N states are spread over G lanes (a template parameter, N/G
//   states a lane).  More lanes fill more of the card but cost more
//   instructions an update (the per-step loads and the sum over lanes are
//   shared by fewer states), so lanes(B, D, N) in kernels/mamba_scan.py
//   picks the fewest that put 32K threads on the card: 4 at B = 1 and
//   D = 8192, 2 at the serve prefill's B = 4 (the lane sweep on the card);
// - G steps at a time: each lane sums its states' share of y for each of
//   the G steps, and a reduce-scatter over the lanes (G - 1 xor shuffles
//   for G steps, one fixed order of the sum) leaves lane g with step
//   t + g's y;
// - the time steps come in chunks of T_CHUNK, double-buffered in shared
//   memory by cp.async (16-byte words where the rows allow): the next
//   chunk's u, dt, B_t and C_t are in flight while this one is computed.
//   B_t and C_t are widened to float32 once a chunk for all the block's
//   channels and read as vectors;
// - y goes back through shared memory as coalesced rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define SCAN_THREADS 128   // threads a block: SCAN_THREADS / G channels
#define T_CHUNK 32         // time steps a chunk

struct ScanArgs {
    int64_t B, S, D, N;
    int has_h0;
    int lanes;             // G
    int vec;               // rows of u, dt, y, B and C copy in 16-byte words
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// one asynchronous copy of BYTES (4 or 16) from device to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// one chunk's inputs in shared memory: u and dt of the block's channels,
// B_t and C_t in float32 for all of them (bfloat16 lands in braw / craw
// first and is widened once a chunk, not once a channel)
template <typename T, int N, int DC>
struct Stage {
    static constexpr bool WIDEN = sizeof(T) == 2;
    alignas(16) float b[T_CHUNK][N];
    alignas(16) float c[T_CHUNK][N];
    alignas(16) float dt[T_CHUNK][DC];
    alignas(16) T u[T_CHUNK][DC];
    alignas(16) T braw[WIDEN ? T_CHUNK : 1][N];
    alignas(16) T craw[WIDEN ? T_CHUNK : 1][N];
};

// copy rows [0, tn) of `width` elements (the first `valid` of them) from
// src (a row every src_stride elements) to dst (every dst_stride), in
// BYTES-wide words
template <int BYTES, typename E>
__device__ __forceinline__ void copy_rows(E* dst, int dst_stride,
                                          const E* src, int64_t src_stride,
                                          int tn, int width, int valid) {
    constexpr int PER = BYTES / sizeof(E);
    const int words = width / PER;
    for (int i = threadIdx.x; i < tn * words; i += SCAN_THREADS) {
        const int tt = i / words, e = (i - tt * words) * PER;
        if (e < valid)
            cp_async<BYTES>(dst + tt * dst_stride + e,
                            src + tt * src_stride + e);
    }
}

// issue the copies of rows [t0, t0 + tn) of batch b, channels [d0, d0 + DC)
// (ragged at D); B_t and C_t rows are one contiguous run.  Words are 16
// bytes when a.vec says every row allows it, else 4 (D and N are even for
// bfloat16)
template <int BYTES, typename T, int N, int DC>
__device__ __forceinline__ void load_chunk(
        const ScanArgs& a, Stage<T, N, DC>& st, const T* u, const float* dt,
        const T* Bm, const T* Cm, int64_t b, int64_t t0, int tn,
        int64_t d0) {
    const int valid = (int)min((int64_t)DC, a.D - d0);
    const int64_t r0 = b * a.S + t0;
    copy_rows<BYTES>(&st.u[0][0], DC, u + r0 * a.D + d0, a.D, tn, DC, valid);
    copy_rows<BYTES>(&st.dt[0][0], DC, dt + r0 * a.D + d0, a.D, tn, DC,
                     valid);
    T* bd = Stage<T, N, DC>::WIDEN ? &st.braw[0][0] : (T*)&st.b[0][0];
    T* cd = Stage<T, N, DC>::WIDEN ? &st.craw[0][0] : (T*)&st.c[0][0];
    copy_rows<BYTES>(bd, 0, Bm + r0 * N, 0, 1, tn * N, tn * N);
    copy_rows<BYTES>(cd, 0, Cm + r0 * N, 0, 1, tn * N, tn * N);
}

// NS consecutive floats of shared memory, in the widest loads they allow
template <int NS>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
    if constexpr (NS % 4 == 0) {
#pragma unroll
        for (int k = 0; k < NS / 4; ++k) {
            const float4 v = reinterpret_cast<const float4*>(src)[k];
            dst[4 * k] = v.x;
            dst[4 * k + 1] = v.y;
            dst[4 * k + 2] = v.z;
            dst[4 * k + 3] = v.w;
        }
    } else if constexpr (NS == 2) {
        const float2 v = *reinterpret_cast<const float2*>(src);
        dst[0] = v.x;
        dst[1] = v.y;
    } else {
        dst[0] = src[0];
    }
}

template <typename T, int N, int G>
__global__ void __launch_bounds__(SCAN_THREADS)
selective_scan_kernel(ScanArgs a, const T* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ hlast) {
    constexpr int DC = SCAN_THREADS / G;           // channels a block
    constexpr int NS = N / G;                      // states a lane
    using St = Stage<T, N, DC>;
    extern __shared__ __align__(16) unsigned char smem[];
    St* st = reinterpret_cast<St*>(smem);
    float (*ys)[DC] = reinterpret_cast<float (*)[DC]>(st + 2);

    const int c = threadIdx.x / G, g = threadIdx.x % G;
    const int64_t d0 = (int64_t)blockIdx.x * DC;
    const int64_t d = d0 + c;
    const int64_t b = blockIdx.y;
    const bool live = d < a.D;
    const int n0 = g * NS;

    float Ad[NS], h[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        Ad[j] = live ? A[d * N + n0 + j] : 0.f;
        h[j] = (live && a.has_h0) ? h0[(b * a.D + d) * N + n0 + j] : 0.f;
    }

    const int64_t n_chunks = (a.S + T_CHUNK - 1) / T_CHUNK;
    auto rows = [&](int64_t k) {
        const int64_t left = a.S - k * T_CHUNK;
        return (int)(left < T_CHUNK ? left : T_CHUNK);
    };
    auto load = [&](int64_t k) {
        if (a.vec)
            load_chunk<16>(a, st[k & 1], u, dt, Bm, Cm, b, k * T_CHUNK,
                           rows(k), d0);
        else
            load_chunk<4>(a, st[k & 1], u, dt, Bm, Cm, b, k * T_CHUNK,
                          rows(k), d0);
    };
    if (n_chunks > 0) load(0);
    cp_async_commit();
    for (int64_t k = 0; k < n_chunks; ++k) {
        const int tn = rows(k);
        if (k + 1 < n_chunks) load(k + 1);        // the next chunk, in flight
        cp_async_commit();
        cp_async_wait_prev();                      // this chunk has landed
        __syncthreads();                           // ... for every thread
        St& cur = st[k & 1];
        if constexpr (St::WIDEN) {
            for (int i = threadIdx.x; i < tn * N; i += SCAN_THREADS) {
                const int tt = i / N, n = i - tt * N;
                cur.b[tt][n] = to_f(cur.braw[tt][n]);
                cur.c[tt][n] = to_f(cur.craw[tt][n]);
            }
            __syncthreads();
        }
        // G steps at a time: each lane sums its NS states' share of y for
        // each step, then a reduce-scatter over the G lanes (G - 1 xor
        // shuffles) leaves lane g with step t + g's sum
        for (int t = 0; t < tn; t += G) {
            float part[G];
#pragma unroll
            for (int s = 0; s < G; ++s) {
                const int tt = t + s;
                float yv = 0.f;
                if (tt < tn) {
                    const float dtv = cur.dt[tt][c];
                    const float dbu = dtv * to_f(cur.u[tt][c]);
                    float bv[NS], cv[NS];
                    load_row<NS>(bv, &cur.b[tt][n0]);
                    load_row<NS>(cv, &cur.c[tt][n0]);
#pragma unroll
                    for (int j = 0; j < NS; ++j) {
                        const float dA = expf(dtv * Ad[j]);
                        h[j] = dA * h[j] + dbu * bv[j];
                        yv += h[j] * cv[j];
                    }
                }
                part[s] = yv;
            }
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
                const bool upper = g & off;        // keeps steps with this bit
#pragma unroll
                for (int s = 0; s < off; ++s) {
                    const float send = upper ? part[s] : part[s + off];
                    const float keep = upper ? part[s + off] : part[s];
                    part[s] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, off);
                }
            }
            if (t + g < tn) ys[t + g][c] = part[0];
        }
        __syncthreads();                           // ys done, stage free
        float* yk = y + (b * a.S + k * T_CHUNK) * a.D + d0;
        if (a.vec) {
            for (int i = threadIdx.x; i < tn * DC / 4; i += SCAN_THREADS) {
                const int tt = i / (DC / 4), e = (i - tt * (DC / 4)) * 4;
                if (d0 + e < a.D)
                    *reinterpret_cast<float4*>(yk + tt * a.D + e) =
                        *reinterpret_cast<const float4*>(&ys[tt][e]);
            }
        } else {
            for (int i = threadIdx.x; i < tn * DC; i += SCAN_THREADS) {
                const int tt = i / DC, e = i - tt * DC;
                if (d0 + e < a.D) yk[tt * a.D + e] = ys[tt][e];
            }
        }
    }
    if (live) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
            hlast[(b * a.D + d) * N + n0 + j] = h[j];
    }
}

template <typename T, int N, int G>
static int launch(const ScanArgs& a, const void* u, const void* dt,
                  const void* A, const void* Bm, const void* Cm,
                  const void* h0, void* y, void* hlast, cudaStream_t stream) {
    constexpr int DC = SCAN_THREADS / G;
    constexpr size_t smem = 2 * sizeof(Stage<T, N, DC>) +
                            sizeof(float) * T_CHUNK * DC;
    auto kernel = selective_scan_kernel<T, N, G>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)((a.D + DC - 1) / DC), (unsigned)a.B);
    kernel<<<grid, SCAN_THREADS, smem, stream>>>(
        a, (const T*)u, (const float*)dt, (const float*)A, (const T*)Bm,
        (const T*)Cm, (const float*)h0, (float*)y, (float*)hlast);
    return (int)cudaGetLastError();
}

template <typename T, int N>
static int with_lanes(const ScanArgs& a, const void* u, const void* dt,
                      const void* A, const void* Bm, const void* Cm,
                      const void* h0, void* y, void* hlast,
                      cudaStream_t st) {
    switch (a.lanes) {
        case 2: return launch<T, N, 2>(a, u, dt, A, Bm, Cm, h0, y, hlast, st);
        case 4: return launch<T, N, 4>(a, u, dt, A, Bm, Cm, h0, y, hlast, st);
        case 8:
            if constexpr (N >= 8)
                return launch<T, N, 8>(a, u, dt, A, Bm, Cm, h0, y, hlast, st);
            break;
        case 16:
            if constexpr (N >= 16)
                return launch<T, N, 16>(a, u, dt, A, Bm, Cm, h0, y, hlast,
                                        st);
            break;
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch(const ScanArgs& a, const void* u, const void* dt,
                    const void* A, const void* Bm, const void* Cm,
                    const void* h0, void* y, void* hlast,
                    cudaStream_t stream) {
    switch (a.N) {
        case 4: return with_lanes<T, 4>(a, u, dt, A, Bm, Cm, h0, y, hlast,
                                        stream);
        case 8: return with_lanes<T, 8>(a, u, dt, A, Bm, Cm, h0, y, hlast,
                                        stream);
        case 16: return with_lanes<T, 16>(a, u, dt, A, Bm, Cm, h0, y, hlast,
                                          stream);
        case 32: return with_lanes<T, 32>(a, u, dt, A, Bm, Cm, h0, y, hlast,
                                          stream);
        case 64: return with_lanes<T, 64>(a, u, dt, A, Bm, Cm, h0, y, hlast,
                                          stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// dtype: 0 float32, 1 bfloat16 (the type of u, B and C); h0 may be null;
// every pointer 4-byte aligned and, for bfloat16, D even
int selective_scan(const ScanArgs* args, int dtype, const void* u,
                   const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* h0, void* y, void* hlast,
                   void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(*args, u, dt, A, Bm, Cm, h0, y, hlast, st);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(*args, u, dt, A, Bm, Cm, h0, y,
                                       hlast, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
