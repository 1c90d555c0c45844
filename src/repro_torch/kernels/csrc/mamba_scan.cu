// Mamba1 selective scan on Hopper.
//
// Replaces the reference's Pallas kernel _kernel in
// src/repro/kernels/mamba_scan.py (grid (B, D blocks, time chunks), whose
// minor time-chunk axis ran in order on the TPU with the (bd, N) state in
// VMEM scratch).  Here one thread owns one (batch, channel d) and keeps its
// N-wide state in registers for the whole sequence, stepping time in order
// itself; blocks of 64 channels run in parallel.
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
// What bounds it on this card: device-memory bytes (u, dt, y: 10-12 bytes
// per (t, d) against ~20 float32 operations per (t, d, n)) when the card
// is full; at B = 1 the D / 64 blocks leave SMs idle and the sequential
// time loop's latency bounds it.  Each time chunk of 32 steps is staged in
// shared memory first (u and dt of the block's channels, coalesced, and
// B_t, C_t shared by the block's 64 channels) so the loads of a chunk are
// in flight together.  A chunked parallel scan over time is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define SCAN_THREADS 64    // channels per block
#define T_CHUNK 32         // time steps staged per chunk

struct ScanArgs {
    int64_t B, S, D, N;
    int has_h0;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(SCAN_THREADS)
selective_scan_kernel(ScanArgs a, const T* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ hlast) {
    __shared__ float us[T_CHUNK][SCAN_THREADS];
    __shared__ float dts[T_CHUNK][SCAN_THREADS];
    __shared__ float bs[T_CHUNK][N];
    __shared__ float cs[T_CHUNK][N];

    const int tid = threadIdx.x;
    const int64_t d = (int64_t)blockIdx.x * SCAN_THREADS + tid;
    const int64_t b = blockIdx.y;
    const bool live = d < a.D;

    float Ad[N], h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        Ad[n] = live ? A[d * N + n] : 0.f;
        h[n] = (live && a.has_h0) ? h0[(b * a.D + d) * N + n] : 0.f;
    }

    for (int64_t t0 = 0; t0 < a.S; t0 += T_CHUNK) {
        const int tn = (int)(a.S - t0 < T_CHUNK ? a.S - t0 : T_CHUNK);
        __syncthreads();                  // the last chunk's reads are done
        for (int tt = 0; tt < tn; ++tt) {
            const int64_t off = (b * a.S + t0 + tt) * a.D + d;
            us[tt][tid] = live ? to_f(u[off]) : 0.f;
            dts[tt][tid] = live ? dt[off] : 0.f;
        }
        for (int i = tid; i < tn * N; i += SCAN_THREADS) {
            const int tt = i / N, n = i % N;
            const int64_t off = (b * a.S + t0 + tt) * N + n;
            bs[tt][n] = to_f(Bm[off]);
            cs[tt][n] = to_f(Cm[off]);
        }
        __syncthreads();
        if (!live) continue;
        for (int tt = 0; tt < tn; ++tt) {
            const float dtv = dts[tt][tid];
            const float dbu = dtv * us[tt][tid];
            float yv = 0.f;
#pragma unroll
            for (int n = 0; n < N; ++n) {
                const float dA = expf(dtv * Ad[n]);
                h[n] = dA * h[n] + dbu * bs[tt][n];
                yv += h[n] * cs[tt][n];
            }
            y[(b * a.S + t0 + tt) * a.D + d] = yv;
        }
    }
    if (live) {
#pragma unroll
        for (int n = 0; n < N; ++n) hlast[(b * a.D + d) * N + n] = h[n];
    }
}

template <typename T, int N>
static int launch(const ScanArgs& a, const void* u, const void* dt,
                  const void* A, const void* Bm, const void* Cm,
                  const void* h0, void* y, void* hlast, cudaStream_t stream) {
    dim3 grid((unsigned)((a.D + SCAN_THREADS - 1) / SCAN_THREADS),
              (unsigned)a.B);
    selective_scan_kernel<T, N><<<grid, SCAN_THREADS, 0, stream>>>(
        a, (const T*)u, (const float*)dt, (const float*)A, (const T*)Bm,
        (const T*)Cm, (const float*)h0, (float*)y, (float*)hlast);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const ScanArgs& a, const void* u, const void* dt,
                    const void* A, const void* Bm, const void* Cm,
                    const void* h0, void* y, void* hlast,
                    cudaStream_t stream) {
    switch (a.N) {
        case 4: return launch<T, 4>(a, u, dt, A, Bm, Cm, h0, y, hlast, stream);
        case 8: return launch<T, 8>(a, u, dt, A, Bm, Cm, h0, y, hlast, stream);
        case 16: return launch<T, 16>(a, u, dt, A, Bm, Cm, h0, y, hlast, stream);
        case 32: return launch<T, 32>(a, u, dt, A, Bm, Cm, h0, y, hlast, stream);
        case 64: return launch<T, 64>(a, u, dt, A, Bm, Cm, h0, y, hlast, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// dtype: 0 float32, 1 bfloat16 (the type of u, B and C); h0 may be null
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
