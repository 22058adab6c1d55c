// ssm_scan.cu — Mamba-1 selective scan for sm_90a, written by hand.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/ssm_scan/kernel.py
// (`_ssm_kernel`, launched by `ssm_scan`, kernel.py:37-67).  Same function:
//   a_t = exp(delta_t * A)                 (per channel d and state n)
//   h_t = a_t * h_{t-1} + (delta_t * B_t) * x_t,  h_{-1} = 0, f32 throughout
//   y_t = <h_t, C_t>                       (sum over n), y in x's dtype
// and h_last = h_{S-1} in f32.  delta, B, C and A are f32; x and y are f32
// or bf16.
//
// Bound on this card.  At the serve slice's shape (delta (4,2048,8192) f32,
// x and y bf16, N = 16) the bytes are about 540 MB, 161 us at 3.35 TB/s,
// and the 4*2048*8192*16 = 1.07e9 exponentials take about 257 us on the
// special-function units (16 per clock per SM, 132 SMs, ~1.98 GHz): the
// kernel is bound by the exponentials.
//
// On the TPU the state lives in VMEM scratch that persists across
// sequence-chunk grid steps.  Here blocks run in no order, so nothing is
// carried between them: one thread owns one (b, d) channel for the whole
// sequence and keeps its N states and its N values of A in registers.  N is
// a template argument, so the state loops unroll; y_t is a sum inside the
// thread, with no shuffles, and each step has N independent exponentials,
// one ex2.approx each with A taken times log2(e) once.  With the plain
// ex2.approx of t = delta * A * log2(e), which is negative, y drifted past
// the f32 tolerance of 1e-4 at the serve shape (|err| 6.9e-4); a
// systematic error of the unit for results just below 1, adding up over a
// channel's long memory (t near 0), would explain it, but that is an
// observation on the card, not a documented property of the unit.  Taking
// a = 2^t as 2^(t + 1) / 2, whose argument lies in [0, 1) for t in [-1, 0),
// held the tolerance on every case tried, the model's own delta and A
// included (chip_smoke.py), at about the plain instruction's cost; for
// t < -1 the argument is negative again, but there a < 1/2 and the
// channel forgets quickly.  It is less precise than expf, and the f32
// cases are what show that it is precise enough.  A block
// is 128 channels of one batch row: at the serve shape 64 x 4 = 256 blocks
// of 4 warps, one wave.  The block stages chunks of 32 time steps of delta
// [32][128] f32 and x [32][128], and the B and C rows [32][N] that all its
// channels share, in shared memory with cp.async, double-buffered so the
// next chunk loads while this one is computed (16-byte copies when DI is a
// multiple of 8, plain loads otherwise).  Each warp's y store covers 32
// consecutive channels, so y goes straight from registers to memory;
// h_last is written once.  Inputs are read once and outputs written once.
//
// C interface: ssm_scan_launch(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 128;  // channels (threads) per block
constexpr int TC = 32;   // time steps per staged chunk
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <typename T, int N>
constexpr int smem_bytes() {
  return 2 * TC * CH * (static_cast<int>(sizeof(float)) + static_cast<int>(sizeof(T))) +
         2 * 2 * TC * N * static_cast<int>(sizeof(float));
}

// VEC: DI is a multiple of 8 and delta and x start on 16 bytes, so rows of
// delta and x are copied in 16-byte pieces.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(CH)
ssm_scan_fwd(const float* __restrict__ delta, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const T* __restrict__ x,
             const float* __restrict__ A, T* __restrict__ y, float* __restrict__ h_last, int S,
             int DI) {
  extern __shared__ __align__(16) float ssm_smem[];
  float* s_delta = ssm_smem;                                       // [2][TC][CH]
  T* s_x = reinterpret_cast<T*>(s_delta + 2 * TC * CH);           // [2][TC][CH]
  float* s_B = reinterpret_cast<float*>(s_x + 2 * TC * CH);       // [2][TC][N]
  float* s_C = s_B + 2 * TC * N;                                   // [2][TC][N]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + tid;
  const bool live = d < DI;
  const int dc = live ? d : DI - 1;  // threads past DI compute on channel DI-1, store nothing

  // Stage the chunk of steps t0 .. t0+TC-1 into buffer buf.
  auto stage = [&](int buf, int t0) {
    const int steps = min(TC, S - t0);
    const long long row0 = static_cast<long long>(b) * S + t0;
    float* sd = s_delta + buf * TC * CH;
    T* sx = s_x + buf * TC * CH;
    if constexpr (VEC) {
      constexpr int DP = CH * 4 / 16;                            // 16-byte pieces per delta row
      for (int i = tid; i < steps * DP; i += CH) {
        const int r = i / DP, p = i % DP;
        if (d0 + p * 4 < DI)
          cp_async16(sd + r * CH + p * 4, delta + (row0 + r) * DI + d0 + p * 4);
      }
      constexpr int XE = 16 / static_cast<int>(sizeof(T));      // x elements per piece
      constexpr int XP = CH / XE;
      for (int i = tid; i < steps * XP; i += CH) {
        const int r = i / XP, p = i % XP;
        if (d0 + p * XE < DI)
          cp_async16(sx + r * CH + p * XE, x + (row0 + r) * DI + d0 + p * XE);
      }
    } else {
      if (live) {
        for (int r = 0; r < steps; ++r) {
          sd[r * CH + tid] = delta[(row0 + r) * DI + d];
          sx[r * CH + tid] = x[(row0 + r) * DI + d];
        }
      }
    }
    for (int i = tid; i < steps * N; i += CH) {
      cp_async4(s_B + buf * TC * N + i, Bm + row0 * N + i);
      cp_async4(s_C + buf * TC * N + i, Cm + row0 * N + i);
    }
    cp_async_commit();
  };

  float an[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = A[static_cast<long long>(dc) * N + n] * LOG2E;
    h[n] = 0.f;
  }

  auto step = [&](const float* sd, const T* sx, const float* sb, const float* sc, T* yp) {
    const float dl = *sd;
    const float xv = to_f32(*sx);
    float bn[N], cn[N];
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 vb = *reinterpret_cast<const float4*>(sb + n);
        const float4 vc = *reinterpret_cast<const float4*>(sc + n);
        bn[n] = vb.x, bn[n + 1] = vb.y, bn[n + 2] = vb.z, bn[n + 3] = vb.w;
        cn[n] = vc.x, cn[n + 1] = vc.y, cn[n + 2] = vc.z, cn[n + 3] = vc.w;
      }
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        bn[n] = sb[n];
        cn[n] = sc[n];
      }
    }
    float yv = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float a = 0.5f * exp2_approx(fmaf(dl, an[n], 1.0f));  // exp(delta A)
      h[n] = a * h[n] + (dl * bn[n]) * xv;
      yv += h[n] * cn[n];
    }
    if (live) *yp = from_f32<T>(yv);
  };

  const int chunks = (S + TC - 1) / TC;
  stage(0, 0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int t0 = c * TC;
    if (c + 1 < chunks) {
      stage(buf ^ 1, t0 + TC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in shared memory
    const float* sd = s_delta + buf * TC * CH + tid;
    const T* sx = s_x + buf * TC * CH + tid;
    const float* sb = s_B + buf * TC * N;
    const float* sc = s_C + buf * TC * N;
    T* yp = y + (static_cast<long long>(b) * S + t0) * DI + dc;
    const int steps = min(TC, S - t0);
    if (steps == TC) {
#pragma unroll 4
      for (int t = 0; t < TC; ++t)
        step(sd + t * CH, sx + t * CH, sb + t * N, sc + t * N, yp + static_cast<long long>(t) * DI);
    } else {
      for (int t = 0; t < steps; ++t)
        step(sd + t * CH, sx + t * CH, sb + t * N, sc + t * N, yp + static_cast<long long>(t) * DI);
    }
    __syncthreads();  // buffer buf is free for chunk c + 2
  }
  if (live) {
    float* hp = h_last + (static_cast<long long>(b) * DI + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hp[n] = h[n];
  }
}

template <typename T, int N>
int launch(const float* delta, const float* Bm, const float* Cm, const void* x, const float* A,
           void* y, float* h_last, int batch, int S, int DI, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, N>();
  const bool vec = DI % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(delta) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
  auto kernel = vec ? ssm_scan_fwd<T, N, true> : ssm_scan_fwd<T, N, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((DI + CH - 1) / CH, batch);
  kernel<<<grid, CH, bytes, stream>>>(delta, Bm, Cm, static_cast<const T*>(x), A,
                                      static_cast<T*>(y), h_last, S, DI);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const float* delta, const float* Bm, const float* Cm, const void* x,
               const float* A, void* y, float* h_last, int batch, int S, int DI,
               cudaStream_t st) {
  switch (N) {
    case 1: return launch<T, 1>(delta, Bm, Cm, x, A, y, h_last, batch, S, DI, st);
    case 2: return launch<T, 2>(delta, Bm, Cm, x, A, y, h_last, batch, S, DI, st);
    case 4: return launch<T, 4>(delta, Bm, Cm, x, A, y, h_last, batch, S, DI, st);
    case 8: return launch<T, 8>(delta, Bm, Cm, x, A, y, h_last, batch, S, DI, st);
    case 16: return launch<T, 16>(delta, Bm, Cm, x, A, y, h_last, batch, S, DI, st);
    case 32: return launch<T, 32>(delta, Bm, Cm, x, A, y, h_last, batch, S, DI, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y).  delta (B,S,DI), B/C (B,S,N),
// A (DI,N) and h_last (B,DI,N) are f32; all tensors are contiguous.  N is a
// power of two up to 32.
extern "C" int ssm_scan_launch(const void* delta, const void* Bm, const void* Cm,
                               const void* x, const void* A, void* y, void* h_last,
                               int dtype, int batch, int S, int DI, int N, void* stream) {
  if (batch <= 0 || S <= 0 || DI <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(delta);
  const float* b = static_cast<const float*>(Bm);
  const float* c = static_cast<const float*>(Cm);
  const float* a = static_cast<const float*>(A);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0) return dispatch_n<float>(N, d, b, c, x, a, y, hl, batch, S, DI, st);
  if (dtype == 1) return dispatch_n<__nv_bfloat16>(N, d, b, c, x, a, y, hl, batch, S, DI, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
