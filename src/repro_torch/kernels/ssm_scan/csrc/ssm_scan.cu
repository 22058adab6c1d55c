// ssm_scan.cu — Mamba-1 selective scan for sm_90a, written by hand.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/ssm_scan/kernel.py
// (`_ssm_kernel`, launched by `ssm_scan`).  Same function:
//   a_t = exp(delta_t * A)                 (per channel d and state n)
//   h_t = a_t * h_{t-1} + (delta_t * B_t) * x_t,  h_{-1} = 0, f32 throughout
//   y_t = <h_t, C_t>                       (sum over n), y in x's dtype
// and h_last = h_{S-1} in f32.  delta, B, C and A are f32; x and y are f32
// or bf16.
//
// On the TPU the state lives in VMEM scratch that persists across
// sequence-chunk grid steps.  Here blocks run in no order, so nothing can be
// carried between them: each thread owns one (b, d, n) and walks the whole
// sequence in a loop, with h in a register.  The N lanes of one channel
// (N a power of two up to 32) sit in one warp, and y_t is their sum by
// __shfl_xor_sync.  Inputs are read once and y and h_last written once; the
// inputs of the next 8 steps are loaded while the current 8 are computed.
//
// Bound on this card.  At the serve slice's shape (delta (4,2048,8192) f32,
// x and y bf16, N = 16) the bytes are about 540 MB, 161 us at 3.35 TB/s,
// and the 4*2048*8192*16 = 1.07e9 exponentials take about 257 us on the
// special-function units (16 per clock per SM, 132 SMs, ~1.98 GHz): the
// kernel is bound by operations.  This simple design spends 4 shuffles of the
// y reduction per step beside each exponential; a reduce-scatter of y over
// several steps, or one thread per channel with the N states in registers,
// is later work.
//
// C interface: ssm_scan_launch(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;  // steps whose inputs are loaded ahead

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_scan_fwd(const float* __restrict__ delta, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const T* __restrict__ x,
             const float* __restrict__ A, T* __restrict__ y, float* __restrict__ h_last,
             int S, int DI, int N) {
  const int b = blockIdx.y;
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int d = static_cast<int>(gid / N);
  const int n = static_cast<int>(gid % N);
  const bool live = d < DI;
  const int dc = live ? d : DI - 1;  // lanes past DI load channel DI-1, store nothing

  const float a_dn = A[static_cast<long long>(dc) * N + n];
  const long long row = static_cast<long long>(b) * S;  // first (b, t=0) row
  const float* dp = delta + row * DI + dc;
  const T* xp = x + row * DI + dc;
  const float* bp = Bm + row * N + n;
  const float* cp = Cm + row * N + n;
  T* yp = y + row * DI + dc;

  float cd[U], cx[U], cb[U], cc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < S;
    cd[u] = in ? dp[static_cast<long long>(u) * DI] : 0.f;
    cx[u] = in ? to_f32(xp[static_cast<long long>(u) * DI]) : 0.f;
    cb[u] = in ? bp[static_cast<long long>(u) * N] : 0.f;
    cc[u] = in ? cp[static_cast<long long>(u) * N] : 0.f;
  }

  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float nd[U], nx[U], nb[U], nc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = t0 + U + u;
      const bool in = t < S;
      nd[u] = in ? dp[t * DI] : 0.f;
      nx[u] = in ? to_f32(xp[t * DI]) : 0.f;
      nb[u] = in ? bp[t * N] : 0.f;
      nc[u] = in ? cp[t * N] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {  // uniform across the warp
        const float a = expf(cd[u] * a_dn);
        h = a * h + (cd[u] * cb[u]) * cx[u];
        float yv = h * cc[u];
        for (int off = N >> 1; off > 0; off >>= 1)
          yv += __shfl_xor_sync(0xffffffffu, yv, off);
        if (live && n == 0) yp[static_cast<long long>(t0 + u) * DI] = from_f32<T>(yv);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cd[u] = nd[u];
      cx[u] = nx[u];
      cb[u] = nb[u];
      cc[u] = nc[u];
    }
  }
  if (live) h_last[(static_cast<long long>(b) * DI + d) * N + n] = h;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y).  delta (B,S,DI), B/C (B,S,N),
// A (DI,N) and h_last (B,DI,N) are f32; all tensors are contiguous.
extern "C" int ssm_scan_launch(const void* delta, const void* Bm, const void* Cm,
                               const void* x, const void* A, void* y, void* h_last,
                               int dtype, int batch, int S, int DI, int N, void* stream) {
  if (batch <= 0 || S <= 0 || DI <= 0 || N <= 0 || N > 32 || (N & (N - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = static_cast<long long>(DI) * N;
  const dim3 grid(static_cast<unsigned>((lanes + THREADS - 1) / THREADS), batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(delta);
  const float* b = static_cast<const float*>(Bm);
  const float* c = static_cast<const float*>(Cm);
  const float* a = static_cast<const float*>(A);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0) {
    ssm_scan_fwd<float><<<grid, THREADS, 0, st>>>(d, b, c, static_cast<const float*>(x), a,
                                                  static_cast<float*>(y), hl, S, DI, N);
  } else if (dtype == 1) {
    ssm_scan_fwd<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        d, b, c, static_cast<const __nv_bfloat16*>(x), a, static_cast<__nv_bfloat16*>(y), hl, S,
        DI, N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
