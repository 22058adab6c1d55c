// flash_attention.cu — FlashAttention-2 forward for sm_90a, written by hand.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention/kernel.py
// (`_fa_kernel`, launched by `flash_attention`).  Same function:
//   q (B,H,Sq,hd), k/v (B,KV,Sk,hd); GQA maps head h to KV head h / (H/KV);
//   s = (q * scale) . k  in f32; causal mask qpos >= kpos (both from 0), masked
//   scores set to finfo(f32).min; online softmax with m, l and acc in f32;
//   a row whose l is 0 outputs 0; the output is in q's dtype.
//
// Bound on this card.  At the serve slice's shape (bf16, q (4,16,2048,128),
// k/v (4,8,2048,128), causal) the work is 4*B*H*S^2*hd/2 = 68.7 GFLOP, 69 us
// at the bf16 tensor-core peak of 989 TFLOP/s, against 100.7 MB of bytes
// (30 us at 3.35 TB/s): the kernel is bound by operations.
//
// What this design does about it, and what it leaves for later.  It is the
// simple version: f32 FMA on the CUDA cores (no tensor cores, so f32 inputs
// never go through TF32), which caps it at the card's 67 TFLOP/s f32 rate.
// Each block owns one (b, h, 64-row query tile) and loops over 64-key tiles
// staged through shared memory, so each K/V tile is read once per block and
// the (S, S) score matrix never leaves the chip.  Tiles wholly above the
// causal diagonal are skipped; the blocks of the heaviest query tiles are
// launched first.  128 threads: thread (ty, tx) owns query rows ty*8..ty*8+7,
// key columns tx*4..tx*4+3 of each score tile and hd/16 output columns, so
// the row statistics reduce over 16 lanes with __shfl_xor_sync.  Operands
// are kept transposed in shared memory so each thread reads its 8 rows and 4
// columns as float4s.  Rows past Sq and keys past Sk are masked in the
// kernel, so any sequence length works.  The tensor-core version (wgmma from
// TMA-fed shared memory, warp-specialised) is later work.
//
// C interface: flash_attention_launch(...) launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 8 row groups x 16 column lanes
constexpr int ROWS = 8;       // query rows per thread
constexpr int KCOLS = 4;      // score columns per thread
constexpr int LDT = BQ + 4;   // leading dim of the transposed tiles (= BK + 4)
constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min, as the reference

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {  // in elements; head_dim has stride 1
  long long b, h, s;
};

// Output column of the thread's ci-th accumulator: four contiguous columns
// per 64 when hd is a multiple of 64 (float4 reads of V), else one column
// per 16 lanes.
template <int HD>
__device__ __forceinline__ int out_col(int ci, int tx) {
  if constexpr (HD % 64 == 0) {
    return (ci / 4) * 64 + tx * 4 + (ci % 4);
  } else {
    return ci * 16 + tx;
  }
}

template <int HD>
constexpr int smem_floats() {
  // sQt [HD][LDT] + sKV (K^T [HD][LDT] or V [BK][HD]) + sPt [BK][LDT]
  return HD * LDT + (HD * LDT > BK * HD ? HD * LDT : BK * HD) + BK * LDT;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       T* __restrict__ o, int H, int KV, int Sq, int Sk, float scale, int causal,
       Strides qs, Strides ks, Strides vs, Strides os) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int OC = HD / 16;  // output columns per thread
  extern __shared__ float4 smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [HD][LDT]  q^T * scale
  float* sKV = sQt + HD * LDT;                       // K^T [HD][LDT], then V [BK][HD]
  float* sPt = sKV + (HD * LDT > BK * HD ? HD * LDT : BK * HD);  // [BK][LDT] p^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / (H / KV)) * ks.h;
  const T* vb = v + b * vs.b + (h / (H / KV)) * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    sQt[d * LDT + r] = qi < Sq ? to_f32(qb[qi * qs.s + d]) * scale : 0.f;
  }

  float acc[ROWS][OC];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;  // tiles past it are all masked
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const int kj = k0 + c;
      sKV[d * LDT + c] = kj < Sk ? to_f32(kb[kj * ks.s + d]) : 0.f;
    }
    __syncthreads();

    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(sQt + d * LDT + ty * ROWS);
      const float4 qc = *reinterpret_cast<const float4*>(sQt + d * LDT + ty * ROWS + 4);
      const float4 kk = *reinterpret_cast<const float4*>(sKV + d * LDT + tx * KCOLS);
      const float qr[ROWS] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
      const float kr[KCOLS] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // online softmax over this tile
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + ty * ROWS + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k0 + tx * KCOLS + j;
        if (kj >= Sk) {
          s[i][j] = -INFINITY;  // not a key: weight 0
        } else if (causal && qi < kj) {
          s[i][j] = NEG_INF;
        }
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KCOLS; ++j)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) sPt[(tx * KCOLS + j) * LDT + ty * ROWS + i] = s[i][j];
    __syncthreads();  // K^T is consumed, P is written

    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const int kj = k0 + c;
      sKV[c * HD + d] = kj < Sk ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(sPt + kk * LDT + ty * ROWS);
      const float4 pc = *reinterpret_cast<const float4*>(sPt + kk * LDT + ty * ROWS + 4);
      const float pr[ROWS] = {pa.x, pa.y, pa.z, pa.w, pc.x, pc.y, pc.z, pc.w};
      float vr[OC];
      if constexpr (HD % 64 == 0) {
#pragma unroll
        for (int g = 0; g < OC / 4; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(sKV + kk * HD + g * 64 + tx * 4);
          vr[g * 4 + 0] = vv.x;
          vr[g * 4 + 1] = vv.y;
          vr[g * 4 + 2] = vv.z;
          vr[g * 4 + 3] = vv.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < OC; ++c) vr[c] = sKV[kk * HD + out_col<HD>(c, tx)];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    if (qi >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < OC; ++c)
      ob[qi * os.s + out_col<HD>(c, tx)] = from_f32<T>(acc[i][c] / li);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
           int Sq, int Sk, float scale, int causal, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fa_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Sk, scale, causal, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
                int KV, int Sq, int Sk, float scale, int causal, Strides qs, Strides ks,
                Strides vs, Strides os, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Strides are in
// elements, (batch, head, seq) for each tensor; head_dim is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int H, int KV,
    int Sq, int Sk, int hd, float scale, int causal,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh, long long oss,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs,
                                      os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
