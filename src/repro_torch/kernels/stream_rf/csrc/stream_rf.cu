// Per-stream Eq. 1 seek count and Eq. 6 seek distance on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/stream_rf/kernel.py:
// `stream_stats` (_stream_stats_kernel: rf and distance) and `stream_rf`
// (_stream_rf_kernel: rf only).  One source serves both; a null `dist`
// pointer turns the distance output off.
//
// What it computes, per row of (M, N) int64 offsets and sizes:
//   sort the row by (offset, arrival index)   -- a stable sort, so ties
//                                                 order as NumPy's argsort
//   resid_i = off[i+1] - off[i] - size[i]      over sorted neighbours
//   rf      = #(resid_i != 0)                  (int64)
//   dist    = sum |resid_i|                    (int64, two's-complement wrap,
//                                                 bit-equal to NumPy)
// The TPU kernel sorted int32 keys with an unstable network and summed the
// distance in float32; this one is exact for any int64 offset.
//
// Design: one warp per row.  Each lane holds K = max(N, 32) / 32 elements in
// registers in a striped layout (logical position p = r * 32 + lane, so the
// loads are coalesced).  A bitonic network over 32 * K positions sorts them:
// strides below 32 exchange across lanes with __shfl_xor_sync, strides of 32
// and up swap registers inside a lane.  Rows shorter than 32 are padded with
// sentinel keys (INT64_MAX, index >= N) that sort past every real element.
// After the sort the neighbour at p + 1 comes from __shfl_down_sync (or lane
// 0 of the next register for lane 31), and a warp reduction sums rf and dist.
//
// Bound: memory.  The kernel must read 16 B per request (offset and size)
// and write 16 B per row; 1M requests are 16 MB, about 5 us at 3.35 TB/s.
// The sort's compare-exchanges stay in registers and are far below the
// card's integer rate.  At per-shard sizes (~100 rows) the launch latency
// dominates; batching shards into one launch is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;  // one warp per row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool key_less(long long ao, int ai, long long bo,
                                         int bi) {
  return ao < bo || (ao == bo && ai < bi);
}

template <int K, int LOG_W>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
stream_stats_kernel(const long long* __restrict__ offs,
                    const long long* __restrict__ sizes,
                    long long* __restrict__ rf_out,
                    long long* __restrict__ dist_out, long long m, int n) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp);
  if (row >= m) return;  // row is warp-uniform: whole warps leave together
  const long long* ro = offs + row * (long long)n;
  const long long* rs = sizes + row * (long long)n;

  long long o[K];
  long long s[K];
  int ix[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int p = r * kWarp + lane;
    if (p < n) {
      o[r] = ro[p];
      s[r] = rs[p];
    } else {
      o[r] = 0x7fffffffffffffffLL;  // sentinel: sorts last
      s[r] = 0;
    }
    ix[r] = p;
  }

  // bitonic sort of 2^LOG_W = 32 * K positions, ascending by (offset, index)
#pragma unroll
  for (int lk = 1; lk <= LOG_W; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= kWarp) {
        const int jr = j / kWarp;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if ((r & jr) == 0) {
            const int r2 = r | jr;
            const bool up = ((r * kWarp + lane) & k) == 0;
            const bool gt = key_less(o[r2], ix[r2], o[r], ix[r]);
            if (gt == up) {
              const long long to = o[r];
              o[r] = o[r2];
              o[r2] = to;
              const long long ts = s[r];
              s[r] = s[r2];
              s[r2] = ts;
              const int ti = ix[r];
              ix[r] = ix[r2];
              ix[r2] = ti;
            }
          }
        }
      } else {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const long long po = __shfl_xor_sync(kFull, o[r], j);
          const long long ps = __shfl_xor_sync(kFull, s[r], j);
          const int pi = __shfl_xor_sync(kFull, ix[r], j);
          const bool up = ((r * kWarp + lane) & k) == 0;
          // the lower position of an ascending pair keeps the smaller key,
          // as does the upper position of a descending pair
          const bool keep_min = (lower == up);
          const bool partner_less = key_less(po, pi, o[r], ix[r]);
          if (keep_min == partner_less) {
            o[r] = po;
            s[r] = ps;
            ix[r] = pi;
          }
        }
      }
    }
  }

  unsigned long long rf = 0;
  unsigned long long dist = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    long long nxt = __shfl_down_sync(kFull, o[r], 1);
    if (r + 1 < K) {
      const long long wrap = __shfl_sync(kFull, o[r + 1 < K ? r + 1 : r], 0);
      if (lane == kWarp - 1) nxt = wrap;
    }
    const int p = r * kWarp + lane;
    if (p < n - 1) {
      unsigned long long d = (unsigned long long)nxt -
                             (unsigned long long)o[r] -
                             (unsigned long long)s[r];
      rf += (d != 0ull);
      if ((long long)d < 0) d = 0ull - d;
      dist += d;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    rf += __shfl_xor_sync(kFull, rf, off);
    dist += __shfl_xor_sync(kFull, dist, off);
  }
  if (lane == 0) {
    rf_out[row] = (long long)rf;
    if (dist_out != nullptr) dist_out[row] = (long long)dist;
  }
}

template <int K, int LOG_W>
void launch(const long long* offs, const long long* sizes, long long* rf,
            long long* dist, long long m, int n, cudaStream_t stream) {
  const long long blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  stream_stats_kernel<K, LOG_W>
      <<<(unsigned)blocks, kRowsPerBlock * kWarp, 0, stream>>>(
          offs, sizes, rf, dist, m, n);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `dist` may be null (count only).  n must be a power of two in [2, 1024];
// the caller checks shapes, dtypes and contiguity.
extern "C" int stream_stats_launch(const void* offs, const void* sizes,
                                   void* rf, void* dist, long long m, int n,
                                   void* stream) {
  if (m <= 0) return 0;
  if (n < 2 || n > 1024 || (n & (n - 1)) != 0 ||
      (m + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* o = static_cast<const long long*>(offs);
  const long long* s = static_cast<const long long*>(sizes);
  long long* r = static_cast<long long*>(rf);
  long long* d = static_cast<long long*>(dist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n <= kWarp ? 1 : n / kWarp) {
    case 1: launch<1, 5>(o, s, r, d, m, n, st); break;
    case 2: launch<2, 6>(o, s, r, d, m, n, st); break;
    case 4: launch<4, 7>(o, s, r, d, m, n, st); break;
    case 8: launch<8, 8>(o, s, r, d, m, n, st); break;
    case 16: launch<16, 9>(o, s, r, d, m, n, st); break;
    case 32: launch<32, 10>(o, s, r, d, m, n, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
