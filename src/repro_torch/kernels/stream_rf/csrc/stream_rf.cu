// Per-stream Eq. 1 seek count and Eq. 6 seek distance on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/stream_rf/kernel.py:
// `stream_stats` (:135, _stream_stats_kernel: rf and distance) and
// `stream_rf` (:97, _stream_rf_kernel: rf only).  One source serves both; a
// null `dist` pointer turns the distance output off.
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
// Bound: bytes.  The kernel must read 16 B per request (offset and size)
// and write 16 B per row: 16.2 MB for the fleet sweep's 7,844 x 128 matrix,
// 4.8 us at 3.35 TB/s.  A first version of this kernel (one warp per row,
// 4 elements per lane, offset, size and index carried through the sort)
// was bound by instruction issue instead: 25 of its 28 bitonic stages
// crossed lanes, each moving five 32-bit shuffles per element and running
// an int64 compare with an index tiebreak and five selects, 16,000
// shuffles per row at N = 128.
//
// Design, against each cause:
// * A 32-bit key.  Each element sorts as one word,
//   ((off - row min) >> shift << log2 N) | index, where shift drops just
//   the low bits that do not fit beside the index (none when the row spans
//   less than 2^(32 - log2 N)).  A compare-exchange is one unsigned min and
//   one unsigned max (VIMNMX), with no predicate; a 64-bit key costs four
//   compares and four selects per exchange, because the eight exchanges of
//   a stage need more predicates than a thread has.  The key orders by
//   (bucket, index), which is the order by (offset, index) unless two
//   different offsets share a bucket.  After the sort each position reads
//   its offset and size back by index from the row staged in shared
//   memory, and the warp checks its rows' order exactly.  Pairs that a
//   shared bucket left out of order are put right by up to kFixRounds
//   rounds of odd-even transposition on exact (offset, index) pairs; for a
//   random row of 128 offsets over 2^32 bytes (the sweep's shards) that is
//   one row in a few thousand.  A warp whose rows are still out of order
//   then sorts them again with the exact (offset, index) network: the wide
//   branch, warp-uniform, counted in `wide_rows`.
// * Few cross-lane stages.  A thread holds K consecutive positions of its
//   row and T = N / K threads share a row, so the stages of stride below K
//   run in the thread's registers.  The network is the bitonic form whose
//   comparators all point one way (each merge begins by comparing position
//   i with its mirror i ^ (k - 1)), so in-register stages need no direction
//   logic.  At N = 128 with K = 8: 18 of the 28 stages in registers, 10
//   across lanes at one 32-bit shuffle per element: 1,280 shuffles per row
//   (the first version: 16,000) and 1,792 exchanges of two VIMNMX each.
// * Rows in flight.  One warp per block holds 32 / T rows; the sweep's
//   7,844 rows are 3,922 blocks, all resident at once.  The rows are copied
//   into shared memory by cp.async in 16-byte chunks, with no register
//   round trip: the offsets first, then the sizes, which the sort does not
//   need, so that half of the bytes arrive while it runs.  Rows past M are
//   sentinel rows of zeros that are sorted and not stored, so every lane
//   takes part in every shuffle.
//
// Any length.  A row of N requests that is not a power of two, or a row
// whose true length L (an optional per-row `lens` array: a trace's ragged
// last stream) is below the matrix width, runs at the next power-of-two
// width W.  Positions from L up to W are inert: their bucket key is the
// largest (every bucket bit set) with their own index, their exact key is
// (INT64_MAX, index), they take no part in the row's min and max, and the
// count and distance stop at position L - 1.  A real offset of INT64_MAX
// still sorts before them, by index.  Rows of such widths are not 16-byte
// aligned in device memory, so their offsets and sizes are read by plain
// coalesced 8-byte loads instead of cp.async.
//
// Long rows (1024 < N <= 8192): one block of kLongThreads threads scores
// one row.  It stages the exact keys (offset, 16-bit index) and the sizes
// in dynamic shared memory (18 B a position: 147,456 B at N = 8192, of the
// 227 KB a block may have), runs the textbook bitonic network over
// W = next power of two positions with a block barrier between stages,
// then counts and sums the residuals in a strided loop and a block
// reduction.  Simple, not tuned: each stage is one pass over shared memory.
// Rows it scores are counted in `long_rows` (stream_stats_long_rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFixRounds = 2;  // odd-even transposition rounds before the wide branch
constexpr int kLongThreads = 1024;  // threads per block of the long-row kernel
constexpr long long kInt64Max = 0x7fffffffffffffffLL;

// rows scored by the wide branch since the last reset (see
// stream_stats_wide_rows)
__device__ unsigned long long wide_rows = 0;
// rows scored by the long-row kernel since the last reset
__device__ unsigned long long long_rows = 0;

// The fast key: one unsigned 32-bit word.
struct Bucket {
  unsigned k;
  __device__ __forceinline__ static void sort2(Bucket& lo, Bucket& hi) {
    const unsigned a = lo.k, b = hi.k;
    lo.k = min(a, b);
    hi.k = max(a, b);
  }
  __device__ __forceinline__ Bucket shfl_xor(int m) const {
    return {__shfl_xor_sync(kFull, k, m)};
  }
  // the lower position of a pair keeps the smaller key, the upper the larger
  __device__ __forceinline__ static Bucket keep(Bucket mine, Bucket theirs,
                                                unsigned lower) {
    return {lower ? min(mine.k, theirs.k) : max(mine.k, theirs.k)};
  }
};

// (offset, index) strictly before (offset, index); no branches
__device__ __forceinline__ bool before(long long ao, int ai, long long bo,
                                       int bi) {
  return (ao < bo) | ((ao == bo) & (ai < bi));
}

// The exact key: offset, then arrival index.
struct Wide {
  long long o;
  int i;
  __device__ __forceinline__ static void sort2(Wide& lo, Wide& hi) {
    const bool swap = before(hi.o, hi.i, lo.o, lo.i);
    const Wide a = lo, b = hi;
    lo = swap ? b : a;
    hi = swap ? a : b;
  }
  __device__ __forceinline__ Wide shfl_xor(int m) const {
    return {__shfl_xor_sync(kFull, o, m), __shfl_xor_sync(kFull, i, m)};
  }
  __device__ __forceinline__ static Wide keep(Wide mine, Wide theirs,
                                              unsigned lower) {
    return (lower != 0) == before(theirs.o, theirs.i, mine.o, mine.i) ? theirs
                                                                      : mine;
  }
};

// Ascending bitonic sort of a row's 2^LOG_W keys.  Position i = t * K + r
// is register r of thread t of the row.  Merge k = 2^lk first compares i
// with i ^ (k - 1), then with i ^ j for j = k/4 .. 1; the lower position
// always keeps the smaller key.  Partners less than K apart are in the
// thread's registers; the others are register r ^ (m & (K - 1)) of thread
// t ^ (m >> LOG_K), fetched by one shuffle.
template <int LOG_W, int LOG_K, class Key>
__device__ __forceinline__ void bitonic_sort(Key (&v)[1 << LOG_K], int t) {
  constexpr int K = 1 << LOG_K;
#pragma unroll
  for (int lk = 1; lk <= LOG_W; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int m = lj == lk - 1 ? (1 << lk) - 1 : 1 << lj;  // partner i ^ m
      if (lj < LOG_K) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if (((r >> lj) & 1) == 0) Key::sort2(v[r], v[r ^ m]);
        }
      } else {
        const int tm = m >> LOG_K;
        const int rm = m & (K - 1);
        const unsigned lower = ((t >> (lj - LOG_K)) & 1) ^ 1;
        Key got[K];
#pragma unroll
        for (int r = 0; r < K; ++r) got[r] = v[r ^ rm].shfl_xor(tm);
#pragma unroll
        for (int r = 0; r < K; ++r) v[r] = Key::keep(v[r], got[r], lower);
      }
    }
  }
}

// Whether every position of the warp's rows is before its successor.
template <int W, int K>
__device__ __forceinline__ bool warp_in_order(const long long (&o)[K],
                                              const int (&ix)[K], int t) {
  const long long o_next = __shfl_down_sync(kFull, o[0], 1);
  const int ix_next = __shfl_down_sync(kFull, ix[0], 1);
  bool ok = true;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (t * K + r < W - 1) {  // every position but the row's last
      const long long on = r + 1 < K ? o[r + 1 < K ? r + 1 : r] : o_next;
      const int in = r + 1 < K ? ix[r + 1 < K ? r + 1 : r] : ix_next;
      ok &= before(o[r], ix[r], on, in);
    }
  }
  return __all_sync(kFull, ok);
}

// One round of odd-even transposition: positions (p, p + 1) swap when out
// of order, first for even p, then for odd p (across threads at r = K - 1).
template <int W, int K>
__device__ __forceinline__ void transposition_round(long long (&o)[K],
                                                    int (&ix)[K], int t) {
  constexpr int T = W / K;
#pragma unroll
  for (int first = 0; first < 2; ++first) {
#pragma unroll
    for (int r = first; r + 1 < K; r += 2) {
      if (before(o[r + 1], ix[r + 1], o[r], ix[r])) {
        const long long to = o[r];
        o[r] = o[r + 1];
        o[r + 1] = to;
        const int ti = ix[r];
        ix[r] = ix[r + 1];
        ix[r + 1] = ti;
      }
    }
    if (first == 1) {  // the pair that spans threads t and t + 1
      const long long on = __shfl_down_sync(kFull, o[0], 1);
      const int in = __shfl_down_sync(kFull, ix[0], 1);
      const long long op = __shfl_up_sync(kFull, o[K - 1], 1);
      const int ip = __shfl_up_sync(kFull, ix[K - 1], 1);
      if (t + 1 < T && before(on, in, o[K - 1], ix[K - 1])) {
        o[K - 1] = on;
        ix[K - 1] = in;
      }
      if (t > 0 && before(o[0], ix[0], op, ip)) {
        o[0] = op;
        ix[0] = ip;
      }
    }
  }
}

// Starts copying the warp's G rows of `src`, from row `row0`, into `dst`
// in 16-byte chunks, lane l taking chunks l, l + 32, ..., so that each copy
// instruction of the warp reads 512 contiguous bytes; rows past M are
// sentinel rows of zeros.  Ends the copy group.
template <int W, int G>
__device__ __forceinline__ void copy_rows(long long* dst, const long long* src,
                                          long long row0, long long m) {
#pragma unroll
  for (int c = 0; c < G * W / (2 * kWarp); ++c) {
    const int f = (c * kWarp + (int)threadIdx.x) * 2;
    if (row0 + f / W < m) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + f));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + row0 * W + f));
    } else {
      dst[f] = 0;
      dst[f + 1] = 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The same for rows of n < W elements (not 16-byte aligned): element f of
// the warp's G * n contiguous elements goes to position f % n of row f / n.
// Positions n .. W - 1 are left as they are (inert); rows past M are zeros.
template <int W, int G>
__device__ __forceinline__ void load_rows(long long* dst, const long long* src,
                                          long long row0, long long m, int n) {
  for (int f = (int)threadIdx.x; f < G * n; f += kWarp) {
    const int g = f / n;
    dst[g * W + (f - g * n)] = row0 + g < m ? src[row0 * n + f] : 0;
  }
}

// Scores G = 32 / T rows per warp (one warp per block); thread t of row g
// holds positions t * K .. t * K + K - 1 of it.
// PAD: rows may be shorter than W (n < W, or a `lens` array); positions
// from the row's length on are inert (see the header).
template <int LOG_W, int LOG_K, bool PAD>
__global__ void __launch_bounds__(kWarp)
stream_stats_kernel(const long long* __restrict__ offs,
                    const long long* __restrict__ sizes,
                    const long long* __restrict__ lens,
                    long long* __restrict__ rf_out,
                    long long* __restrict__ dist_out, long long m, int n) {
  constexpr int W = 1 << LOG_W;
  constexpr int K = 1 << LOG_K;
  constexpr int T = W / K;      // threads per row
  constexpr int G = kWarp / T;  // rows per warp
  __shared__ __align__(16) long long off_of[G][W];
  __shared__ __align__(16) long long size_of[G][W];

  const int g = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long row = (long long)blockIdx.x * G + g;
  const bool live = row < m;  // a sentinel row of zeros past M
  // the row's true length: positions from it on are inert (PAD only)
  int len = W;
  if (PAD) {
    len = n;
    if (lens != nullptr && live) {
      const long long l = lens[row];
      len = l < 0 ? 0 : (l < n ? (int)l : n);
    }
  }

  // The offsets first, then the sizes in a second group: the sort needs
  // only the offsets, so the sizes are still arriving while it runs.
  if (!PAD || n == W) {
    copy_rows<W, G>(&off_of[0][0], offs, (long long)blockIdx.x * G, m);
    copy_rows<W, G>(&size_of[0][0], sizes, (long long)blockIdx.x * G, m);
    asm volatile("cp.async.wait_group 1;\n" ::);  // the offsets
  } else {
    load_rows<W, G>(&off_of[0][0], offs, (long long)blockIdx.x * G, m, n);
    load_rows<W, G>(&size_of[0][0], sizes, (long long)blockIdx.x * G, m, n);
  }
  __syncwarp();

  long long lo = 0x7fffffffffffffffLL;
  long long hi = -lo - 1;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (!PAD || r * T + t < len) {
      const long long o = off_of[g][r * T + t];
      lo = o < lo ? o : lo;
      hi = o > hi ? o : hi;
    }
  }
#pragma unroll
  for (int s = T / 2; s > 0; s >>= 1) {
    const long long plo = __shfl_xor_sync(kFull, lo, s);
    const long long phi = __shfl_xor_sync(kFull, hi, s);
    lo = plo < lo ? plo : lo;
    hi = phi > hi ? phi : hi;
  }
  // drop the low bits of (off - min) that do not fit beside the index
  const unsigned long long span =
      (unsigned long long)hi - (unsigned long long)lo;
  const int width = 64 - __clzll((long long)span);
  const int shift = width > 32 - LOG_W ? width - (32 - LOG_W) : 0;

  Bucket v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const unsigned long long rel =
        (unsigned long long)off_of[g][r * T + t] - (unsigned long long)lo;
    v[r].k = (unsigned)(rel >> shift) << LOG_W | (unsigned)(r * T + t);
    if (PAD && r * T + t >= len) v[r].k = ~0u << LOG_W | (unsigned)(r * T + t);
  }
  bitonic_sort<LOG_W, LOG_K>(v, t);

  long long o[K];
  int ix[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    ix[r] = (int)(v[r].k & (W - 1));
    o[r] = PAD && ix[r] >= len ? kInt64Max : off_of[g][ix[r]];
  }
  bool wide = false;
  for (int round = 0; !warp_in_order<W, K>(o, ix, t); ++round) {
    if (round == kFixRounds) {  // the wide branch: the exact network
      wide = true;
      Wide w[K];
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const int p = r * T + t;
        w[r] = {PAD && p >= len ? kInt64Max : off_of[g][p], p};
      }
      bitonic_sort<LOG_W, LOG_K>(w, t);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        o[r] = w[r].o;
        ix[r] = w[r].i;
      }
      break;
    }
    transposition_round<W, K>(o, ix, t);
  }
  if (wide && threadIdx.x == 0) {
    atomicAdd(&wide_rows, (unsigned long long)min((long long)G, m - row));
  }

  asm volatile("cp.async.wait_group 0;\n" ::);  // the sizes
  __syncwarp();
  const long long o_next = __shfl_down_sync(kFull, o[0], 1);
  unsigned rf = 0;
  unsigned long long dist = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (t * K + r < len - 1) {
      const long long on = r + 1 < K ? o[r + 1 < K ? r + 1 : r] : o_next;
      unsigned long long d = (unsigned long long)on - (unsigned long long)o[r] -
                             (unsigned long long)size_of[g][ix[r]];
      rf += d != 0ull;
      if ((long long)d < 0) d = 0ull - d;
      dist += d;
    }
  }
#pragma unroll
  for (int s = T / 2; s > 0; s >>= 1) {
    rf += __shfl_xor_sync(kFull, rf, s);
    dist += __shfl_xor_sync(kFull, dist, s);
  }
  if (live && t == 0) {
    rf_out[row] = (long long)rf;
    if (dist_out != nullptr) dist_out[row] = (long long)dist;
  }
}

template <int LOG_W, int LOG_K>
int launch(const long long* offs, const long long* sizes, const long long* lens,
           long long* rf, long long* dist, long long m, int n,
           cudaStream_t stream) {
  constexpr int G = kWarp / ((1 << LOG_W) >> LOG_K);
  const long long blocks = (m + G - 1) / G;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (lens == nullptr && n == (1 << LOG_W)) {
    stream_stats_kernel<LOG_W, LOG_K, false><<<(unsigned)blocks, kWarp, 0, stream>>>(
        offs, sizes, nullptr, rf, dist, m, n);
  } else {
    stream_stats_kernel<LOG_W, LOG_K, true><<<(unsigned)blocks, kWarp, 0, stream>>>(
        offs, sizes, lens, rf, dist, m, n);
  }
  return (int)cudaGetLastError();
}

// One block scores one long row (1024 < n <= kMaxLong); see the header.
// Shared memory: W exact offsets, n sizes, W 16-bit indices.
constexpr int kMaxLong = 8192;

__global__ void __launch_bounds__(kLongThreads)
stream_stats_long_kernel(const long long* __restrict__ offs,
                         const long long* __restrict__ sizes,
                         const long long* __restrict__ lens,
                         long long* __restrict__ rf_out,
                         long long* __restrict__ dist_out, int n, int log_w) {
  extern __shared__ __align__(16) long long smem[];
  const int w = 1 << log_w;
  long long* key = smem;                       // [w] exact offsets
  long long* size_of = smem + w;               // [n] sizes, arrival order
  unsigned short* ix = reinterpret_cast<unsigned short*>(smem + w + n);  // [w]
  const long long row = blockIdx.x;
  int len = n;
  if (lens != nullptr) {
    const long long l = lens[row];
    len = l < 0 ? 0 : (l < n ? (int)l : n);
  }
  const long long* ro = offs + row * n;
  const long long* rs = sizes + row * n;
  for (int p = threadIdx.x; p < w; p += kLongThreads) {
    key[p] = p < len ? ro[p] : kInt64Max;
    ix[p] = (unsigned short)p;
    if (p < n) size_of[p] = rs[p];
  }
  __syncthreads();
  // ascending bitonic sort on (offset, index); pair (a, a | j), a's bit j
  // clear, ascending where a's bit k is clear
  for (int k = 2; k <= w; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < w / 2; i += kLongThreads) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int b = a | j;
        const long long oa = key[a], ob = key[b];
        const int ia = ix[a], ib = ix[b];
        const bool b_first = before(ob, ib, oa, ia);
        if (b_first == ((a & k) == 0)) {
          key[a] = ob;
          key[b] = oa;
          ix[a] = (unsigned short)ib;
          ix[b] = (unsigned short)ia;
        }
      }
      __syncthreads();
    }
  }
  unsigned rf = 0;
  unsigned long long dist = 0;
  for (int p = threadIdx.x; p < len - 1; p += kLongThreads) {
    unsigned long long d = (unsigned long long)key[p + 1] -
                           (unsigned long long)key[p] -
                           (unsigned long long)size_of[ix[p]];
    rf += d != 0ull;
    if ((long long)d < 0) d = 0ull - d;
    dist += d;
  }
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    rf += __shfl_xor_sync(kFull, rf, s);
    dist += __shfl_xor_sync(kFull, dist, s);
  }
  __shared__ unsigned warp_rf[kLongThreads / kWarp];
  __shared__ unsigned long long warp_dist[kLongThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) {
    warp_rf[warp] = rf;
    warp_dist[warp] = dist;
  }
  __syncthreads();
  if (warp == 0) {
    rf = lane < kLongThreads / kWarp ? warp_rf[lane] : 0u;
    dist = lane < kLongThreads / kWarp ? warp_dist[lane] : 0ull;
#pragma unroll
    for (int s = kWarp / 2; s > 0; s >>= 1) {
      rf += __shfl_xor_sync(kFull, rf, s);
      dist += __shfl_xor_sync(kFull, dist, s);
    }
    if (lane == 0) {
      rf_out[row] = (long long)rf;
      if (dist_out != nullptr) dist_out[row] = (long long)dist;
      atomicAdd(&long_rows, 1ull);
    }
  }
}

int launch_long(const long long* offs, const long long* sizes,
                const long long* lens, long long* rf, long long* dist,
                long long m, int n, cudaStream_t stream) {
  if (m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int log_w = 0;
  while ((1 << log_w) < n) ++log_w;
  const int w = 1 << log_w;
  const size_t bytes = (size_t)w * 8 + (size_t)n * 8 + (size_t)w * 2;
  cudaError_t err = cudaFuncSetAttribute(
      stream_stats_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  stream_stats_long_kernel<<<(unsigned)m, kLongThreads, bytes, stream>>>(
      offs, sizes, lens, rf, dist, n, log_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Rows are n elements apart, 2 <= n <= 8192.  `dist` may be null (count
// only); `lens` may be null (every row n long), else M true lengths.
// When n is a power of two up to 1024, offs and sizes must be 16-byte
// aligned.  The caller checks shapes, dtypes and contiguity.
extern "C" int stream_stats_launch(const void* offs, const void* sizes,
                                   const void* lens, void* rf, void* dist,
                                   long long m, int n, void* stream) {
  if (m <= 0) return 0;
  if (n < 2 || n > kMaxLong) return (int)cudaErrorInvalidValue;
  const long long* o = static_cast<const long long*>(offs);
  const long long* s = static_cast<const long long*>(sizes);
  const long long* l = static_cast<const long long*>(lens);
  long long* r = static_cast<long long*>(rf);
  long long* d = static_cast<long long*>(dist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 1024) return launch_long(o, s, l, r, d, m, n, st);
  int w = 2;
  while (w < n) w <<= 1;
  if (w == n &&
      ((reinterpret_cast<uintptr_t>(offs) | reinterpret_cast<uintptr_t>(sizes)) & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  switch (w) {  // <log2 W, log2 K>
    case 2: return launch<1, 1>(o, s, l, r, d, m, n, st);
    case 4: return launch<2, 2>(o, s, l, r, d, m, n, st);
    case 8: return launch<3, 3>(o, s, l, r, d, m, n, st);
    case 16: return launch<4, 3>(o, s, l, r, d, m, n, st);
    case 32: return launch<5, 3>(o, s, l, r, d, m, n, st);
    case 64: return launch<6, 3>(o, s, l, r, d, m, n, st);
    case 128: return launch<7, 3>(o, s, l, r, d, m, n, st);
    case 256: return launch<8, 3>(o, s, l, r, d, m, n, st);
    case 512: return launch<9, 4>(o, s, l, r, d, m, n, st);
    default: return launch<10, 5>(o, s, l, r, d, m, n, st);
  }
}

// Reads the count of rows the wide branch has scored into `*out` and, if
// `reset`, sets it to 0; synchronises with the device.  Returns the CUDA
// error (0 on success).
extern "C" int stream_stats_wide_rows(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, wide_rows, sizeof(*out));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(wide_rows, &zero, sizeof(zero));
  }
  return (int)err;
}

// The same for the rows the long-row kernel has scored.
extern "C" int stream_stats_long_rows(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, long_rows, sizeof(*out));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(long_rows, &zero, sizeof(zero));
  }
  return (int)err;
}
