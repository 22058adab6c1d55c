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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFixRounds = 2;  // odd-even transposition rounds before the wide branch

// rows scored by the wide branch since the last reset (see
// stream_stats_wide_rows)
__device__ unsigned long long wide_rows = 0;

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

// Scores G = 32 / T rows per warp (one warp per block); thread t of row g
// holds positions t * K .. t * K + K - 1 of it.
template <int LOG_W, int LOG_K>
__global__ void __launch_bounds__(kWarp)
stream_stats_kernel(const long long* __restrict__ offs,
                    const long long* __restrict__ sizes,
                    long long* __restrict__ rf_out,
                    long long* __restrict__ dist_out, long long m) {
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

  // The offsets first, then the sizes in a second group: the sort needs
  // only the offsets, so the sizes are still arriving while it runs.
  copy_rows<W, G>(&off_of[0][0], offs, (long long)blockIdx.x * G, m);
  copy_rows<W, G>(&size_of[0][0], sizes, (long long)blockIdx.x * G, m);
  asm volatile("cp.async.wait_group 1;\n" ::);  // the offsets
  __syncwarp();

  long long lo = 0x7fffffffffffffffLL;
  long long hi = -lo - 1;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const long long o = off_of[g][r * T + t];
    lo = o < lo ? o : lo;
    hi = o > hi ? o : hi;
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
  }
  bitonic_sort<LOG_W, LOG_K>(v, t);

  long long o[K];
  int ix[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    ix[r] = (int)(v[r].k & (W - 1));
    o[r] = off_of[g][ix[r]];
  }
  bool wide = false;
  for (int round = 0; !warp_in_order<W, K>(o, ix, t); ++round) {
    if (round == kFixRounds) {  // the wide branch: the exact network
      wide = true;
      Wide w[K];
#pragma unroll
      for (int r = 0; r < K; ++r) w[r] = {off_of[g][r * T + t], r * T + t};
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
    if (t * K + r < W - 1) {
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
int launch(const long long* offs, const long long* sizes, long long* rf,
           long long* dist, long long m, cudaStream_t stream) {
  constexpr int G = kWarp / ((1 << LOG_W) >> LOG_K);
  const long long blocks = (m + G - 1) / G;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stream_stats_kernel<LOG_W, LOG_K>
      <<<(unsigned)blocks, kWarp, 0, stream>>>(offs, sizes, rf, dist, m);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `dist` may be null (count only).  n must be a power of two in [2, 1024]
// and offs and sizes 16-byte aligned; the caller checks shapes, dtypes and
// contiguity.
extern "C" int stream_stats_launch(const void* offs, const void* sizes,
                                   void* rf, void* dist, long long m, int n,
                                   void* stream) {
  if (m <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(offs) | reinterpret_cast<uintptr_t>(sizes)) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  const long long* o = static_cast<const long long*>(offs);
  const long long* s = static_cast<const long long*>(sizes);
  long long* r = static_cast<long long*>(rf);
  long long* d = static_cast<long long*>(dist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {  // <log2 n, log2 K>
    case 2: return launch<1, 1>(o, s, r, d, m, st);
    case 4: return launch<2, 2>(o, s, r, d, m, st);
    case 8: return launch<3, 3>(o, s, r, d, m, st);
    case 16: return launch<4, 3>(o, s, r, d, m, st);
    case 32: return launch<5, 3>(o, s, r, d, m, st);
    case 64: return launch<6, 3>(o, s, r, d, m, st);
    case 128: return launch<7, 3>(o, s, r, d, m, st);
    case 256: return launch<8, 3>(o, s, r, d, m, st);
    case 512: return launch<9, 4>(o, s, r, d, m, st);
    case 1024: return launch<10, 5>(o, s, r, d, m, st);
    default: return (int)cudaErrorInvalidValue;
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
