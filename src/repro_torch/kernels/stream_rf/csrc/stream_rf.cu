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
// Long rows (1024 < N <= 8192): one block of T = W / 16 threads scores one
// row (128 at W = 2048, 512 at W = 8192), each thread holding K = 16
// positions.  It runs the short kernel's algorithm over a block:
// * The same 32-bit key, exact check, repair rounds and exact branch as
//   above, block-wide: the order check is one block barrier (each warp
//   checks its own positions and posts its verdict and its edge pairs),
//   a transposition round one more.  Rows still out of order after
//   kFixRounds take the exact branch, counted in `long_wide_rows`: the
//   textbook network on (offset, index) pairs in shared memory, a block
//   barrier a stage, compact code for a rare path (with an unrolled one
//   the port's three sources built in 73 s, not 50, on the H100 machine's
//   host: this one was the last to finish).  An exact 64-bit key,
//   ((off - min) << log2 W) | index, needs no check, but its compares and
//   two-word shuffles made the kernel about 1.7 times slower.
// * Registers, not shared memory, for most stages: strides below 16 in
//   registers, up to 511 across lanes.  Merges wider than a warp's 512
//   positions cross warps.  The first of them has one such stage, its
//   mirror, which reads each partner's key from shared memory (one
//   barrier); wider ones re-lay the row once so that each warp holds the
//   positions their cross-warp stages pair (the mirror stage included, by
//   reading the upper half of each merge block mirrored), and after those
//   stages lay it back.  Three shared-memory rounds at W = 2048 (a
//   textbook network: 66 barriers), seven at W = 8192; two buffers taken in
//   turns spare a barrier before each write, and an XOR swizzle keeps a
//   warp's accesses on 32 distinct banks in every layout.
// * Rows in flight, loaded without registers: 48 KB of shared memory a
//   block at W = 2048 (offsets; two 32-bit re-layout buffers; sizes), so
//   four blocks share an SM and 489 rows run in one wave.  A 16-byte-
//   aligned row's offsets and sizes arrive by one bulk asynchronous copy
//   each (cp.async.bulk, completing on an mbarrier); the sort waits only
//   for the offsets.  Other rows (odd N) are read by coalesced 8-byte
//   loads.
// * No host work per launch but the launch: the dynamic shared-memory
//   limit is raised once per instance and device.
// Bound: bytes, as above, but the sort sets the pace: its cross-lane
// stages and its shared-memory rounds (their accesses, not their barriers)
// take most of the time (PERF.md, measured by chip_stream_variants.py).
// Rows it scores are counted in `long_rows` (stream_stats_long_rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFixRounds = 2;  // odd-even transposition rounds before the wide branch
constexpr long long kInt64Max = 0x7fffffffffffffffLL;

// rows scored by the wide branch since the last reset (see
// stream_stats_wide_rows)
__device__ unsigned long long wide_rows = 0;
// rows scored by the long-row kernel since the last reset
__device__ unsigned long long long_rows = 0;
// rows the long-row kernel scored by its exact branch since the last reset
__device__ unsigned long long long_wide_rows = 0;

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

// Stage lj of merge k = 2^lk of the ascending one-way bitonic network, on
// positions i = t * K + r (register r of thread t).  Merge k first compares
// i with i ^ (k - 1), then with i ^ j for j = k/4 .. 1; the lower position
// always keeps the smaller key.  Partners less than K apart are in the
// thread's registers; the others are register r ^ (m & (K - 1)) of thread
// t ^ (m >> LOG_K), fetched by one shuffle (lanes of one warp).
template <int LOG_K, class Key>
__device__ __forceinline__ void network_stage(Key (&v)[1 << LOG_K], int t, int lk,
                                              int lj) {
  constexpr int K = 1 << LOG_K;
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

// Ascending bitonic sort of a row's 2^LOG_W keys held by one warp's lanes.
template <int LOG_W, int LOG_K, class Key>
__device__ __forceinline__ void bitonic_sort(Key (&v)[1 << LOG_K], int t) {
#pragma unroll
  for (int lk = 1; lk <= LOG_W; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) network_stage<LOG_K>(v, t, lk, lj);
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

// ---- Long rows (1024 < n <= kMaxLong): one block a row; see the header.

constexpr int kMaxLong = 8192;
constexpr int kMaxDevices = 64;  // devices whose shared-memory limit is tracked

constexpr int kLongLogK = 4;  // K = 16 positions a thread of the long-row kernel
constexpr int kLongK = 1 << kLongLogK;

// A re-layout parks each key in a word of shared memory.
__device__ __forceinline__ void park(void* s, int a, Bucket v) {
  static_cast<unsigned*>(s)[a] = v.k;
}
__device__ __forceinline__ void unpark(const void* s, int a, Bucket& v) {
  v.k = static_cast<const unsigned*>(s)[a];
}

// The shared-memory slot of position p: its low five bits XOR the five
// from bit log2 K on, so that the 32 positions a warp holds in one
// register, which differ in those bits, fall on 32 distinct banks in both
// layouts below.  Like merge_position, slot is linear over GF(2)
// (slot(a ^ b) = slot(a) ^ slot(b)), so a thread computes it once a layout
// and each register's slot differs from it by a constant.
__host__ __device__ constexpr int slot(int p) {
  return p ^ ((p >> kLongLogK) & (kWarp - 1));
}

// Which bit of x = t * K + r (register bits 0 .. log2 K - 1, lane bits
// log2 K .. log2 K + 4) holds bit lk - 1 - j of the merge coordinate
// (below), j = 0 .. lk - log2 K - 6: the top ones in registers, the next
// ones in lanes.
__host__ __device__ constexpr int merge_bit(int j) {
  return j < kLongLogK ? kLongLogK - 1 - j : 2 * kLongLogK + 4 - j;
}

// The position register r of thread t holds while merge lk runs its
// cross-warp stages (x = t * K + r; lk > log2 K + 5, the merges wider than
// a warp's 32 K positions).  Its merge coordinate c is x with bits
// lk - 1 - j and merge_bit(j) swapped for each j, so that those stages pair
// positions of one warp; the position is c, or c with its low lk - 1 bits
// flipped where bit lk - 1 is set (the upper half of the merge block read
// mirrored), so that the merge's mirror stage i <-> i ^ (2^lk - 1) becomes
// the pair (c, c ^ 2^(lk - 1)) like the others.
__host__ __device__ constexpr int merge_position(int lk, int x) {
  int c = x;
  for (int j = 0; j < lk - kLongLogK - 5; ++j) {
    const int hi = lk - 1 - j, lo = merge_bit(j);
    const int differ = ((x >> hi) ^ (x >> lo)) & 1;
    c ^= (differ << hi) | (differ << lo);
  }
  // x bit log2 K - 1 is c bit lk - 1
  return (x >> (kLongLogK - 1)) & 1 ? c ^ ((1 << (lk - 1)) - 1) : c;
}

// Merge lk's cross-warp stages, in the merge layout: coordinate bit
// q = lk - 1 - j pairs register r with r ^ 2^merge_bit(j), or lane l with
// l ^ 2^(merge_bit(j) - log2 K).  Position bit q = 0 keeps the smaller key:
// for the mirror stage (j = 0) that is coordinate bit q = 0, for the
// others coordinate bit q equal to the mirror bit b (register bit
// log2 K - 1).
template <class Key>
__device__ __forceinline__ void merge_stages(Key (&v)[kLongK], int lane, int lk) {
#pragma unroll
  for (int j = 0; j < lk - kLongLogK - 5; ++j) {
    const int s = merge_bit(j);
    if (s < kLongLogK) {
#pragma unroll
      for (int r = 0; r < kLongK; ++r) {
        if ((r >> s) & 1) continue;
        const int r2 = r | (1 << s);
        if (j == 0 || ((r >> (kLongLogK - 1)) & 1) == 0) {
          Key::sort2(v[r], v[r2]);
        } else {
          Key::sort2(v[r2], v[r]);
        }
      }
    } else {
      const int lm = 1 << (s - kLongLogK);
      const unsigned cq = (lane >> (s - kLongLogK)) & 1;
      Key got[kLongK];
#pragma unroll
      for (int r = 0; r < kLongK; ++r) got[r] = v[r].shfl_xor(lm);
#pragma unroll
      for (int r = 0; r < kLongK; ++r) {
        v[r] = Key::keep(v[r], got[r], cq == (unsigned)((r >> (kLongLogK - 1)) & 1));
      }
    }
  }
}

// Re-lays the block's keys through `s`: each thread parks its keys at the
// positions of one layout and takes up those of the other (the merge layout
// of merge lk when `to_merge`, else the plain one, t * K + r).
template <class Key>
__device__ __forceinline__ void relayout(Key (&v)[kLongK], void* s, int t, int lk,
                                         bool to_merge) {
  // the slot of t * K + r's position: the thread's for r = 0 ^ that of r
  const int plain = slot(t * kLongK);
  const int merge = slot(merge_position(lk, t * kLongK));
#pragma unroll
  for (int r = 0; r < kLongK; ++r) {
    park(s, to_merge ? plain ^ slot(r)
                     : merge ^ slot(merge_position(lk, r)), v[r]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLongK; ++r) {
    unpark(s, to_merge ? merge ^ slot(merge_position(lk, r))
                       : plain ^ slot(r), v[r]);
  }
}

// The mirror stage of merge lk (position p against p ^ (2^lk - 1)) where
// it is the merge's only cross-warp stage: each thread parks its keys at
// their plain positions and reads its partners', one barrier in place of
// two re-layouts.  The lower position, position bit lk - 1 clear (the
// same for all of a thread's positions), keeps the smaller key.
template <class Key>
__device__ __forceinline__ void mirror_stage(Key (&v)[kLongK], void* s, int t, int lk) {
  const int mine = slot(t * kLongK);
  const int theirs = mine ^ slot((1 << lk) - 1);  // slot(p ^ m) = slot(p) ^ slot(m)
  const unsigned lower = (((t * kLongK) >> (lk - 1)) & 1) ^ 1;
#pragma unroll
  for (int r = 0; r < kLongK; ++r) park(s, mine ^ slot(r), v[r]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLongK; ++r) {
    Key got;
    unpark(s, theirs ^ slot(r), got);
    v[r] = Key::keep(v[r], got, lower);
  }
}

// Ascending one-way bitonic sort of a row's 2^LOG_W keys over the block,
// position t * K + r in register r of thread t.  Merges up to a warp's 32 K
// positions and every merge's stages of smaller stride run in the plain
// layout (network_stage); the first merge wider than a warp has one
// cross-warp stage, its mirror (mirror_stage); the others run theirs in the
// merge layout, between two re-layouts.  Shared memory goes through `a`
// and `b` taken in turns, so that no barrier is needed before a write.
template <int LOG_W, class Key>
__device__ __forceinline__ void long_sort(Key (&v)[kLongK], int t, void* a, void* b) {
  constexpr int kWarpLog = kLongLogK + 5;  // log2 of a warp's positions
  int turn = 0;
#pragma unroll
  for (int lk = 1; lk <= LOG_W; ++lk) {
    int top = lk - 1;
    if (lk == kWarpLog + 1) {
      mirror_stage(v, turn++ & 1 ? b : a, t, lk);
      top = kWarpLog - 1;
    } else if (lk > kWarpLog) {
      relayout(v, turn++ & 1 ? b : a, t, lk, true);
      merge_stages(v, t % kWarp, lk);
      relayout(v, turn++ & 1 ? b : a, t, lk, false);
      top = kWarpLog - 1;
    }
#pragma unroll
    for (int lj = top; lj >= 0; --lj) network_stage<kLongLogK>(v, t, lk, lj);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Starts a bulk asynchronous copy of `bytes` (a multiple of 16) from
// global `src` to shared `dst`, both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Waits for the first phase of `bar`.  A wait of more than about 10 s (a
// lost copy) traps, so a fault ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

template <int LOG_W>
struct LongShape {
  static constexpr int W = 1 << LOG_W;
  static constexpr int T = W >> kLongLogK;  // threads a block
  static constexpr int kWarps = T / kWarp;
  static constexpr int kBlocks = LOG_W == 11 ? 4 : (LOG_W == 12 ? 2 : 1);  // a SM
  // dynamic shared memory at most: offsets, re-layout buffers, sizes
  static constexpr int kBytes = 3 * W * 8;
};

// The first position of each warp's span and the last, exchanged through
// shared memory for the pairs that span two warps, and whether the warp's
// own positions are in order.
struct Edges {
  long long first_o[kWarp], last_o[kWarp];
  int first_ix[kWarp], last_ix[kWarp];
  int ok[kWarp];
};

// The sorted neighbours of thread t's first and last positions: the next
// thread's first (none for the row's last thread) and the previous
// thread's last.  One block barrier; `e` must not be read by any thread
// when it is called.
template <int T>
__device__ __forceinline__ void neighbours(const long long (&o)[kLongK],
                                           const int (&ix)[kLongK], int t, Edges& e,
                                           long long& on, int& in, long long& op,
                                           int& ip) {
  const int lane = t % kWarp, warp = t / kWarp;
  if (lane == 0) {
    e.first_o[warp] = o[0];
    e.first_ix[warp] = ix[0];
  }
  if (lane == kWarp - 1) {
    e.last_o[warp] = o[kLongK - 1];
    e.last_ix[warp] = ix[kLongK - 1];
  }
  __syncthreads();
  on = __shfl_down_sync(kFull, o[0], 1);
  in = __shfl_down_sync(kFull, ix[0], 1);
  op = __shfl_up_sync(kFull, o[kLongK - 1], 1);
  ip = __shfl_up_sync(kFull, ix[kLongK - 1], 1);
  if (lane == kWarp - 1 && t + 1 < T) {
    on = e.first_o[warp + 1];
    in = e.first_ix[warp + 1];
  }
  if (lane == 0 && t > 0) {
    op = e.last_o[warp - 1];
    ip = e.last_ix[warp - 1];
  }
}

// Whether every position of the row is before its successor, with one
// block barrier: each warp checks its own positions and posts its verdict
// and its first and last (offset, index); lane w then checks warp w's post
// against warp w + 1's.  `on`, `in`: the sorted successor of the thread's
// last position (undefined for the row's last), which the residuals reuse.
template <int T>
__device__ __forceinline__ bool block_in_order(const long long (&o)[kLongK],
                                               const int (&ix)[kLongK], int t, Edges& e,
                                               long long& on, int& in) {
  constexpr int kWarps = T / kWarp;
  const int lane = t % kWarp, warp = t / kWarp;
  on = __shfl_down_sync(kFull, o[0], 1);
  in = __shfl_down_sync(kFull, ix[0], 1);
  bool ok = true;
#pragma unroll
  for (int r = 0; r < kLongK; ++r) {
    if (r + 1 < kLongK) {
      ok &= before(o[r], ix[r], o[r + 1 < kLongK ? r + 1 : r], ix[r + 1 < kLongK ? r + 1 : r]);
    } else if (lane + 1 < kWarp) {
      ok &= before(o[r], ix[r], on, in);
    }
  }
  ok = __all_sync(kFull, ok);
  if (lane == 0) {
    e.first_o[warp] = o[0];
    e.first_ix[warp] = ix[0];
    e.ok[warp] = ok;
  }
  if (lane == kWarp - 1) {
    e.last_o[warp] = o[kLongK - 1];
    e.last_ix[warp] = ix[kLongK - 1];
  }
  __syncthreads();
  if (lane == kWarp - 1 && warp + 1 < kWarps) {
    on = e.first_o[warp + 1];
    in = e.first_ix[warp + 1];
  }
  bool post = true;
  if (lane < kWarps) {
    post = e.ok[lane];
    if (lane + 1 < kWarps) {
      post &= before(e.last_o[lane], e.last_ix[lane], e.first_o[lane + 1], e.first_ix[lane + 1]);
    }
  }
  return __all_sync(kFull, post);
}

// One round of odd-even transposition over the row: positions (p, p + 1)
// swap when out of order, first for even p, then for odd p (across
// threads at r = K - 1, across warps through `e`).
template <int T>
__device__ __forceinline__ void block_transposition_round(long long (&o)[kLongK],
                                                          int (&ix)[kLongK], int t,
                                                          Edges& e) {
#pragma unroll
  for (int first = 0; first < 2; ++first) {
#pragma unroll
    for (int r = first; r + 1 < kLongK; r += 2) {
      if (before(o[r + 1], ix[r + 1], o[r], ix[r])) {
        const long long to = o[r];
        o[r] = o[r + 1];
        o[r + 1] = to;
        const int ti = ix[r];
        ix[r] = ix[r + 1];
        ix[r + 1] = ti;
      }
    }
  }
  long long on, op;
  int in, ip;
  neighbours<T>(o, ix, t, e, on, in, op, ip);
  if (t + 1 < T && before(on, in, o[kLongK - 1], ix[kLongK - 1])) {
    o[kLongK - 1] = on;
    ix[kLongK - 1] = in;
  }
  if (t > 0 && before(o[0], ix[0], op, ip)) {
    o[0] = op;
    ix[0] = ip;
  }
}

// One block scores one row of n (1024 < n <= 2^LOG_W) requests.  Dynamic
// shared memory: [W] the row's offsets (in the exact branch, later the
// sorted 16-bit indices); [W] 64-bit words: two buffers of 32-bit bucket
// keys (in the exact branch, the sorted offsets); [n] sizes.
template <int LOG_W>
__global__ void __launch_bounds__(LongShape<LOG_W>::T, LongShape<LOG_W>::kBlocks)
stream_stats_long_kernel(const long long* __restrict__ offs,
                         const long long* __restrict__ sizes,
                         const long long* __restrict__ lens,
                         long long* __restrict__ rf_out,
                         long long* __restrict__ dist_out, int n) {
  using S = LongShape<LOG_W>;
  constexpr int W = S::W, T = S::T, K = kLongK, kWarps = S::kWarps;
  extern __shared__ __align__(16) long long smem[];
  long long* off_of = smem;
  long long* relay = smem + W;
  long long* size_of = smem + 2 * W;
  __shared__ __align__(8) uint64_t bar[2];  // offsets, sizes
  __shared__ long long part_lo[kWarps], part_hi[kWarps];
  __shared__ unsigned part_rf[kWarps];
  __shared__ unsigned long long part_dist[kWarps];
  __shared__ Edges check_edges, round_edges;

  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const long long row = blockIdx.x;
  int len = n;
  if (lens != nullptr) {
    const long long l = lens[row];
    len = l < 0 ? 0 : (l < n ? (int)l : n);
  }
  const long long* ro = offs + row * n;
  const long long* rs = sizes + row * n;
  const bool bulk =
      (((reinterpret_cast<uintptr_t>(ro) | reinterpret_cast<uintptr_t>(rs)) & 15) | (n & 1)) == 0;
  if (bulk) {
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar[0])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar[1])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      bulk_load(off_of, ro, (uint32_t)n * 8, &bar[0]);
      bulk_load(size_of, rs, (uint32_t)n * 8, &bar[1]);
    }
    __syncthreads();  // the barriers are initialised
    bulk_wait(&bar[0]);
  } else {
    for (int p = t; p < n; p += T) {
      off_of[p] = ro[p];
      size_of[p] = rs[p];
    }
    __syncthreads();
  }

  // element r * T + t goes to position t * K + r; min and max over real ones
  long long off[K];
  long long lo = kInt64Max, hi = -kInt64Max - 1;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    off[r] = off_of[r * T + t];
    if (r * T + t < len) {
      lo = off[r] < lo ? off[r] : lo;
      hi = off[r] > hi ? off[r] : hi;
    }
  }
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    const long long plo = __shfl_xor_sync(kFull, lo, s);
    const long long phi = __shfl_xor_sync(kFull, hi, s);
    lo = plo < lo ? plo : lo;
    hi = phi > hi ? phi : hi;
  }
  if (lane == 0) {
    part_lo[warp] = lo;
    part_hi[warp] = hi;
  }
  __syncthreads();
  lo = lane < kWarps ? part_lo[lane] : kInt64Max;
  hi = lane < kWarps ? part_hi[lane] : -kInt64Max - 1;
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    const long long plo = __shfl_xor_sync(kFull, lo, s);
    const long long phi = __shfl_xor_sync(kFull, hi, s);
    lo = plo < lo ? plo : lo;
    hi = phi > hi ? phi : hi;
  }
  // drop the low bits of (off - min) that do not fit beside the index
  const unsigned long long span = (unsigned long long)hi - (unsigned long long)lo;
  const int width = 64 - __clzll((long long)span);
  const int shift = width > 32 - LOG_W ? width - (32 - LOG_W) : 0;

  Bucket v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int e = r * T + t;
    const unsigned long long rel = (unsigned long long)off[r] - (unsigned long long)lo;
    v[r].k = (e < len ? (unsigned)(rel >> shift) << LOG_W : ~0u << LOG_W) | (unsigned)e;
  }
  unsigned* relay32 = reinterpret_cast<unsigned*>(relay);
  long_sort<LOG_W>(v, t, relay32, relay32 + W);

  long long o[K];
  int ix[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    ix[r] = (int)(v[r].k & (W - 1));
    o[r] = ix[r] >= len ? kInt64Max : off_of[ix[r]];
  }
  bool exact = false;
  long long on;  // the sorted successor of the thread's last position
  int in;
  for (int round = 0; !block_in_order<T>(o, ix, t, check_edges, on, in); ++round) {
    if (round == kFixRounds) {
      exact = true;
      break;
    }
    block_transposition_round<T>(o, ix, t, round_edges);
  }
  if (exact) {  // the exact branch: the textbook network on (offset, index)
    long long* key_o = relay;                                              // [W]
    unsigned short* key_ix = reinterpret_cast<unsigned short*>(off_of);   // [W]
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int e = r * T + t;
      key_o[e] = e < len ? off[r] : kInt64Max;
      key_ix[e] = (unsigned short)e;
    }
    __syncthreads();
    // pair (a, a | j), a's bit j clear, ascending where a's bit k is clear
#pragma unroll 1
    for (int k = 2; k <= W; k <<= 1) {
#pragma unroll 1
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < W / 2; i += T) {
          const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
          const int b = a | j;
          const long long oa = key_o[a], ob = key_o[b];
          const int ia = key_ix[a], ib = key_ix[b];
          if (before(ob, ib, oa, ia) == ((a & k) == 0)) {
            key_o[a] = ob;
            key_o[b] = oa;
            key_ix[a] = (unsigned short)ib;
            key_ix[b] = (unsigned short)ia;
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      o[r] = key_o[t * K + r];
      ix[r] = key_ix[t * K + r];
    }
    if (t == 0) atomicAdd(&long_wide_rows, 1ull);
    block_in_order<T>(o, ix, t, check_edges, on, in);  // in order: the successors
  }

  if (bulk) bulk_wait(&bar[1]);  // the sizes
  unsigned rf = 0;
  unsigned long long dist = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (t * K + r < len - 1) {
      const long long onext = r + 1 < K ? o[r + 1 < K ? r + 1 : r] : on;
      unsigned long long d = (unsigned long long)onext - (unsigned long long)o[r] -
                             (unsigned long long)size_of[ix[r]];
      rf += d != 0ull;
      if ((long long)d < 0) d = 0ull - d;
      dist += d;
    }
  }
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    rf += __shfl_xor_sync(kFull, rf, s);
    dist += __shfl_xor_sync(kFull, dist, s);
  }
  if (lane == 0) {
    part_rf[warp] = rf;
    part_dist[warp] = dist;
  }
  __syncthreads();
  if (warp == 0) {
    rf = lane < kWarps ? part_rf[lane] : 0u;
    dist = lane < kWarps ? part_dist[lane] : 0ull;
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

template <int LOG_W>
int launch_long(const long long* offs, const long long* sizes, const long long* lens,
                long long* rf, long long* dist, long long m, int n, cudaStream_t stream) {
  using S = LongShape<LOG_W>;
  if (m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the dynamic shared-memory limit, raised once per device
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(stream_stats_long_kernel<LOG_W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  const size_t bytes = (size_t)2 * S::W * 8 + (((size_t)n * 8 + 15) & ~(size_t)15);
  stream_stats_long_kernel<LOG_W><<<(unsigned)m, S::T, bytes, stream>>>(
      offs, sizes, lens, rf, dist, n);
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
  if (n > 2048) {
    return n > 4096 ? launch_long<13>(o, s, l, r, d, m, n, st)
                    : launch_long<12>(o, s, l, r, d, m, n, st);
  }
  if (n > 1024) return launch_long<11>(o, s, l, r, d, m, n, st);
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

// The same for the rows the long-row kernel has scored by its exact branch.
extern "C" int stream_stats_long_wide_rows(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, long_wide_rows, sizeof(*out));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(long_wide_rows, &zero, sizeof(zero));
  }
  return (int)err;
}
