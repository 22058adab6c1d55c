// tapes.cu — the event tape's per-stream columns for sm_90a, written by hand:
// one shard's SSD walls, suffix HDD times, prefix and window seek counts and
// cross-stream merge counts, in one cooperative launch on one stream.
//
// Replaces no Pallas kernel.  It is the per-request half of the reference's
// host tape builder, src/repro/core/engine_device.py::build_events (the SSD
// wall's reduceat, _suffix_hdd_anchors, _prefix_seek_anchors,
// _window_seek_anchors, _cross_stream_merges), which the port otherwise
// runs in NumPy: a lexsort of the shard and a bincount for each of 47
// masks.  Same function, bit for bit.  A shard of n requests in arrival
// order is cut into streams of L (the last may be shorter); for each stream
//
//   ssd_w               the sum over its requests, in arrival order, of
//                       max(size / link_bw, size / write_bw), added as
//                       NumPy's add.reduceat adds (the first request, plus
//                       the pairwise sum of the rest);
//   hddt_j (j = 1..15)  the HDD time of the stream's arrival-order suffix
//                       from request round(j * len / 16), sorted by
//                       (offset, arrival): Eq. 1 seeks, the summed |gap| to
//                       the previous extent's end, the bytes;
//   pf_j (j = 1..16)    the Eq. 6 seek count of the prefix up to
//                       round(j * len / 16), sorted by (file, offset, arrival);
//   wf_c, wn_c          the seek count and the count of new files of each
//                       dyadic arrival window (1 + 2 + 4 + 8 of them), in
//                       the same order;
//   xm_d (d = 1..4)     the contiguous pairs the stream forms, as the later
//                       stream, with stream s - d in the shard's global
//                       (file, offset, arrival) order.
//
// Bound on this card: the bytes are the shard's three int64 columns read
// once and the columns written once (0.9 MiB for 32,768 requests, 0.28 us
// at 3.35 TB/s).  What holds the kernel is latency, and the design keeps
// each chain short:
//
// 1. A block a stream (stream_columns).  The stream's offsets, sizes and
//    file ids are staged in shared memory; a bitonic network sorts its
//    positions by (offset, arrival) and by (file, offset, arrival), both in
//    one pass of compare-exchanges; then one thread a mask walks the sorted
//    stream once, keeping the previous masked request in registers
//    (walk_mask).  That is the NumPy code's masked predecessor, taken in the
//    order its bincount sums: the float64 distance and byte sums of a
//    suffix anchor are added in that order, one thread an anchor.  46
//    threads walk in parallel, each len steps of shared-memory reads, and
//    one more adds the stream's SSD wall in NumPy's pairwise order.
// 2. The shard's global order by merging the streams' sorted runs, one
//    round a grid barrier, log2(streams) rounds (merge_one): every request
//    finds its rank in the partner run by binary search over (file,
//    offset, arrival) keys, which are unique, and moves to its place.  A
//    round's searches are independent, one thread a request.
// 3. One thread a neighbouring pair of the global order (count_merge)
//    tests contiguity and adds one, exactly, to the later stream's xm_d.
//
// The phases are one cooperative launch (every block resident, a grid
// barrier between phases), so the host issues one launch a shard.
//
// Arithmetic, to equal the NumPy code: the library is built with
// -fmad=false and the suffix time is __dmul_rn, __dadd_rn and __ddiv_rn in
// the host's term order; every int64 to float64 conversion rounds to
// nearest, as NumPy's does; offsets and ends wrap as int64 sums do in
// NumPy.  Counts are integers, so their atomic adds are exact in any order.
//
// C interface: tapes_launch(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or an error it found in its
// arguments before launching).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int SUFFIX_ANCHORS = 16;
constexpr int WINDOW_SCALES = 4;
constexpr int N_WINDOWS = (1 << WINDOW_SCALES) - 1;
constexpr int XMERGE_D = 4;
// The longest stream a block holds: five arrays of it in shared memory.
constexpr int MAX_STREAM_LEN = 8192;
constexpr int THREADS = 128;
constexpr int MAX_DEVICES = 64;

// The rows of the input columns and of the output, in the order of the
// tuples of repro_torch/kernels/tapes/ops.py (the CPU tests parse these).
// A member named NAME_0 or NAME_1 starts a group of fields that runs to
// the next.  The output is (rows, streams): row r of stream s at r * ns + s.
struct Col { enum : int { OFFSETS, SIZES, FILE_IDS, COUNT }; };
struct Column { enum : int {
  SSD_W,
  HDDT_1,
  PF_1 = HDDT_1 + SUFFIX_ANCHORS - 1,
  WF_0 = PF_1 + SUFFIX_ANCHORS,
  WN_0 = WF_0 + N_WINDOWS,
  XM_1 = WN_0 + N_WINDOWS,
  COUNT = XM_1 + XMERGE_D
}; };

// The walkers of a stream: thread w < WALKERS walks one mask.
enum : int {
  SUFFIX_W = SUFFIX_ANCHORS - 1,        // hddt_1..15 over the (offset) order
  PREFIX_W = SUFFIX_ANCHORS,            // pf_1..16 over the (file, offset) order
  WINDOW_W = N_WINDOWS,                 // wf_c and wn_c, same order
  WALKERS = SUFFIX_W + PREFIX_W + WINDOW_W
};
// and the threads after them: XMERGE_D zero the xm rows, one adds ssd_w
enum : int { SSD_W_T = WALKERS + XMERGE_D };
static_assert(SSD_W_T < THREADS, "a thread for every walker, xm row and ssd_w");

struct Consts {
  double seek_time, seek_dist_coeff, seq_bw, link_bw, write_bw;
};

typedef unsigned long long u64;

// The window of arrival position p among w windows of a stream of len:
// boundaries at round(k * len / w), as the host computes it.
__device__ __forceinline__ long long window_of(long long p, long long w, long long len) {
  const long long k = ((2 * p + 1) * w - 1) / (2 * len);
  return k < w - 1 ? k : w - 1;
}

// The first position in [0, len) whose window is at least k (len if none).
__device__ int first_in_window(long long k, long long w, int len) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (window_of(mid, w, len) < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Sort keys of stream positions a, b; positions at or past len (padding)
// come after every request, in position order.
__device__ __forceinline__ bool before_by_offset(int a, int b, int len, const long long* off) {
  const bool pa = a >= len, pb = b >= len;
  if (pa || pb) return pa == pb ? a < b : pb;
  const long long oa = off[a], ob = off[b];
  return oa < ob || (oa == ob && a < b);
}

__device__ __forceinline__ bool before_by_file(int a, int b, int len, const long long* off,
                                               const long long* fid) {
  const bool pa = a >= len, pb = b >= len;
  if (pa || pb) return pa == pb ? a < b : pb;
  const long long fa = fid[a], fb = fid[b];
  if (fa != fb) return fa < fb;
  const long long oa = off[a], ob = off[b];
  return oa < ob || (oa == ob && a < b);
}

// Walker tid of stream s: its mask's requests in sorted order, each
// against the previous masked one, and its column written.
__device__ void walk_mask(int tid, int len, int s, int ns, const long long* off,
                          const long long* siz, const long long* fid,
                          const unsigned short* by_off, const unsigned short* by_file,
                          double* __restrict__ out, const Consts& k) {
  // this thread's mask: the arrival positions [lo, hi) of its suffix,
  // prefix or window
  const bool suffix = tid < SUFFIX_W;
  const bool window = tid >= SUFFIX_W + PREFIX_W;
  int lo, hi;
  if (suffix) {
    lo = ((tid + 1) * len + SUFFIX_ANCHORS / 2) / SUFFIX_ANCHORS;  // round(j * len / 16)
    hi = len;
  } else if (!window) {
    lo = 0;
    hi = ((tid - SUFFIX_W + 1) * len + SUFFIX_ANCHORS / 2) / SUFFIX_ANCHORS;
  } else {
    const int c = tid - SUFFIX_W - PREFIX_W;
    const int sc = 31 - __clz(c + 1);  // scale: c in [2^sc - 1, 2^(sc+1) - 1)
    const long long w = 1LL << sc, kw = c + 1 - w;
    lo = first_in_window(kw, w, len);
    hi = kw == w - 1 ? len : first_in_window(kw + 1, w, len);
  }
  const unsigned short* order = suffix ? by_off : by_file;

  bool has = false;
  long long pf = 0;
  u64 pend = 0;
  int seeks = 0, new_files = 0;
  long long rf = 0;
  double dist = 0.0, nb = 0.0;
  for (int t = 0; t < len; ++t) {
    const int i = order[t];
    if (i < lo || i >= hi) continue;
    const long long o = off[i], f = fid[i], z = siz[i];
    const bool same = has && (suffix || f == pf);
    const bool contig = same && (u64)o == pend;
    seeks += !contig;
    new_files += !same;
    if (suffix) {
      if (has) {
        const long long r = (long long)((u64)o - pend);
        const long long a = r < 0 ? (long long)(0ULL - (u64)r) : r;
        rf += r != 0;
        dist = __dadd_rn(dist, __ll2double_rn(a));
      }
      nb = __dadd_rn(nb, __ll2double_rn(z));
    }
    has = true;
    pf = f;
    pend = (u64)o + (u64)z;
  }

  if (suffix) {
    // the host's term order: rf * seek_time + dist * coeff + nb / seq_bw
    const double t = __dadd_rn(__dadd_rn(__dmul_rn(__ll2double_rn(rf), k.seek_time),
                                         __dmul_rn(dist, k.seek_dist_coeff)),
                               __ddiv_rn(nb, k.seq_bw));
    out[(Column::HDDT_1 + tid) * ns + s] = t;
  } else if (!window) {
    out[(Column::PF_1 + tid - SUFFIX_W) * ns + s] = (double)seeks;
  } else {
    const int c = tid - SUFFIX_W - PREFIX_W;
    out[(Column::WF_0 + c) * ns + s] = (double)seeks;
    out[(Column::WN_0 + c) * ns + s] = (double)new_files;
  }
}

// One request's SSD wall, as NumPy's maximum of the two quotients (NaN
// propagates).
__device__ __forceinline__ double wall(long long size, const Consts& k) {
  const double z = __ll2double_rn(size);
  const double a = __ddiv_rn(z, k.link_bw), b = __ddiv_rn(z, k.write_bw);
  return (a != a || a >= b) ? a : b;
}

// NumPy's pairwise sum of the walls of siz[0, n), n <= 128: under 8 one
// after another from 0; else in eight interleaved sums, combined as
// ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)), then the rest one after another.
__device__ double block_walls(const long long* siz, int n, const Consts& k) {
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res = __dadd_rn(res, wall(siz[i], k));
    return res;
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = wall(siz[j], k);
  int i = 8;
  for (; i < n - n % 8; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = __dadd_rn(r[j], wall(siz[i + j], k));
  }
  double res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                         __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
  for (; i < n; ++i) res = __dadd_rn(res, wall(siz[i], k));
  return res;
}

// NumPy's pairwise sum of the walls of siz[0, n): above 128, the two halves
// (the first a multiple of 8) summed apart and added.  Its recursion walked
// without a call stack: the right halves still to sum and the left sums
// waiting for them, one level each (n <= MAX_STREAM_LEN: 7 levels at most).
__device__ double pairwise_walls(const long long* siz, int n, const Consts& k) {
  constexpr int DEPTH = 16;
  int right_at[DEPTH], right_n[DEPTH];
  double left[DEPTH];
  bool on_right[DEPTH];
  int depth = 0, at = 0, m = n;
  for (;;) {
    while (m > 128) {
      int m2 = m / 2;
      m2 -= m2 % 8;
      right_at[depth] = at + m2;
      right_n[depth] = m - m2;
      on_right[depth] = false;
      ++depth;
      m = m2;
    }
    double v = block_walls(siz + at, m, k);
    for (;;) {
      if (depth == 0) return v;
      if (!on_right[depth - 1]) {  // the left half is done: sum the right one
        left[depth - 1] = v;
        on_right[depth - 1] = true;
        at = right_at[depth - 1];
        m = right_n[depth - 1];
        break;
      }
      v = __dadd_rn(left[depth - 1], v);
      --depth;
    }
  }
}

// One stream s: staged, sorted both ways, its columns computed, its
// (file, offset, arrival) run written to run[].  Ends with a block barrier,
// so the caller may stage the next stream.
__device__ void stream_columns(const long long* __restrict__ cols, int n, int L, int P, int s,
                               int ns, int* __restrict__ run, double* __restrict__ out,
                               const Consts& k, unsigned char* smem) {
  long long* off = reinterpret_cast<long long*>(smem);
  long long* siz = off + P;
  long long* fid = siz + P;
  unsigned short* by_off = reinterpret_cast<unsigned short*>(fid + P);
  unsigned short* by_file = by_off + P;

  const int tid = threadIdx.x;
  const long long base = (long long)s * L;
  const int len = (int)(n - base < L ? n - base : L);

  for (int i = tid; i < P; i += THREADS) {
    if (i < len) {
      off[i] = cols[Col::OFFSETS * (long long)n + base + i];
      siz[i] = cols[Col::SIZES * (long long)n + base + i];
      fid[i] = cols[Col::FILE_IDS * (long long)n + base + i];
    }
    by_off[i] = (unsigned short)i;
    by_file[i] = (unsigned short)i;
  }
  __syncthreads();

  // both orders, one bitonic network
  for (int kk = 2; kk <= P; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += THREADS) {
        const int l = i ^ j;
        if (l > i) {
          const bool up = (i & kk) == 0;
          const int a = by_off[i], b = by_off[l];
          if (before_by_offset(b, a, len, off) == up) {
            by_off[i] = (unsigned short)b;
            by_off[l] = (unsigned short)a;
          }
          const int c = by_file[i], d = by_file[l];
          if (before_by_file(d, c, len, off, fid) == up) {
            by_file[i] = (unsigned short)d;
            by_file[l] = (unsigned short)c;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < len; t += THREADS) run[base + t] = (int)(base + by_file[t]);
  if (tid < WALKERS) {
    walk_mask(tid, len, s, ns, off, siz, fid, by_off, by_file, out, k);
  } else if (tid < SSD_W_T) {
    out[(Column::XM_1 + tid - WALKERS) * ns + s] = 0.0;
  } else if (tid == SSD_W_T) {
    // add.reduceat: the first request, plus the pairwise sum of the rest
    const double first = wall(siz[0], k);
    out[Column::SSD_W * ns + s] = len > 1 ? __dadd_rn(first, pairwise_walls(siz + 1, len - 1, k))
                                          : first;
  }
  __syncthreads();
}

// Global request index a before b in the shard's (file, offset, arrival) order.
__device__ __forceinline__ bool before_in_shard(int a, int b, const long long* __restrict__ off,
                                                const long long* __restrict__ fid) {
  const long long fa = fid[a], fb = fid[b];
  if (fa != fb) return fa < fb;
  const long long oa = off[a], ob = off[b];
  return oa < ob || (oa == ob && a < b);
}

// Request t of one round: the sorted runs [g * seg, (g + 1) * seg) of src
// merged in pairs into dst.  A request's place is its index in its run
// plus the count of the partner run's requests before it.
__device__ void merge_one(const long long* __restrict__ off, const long long* __restrict__ fid,
                          long long n, long long seg, const int* __restrict__ src,
                          int* __restrict__ dst, long long t) {
  const long long g = t / seg;
  const long long a0 = (g & ~1LL) * seg;
  long long start, other, local;
  if (g & 1) {
    start = a0;
    other = seg;
    local = t - a0 - seg;
  } else {
    start = a0 + seg;
    other = start < n ? (n - start < seg ? n - start : seg) : 0;
    local = t - a0;
  }
  const int me = src[t];
  long long lo = 0, hi = other;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (before_in_shard(src[start + mid], me, off, fid)) lo = mid + 1; else hi = mid;
  }
  dst[a0 + local + lo] = me;
}

// The pair (t - 1, t) of the shard's order: contiguous, and in streams
// 1..XMERGE_D apart, it adds one to the later stream's xm_d.
__device__ void count_merge(const long long* __restrict__ off, const long long* __restrict__ siz,
                            const long long* __restrict__ fid, int L, int ns,
                            const int* __restrict__ order, double* __restrict__ out,
                            long long t) {
  const int a = order[t - 1], b = order[t];
  if (fid[a] != fid[b] || (u64)off[b] != (u64)off[a] + (u64)siz[a]) return;
  const int sa = a / L, sb = b / L;
  const int d = sa > sb ? sa - sb : sb - sa;
  if (d >= 1 && d <= XMERGE_D) {
    atomicAdd(&out[(Column::XM_1 + d - 1) * ns + (sa > sb ? sa : sb)], 1.0);
  }
}

// The whole shard in one cooperative launch: every stream (a block a
// stream, blocks taking the next stream until none is left), then the merge
// rounds and the merge counts over every request (a thread a request,
// threads striding over the rest), a grid barrier between phases.
__global__ void __launch_bounds__(THREADS)
tapes_kernel(const long long* __restrict__ cols, int n, int L, int P, int* __restrict__ runs,
             double* __restrict__ out, Consts k) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int ns = (int)((n + (long long)L - 1) / L);
  for (int s = blockIdx.x; s < ns; s += gridDim.x) {
    stream_columns(cols, n, L, P, s, ns, runs, out, k, smem);
  }
  const long long* off = cols + Col::OFFSETS * (long long)n;
  const long long* siz = cols + Col::SIZES * (long long)n;
  const long long* fid = cols + Col::FILE_IDS * (long long)n;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  int* buf[2] = {runs, runs + n};
  int cur = 0;
  for (long long seg = L; seg < n; seg *= 2) {
    grid.sync();
    for (long long t = first; t < n; t += stride) {
      merge_one(off, fid, n, seg, buf[cur], buf[cur ^ 1], t);
    }
    cur ^= 1;
  }
  grid.sync();
  for (long long t = first + 1; t < n; t += stride) {
    count_merge(off, siz, fid, L, ns, buf[cur], out, t);
  }
}

// Per device: its SM count, and the blocks an SM holds at the shared
// memory last asked for (a call of the same stream length asks again for
// nothing).
struct Fit {
  int sms = 0, smem = -1, blocks = 0;
};

}  // namespace

// cols: (Col::COUNT, n) int64; runs: (2, n) int32 scratch; out:
// (Column::COUNT, ceil(n / L)) float64, written whole.
extern "C" int tapes_launch(const void* cols, int n, int L, void* runs, void* out,
                            double seek_time, double seek_dist_coeff, double seq_bw,
                            double link_bw, double write_bw, void* stream) {
  if (n < 1 || L < 1 || L > MAX_STREAM_LEN) return (int)cudaErrorInvalidValue;
  static Fit fits[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  Fit& fit = fits[dev];
  int P = 1;
  while (P < L) P <<= 1;
  const int smem = P * (3 * (int)sizeof(long long) + 2 * (int)sizeof(unsigned short));
  if (fit.sms == 0) {
    err = cudaDeviceGetAttribute(&fit.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem != fit.smem) {
    err = cudaFuncSetAttribute(tapes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.blocks, tapes_kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    fit.smem = smem;
  }
  if (fit.blocks < 1) return (int)cudaErrorInvalidConfiguration;
  // every block resident at once, as the grid barrier needs
  const long long ns = (n + (long long)L - 1) / L;
  const long long per_thread = (n + (long long)THREADS - 1) / THREADS;
  const long long want = ns > per_thread ? ns : per_thread;
  const long long most = (long long)fit.blocks * fit.sms;
  const int grid = (int)(want < most ? want : most);
  const long long* c = static_cast<const long long*>(cols);
  int* r = static_cast<int*>(runs);
  double* o = static_cast<double*>(out);
  Consts k{seek_time, seek_dist_coeff, seq_bw, link_bw, write_bw};
  void* args[] = {&c, &n, &L, &P, &r, &o, &k};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(tapes_kernel), grid, THREADS,
                                    args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
