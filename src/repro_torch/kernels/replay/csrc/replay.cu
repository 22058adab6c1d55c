// replay.cu — the fleet replay for sm_90a, written by hand: every lane of a
// sweep through its whole event tape, and its final drain, in one launch.
//
// Replaces no Pallas kernel.  It is the reference's XLA program
// src/repro/core/engine_device.py::_replay_program (lax.scan over the
// tape's events of vmap(_event_step), then _final_drain), which the port
// otherwise runs as its plain torch version
// (repro_torch/kernels/replay/ref.py), several hundred small ops an event
// issued from the host.  Same function: for every lane (one node shard
// under one scheme), the first `steps` events of its tape: a stream event
// routes the stream (Eq. 1-3 threshold and Algorithm 1 hysteresis), fills
// SSD regions (swaps, blocks, plain-BB overflow), advances the HDD with
// Eq. 7 interference and accounts flushes per Eq. 6; a gap event drains
// the flush; an invalid (padding) event leaves the lane as it is.  Then the
// drain's ten outputs.  All four schemes, the constant SSD and the FTL
// columns, both flush gates.
//
// Bound on this card.  The bytes are the tape's (73 float64, one int64 and
// two uint8 fields an event: 594 B; the sweep's 128 x 256 events are
// 18.56 MiB, 5.8 us at 3.35 TB/s) and the state's.  What holds the kernel
// is latency: each lane is one chain of dependent float64 operations
// (about two hundred an event, divisions and a log2 among them, and for
// each field of the tape it reads, the latency of the read), and a sweep
// has only 256 lanes.  The longest lane's chain sets the time.  Three
// things lengthened that chain, and the design takes each off it:
//
// 1. The threshold pass, off the chain.  SSDUP+'s threshold (Eq. 2/3: the
//    mean of the pre-insert sorted window, then an entry of the
//    post-insert one) depends only on the tape's stream percentages and
//    the initial window, never on fills, clocks or flushes.  So the lane's
//    warp computes it ahead of the chain, a chunk of C stream events at a
//    time, one event a thread: the chunk's candidates (the W entries of the
//    window at the chunk's start and the chunk's C percentages, each with
//    the events whose windows hold it) are sorted once by a bitonic network
//    in shared memory, and each thread walks them in order, summing the
//    members of its event's window one after another (the order of
//    torch.cumsum over torch.sort, NaN last) and then picking the indexed
//    member of the next window.  The chain keeps only the two one-bit
//    hysteresis updates.  SSDUP's threshold is the static watermark pair,
//    so an SSDUP lane keeps no window at all.
// 2. One lane a block, on every SM.  Each lane has a block of two warps of
//    its own: warp 0 runs the threshold pass, then its thread 0 runs the
//    chain with the lane's state in registers; warp 1 copies the tape.  No
//    warp runs another lane's branches, and the 256 lanes spread over the
//    132 SMs instead of 8.
// 3. The tape in shared memory ahead of the chain.  The packed tape keeps
//    each field of one lane's events contiguous ((F, L, S), S a multiple of
//    16), so warp 1 copies stages of 32 events, one bulk asynchronous copy
//    a field (cp.async.bulk, completing on an mbarrier), into a ring of
//    three stages; the chain reads every field from shared memory instead
//    of L2, and frees a stage for the next copy when it leaves it.
//
// Arithmetic, to equal the plain version on the CPU: the library is built
// with -fmad=false (torch computes each product and sum as its own op);
// max, min and clamp propagate NaN as torch's do (fmax and fmin drop it);
// torch.round is rint (half to even); float-to-integer conversions give
// the x86 result (truncation; INT_MIN for NaN and out of range); every sum
// keeps the plain version's order (the window's prefix in ascending order,
// the 17 hat terms, the 4 merge terms).  A lane whose fill loop passes
// MAX_FILLS iterations in one event (the plain version would never end)
// stops and sets its status, and the wrapper raises.
//
// C interface: replay_launch(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or an error it found in its
// arguments before launching).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int SUFFIX_ANCHORS = 16;
constexpr int N_ANCHORS = SUFFIX_ANCHORS + 1;
constexpr int WINDOW_SCALES = 4;
constexpr int N_WINDOWS = (1 << WINDOW_SCALES) - 1;
constexpr int XMERGE_D = 4;
constexpr int MAX_WINDOW = 1024;
constexpr long long MAX_FILLS = 1LL << 20;
// The packed tape's rows hold a multiple of TAPE_ALIGN events, so that every
// stage copy starts and ends on 16 bytes.
constexpr int TAPE_ALIGN = 16;
constexpr int STAGE_EVENTS = 32;
constexpr int RING_STAGES = 3;
constexpr int WARP = 32;
constexpr int THREADS = 2 * WARP;

// The rows of each packed array, in the order of the tuples of
// repro_torch/kernels/replay/ops.py (the CPU tests parse these).  A member
// named NAME_0 or NAME_1 starts a group of fields that runs to the next.
// The tape arrays are (rows, L, S): row f of lane i's event t at
// (f * L + i) * S + t.
struct TapeF64 { enum : int {
  GAP_SEC, PCT, NET_T, SSD_W, MEAN_SZ,
  HDDT_0,
  PF_0 = HDDT_0 + N_ANCHORS,
  WF_0 = PF_0 + N_ANCHORS,
  WN_0 = WF_0 + N_WINDOWS,
  XM_1 = WN_0 + N_WINDOWS,
  COUNT = XM_1 + XMERGE_D
}; };
struct TapeI64 { enum : int { NBYTES, COUNT }; };
struct TapeU8 { enum : int { VALID, IS_GAP, COUNT }; };
struct LaneF64 { enum : int {
  GATE, FTL_PAGE, FTL_TPP, FTL_TERASE, FTL_PPB, FTL_PHYS, FTL_LOW, FTL_HIGH, COUNT
}; };
struct LaneI64 { enum : int { SCHEME, CAP, FTL_ON, COUNT }; };
struct StateF64 { enum : int {
  CLOCK, GAP, PAUSE, BLOCKED, A_FS,
  XF_1,
  J_LEFT = XF_1 + XMERGE_D,
  J_RATE, FTL_FREE, FTL_LIVE, FTL_RELOC, COUNT
}; };
struct StateI64 { enum : int {
  B_SSD, B_HDD, A_USED, S_USED, PEAK, FLUSHES, WIN_N, WIN_P, J_ALIVE, STATIC_RAND, CUR_SSD,
  COUNT
}; };
struct OutF64 { enum : int {
  IO_SECONDS, TOTAL_SECONDS, FLUSH_PAUSED_SECONDS, BLOCKED_SECONDS, FTL_RELOC_PAGES,
  FTL_LIVE_PAGES, COUNT
}; };
struct OutI64 { enum : int {
  BYTES_TO_SSD, BYTES_TO_HDD_DIRECT, FLUSHES, PEAK_SSD_OCCUPANCY, STATUS, COUNT
}; };

// One ring stage: the float64 rows [F][E], then nbytes [E], then the two
// flag rows [2][E], each row's events contiguous.
enum : int {
  STAGE_I64_AT = TapeF64::COUNT * STAGE_EVENTS * 8,
  STAGE_U8_AT = STAGE_I64_AT + STAGE_EVENTS * 8,
  STAGE_BYTES = STAGE_U8_AT + TapeU8::COUNT * STAGE_EVENTS,
  EVENT_BYTES = TapeF64::COUNT * 8 + 8 + TapeU8::COUNT,
  RING_BYTES = RING_STAGES * STAGE_BYTES
};
static_assert(STAGE_BYTES % 16 == 0 && STAGE_U8_AT % 16 == 0, "stage rows on 16 bytes");
static_assert(STAGE_EVENTS % TAPE_ALIGN == 0, "a stage is whole rows of copies");

// The globals, in the order of ops.GLOBALS.
struct Globals {
  double seek_time, seq_bw, slowdown, flush_frac, default_thr, static_high, static_low;
};

struct Lane {
  int scheme;
  long long cap;
  bool ftl_on;
  double gate, page, tpp, terase, ppb, phys, low, high;
};

struct State {
  double clock, gap, pause, blocked, a_fs, xf[XMERGE_D], j_left, j_rate;
  double ftl_free, ftl_live, ftl_reloc;
  long long b_ssd, b_hdd, a_used, s_used, peak;
  int flushes;
  bool j_alive, static_rand, cur_ssd;
};

// One event's float64 fields in a ring stage: field f at f[f * E].
struct Event {
  const double* f;
  __device__ __forceinline__ double operator()(int field) const {
    return f[field * STAGE_EVENTS];
  }
};

// torch.maximum / torch.minimum: a NaN operand gives NaN.
__device__ __forceinline__ double tmax(double a, double b) {
  return (a != a || b != b) ? a + b : (a < b ? b : a);
}
__device__ __forceinline__ double tmin(double a, double b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
__device__ __forceinline__ double tclamp(double x, double lo, double hi) {
  return tmin(tmax(x, lo), hi);
}
// .to(torch.int64 / torch.int32) as on x86: truncation, INT_MIN for NaN and
// for values out of range.
__device__ __forceinline__ long long to_i64(double x) {
  return (x != x || x >= 9223372036854775808.0 || x < -9223372036854775808.0)
             ? LLONG_MIN : (long long)x;
}
__device__ __forceinline__ int to_i32(double x) {
  return (x != x || x >= 2147483648.0 || x <= -2147483649.0) ? INT_MIN : (int)x;
}
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// -- the threshold pass ---------------------------------------------------

// torch.sort's order as an unsigned key: -inf first, NaN after +inf, and
// PAD_KEY after everything.  Two values with one key are the same value
// (every NaN is one NaN here, which the threshold reads only through
// comparisons), so a sort of keys alone orders values as torch.sort does.
constexpr unsigned long long SIGN = 1ULL << 63;
constexpr unsigned long long NAN_KEY = ~1ULL;
constexpr unsigned long long PAD_KEY = ~0ULL;

__device__ __forceinline__ unsigned long long order_key(double v) {
  if (v != v) return NAN_KEY;
  const unsigned long long u = (unsigned long long)__double_as_longlong(v);
  return (u & SIGN) ? ~u : (u | SIGN);
}
__device__ __forceinline__ double key_value(unsigned long long k) {
  return __longlong_as_double((long long)((k & SIGN) ? (k & ~SIGN) : ~k));
}

// A value that some windows of the chunk hold: the windows (pre-insert, of
// the chunk's events first..last, counted from the chunk's start) it is in.
struct Cand {
  unsigned long long key;
  int first, last;
};

// The candidates of a chunk: a power of two P >= W + 32 entries, at least
// 64, so a chunk takes C = P - W >= 32 events (one a thread or more).
__host__ __device__ __forceinline__ int candidates(int W) {
  int p = 64;
  while (p < W + WARP) p <<= 1;
  return p;
}

// Sorts the P keys of `cand` ascending with the warp (a bitonic network).
__device__ void warp_sort(Cand* cand, int P, int lane) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = lane; x < P / 2; x += WARP) {
        const int lo = ((x & ~(j - 1)) << 1) | (x & (j - 1));
        const int hi = lo + j;
        const Cand a = cand[lo], b = cand[hi];
        if ((a.key > b.key) == ((lo & k) == 0)) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

// The pass's state between chunks (every thread of warp 0 holds a copy).
struct Window {
  double* win;   // [W]: slot s of the window at the next chunk's start
  double* pct;   // [C]: the chunk's stream percentages
  double* thr;   // [C]: the chunk's thresholds
  Cand* cand;    // [P]
  int W, C, P;
  int n0;        // entries in the window before the chunk's first event
  int p0;        // the slot the chunk's first event overwrites
  int row;       // the first tape row the next chunk scans
};

// The SSDUP+ thresholds of the next (up to) C stream events of lane i, in
// thr[0..n): ref._observe_and_route's adap_thr, event by event.  Returns n
// (0 when the tape has no stream event left).  Whole warp.
__device__ int threshold_chunk(Window& w, const Globals& g, const double* __restrict__ tape_f64,
                               const unsigned char* __restrict__ tape_u8, int S, int L, int i,
                               int steps, int lane) {
  const long long valid_at = ((long long)TapeU8::VALID * L + i) * S;
  const long long gap_at = ((long long)TapeU8::IS_GAP * L + i) * S;
  const long long pct_at = ((long long)TapeF64::PCT * L + i) * S;
  // gather the chunk's percentages: the stream events, in row order
  int n = 0;
  while (n < w.C && w.row < steps) {
    const int r = w.row + lane;
    const bool stream = r < steps && tape_u8[valid_at + r] && !tape_u8[gap_at + r];
    const unsigned found = __ballot_sync(0xffffffffu, stream);
    const int rank = __popc(found & ((1u << lane) - 1u));
    const bool take = stream && n + rank < w.C;
    if (take) w.pct[n + rank] = tape_f64[pct_at + r];
    const unsigned taken = __ballot_sync(0xffffffffu, take);
    n += __popc(taken);
    w.row += taken != found ? WARP - __clz(taken) : WARP;
  }
  __syncwarp();
  // the candidates: the window's slots (slot s is overwritten by the
  // chunk's event (s - p0) mod W), the chunk's percentages (event c's is in
  // the windows of events c + 1 .. c + W), then pads
  for (int x = lane; x < w.P; x += WARP) {
    Cand cd;
    if (x < w.W) {
      cd = {order_key(w.win[x]), 0, (x - w.p0 + w.W) % w.W};
    } else if (x - w.W < n) {
      const int c = x - w.W;
      cd = {order_key(w.pct[c]), c + 1, c + w.W};
    } else {
      cd = {PAD_KEY, INT_MAX, -1};
    }
    w.cand[x] = cd;
  }
  __syncwarp();
  // the window at the next chunk's start: each slot keeps its last write
  for (int c = lane; c < n; c += WARP) {
    if (c + w.W >= n) w.win[(w.p0 + c) % w.W] = w.pct[c];
  }
  warp_sort(w.cand, w.P, lane);
  // one event a thread: the mean of its pre-insert window (Eq. 2/3, summed
  // in ascending order), then the entry it indexes in the post-insert one
  for (int c = lane; c < n; c += WARP) {
    const int have = min(w.n0 + c, w.W);
    double thr = g.default_thr;
    if (have > 0) {
      double sum = 0.0;
      for (int x = 0, cnt = 0; cnt < have; ++x) {
        const Cand e = w.cand[x];
        if (e.first <= c && c <= e.last) {
          sum = sum + key_value(e.key);
          ++cnt;
        }
      }
      const double avg = sum / (double)have;
      const int n2 = min(have + 1, w.W);
      const int idx = min(max(to_i32(floor((1.0 - avg) * (double)n2)), 0), n2 - 1);
      for (int x = 0, cnt = 0;; ++x) {
        const Cand e = w.cand[x];
        if (e.first <= c + 1 && c + 1 <= e.last) {
          if (cnt == idx) {
            thr = key_value(e.key);
            break;
          }
          ++cnt;
        }
      }
    }
    w.thr[c] = thr;
  }
  __syncwarp();
  w.n0 = min(w.n0 + n, w.W);
  w.p0 = (w.p0 + n) % w.W;
  return n;
}

// -- the chain ---------------------------------------------------------------

// Algorithm 1: the device serving this stream and whether the gate lets
// the flusher run; SSDUP's static watermarks and the routing state move on
// for the two-region schemes (SSDUP+'s threshold `thr` from the pass).
__device__ __forceinline__ void route(const Globals& g, const Lane& c, State& st, double pct,
                                      double thr, bool& dev_ssd, bool& allowed) {
  const bool is_ofs = c.scheme == 0, is_bb = c.scheme == 1, is_plus = c.scheme == 3;
  dev_ssd = is_bb || (!is_ofs && st.cur_ssd);
  allowed = !is_plus || (c.gate < 0.0 ? dev_ssd : pct >= c.gate);
  if (c.scheme == 2) {
    const bool sr2 = pct > g.static_high || (!(pct < g.static_low) && st.static_rand);
    thr = sr2 ? g.static_low : g.static_high;
    st.static_rand = sr2;
  } else if (!is_plus) {
    return;
  }
  st.cur_ssd = pct > thr || (!(pct < thr) && st.cur_ssd);
}

// One region fill (ref._fill_body) of a lane still filling.
__device__ __forceinline__ void fill_once(const Globals& g, const Lane& c, const Event& ev,
                                          long long nbytes, bool allowed, State& st,
                                          long long& rem, bool& ovf, double& cur_xf) {
  using T = TapeF64;
  const bool is_bb = c.scheme == 1;
  const bool is_tworeg = c.scheme == 2 || c.scheme == 3;
  const double nb_f = (double)(nbytes > 1 ? nbytes : 1);
  const double mean_sz = ev(T::MEAN_SZ);
  const double margin = tmax(mean_sz, (double)floor_div(c.cap, 256));

  const bool bb_ovf = is_bb && st.j_alive;  // BB drains: the whole rest overflows
  const long long room = c.cap - st.a_used;
  const double room_f = (double)room;
  const double m = tmax(mean_sz, 1.0);
  const double kreq = floor((room_f - margin) / m) + 1.0;
  const long long bb_cap = to_i64(ceil(tmax(kreq, 0.0) * m));
  const long long tr_cap = to_i64(floor(room_f / m) * m);
  const long long fill_cap = is_bb ? min(room, bb_cap) : tr_cap;
  const long long fill = bb_ovf ? 0 : min(rem, fill_cap);
  const double frac = (double)fill / nb_f;
  // the storage model's time of this fill
  double segw, free1 = 0.0, live1 = 0.0, reloc = 0.0;
  bool gc_on = false;
  if (c.ftl_on) {
    const double pages = (double)fill / c.page;
    free1 = st.ftl_free - pages;
    live1 = st.ftl_live + pages;
    gc_on = fill > 0 && free1 < c.low;
    const double u = tclamp(live1 / tmax(c.phys - free1, 1.0), 0.0, 0.97);
    const double need = tmax(c.high - free1, 0.0);
    const double nblk = need / tmax(c.ppb * (1.0 - u), 1.0);
    reloc = nblk * c.ppb * u;
    const double gc_t = reloc * c.tpp + nblk * c.terase;
    const double seg_dev = pages * c.tpp + (gc_on ? gc_t : 0.0);
    segw = tmax(ev(T::NET_T) * frac, seg_dev);
  } else {
    segw = ev(T::SSD_W) * frac;
  }

  // the flush drains at its full Eq. 6 rate while the foreground fills
  const bool progressing = st.j_alive && allowed;
  const double prog = st.j_rate * segw;
  const bool completed = progressing && prog >= st.j_left;
  long long trim_b = completed ? st.s_used : 0;
  st.j_left = completed ? 0.0 : (progressing ? st.j_left - prog : st.j_left);
  st.pause = st.pause + ((st.j_alive && !allowed) ? segw : 0.0);
  st.flushes += completed;
  if (completed) st.s_used = 0;
  st.j_alive = st.j_alive && !completed;
  st.clock = st.clock + segw;
  st.a_used += fill;

  // Eq. 6 seeks against the dyadic window anchors of the nearest scale
  const double a0 = (nb_f - (double)rem) / nb_f;
  const double wfrac = (double)fill / nb_f;
  const double a1 = a0 + wfrac;
  const int scale = to_i32(tclamp(rint(-log2(tmax(wfrac, 1e-9))), 0.0,
                                  (double)(WINDOW_SCALES - 1)));
  double seg_fs = 0.0;
  int col = 0;
  for (int s = 0; s < WINDOW_SCALES; ++s) {
    const int nw = 1 << s;
    if (s == scale) {
      double acc = 0.0;
      for (int wj = 0; wj < nw; ++wj) {
        const double lo = (double)wj / (double)nw;
        const double cov = tclamp((tmin(a1, lo + 1.0 / (double)nw) - tmax(a0, lo)) * (double)nw,
                                  0.0, 1.0);
        const double wfv = ev(T::WF_0 + col + wj), wnv = ev(T::WN_0 + col + wj);
        acc = acc + (cov > 0.0 ? wnv + (wfv - wnv) * cov : 0.0);
      }
      seg_fs = acc;
    }
    col += nw;
  }
  // prefix-aligned fills: the exact anchors at the request quantiles
  const double ppos = tclamp(a1 * (double)SUFFIX_ANCHORS, 0.0, (double)SUFFIX_ANCHORS);
  const int pj = to_i32(tclamp(floor(ppos), 0.0, (double)(SUFFIX_ANCHORS - 1)));
  const double plam = ppos - (double)pj;
  double pref_fs = 0.0;
  if (pj >= 0 && pj < SUFFIX_ANCHORS)
    pref_fs = (1.0 - plam) * ev(T::PF_0 + pj) + plam * ev(T::PF_0 + pj + 1);
  if (a0 <= 0.0) seg_fs = pref_fs;
  if (!(fill > 0)) seg_fs = 0.0;
  // cross-stream merges with predecessors still in the active region
  double xsum = ev(T::XM_1) * st.xf[0];
  for (int d = 1; d < XMERGE_D; ++d) xsum = xsum + ev(T::XM_1 + d) * st.xf[d];
  const double seg_xm = wfrac * xsum;
  st.a_fs = tmax(st.a_fs + seg_fs - seg_xm, 0.0);
  st.b_ssd += fill;
  rem -= fill;

  // plain BB's eager trigger; a two-region swap, blocked by a live flush
  const bool bb_trig = is_bb && !bb_ovf && (double)(room - fill) < margin;
  const bool swap = is_tworeg && rem > 0;
  const bool do_block = swap && st.j_alive;
  const double dtb = do_block ? st.j_left / st.j_rate : 0.0;
  st.clock = st.clock + dtb;
  st.blocked = st.blocked + dtb;
  st.flushes += do_block;
  st.j_alive = st.j_alive && !do_block;
  if (do_block) st.j_left = 0.0;
  trim_b = trim_b + (do_block ? st.s_used : 0);
  if (do_block) st.s_used = 0;

  // schedule the filled region's flush at its Eq. 6 rate
  const bool sched = swap || bb_trig;
  const long long jb = st.a_used;
  const double jb_f = (double)jb;
  const double service = st.a_fs * g.seek_time + jb_f / g.seq_bw;
  const double n_rate = jb > 0 ? jb_f / service : g.seq_bw;
  if (sched) {
    st.j_rate = n_rate;
    st.j_left = jb_f;
    st.j_alive = true;
    st.s_used = jb;
    st.a_used = 0;
    st.a_fs = 0.0;
    for (int d = 0; d < XMERGE_D; ++d) st.xf[d] = 0.0;
    cur_xf = 0.0;
  } else {
    cur_xf = cur_xf + wfrac;
  }
  ovf = ovf || bb_ovf || (bb_trig && rem > 0);
  const double trim_p = (double)trim_b / c.page;
  if (c.ftl_on) {
    st.ftl_free = gc_on ? c.high : free1;
    st.ftl_live = live1 - trim_p;
  }
  st.ftl_reloc = st.ftl_reloc + (gc_on ? reloc : 0.0);
}

// Foreground HDD write of hdd_b bytes with Eq. 7 interference
// (ref._hdd_advance).
__device__ __forceinline__ void hdd_advance(const Globals& g, const Lane& c, State& st,
                                            long long hdd_b, long long nbytes, const Event& ev,
                                            bool allowed) {
  using T = TapeF64;
  const double nb_f = (double)(nbytes > 1 ? nbytes : 1);
  const double frac = (double)hdd_b / nb_f;
  const double pos = (1.0 - frac) * (double)SUFFIX_ANCHORS;
  double dt = 0.0;
  for (int j = 0; j < N_ANCHORS; ++j) {
    const double w = tmax(1.0 - fabs(pos - (double)j), 0.0);
    dt = dt + w * ev(T::HDDT_0 + j);
  }
  const double net = ev(T::NET_T) * frac;
  const bool run = hdd_b > 0;
  const bool flushing = st.j_alive;
  const bool adv = flushing && allowed;
  const double wall_alone = tmax(net, dt);
  const double wall_shared = tmax(net, dt * g.slowdown);
  const double wall = adv ? wall_shared : wall_alone;
  const double prog = st.j_rate * g.flush_frac * wall;
  const bool completed = run && adv && prog >= st.j_left;
  st.j_left = completed ? 0.0 : ((run && adv) ? st.j_left - prog : st.j_left);
  const double trim_p = (double)(completed ? st.s_used : 0) / c.page;
  st.clock = st.clock + (run ? wall : 0.0);
  st.pause = st.pause + ((run && flushing && !adv) ? wall_alone : 0.0);
  st.b_hdd = st.b_hdd + hdd_b;
  st.flushes += completed;
  if (completed) st.s_used = 0;
  st.j_alive = st.j_alive && !completed;
  if (c.ftl_on) st.ftl_live = st.ftl_live - trim_p;
}

// One stream event (ref._stream_step); returns nonzero if the fill loop
// passed MAX_FILLS.
__device__ __forceinline__ int stream_step(const Globals& g, const Lane& c, State& st,
                                           const Event& ev, long long nbytes, double thr) {
  bool dev_ssd, allowed;
  route(g, c, st, ev(TapeF64::PCT), thr, dev_ssd, allowed);
  long long rem = (dev_ssd && c.cap > 0) ? nbytes : 0;
  bool ovf = false;
  double cur_xf = 0.0;
  long long fills = 0;
  while (rem > 0 && !ovf) {
    if (++fills > MAX_FILLS) return 1;
    fill_once(g, c, ev, nbytes, allowed, st, rem, ovf, cur_xf);
  }
  // the whole stream when HDD-routed, plain BB's overflow suffix
  const long long hdd_b = dev_ssd ? (ovf ? rem : 0) : nbytes;
  hdd_advance(g, c, st, hdd_b, nbytes, ev, allowed);
  // shift the merge partners one stream (an HDD-routed stream enters as 0)
  for (int d = XMERGE_D - 1; d > 0; --d) st.xf[d] = st.xf[d - 1];
  st.xf[0] = cur_xf;
  // occupancy at the end of the stream, after the overflow's HDD writes
  if (dev_ssd) st.peak = max(st.peak, st.a_used + st.s_used);
  return 0;
}

// A compute gap: the flusher has the HDD to itself (ref._gap_step).
__device__ __forceinline__ void gap_step(const Lane& c, State& st, double sec) {
  const double need = st.j_left / st.j_rate;
  const bool full = st.j_alive && need <= sec;
  const bool partial = st.j_alive && !full;
  st.j_left = full ? 0.0 : (partial ? st.j_left - st.j_rate * sec : st.j_left);
  const double trim_p = (double)(full ? st.s_used : 0) / c.page;
  st.clock = st.clock + sec;
  st.gap = st.gap + sec;
  st.flushes += full;
  if (full) st.s_used = 0;
  st.j_alive = st.j_alive && !full;
  if (c.ftl_on) st.ftl_live = st.ftl_live - trim_p;
}

// -- the ring of tape stages ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool bar_done(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity to complete, or (when `stop`
// is given) for *stop to be set; returns false on the latter.  A wait of
// more than about 10 s (a lost copy or arrival) traps, so a fault ends the
// launch with an error instead of hanging the card.
__device__ bool bar_wait(uint64_t* bar, int parity, const volatile int* stop = nullptr) {
  long long start = 0;
  while (!bar_done(bar, parity)) {
    if (stop != nullptr && *stop) return false;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
  return true;
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Warp 1: copies stage q (events q * E ..) of lane i into ring slot q % R,
// once the chain has left the stage that slot held, until every stage up to
// `steps` is copied or the chain stops; then waits for its copies to land,
// so none is in flight when the block ends.
__device__ void copy_tape(unsigned char* ring, uint64_t* full, uint64_t* empty,
                          const volatile int* stop, const double* tape_f64,
                          const long long* tape_i64, const unsigned char* tape_u8, int S, int L,
                          int i, int steps, int lane) {
  const int stages = (steps + STAGE_EVENTS - 1) / STAGE_EVENTS;
  int issued = 0;
  for (int q = 0; q < stages; ++q) {
    const int slot = q % RING_STAGES;
    int go = 1;
    if (lane == 0 && q >= RING_STAGES) go = bar_wait(&empty[slot], (q / RING_STAGES - 1) & 1, stop);
    if (!__shfl_sync(0xffffffffu, go, 0)) break;
    const int t0 = q * STAGE_EVENTS;
    const int n = min(STAGE_EVENTS, S - t0);  // a multiple of TAPE_ALIGN
    unsigned char* stage = ring + slot * STAGE_BYTES;
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(smem_u32(&full[slot])), "r"(n * EVENT_BYTES) : "memory");
    }
    __syncwarp();
    for (int row = lane; row < TapeF64::COUNT + TapeI64::COUNT + TapeU8::COUNT; row += WARP) {
      const void* src;
      unsigned char* dst;
      uint32_t bytes;
      if (row < TapeF64::COUNT) {
        src = tape_f64 + ((long long)row * L + i) * S + t0;
        dst = stage + row * STAGE_EVENTS * 8;
        bytes = n * 8;
      } else if (row == TapeF64::COUNT) {
        src = tape_i64 + (long long)i * S + t0;
        dst = stage + STAGE_I64_AT;
        bytes = n * 8;
      } else {
        const int f = row - TapeF64::COUNT - TapeI64::COUNT;
        src = tape_u8 + ((long long)f * L + i) * S + t0;
        dst = stage + STAGE_U8_AT + f * STAGE_EVENTS;
        bytes = n;
      }
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(&full[slot]))
          : "memory");
    }
    issued = q + 1;
  }
  if (lane == 0) {
    for (int q = max(issued - RING_STAGES, 0); q < issued; ++q)
      bar_wait(&full[q % RING_STAGES], (q / RING_STAGES) & 1);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
replay_kernel(const double* __restrict__ tape_f64, const long long* __restrict__ tape_i64,
              const unsigned char* __restrict__ tape_u8, const double* __restrict__ lane_f64,
              const long long* __restrict__ lane_i64, const double* __restrict__ state_f64,
              const long long* __restrict__ state_i64, const double* __restrict__ win0,
              double* __restrict__ out_f64, long long* __restrict__ out_i64, Globals g, int S,
              int L, int W, int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[RING_STAGES], empty[RING_STAGES];
  __shared__ int stop;
  const int i = blockIdx.x;
  const int lane = threadIdx.x % WARP;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&empty[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    stop = 0;
  }
  __syncthreads();
  unsigned char* ring = smem;
  if (threadIdx.x >= WARP) {
    copy_tape(ring, full, empty, &stop, tape_f64, tape_i64, tape_u8, S, L, i, steps, lane);
    return;
  }

  Lane c;
  c.scheme = (int)lane_i64[LaneI64::SCHEME * L + i];
  c.cap = lane_i64[LaneI64::CAP * L + i];
  c.ftl_on = lane_i64[LaneI64::FTL_ON * L + i] != 0;
  c.gate = lane_f64[LaneF64::GATE * L + i];
  c.page = lane_f64[LaneF64::FTL_PAGE * L + i];
  c.tpp = lane_f64[LaneF64::FTL_TPP * L + i];
  c.terase = lane_f64[LaneF64::FTL_TERASE * L + i];
  c.ppb = lane_f64[LaneF64::FTL_PPB * L + i];
  c.phys = lane_f64[LaneF64::FTL_PHYS * L + i];
  c.low = lane_f64[LaneF64::FTL_LOW * L + i];
  c.high = lane_f64[LaneF64::FTL_HIGH * L + i];
  State st;
  st.clock = state_f64[StateF64::CLOCK * L + i];
  st.gap = state_f64[StateF64::GAP * L + i];
  st.pause = state_f64[StateF64::PAUSE * L + i];
  st.blocked = state_f64[StateF64::BLOCKED * L + i];
  st.a_fs = state_f64[StateF64::A_FS * L + i];
  for (int d = 0; d < XMERGE_D; ++d) st.xf[d] = state_f64[(StateF64::XF_1 + d) * L + i];
  st.j_left = state_f64[StateF64::J_LEFT * L + i];
  st.j_rate = state_f64[StateF64::J_RATE * L + i];
  st.ftl_free = state_f64[StateF64::FTL_FREE * L + i];
  st.ftl_live = state_f64[StateF64::FTL_LIVE * L + i];
  st.ftl_reloc = state_f64[StateF64::FTL_RELOC * L + i];
  st.b_ssd = state_i64[StateI64::B_SSD * L + i];
  st.b_hdd = state_i64[StateI64::B_HDD * L + i];
  st.a_used = state_i64[StateI64::A_USED * L + i];
  st.s_used = state_i64[StateI64::S_USED * L + i];
  st.peak = state_i64[StateI64::PEAK * L + i];
  st.flushes = (int)state_i64[StateI64::FLUSHES * L + i];
  st.j_alive = state_i64[StateI64::J_ALIVE * L + i] != 0;
  st.static_rand = state_i64[StateI64::STATIC_RAND * L + i] != 0;
  st.cur_ssd = state_i64[StateI64::CUR_SSD * L + i] != 0;

  // SSDUP+'s window, in shared memory past the ring
  const bool plus = c.scheme == 3;
  Window w;
  w.W = W;
  w.P = candidates(W);
  w.C = w.P - W;
  w.cand = reinterpret_cast<Cand*>(smem + RING_BYTES);
  w.win = reinterpret_cast<double*>(w.cand + w.P);
  w.pct = w.win + W;
  w.thr = w.pct + w.C;
  w.n0 = (int)state_i64[StateI64::WIN_N * L + i];
  w.p0 = (int)state_i64[StateI64::WIN_P * L + i];
  w.row = 0;
  if (plus) {
    for (int s = lane; s < W; s += WARP) w.win[s] = win0[(long long)i * W + s];
    __syncwarp();
  }

  // chunks of the threshold pass, each followed by the chain up to the
  // first stream event whose threshold the chunk did not compute
  int t = 0, status = 0;
  while (true) {
    const int n = plus ? threshold_chunk(w, g, tape_f64, tape_u8, S, L, i, steps, lane) : INT_MAX;
    int done = 1;
    if (lane == 0) {
      int k = 0;  // the chunk's stream events stepped
      for (; t < steps; ++t) {
        const int q = t / STAGE_EVENTS, e = t % STAGE_EVENTS, slot = q % RING_STAGES;
        const unsigned char* stage = ring + slot * STAGE_BYTES;
        if (e == 0) bar_wait(&full[slot], (q / RING_STAGES) & 1);
        const unsigned char* flags = stage + STAGE_U8_AT;
        if (flags[TapeU8::VALID * STAGE_EVENTS + e]) {
          if (flags[TapeU8::IS_GAP * STAGE_EVENTS + e]) {
            gap_step(c, st, reinterpret_cast<const double*>(stage)[TapeF64::GAP_SEC * STAGE_EVENTS + e]);
          } else {
            if (k == n) {  // the next chunk's thresholds first
              done = 0;
              break;
            }
            const double thr = plus ? w.thr[k] : 0.0;
            ++k;
            status = stream_step(
                g, c, st, Event{reinterpret_cast<const double*>(stage) + e},
                reinterpret_cast<const long long*>(stage + STAGE_I64_AT)[e], thr);
            if (status) break;
          }
        }
        if (e == STAGE_EVENTS - 1) bar_arrive(&empty[slot]);
      }
      if (done) *(volatile int*)&stop = 1;
    }
    if (__shfl_sync(0xffffffffu, done, 0)) break;
  }
  if (lane != 0) return;

  // the final drain: the in-flight job, then the active region (Eq. 6)
  const double d1 = st.j_alive ? st.j_left / st.j_rate : 0.0;
  const bool has_active = st.a_used > 0;
  const double d2 = has_active ? st.a_fs * g.seek_time + (double)st.a_used / g.seq_bw : 0.0;
  out_f64[OutF64::IO_SECONDS * L + i] = st.clock - st.gap;
  out_f64[OutF64::TOTAL_SECONDS * L + i] = st.clock + d1 + d2;
  out_f64[OutF64::FLUSH_PAUSED_SECONDS * L + i] = st.pause;
  out_f64[OutF64::BLOCKED_SECONDS * L + i] = st.blocked;
  out_f64[OutF64::FTL_RELOC_PAGES * L + i] = st.ftl_reloc;
  out_f64[OutF64::FTL_LIVE_PAGES * L + i] = st.ftl_live;
  out_i64[OutI64::BYTES_TO_SSD * L + i] = st.b_ssd;
  out_i64[OutI64::BYTES_TO_HDD_DIRECT * L + i] = st.b_hdd;
  out_i64[OutI64::FLUSHES * L + i] = st.flushes + (int)st.j_alive + (int)has_active;
  out_i64[OutI64::PEAK_SSD_OCCUPANCY * L + i] = st.peak;
  out_i64[OutI64::STATUS * L + i] = status;
}

}  // namespace

extern "C" int replay_launch(const void* tape_f64, const void* tape_i64, const void* tape_u8,
                             const void* lane_f64, const void* lane_i64, const void* state_f64,
                             const void* state_i64, const void* win0, void* out_f64,
                             void* out_i64, double seek_time, double seq_bw, double slowdown,
                             double flush_frac, double default_thr, double static_high,
                             double static_low, int S, int L, int W, int steps, void* stream) {
  if (L < 1 || W < 1 || W > MAX_WINDOW || steps < 0 || steps > S || S % TAPE_ALIGN != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)tape_f64 | (uintptr_t)tape_i64 | (uintptr_t)tape_u8) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const Globals g{seek_time, seq_bw, slowdown, flush_frac, default_thr, static_high,
                  static_low};
  const int P = candidates(W);
  const int smem = RING_BYTES + P * (int)sizeof(Cand) + (W + 2 * (P - W)) * 8;
  cudaError_t err = cudaFuncSetAttribute(replay_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  replay_kernel<<<L, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tape_f64), static_cast<const long long*>(tape_i64),
      static_cast<const unsigned char*>(tape_u8), static_cast<const double*>(lane_f64),
      static_cast<const long long*>(lane_i64), static_cast<const double*>(state_f64),
      static_cast<const long long*>(state_i64), static_cast<const double*>(win0),
      static_cast<double*>(out_f64), static_cast<long long*>(out_i64), g, S, L, W, steps);
  return (int)cudaGetLastError();
}
