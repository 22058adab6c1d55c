// replay.cu — the fleet replay for sm_90a, written by hand: every lane of a
// sweep through its whole event tape, and its final drain, in one launch.
//
// Replaces no Pallas kernel.  It is the reference's XLA program
// src/repro/core/engine_device.py::_replay_program (lax.scan over the
// tape's events of vmap(_event_step), then _final_drain), which the port
// otherwise runs as its plain torch version
// (repro_torch/kernels/replay/ref.py), several hundred small ops an event
// issued from the host.  Same function: for every lane (one node shard
// under one scheme), the first `steps` events of its column of the stacked
// (S, L) tape: a stream event routes the stream (Eq. 1-3 threshold and
// Algorithm 1 hysteresis), fills SSD regions (swaps, blocks, plain-BB
// overflow), advances the HDD with Eq. 7 interference and accounts flushes
// per Eq. 6; a gap event drains the flush; an invalid (padding) event
// leaves the lane as it is.  Then the drain's ten outputs.  All four
// schemes, the constant SSD and the FTL columns, both flush gates.
//
// Bound on this card.  The bytes are the tape's (73 float64, one int64 and
// two uint8 fields an event: 594 B; the sweep's 128 x 256 events are
// 18.56 MiB, 5.8 us at 3.35 TB/s) and the state's.  What holds the kernel
// is latency: each lane is one chain of dependent float64 operations
// (about a thousand an event, divisions and a log2 among them, and a
// threshold scheme's pass over its sorted window), and a sweep has only
// 256 lanes, 8 warps for 132 SMs.  The longest lane's chain sets the time.
//
// Design.  One thread a lane, all of its state in registers; 32 lanes a
// block, so the sweep's 8 warps sit on 8 SMs, and a warp's lanes are one
// scheme (the lanes are scheme-major), so they seldom diverge.  The tape is
// field-major (F, S, L): a warp's 32 loads of one field are one 256-byte
// transaction.  Where the plain version computes both sides of a select
// for every lane, the kernel branches: a gap or a stream, the FTL or the
// constant SSD, one dyadic scale of the Eq. 6 window anchors and one prefix
// anchor pair instead of all of them.  The region-fill loop runs per lane
// (`while rem > 0 && !ovf`), as the plain version's masked loop leaves
// finished lanes unchanged.  The adaptive window keeps a sorted copy,
// updated in place (the slot the write position overwrites is taken out,
// the new percentage put in), instead of two sorts an event; both copies
// live in scratch laid out (W, L) that the wrapper allocates.
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
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int SUFFIX_ANCHORS = 16;
constexpr int N_ANCHORS = SUFFIX_ANCHORS + 1;
constexpr int WINDOW_SCALES = 4;
constexpr int N_WINDOWS = (1 << WINDOW_SCALES) - 1;
constexpr int XMERGE_D = 4;
constexpr int MAX_WINDOW = 1024;
constexpr long long MAX_FILLS = 1LL << 20;
constexpr int LANES_PER_BLOCK = 32;

// The rows of each packed array, in the order of the tuples of
// repro_torch/kernels/replay/ops.py (the CPU tests parse these).  A member
// named NAME_0 or NAME_1 starts a group of fields that runs to the next.
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
  int flushes, win_n, win_p;
  bool j_alive, static_rand, cur_ssd;
};

// One event's float64 fields: field f of this lane's event at f[f * sl].
struct Event {
  const double* f;
  long long sl;
  __device__ __forceinline__ double operator()(int field) const { return __ldg(f + field * sl); }
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
// torch.sort's order: NaN after everything else.
__device__ __forceinline__ bool before(double a, double b) {
  return a < b || (a == a && b != b);
}
__device__ __forceinline__ bool same(double a, double b) {
  return a == b || (a != a && b != b);
}

// Threshold observe and Algorithm 1 hysteresis (ref._observe_and_route):
// the device serving this stream and whether the gate lets the flusher
// run; the window, watermark and routing state move on for the two-region
// schemes.  wv and sv are the lane's circular and sorted window, element k
// at [k * L].
__device__ __forceinline__ void observe(const Globals& g, const Lane& c, State& st, double pct,
                                        double* wv, double* sv, int L, int W,
                                        bool& dev_ssd, bool& allowed) {
  const bool is_ofs = c.scheme == 0, is_bb = c.scheme == 1, is_plus = c.scheme == 3;
  dev_ssd = is_bb || (!is_ofs && st.cur_ssd);
  allowed = !is_plus || (c.gate < 0.0 ? dev_ssd : pct >= c.gate);
  if (!(c.scheme == 2 || is_plus)) return;
  // Eq. 2/3: the mean of the pre-insert window, summed in ascending order
  const bool have = st.win_n > 0;
  double avg = 0.0;
  if (have && is_plus) {
    double sum = 0.0;
    for (int k = 0; k < st.win_n; ++k) sum = sum + sv[k * L];
    avg = sum / (double)st.win_n;
  }
  // insert over the oldest entry: take the overwritten value out of the
  // sorted copy and slide the hole to the new value's place
  const double old = wv[st.win_p * L];
  wv[st.win_p * L] = pct;
  int k = 0;
  while (k < W - 1 && !same(sv[k * L], old)) ++k;
  while (k + 1 < W && before(sv[(k + 1) * L], pct)) {
    sv[k * L] = sv[(k + 1) * L];
    ++k;
  }
  while (k > 0 && before(pct, sv[(k - 1) * L])) {
    sv[k * L] = sv[(k - 1) * L];
    --k;
  }
  sv[k * L] = pct;
  const int n2 = min(st.win_n + 1, W);
  // SSDUP's static watermarks; SSDUP+ picks from the post-insert window
  const bool sr2 = pct > g.static_high || (!(pct < g.static_low) && st.static_rand);
  double thr = sr2 ? g.static_low : g.static_high;
  if (is_plus) {
    thr = g.default_thr;
    if (have) {
      const int idx = min(max(to_i32(floor((1.0 - avg) * (double)n2)), 0), n2 - 1);
      thr = sv[idx * L];
    }
  }
  st.cur_ssd = pct > thr || (!(pct < thr) && st.cur_ssd);
  st.static_rand = sr2;
  st.win_n = n2;
  st.win_p = (st.win_p + 1) % W;
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
                                           const Event& ev, long long nbytes, double* wv,
                                           double* sv, int L, int W) {
  bool dev_ssd, allowed;
  observe(g, c, st, ev(TapeF64::PCT), wv, sv, L, W, dev_ssd, allowed);
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

__global__ void __launch_bounds__(LANES_PER_BLOCK)
replay_kernel(const double* __restrict__ tape_f64, const long long* __restrict__ tape_i64,
              const unsigned char* __restrict__ tape_u8, const double* __restrict__ lane_f64,
              const long long* __restrict__ lane_i64, const double* __restrict__ state_f64,
              const long long* __restrict__ state_i64, const double* __restrict__ win0,
              double* __restrict__ win, double* __restrict__ srt, double* __restrict__ out_f64,
              long long* __restrict__ out_i64, Globals g, int S, int L, int W, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
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
  st.win_n = (int)state_i64[StateI64::WIN_N * L + i];
  st.win_p = (int)state_i64[StateI64::WIN_P * L + i];
  st.j_alive = state_i64[StateI64::J_ALIVE * L + i] != 0;
  st.static_rand = state_i64[StateI64::STATIC_RAND * L + i] != 0;
  st.cur_ssd = state_i64[StateI64::CUR_SSD * L + i] != 0;

  // the window and its sorted copy (insertion sort), element k at [k * L]
  double* wv = win + i;
  double* sv = srt + i;
  for (int k = 0; k < W; ++k) {
    const double v = win0[(long long)i * W + k];
    wv[k * L] = v;
    int j = k;
    while (j > 0 && before(v, sv[(j - 1) * L])) {
      sv[j * L] = sv[(j - 1) * L];
      --j;
    }
    sv[j * L] = v;
  }

  const long long sl = (long long)S * L;
  int status = 0;
  for (int t = 0; t < steps && !status; ++t) {
    const long long e = (long long)t * L + i;
    if (!tape_u8[TapeU8::VALID * sl + e]) continue;  // padding: no change
    if (tape_u8[TapeU8::IS_GAP * sl + e]) {
      gap_step(c, st, __ldg(tape_f64 + TapeF64::GAP_SEC * sl + e));
    } else {
      status = stream_step(g, c, st, Event{tape_f64 + e, sl},
                           tape_i64[TapeI64::NBYTES * sl + e], wv, sv, L, W);
    }
  }

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
                             const void* state_i64, const void* win0, void* win, void* srt,
                             void* out_f64, void* out_i64, double seek_time, double seq_bw,
                             double slowdown, double flush_frac, double default_thr,
                             double static_high, double static_low, int S, int L, int W,
                             int steps, void* stream) {
  if (L < 1 || W < 1 || W > MAX_WINDOW || steps < 0 || steps > S) {
    return (int)cudaErrorInvalidValue;
  }
  const Globals g{seek_time, seq_bw, slowdown, flush_frac, default_thr, static_high,
                  static_low};
  const int blocks = (L + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  replay_kernel<<<blocks, LANES_PER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tape_f64), static_cast<const long long*>(tape_i64),
      static_cast<const unsigned char*>(tape_u8), static_cast<const double*>(lane_f64),
      static_cast<const long long*>(lane_i64), static_cast<const double*>(state_f64),
      static_cast<const long long*>(state_i64), static_cast<const double*>(win0),
      static_cast<double*>(win), static_cast<double*>(srt), static_cast<double*>(out_f64),
      static_cast<long long*>(out_i64), g, S, L, W, steps);
  return (int)cudaGetLastError();
}
