#!/usr/bin/env python3
"""Variants of the stream kernel's long-row branch, timed on one CUDA card.

    python3 chip_stream_variants.py [VARIANT,...]

Builds ``src/repro_torch/kernels/stream_rf/csrc/stream_rf.cu`` as it is and
in variants made from it by editing its text (each edit must apply exactly
once, so a variant that no longer fits the source fails loudly):

* ``k8``, ``k32``   -- K = 8 or 32 positions a thread instead of 16;
* ``u64``, ``u64_k8`` -- the exact 64-bit key ((off - min) << log2 W) |
                       index in place of the 32-bit bucket key, so no order
                       check or repair (the exact branch for rows spanning
                       2^(64 - log2 W) or more), at K = 16 or 8;
* ``nosort``        -- no sort and no order check: the load, the keys and
                       the residuals alone;
* ``nocheck``       -- the sort without the order check and its repairs;
* ``local``         -- only the merges that stay inside a warp (no check);
* ``norelay``       -- no mirror stage or re-layout through shared memory
                       (no check);
* ``noshfl``        -- no cross-lane stage (no check);
* ``nobar``         -- the shared-memory rounds without their block
                       barriers (no check).

The source as it is and the ``k`` and ``u64`` variants are whole kernels:
each is held bit-equal to the plain torch version on every matrix first.
The others are timing ablations whose results are not read.  Each variant is timed (raw launches
in a CUDA graph, L2-warm, as ``chip_smoke.py`` times the kernel) on the
sweep's whole trace at ``stream_len`` 2048, 4096 and 8192 and on seeded
row kinds, in two rounds that take turns over the variants.  Prints the
card's name and power limit, then one JSON line.  Exits nonzero without a
CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "stream_rf" / "csrc" / "stream_rf.cu"
OUT = ROOT / "build" / "stream_variants"

# a re-layout's or the mirror stage's barrier and the loop that reads after it
_LOOP = "  __syncthreads();\n#pragma unroll\n  for (int r = 0; r < kLongK; ++r) {\n"
# (text, replacement) edits that switch a part off behind a macro
_GUARDS = (
    ("  long_sort<LOG_W>(v, t, relay32, relay32 + W);\n",
     "#ifndef NO_SORT\n  long_sort<LOG_W>(v, t, relay32, relay32 + W);\n#endif\n"),
    ("  for (int round = 0; !block_in_order<T>(o, ix, t, check_edges, on, in); ++round) {",
     "#ifdef NO_CHECK\n  on = __shfl_down_sync(kFull, o[0], 1);\n  if (0)\n#endif\n"
     "  for (int round = 0; !block_in_order<T>(o, ix, t, check_edges, on, in); ++round) {"),
    ("    if (lk == kWarpLog + 1) {\n",
     "#ifdef ONLY_LOCAL\n    if (lk > kWarpLog) continue;\n#endif\n#ifdef NO_RELAY\n"
     "    if (lk > kWarpLog) {\n      merge_stages(v, t % kWarp, lk);\n"
     "      top = kWarpLog - 1;\n    }\n    if (0) {\n#else\n    if (lk == kWarpLog + 1) {\n"
     "#endif\n"),
    ("    } else if (lk > kWarpLog) {\n",
     "#ifdef NO_RELAY\n    } else if (0) {\n#else\n    } else if (lk > kWarpLog) {\n#endif\n"),
    (_LOOP + "    unpark(s, to_merge", "#ifndef NO_BAR\n" + _LOOP.replace(
        "();\n", "();\n#endif\n", 1) + "    unpark(s, to_merge"),
    (_LOOP + "    Key got;", "#ifndef NO_BAR\n" + _LOOP.replace(
        "();\n", "();\n#endif\n", 1) + "    Key got;"),
    ("    const int tm = m >> LOG_K;\n",
     "#ifdef NO_SHFL\n    return;\n#endif\n    const int tm = m >> LOG_K;\n"),
)
_K = "constexpr int kLongLogK = 4;"

# the exact 64-bit key: its type, parked in 64-bit words
_PACKED = """struct Packed {
  unsigned long long k;
  __device__ __forceinline__ static void sort2(Packed& lo, Packed& hi) {
    const unsigned long long a = lo.k, b = hi.k;
    lo.k = a < b ? a : b;
    hi.k = a < b ? b : a;
  }
  __device__ __forceinline__ Packed shfl_xor(int m) const {
    return {__shfl_xor_sync(kFull, k, m)};
  }
  __device__ __forceinline__ static Packed keep(Packed mine, Packed theirs, unsigned lower) {
    return {(theirs.k < mine.k) == (lower != 0) ? theirs.k : mine.k};
  }
};
__device__ __forceinline__ void park(void* s, int a, Packed v) {
  static_cast<unsigned long long*>(s)[a] = v.k;
}
__device__ __forceinline__ void unpark(const void* s, int a, Packed& v) {
  v.k = static_cast<const unsigned long long*>(s)[a];
}

"""
# the kernel's bucket sort, check and repairs, from its first line to its
# last, and what the exact 64-bit key puts in their place: the offsets'
# words and the re-layout words are its two buffers
_BUCKET_FROM = ("  Bucket v[K];\n#pragma unroll\n  for (int r = 0; r < K; ++r) {\n"
                "    const int e = r * T + t;\n")
_BUCKET_TO = "    block_transposition_round<T>(o, ix, t, round_edges);\n  }\n"
_U64 = """  long long o[K];
  int ix[K];
  bool exact = (span >> (64 - LOG_W)) != 0;
  long long on;
  int in;
  if (!exact) {
    Packed v[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int e = r * T + t;
      const unsigned long long rel = (unsigned long long)off[r] - (unsigned long long)lo;
      v[r].k = (e < len ? rel << LOG_W : ~0ull << LOG_W) | (unsigned long long)e;
    }
    long_sort<LOG_W>(v, t, off_of, relay);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      ix[r] = (int)(v[r].k & (W - 1));
      o[r] = (long long)((unsigned long long)lo + (v[r].k >> LOG_W));
    }
    block_in_order<T>(o, ix, t, check_edges, on, in);  // the successors
  }
"""
VARIANTS = {
    "as_is": "",
    "k8": "K3",
    "k32": "K5",
    "u64": "U64",
    "u64_k8": "U64 K3",
    "nosort": "NO_SORT NO_CHECK",
    "nocheck": "NO_CHECK",
    "local": "ONLY_LOCAL NO_CHECK",
    "norelay": "NO_RELAY NO_CHECK",
    "noshfl": "NO_SHFL NO_CHECK",
    "nobar": "NO_BAR NO_CHECK",
}


def _edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"variant edit does not fit the source: {old[:60]!r}")
    return text.replace(old, new)


def variant_source(flags: str) -> str:
    text = SOURCE.read_text()
    for flag in flags.split():
        if flag.startswith("K"):
            text = _edit(text, _K, _K.replace("4", flag[1:]))
        elif flag == "U64":
            text = _edit(text, "// The shared-memory slot of position p", _PACKED +
                         "// The shared-memory slot of position p")
            if text.count(_BUCKET_FROM) != 1 or text.count(_BUCKET_TO) != 1:
                raise SystemExit("the bucket sort is not where the variants expect it")
            start, end = text.index(_BUCKET_FROM), text.index(_BUCKET_TO) + len(_BUCKET_TO)
            text = text[:start] + _U64 + text[end:]
        else:
            if "#define" not in text.split("\n", 1)[0]:
                for old, new in _GUARDS:
                    text = _edit(text, old, new)
            text = f"#define {flag}\n" + text
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_stream_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs  # noqa: E402  (its timing helpers)
    from repro_torch.kernels.build import CudaLibrary
    from repro_torch.kernels.stream_rf import kernel, ref
    from repro_torch.testing.stream_rows import stream_rows
    from repro_torch.testing.traces import sweep_trace

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in names:
        path = OUT / f"{name}.cu"
        path.write_text(variant_source(VARIANTS[name]))
        libs[name] = CudaLibrary(path, kernel._bind)
    with concurrent.futures.ThreadPoolExecutor(min(len(libs), os.cpu_count() or 1)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if "stream_stats_long" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()[:160]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")

    def raw(lib, o, s):
        m, n = o.shape
        rf = torch.empty(m, dtype=torch.int64, device=dev)
        dist = torch.empty_like(rf)

        def launch():
            err = lib.stream_stats_launch(o.data_ptr(), s.data_ptr(), None, rf.data_ptr(),
                                          dist.data_ptr(), m, n,
                                          torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        launch.out = (rf, dist)
        return launch

    batch = sweep_trace(cs.SWEEP_REQUESTS)
    rng = np.random.default_rng(0)
    cases = [(f"sweep{n}", *batch.padded_stream_matrix(n)[:2]) for n in (2048, 4096, 8192)]
    cases += [(f"{kind}{n}", *stream_rows(kind, m, n, rng)) for kind, m, n in (
        ("random40", 489, 2048), ("collide", 489, 2048), ("outlier", 489, 2048),
        ("contiguous", 489, 2048), ("random40", 123, 8192))]
    out = {"card": smi, "us": {}}
    for label, offs, szs in cases:
        o, s = torch.from_numpy(offs).to(dev), torch.from_numpy(szs).to(dev)
        rf_p, dist_p = ref.stream_stats_ref(o, s)
        row = {}
        for name, lib in libs.items():
            f = raw(lib.load(), o, s)
            f()
            torch.cuda.synchronize()
            whole = not any(flag.startswith(("NO_", "ONLY_")) for flag in VARIANTS[name].split())
            if whole and not (torch.equal(f.out[0], rf_p) and torch.equal(f.out[1], dist_p)):
                raise SystemExit(f"{label}: variant {name} differs from the plain version")
        for _ in range(2):
            for name, lib in libs.items():
                row.setdefault(name, []).append(cs.graph_ms(raw(lib.load(), o, s)) * 1e3)
        out["us"][label] = {"shape": list(o.shape), **row}
        print(label, json.dumps(out["us"][label]), flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
