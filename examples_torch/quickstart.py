"""Quickstart on the port: SSDUP+ in 60 seconds, on the CUDA card.

Builds the paper's full pipeline on a synthetic mixed workload:
random-factor detection -> adaptive threshold -> redirection -> two-region
pipeline with traffic-aware flushing, then prints what each scheme would
have done (the paper's Fig. 13 comparison) on the calibrated device model.
Every stream is scored once, in one launch of the ``stream_stats`` kernel
on the card; the redirector and the four scheme replays reuse the scores.

    PYTHONPATH=src python examples_torch/quickstart.py               # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    AdaptiveThreshold,
    DataRedirector,
    Device,
    compute_stream_scores,
    ior,
    mixed,
    relabel,
    run_schemes,
)
from repro_torch.core.workloads import GiB  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # two applications hitting the same I/O node: one sequential writer,
    # one random writer (the paper's workload_1)
    seq_app = relabel(ior("segmented-contiguous", 16, total_bytes=GiB // 2,
                          seed=1), app_id=0, file_id=0)
    rnd_app = relabel(ior("segmented-random", 16, total_bytes=GiB // 2,
                          seed=2), app_id=1, file_id=1)
    workload = mixed(seq_app, rnd_app, burst_requests=512)
    print(f"workload: {len(workload)} requests, "
          f"{workload.total_bytes / 2**30:.1f} GiB from 2 apps")
    scores = compute_stream_scores(workload.trace, device=dev)

    # 1) detection + adaptive redirection (paper Sections 2.2-2.3): the
    # redirector's streams are the scored blocks, in arrival order
    red = DataRedirector(AdaptiveThreshold(window=64))
    routed = [red.route_stream(stream, percentage=float(pct))
              for stream, pct in zip(red.grouper.push_many(workload.trace),
                                     scores.percentage)]
    print(f"\nstreams: {len(routed)}; "
          f"redirected to fast tier: {red.ssd_stream_ratio*100:.1f}% of streams "
          f"({red.ssd_byte_ratio*100:.1f}% of bytes)")
    print(f"final adaptive threshold: {red.policy.threshold:.3f}")
    ssd_pcts = [r.percentage for r in routed if r.device is Device.SSD]
    hdd_pcts = [r.percentage for r in routed if r.device is Device.HDD]
    if ssd_pcts and hdd_pcts:
        print(f"mean pct | fast tier: {sum(ssd_pcts)/len(ssd_pcts):.2f}  "
              f"slow tier: {sum(hdd_pcts)/len(hdd_pcts):.2f}  "
              "(random streams buffered, sequential pass through)")

    # 2) end-to-end scheme comparison under a constrained SSD (Fig. 13)
    print("\nscheme comparison (SSD = half the data):")
    res = run_schemes(workload.trace, ssd_capacity=workload.total_bytes // 2,
                      scores=scores, device=dev)
    for name, r in res.items():
        print(f"  {name:12s} {2*r.throughput_mbs:7.1f} MB/s aggregate | "
              f"ssd {r.ssd_byte_ratio*100:5.1f}% | "
              f"flush paused {r.flush_paused_seconds:5.1f}s | "
              f"{r.flushes} flushes")
    best = max(res, key=lambda s: res[s].throughput_mbs)
    print(f"\nbest scheme on this trace: {best}")
    return {"scores": scores, "routed": routed, "threshold": red.policy.threshold,
            "results": res, "best": best}


if __name__ == "__main__":
    main()
