"""End-to-end training launcher.

Composes the port's pieces: a model of any family (``--arch``, or a size
``--preset``), sharded synthetic data (the VLM's patch embeddings and the
encoder-decoder's frames drawn from ``--seed`` and the step, as the
modality frontends are stubs), AdamW,
optional gradient compression, heartbeat bookkeeping, and SSDUP+
burst-buffered async checkpointing with restart (``--resume`` picks up the
newest committed manifest).  Runs on the CUDA card unless ``--device cpu``
is given; without a card and without it, it raises.

Presets (dense, f32, the layers' own torch paths):

    tiny   ~7M params   [default]
    20m    ~21M params
    100m   ~101M params

``--arch`` trains the arch's smoke config, ``--full`` its published
config.  Either way attention and the scan run on their torch paths: the
CUDA kernels have no backward pass.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --preset tiny --steps 200 --ckpt-dir /tmp/ckpt --ckpt-every 50
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..checkpoint import Checkpointer, TieredCheckpointStore
from ..configs import get_config, get_smoke_config
from ..configs.base import ModelConfig
from ..data import DataConfig, ShardedLoader
from ..device import resolve_device
from ..distributed.fault_tolerance import HeartbeatTable
from ..models import frontend_inputs, get_model
from ..models.convert import params_from_jax, tree_from_params
from ..optim import AdamWConfig, CompressionConfig, init_state, linear_warmup_cosine
from .steps import make_train_step

# the reference's presets, its "xla" impls as the port's "torch"
PRESETS: dict[str, ModelConfig] = {
    "tiny": ModelConfig(
        name="tiny", family="dense", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=1024, vocab_size=8192, head_dim=64,
        dtype="float32", remat="none", attention_impl="torch", ssm_impl="torch"),
    "20m": ModelConfig(
        name="20m", family="dense", n_layers=6, d_model=384, n_heads=6,
        n_kv_heads=2, d_ff=1536, vocab_size=16384, head_dim=64,
        dtype="float32", remat="none", attention_impl="torch", ssm_impl="torch"),
    "100m": ModelConfig(
        name="100m", family="dense", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=8, d_ff=2048, vocab_size=49152, head_dim=64,
        dtype="float32", remat="none", attention_impl="torch", ssm_impl="torch"),
}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--arch", default=None,
                    help="an arch's smoke config instead of a preset")
    ap.add_argument("--full", action="store_true",
                    help="train --arch at its published config, not its smoke config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.arch:
        cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
        cfg = dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch")
        print("[train] attention_impl='torch', ssm_impl='torch' (the kernels have no "
              "backward pass)")
    else:
        cfg = PRESETS[args.preset]
    model = get_model(cfg, dev)
    print(f"[train] model={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family} device={dev}")

    params = model.init_params(args.seed)
    opt_cfg = AdamWConfig(lr=args.lr,
                          schedule=linear_warmup_cosine(args.warmup, args.steps))
    opt_state = init_state(dict(params.named_parameters()))
    comp = CompressionConfig(enabled=args.compress_grads)
    step_fn = make_train_step(model, opt_cfg, comp)

    data = ShardedLoader(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch, seed=args.seed), host_id=0)

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        store = TieredCheckpointStore(args.ckpt_dir, host_id=0)
        ckpt = Checkpointer(store)
        if args.resume:
            restored = ckpt.restore_latest(like={"params": tree_from_params(params)})
            if restored is not None:
                start_step, tree = restored
                params = params_from_jax(cfg, tree["params"], device=dev)
                print(f"[train] resumed from step {start_step}")

    hb = HeartbeatTable(timeout=60.0, clock=time.monotonic)
    hb.register(0)

    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.get(step).items()}
        batch.update(frontend_inputs(cfg, args.batch, args.seed * 1_000_003 + step, dev))
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        hb.heartbeat(0, dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / dt
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f} ms/step {tok_s:9.0f} tok/s", flush=True)
        if ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, {"params": tree_from_params(params)})

    if ckpt:
        ckpt.save_blocking(args.steps, {"params": tree_from_params(params)})
        ckpt.close()
        print(f"[train] checkpoints committed under {args.ckpt_dir} "
              f"(async saves: {ckpt.saves_completed})")

    wall = time.time() - t_start
    print(f"[train] done: {args.steps - start_step} steps in {wall:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if len(losses) > 20:
        if np.mean(losses[-10:]) >= np.mean(losses[:10]):
            raise RuntimeError("no learning: loss did not decrease")


if __name__ == "__main__":
    main()
