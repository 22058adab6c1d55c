"""End-to-end example on the port: train a small LM with burst-buffered
checkpointing on the CUDA card, kill it mid-run, and restart from the
newest committed manifest.

The tiny preset trains on the layers' torch paths (the kernels have no
backward pass).  Saves go through ``Checkpointer`` into a
``TieredCheckpointStore`` in the reference's stacked layout, and the
restart restores them into freshly drawn (wrong) weights.

    PYTHONPATH=src python examples_torch/train_checkpointed.py [--steps 120]   # the card
    PYTHONPATH=src python examples_torch/train_checkpointed.py --device cpu
"""

import argparse
import math
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import Checkpointer, TieredCheckpointStore  # noqa: E402
from repro_torch.data import DataConfig, ShardedLoader  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import PRESETS  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax, tree_from_params  # noqa: E402
from repro_torch.optim import AdamWConfig, init_state, linear_warmup_cosine  # noqa: E402

SAVE_EVERY = 40  # steps between async saves


def train_segment(model, params, opt_state, data, ckpt, start, stop, steps, losses):
    opt_cfg = AdamWConfig(lr=3e-3, schedule=linear_warmup_cosine(10, steps))
    step_fn = make_train_step(model, opt_cfg)
    loss = None
    for step in range(start, stop):
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in data.get(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = losses[step] = float(metrics["loss"])
        if step % 20 == 0:
            print(f"  step {step:4d} loss {loss:.4f}")
        if (step + 1) % SAVE_EVERY == 0:
            ckpt.save_async(step + 1, {"params": tree_from_params(params)})
    return params, opt_state, loss


def make_loader(cfg) -> ShardedLoader:
    return ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
                         host_id=0)


def restore(ckpt, model, cfg, dev) -> tuple[int, torch.nn.Module]:
    """The newest committed checkpoint, restored into freshly drawn (wrong)
    weights: (its step, the weights)."""

    fresh = model.init_params(42)  # wrong weights
    restored = ckpt.restore_latest(like={"params": tree_from_params(fresh)})
    if restored is None:
        raise RuntimeError("no committed checkpoint found")
    start, tree = restored
    return start, params_from_jax(cfg, tree["params"], device=dev)


def train(steps: int, device, params=None, root: str | None = None) -> dict:
    """Train the tiny preset to ``steps // 2``, "crash" after the last
    async save commits, restore the newest checkpoint into fresh weights
    and train on to ``steps``.  Initial weights are drawn from seed 0
    unless ``params`` are given; checkpoints go to ``root`` (a new
    temporary directory unless given)."""

    dev = resolve_device(device)
    cfg = PRESETS["tiny"]
    model = get_model(cfg, dev)
    data = make_loader(cfg)
    root = root or tempfile.mkdtemp(prefix="ckpt_example_")
    store = TieredCheckpointStore(root, host_id=0)
    ckpt = Checkpointer(store)
    losses: dict[int, float] = {}  # every step's

    print(f"phase 1: train to step {steps // 2} then 'crash'")
    if params is None:
        params = model.init_params(0)
    opt_state = init_state(dict(params.named_parameters()))
    params, opt_state, loss_a = train_segment(
        model, params, opt_state, data, ckpt, 0, steps // 2, steps, losses)
    ckpt.wait()  # simulate crash AFTER the last async save commits
    del params, opt_state

    print("phase 2: restart from the newest committed manifest")
    start, params = restore(ckpt, model, cfg, dev)
    opt_state = init_state(dict(params.named_parameters()))  # cold optimizer
    print(f"  resumed at step {start}")
    params, opt_state, loss_b = train_segment(
        model, params, opt_state, data, ckpt, start, steps, steps, losses)
    ckpt.close()

    print(f"\nloss before crash: {loss_a:.4f}; final loss: {loss_b:.4f}")
    if loss_b is None or not math.isfinite(loss_b):
        raise RuntimeError(f"final loss {loss_b} is not finite")
    print(f"checkpoints in {root}")
    return {"losses": losses, "loss_before_crash": loss_a, "final_loss": loss_b,
            "resumed_at": start, "root": root, "saves": ckpt.saves_completed}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where checkpoints go (default: a new temporary directory)")
    args = ap.parse_args(argv)
    return train(args.steps, args.device, root=args.ckpt_dir)


if __name__ == "__main__":
    main()
