"""Run the model steps on a mesh and bring the results back whole.

* :func:`sharded_steps` — one train step, one prefill and a few greedy
  decode steps of a model on given weights and batch, with parameters,
  optimizer state, batch and cache as DTensors laid out by their logical
  axes on ``mesh`` (``None``: plain tensors, the unsharded run); every
  result comes back as a whole tensor on the CPU, so two runs compare
  element for element;
* :func:`spawn_world` — run a function in ``n`` spawned processes joined
  in one ``gloo`` process group (a ``FileStore``, no port), and return
  every rank's result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import multiprocessing.connection
import os
import pickle
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..distributed.sharding import distribute, distribute_module, use_mesh
from ..launch.serve import pad_cache
from ..launch.steps import make_prefill_step, make_serve_step, make_train_step
from ..models import get_model, input_axes, named_param_axes
from ..models.convert import params_from_jax, tree_from_params
from ..optim import AdamWConfig, CompressionConfig, init_state


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a plain tensor as it is), on the CPU."""

    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu()


def _rules(cfg) -> dict | None:
    return dict(cfg.shard_rules_override) if cfg.shard_rules_override else None


def sharded_steps(cfg, tree: dict, batch: dict, mesh=None, *, device="cpu",
                  decode_steps: int = 3, lr: float = 1e-3,
                  compression: CompressionConfig | None = None, serve_first: bool = False,
                  decode_tokens: torch.Tensor | None = None) -> dict:
    """The port's steps of ``cfg`` from the reference-layout weights
    ``tree`` and ``batch`` (``tokens``, ``labels`` and a frontend input,
    all (B, ...) tensors): one AdamW step (``lr``) on the torch paths (the
    kernels have no backward pass; gradient ``compression`` if given),
    then from the updated weights (from ``tree``'s, before the step, with
    ``serve_first``) a prefill of ``tokens`` and ``decode_steps`` decode
    steps as ``cfg`` runs them (its ``attention_impl``), each fed the
    previous step's greedy token or, given ``decode_tokens`` (B,
    decode_steps), its column of them.
    Returns ``loss``, ``grad_norm``, ``params`` (the updated weights in the
    reference's layout), ``prefill_logits``, ``cache`` (the prefill's),
    ``decode_logits`` (a list) and ``decode_tokens`` (the tokens the
    decode steps were fed), all whole, on the CPU."""

    model = get_model(cfg, device)
    trainer = get_model(dataclasses.replace(cfg, attention_impl="torch", ssm_impl="torch"),
                        device)
    params = params_from_jax(cfg, tree, device=device)
    batch = {k: v.to(device) for k, v in batch.items()}
    out = {}
    with use_mesh(mesh, _rules(cfg)) if mesh is not None else contextlib.nullcontext():
        if mesh is not None:
            distribute_module(params, named_param_axes(cfg, params), mesh)
            axes = input_axes(cfg, "train")
            batch = {k: distribute(v, axes[k], mesh) for k, v in batch.items()}
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        if serve_first:
            out.update(_serve(model, params, prompt, decode_steps, decode_tokens))
        step = make_train_step(trainer, AdamWConfig(lr=lr), compression)
        params, _, metrics = step(params, init_state(dict(params.named_parameters())), batch)
        params.requires_grad_(False)
        out.update(loss=whole(metrics["loss"]), grad_norm=whole(metrics["grad_norm"]),
                   params={k: whole(v) for k, v in _flat(tree_from_params(params)).items()})
        if not serve_first:
            out.update(_serve(model, params, prompt, decode_steps, decode_tokens))
    return out


@torch.no_grad()
def _serve(model, params, prompt: dict, decode_steps: int, decode_tokens) -> dict:
    logits, cache = make_prefill_step(model)(params, prompt)
    out = {"prefill_logits": whole(logits), "cache": {k: whole(v) for k, v in cache.items()},
           "decode_logits": [], "decode_tokens": []}
    seq = prompt["tokens"].shape[1]
    cache = pad_cache(cache, decode_steps)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    serve_step = make_serve_step(model)
    for i in range(decode_steps):
        if decode_tokens is not None:
            tok = decode_tokens[:, i: i + 1].to(tok.device)
            if isinstance(prompt["tokens"], DTensor):
                tok = distribute(tok, ("batch", None))
        out["decode_tokens"].append(whole(tok))
        tok, logits, cache = serve_step(params, cache, tok, seq + i)
        out["decode_logits"].append(whole(logits))
    out["decode_tokens"] = torch.cat(out["decode_tokens"], dim=1)
    return out


def steps_on_mesh(shape: tuple, names: tuple, cfg, tree: dict, batch: dict,
                  device_type: str = "cpu", **kw) -> dict:
    """:func:`sharded_steps` on a ``shape`` mesh of ``names`` over the
    process group that is up (its ranks in row-major order)."""

    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device_type, shape, mesh_dim_names=names)
    return sharded_steps(cfg, tree, batch, mesh, device=device_type, **kw)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _worker(rank: int, world: int, workdir: str, group: bool, fn, args) -> None:
    if group:
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        if group:
            dist.destroy_process_group()


def spawn_world(n: int, workdir: str, fn, *args, group: bool = True,
                timeout: float = 600.0) -> list:
    """``fn(*args)`` on each of ``n`` spawned ranks of one ``gloo`` group
    (a ``FileStore`` under ``workdir``; with ``group=False`` no group, for a
    function that starts its own); returns every rank's result.  ``fn``
    must be importable by name (it is pickled).  Raises ``RuntimeError``
    if a rank fails or outlasts ``timeout`` seconds."""

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, n, workdir, group, fn, args))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        # a rank that fails leaves the others waiting in a collective: stop
        # at the first failure
        pending = {p.sentinel: p for p in procs}
        deadline = time.monotonic() + timeout
        while pending and time.monotonic() < deadline:
            for s in multiprocessing.connection.wait(list(pending), deadline - time.monotonic()):
                done = pending.pop(s)
                done.join()
                if done.exitcode != 0:
                    pending = {}
                    break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks exited with {codes}")
    results = []
    for r in range(n):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
