"""Batched serving: prefill a prompt batch, then greedy-decode N tokens.

Prefill emits a KV cache padded to the decode horizon; each serve step then
appends one token.  Weights and prompts are drawn from ``--seed``.  Runs on
the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --device cpu --batch 4 --prompt-len 32 --gen 32

``--arch`` takes every arch of ``repro_torch.configs.ARCHITECTURES`` (the
dense qwen3-1.7b, stablelm-3b, starcoder2-3b and phi4-mini-3.8b, the hybrid
zamba2-2.7b, the Mamba-1 falcon-mamba-7b); alone it serves the arch's
reduced smoke config, and ``--full`` serves its published config.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import get_model
from .steps import make_prefill_step, make_serve_step
from .train import PRESETS


def pad_cache(cache: dict, extra: int) -> dict:
    """Grow attention caches' sequence axis (axis 2) by ``extra`` zero slots."""

    def pad(key, x):
        if key in ("k", "v", "attn_k", "attn_v"):
            shape = list(x.shape)
            shape[2] = extra
            return torch.cat([x, x.new_zeros(shape)], dim=2)
        return x

    return {k: pad(k, v) for k, v in cache.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device: "torch.device | str | None" = None, params=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily (the first from the prefill's logits).

    Weights are drawn from ``seed`` unless ``params`` are given, prompts
    from ``seed + 1``.  Returns the tokens (B, gen), the prefill's
    last-position logits (B, V) in f32, and the prefill and decode wall
    times (ended by a device synchronise on a card)."""

    if gen < 1:
        raise ValueError("gen must be at least 1")
    dev = resolve_device(device)
    model = get_model(cfg, dev)
    if params is None:
        params = model.init_params(seed)
    gen_prompts = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen_prompts,
                            device=dev)
    prefill = make_prefill_step(model)
    step = make_serve_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    cache = pad_cache(cache, gen)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, _, cache = step(params, cache, tok, prompt_len + i)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    tokens = torch.cat(out, dim=1).cpu()
    if tokens.shape != (batch, gen):
        raise RuntimeError(f"bad generation shape {tuple(tokens.shape)}")
    if not bool(((tokens >= 0) & (tokens < cfg.padded_vocab)).all()):
        raise RuntimeError("generated token ids out of vocab range")
    return {
        "model": cfg.name,
        "device": str(dev),
        "tokens": tokens,
        "prefill_logits": logits[:, -1, :].float().cpu(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_steps": gen - 1,
        "decode_tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--full", action="store_true",
                    help="serve the arch's published config, not its smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()

    if args.arch:
        cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    else:
        cfg = PRESETS[args.preset]
    print(f"[serve] model={cfg.name} family={cfg.family} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} device={resolve_device(args.device)}")
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                seed=args.seed, device=args.device)
    print(f"[serve] prefill {res['prefill_s'] * 1e3:.1f} ms; decode "
          f"{res['decode_s'] * 1e3:.1f} ms ({res['decode_tokens_per_s']:.0f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"[serve] seq{b}: {res['tokens'][b][:16].tolist()}...")
    print("[serve] ok")


if __name__ == "__main__":
    main()
