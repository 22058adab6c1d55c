"""Batched serving example on the port: prefill a prompt batch, decode
greedily, on the CUDA card.

Exercises exactly the path the decode_32k / long_500k dry-run cells lower
(serve_step: one token against a KV cache), at CPU-friendly sizes, for a
dense arch and an SSM arch (O(1)-state decode).  On the card the dense
arch's prefill runs the ``flash_attention`` kernel (head_dim 16) once a
layer and the SSM arch's the ``ssm_scan`` kernel once a layer.  Weights
and prompts are drawn from seeded ``torch.Generator``\\ s.

    PYTHONPATH=src python examples_torch/serve_batched.py               # the card
    PYTHONPATH=src python examples_torch/serve_batched.py --device cpu
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import _sync, pad_cache  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402

ARCHS = ("qwen3-1.7b", "falcon-mamba-7b")
BATCH, PROMPT, GEN = 4, 24, 16


@torch.inference_mode()
def serve(arch: str, device, params=None, prompts: torch.Tensor | None = None) -> dict:
    """Prefill ``BATCH`` prompts of ``PROMPT`` tokens and decode ``GEN``
    tokens greedily (the first from the prefill's logits).  Weights are
    drawn from seed 0 and prompts from seed 1 unless given.  Returns the
    tokens (BATCH, GEN) and each step's last-position logits in f32."""

    dev = resolve_device(device)
    cfg = get_smoke_config(arch)
    model = get_model(cfg, dev)
    if params is None:
        params = model.init_params(0)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": prompts.to(dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (BATCH, cfg.n_patches, cfg.d_model), dtype=dtype_of(cfg), device=dev)

    prefill = make_prefill_step(model)
    step = make_serve_step(model)

    _sync(dev)
    t0 = time.time()
    logits, cache = prefill(params, batch)
    if cfg.family not in ("ssm",):
        cache = pad_cache(cache, GEN)
    tok = torch.argmax(logits[:, -1, :], -1)[:, None]
    toks, step_logits = [tok], [logits[:, -1, :].float()]
    for i in range(GEN - 1):
        tok, lg, cache = step(params, cache, tok, PROMPT + i)
        toks.append(tok)
        step_logits.append(lg[:, -1, :].float())
    gen = torch.cat(toks, dim=1).cpu()
    dt = time.time() - t0
    print(f"{arch:18s} [{cfg.family:6s}] generated {tuple(gen.shape)} in {dt:5.1f}s "
          f"sample: {gen[0][:8].tolist()}")
    if gen.shape != (BATCH, GEN):
        raise RuntimeError(f"bad generation shape {tuple(gen.shape)}")
    if not bool(((gen >= 0) & (gen < cfg.padded_vocab)).all()):
        raise RuntimeError("generated token ids out of vocab range")
    return {"tokens": gen, "logits": torch.stack(step_logits, dim=1).cpu(), "seconds": dt,
            "padded_vocab": cfg.padded_vocab}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {arch: serve(arch, dev) for arch in ARCHS}
    print("serve example ok")
    return out


if __name__ == "__main__":
    main()
