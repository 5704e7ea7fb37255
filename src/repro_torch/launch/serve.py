"""Serving on one card: prefill a prompt batch, then batched greedy decode
(counterpart of ``repro.launch.serve`` and ``examples/serve_lm.py``), for
every architecture of the registry.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        --batch 8 --prompt-len 1024 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        --arch qwen3-moe-235b-a22b --layers 2 --dtype bf16 --batch 8 \\
        --prompt-len 1024 --gen 16

The model's weights are random, drawn from seed 0 by the reference's key
tree, in float32 (as the reference's launcher builds them) or, with
``--dtype bf16``, in bfloat16 (the reference's ``init_params`` default);
the prompt is drawn from ``numpy.random.default_rng(0)`` ([B, S, C] for
the audio codebooks), and a VLM's image embeds ([B, min(n_img_tokens, S),
D]) from the same generator after it.  ``--smoke`` (the default, as in
the reference, whose flag cannot be turned off) runs the reduced config;
``--no-smoke`` the full width, and ``--layers N`` keeps its first N
layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import inputs
from repro_torch.models.model import init_params
from repro_torch.train.step import make_prefill_step, make_serve_step

#: ``--dtype`` names.
DTYPES = {"f32": torch.float32, "float32": torch.float32,
          "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _prompt(cfg, batch, prompt_len, rng):
    shape = ((batch, prompt_len, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, prompt_len))
    return rng.integers(0, cfg.vocab, shape)


def setup(arch="tinyllama-1.1b", smoke=True, batch=4, prompt_len=32,
          device=None, n_layers=0, dtype=torch.float32):
    """(cfg, params, prompt tokens [batch, prompt_len] (or [batch,
    prompt_len, C] audio)) on ``device``, the weights in ``dtype``.
    ``n_layers`` > 0 keeps only the first n layers of the plan (depth cut,
    every width intact)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  layer_plan=cfg.layer_plan[:n_layers])
    params = init_params(cfg, random.key(0, dev), dtype)
    tokens = _prompt(cfg, batch, prompt_len, np.random.default_rng(0))
    return cfg, params, torch.as_tensor(tokens, device=dev)


def image_embeds(cfg, batch, prompt_len, device=None):
    """A VLM's image embeds in the shape ``inputs.input_specs`` gives a
    prefill, their count cut to the prompt: [batch, min(n_img_tokens,
    prompt_len), D], float32, drawn from ``default_rng(0)`` after
    :func:`setup`'s prompt; None for another family."""
    if cfg.family != "vlm":
        return None
    (B, n, D), _ = inputs.input_specs(cfg, InputShape(
        "prefill", prompt_len, batch, "prefill"))["image_embeds"]
    rng = np.random.default_rng(0)
    _prompt(cfg, batch, prompt_len, rng)
    return torch.as_tensor(
        rng.normal(size=(B, min(n, prompt_len), D)).astype(np.float32),
        device=resolve_device(device))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, tokens, gen: int, feed=None, image_embeds=None):
    """Prefill ``tokens`` [B, S] (or [B, S, C] audio), with a VLM's
    ``image_embeds`` in place of the first positions, then ``gen`` greedy
    decode steps (or, with ``feed`` [B, gen] (or [B, gen, C]), steps fed
    those tokens instead of their own argmax: a run held against another
    device's).

    Returns a dict: ``generated`` [B, gen] (or [B, gen, C]: the token fed
    to each step, the first one from the prefill's logits), ``logits``
    [gen + 1, B, V] (or [gen + 1, B, C, V]: the prefill's last position,
    then each step's), ``prefill_ms`` and ``decode_ms`` (host clock around
    work that ends in a synchronize; decode per step, each step decoding B
    tokens), ``tokens_per_s`` (B * gen over the decode time) and
    ``prefill_flash_launches`` (flash-attention kernel launches during the
    prefill: one per attention layer on the card, 0 on the CPU)."""
    dev = tokens.device
    B, S = tokens.shape[:2]
    prefill_step = make_prefill_step(cfg, max_len=S + gen)
    serve_step = make_serve_step(cfg)
    batch = {"tokens": tokens}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    _sync(dev)
    n0 = ops.launches["flash_attention"]
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    flash = ops.launches["flash_attention"] - n0
    all_logits = [logits[:, 0]]
    generated = []
    tok = logits.argmax(dim=-1)                          # [B, 1] (or C)
    t0 = time.perf_counter()
    for i, t in enumerate(range(S, S + gen)):
        if feed is not None:
            tok = feed[:, i:i + 1].to(dev)
        generated.append(tok[:, 0])
        logits, cache = serve_step(params, cache, {"tokens": tok}, t)
        all_logits.append(logits[:, 0])
        tok = logits.argmax(dim=-1)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {"generated": torch.stack(generated, dim=1),
            "logits": torch.stack(all_logits),
            "prefill_ms": 1e3 * prefill_s,
            "decode_ms": 1e3 * decode_s / max(gen, 1),
            "tokens_per_s": B * gen / decode_s if gen else 0.0,
            "prefill_flash_launches": flash}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                    help="the weights' type (default float32)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (default: all)")
    args = ap.parse_args(argv)

    cfg, params, tokens = setup(args.arch, args.smoke, args.batch,
                                args.prompt_len, args.device, args.layers,
                                DTYPES[args.dtype])
    out = generate(cfg, params, tokens, args.gen,
                   image_embeds=image_embeds(cfg, args.batch,
                                             args.prompt_len, tokens.device))
    dev = tokens.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.arch_id} on {where}")
    print(f"prefill[{args.batch}x{args.prompt_len}] {out['prefill_ms']:.1f} ms"
          f" ({out['prefill_flash_launches']} flash-attention launches)")
    print(f"decode: {args.gen} steps, {out['decode_ms']:.2f} ms/token/batch, "
          f"{out['tokens_per_s']:.1f} tokens/s")
    if dev.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
              f" GiB")
    print("generated token ids (row 0):", out["generated"][0].tolist())
    return out


if __name__ == "__main__":
    main()
