"""Serving on one card: prefill a prompt batch, then batched greedy decode
(counterpart of ``repro.launch.serve`` and ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        --batch 8 --prompt-len 1024 --gen 64

The model's weights are random, drawn from seed 0 by the reference's key
tree, in float32 (as the reference's launcher builds them); the prompt is
drawn from ``numpy.random.default_rng(0)``.  ``--smoke`` (the default, as in
the reference, whose flag cannot be turned off) runs the reduced config;
``--no-smoke`` the full width.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops
from repro_torch.models.model import init_params
from repro_torch.train.step import make_prefill_step, make_serve_step


def setup(arch="tinyllama-1.1b", smoke=True, batch=4, prompt_len=32,
          device=None, n_layers=0):
    """(cfg, params, prompt tokens [batch, prompt_len]) on ``device``.
    ``n_layers`` > 0 keeps only the first n layers of the plan (depth cut,
    every width intact)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  layer_plan=cfg.layer_plan[:n_layers])
    params = init_params(cfg, random.key(0, dev), torch.float32)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                             device=dev)
    return cfg, params, tokens


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, tokens, gen: int, feed=None):
    """Prefill ``tokens`` [B, S], then ``gen`` greedy decode steps (or, with
    ``feed`` [B, gen], steps fed those tokens instead of their own argmax:
    a run held against another device's).

    Returns a dict: ``generated`` [B, gen] (the token fed to each step, the
    first one from the prefill's logits), ``logits`` [gen + 1, B, V] (the
    prefill's last position, then each step's), ``prefill_ms`` and
    ``decode_ms`` (host clock around work that ends in a synchronize; decode
    per step, each step decoding B tokens), ``tokens_per_s`` (B * gen over
    the decode time) and ``prefill_flash_launches`` (flash-attention kernel
    launches during the prefill: one per attention layer on the card, 0 on
    the CPU)."""
    dev = tokens.device
    B, S = tokens.shape
    prefill_step = make_prefill_step(cfg, max_len=S + gen)
    serve_step = make_serve_step(cfg)
    _sync(dev)
    n0 = ops.launches["flash_attention"]
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": tokens})
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    flash = ops.launches["flash_attention"] - n0
    all_logits = [logits[:, 0]]
    generated = []
    tok = logits.argmax(dim=-1)                                  # [B, 1]
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
    args = ap.parse_args(argv)

    cfg, params, tokens = setup(args.arch, args.smoke, args.batch,
                                args.prompt_len, args.device)
    out = generate(cfg, params, tokens, args.gen)
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
