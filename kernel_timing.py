"""Time kernels of one checkout on one card, to compare versions in one call.

    python3 kernel_timing.py compressor [--root DIR] [--topk-chunk N]
    python3 kernel_timing.py flash-forward [--root DIR] [-D NAME=VALUE ...]
    python3 kernel_timing.py flash-backward [--root DIR] [-D NAME=VALUE ...]
    python3 kernel_timing.py topk [--root DIR] [--topk-chunk N]
    python3 kernel_timing.py fednl [--root DIR]
    python3 kernel_timing.py dither [--root DIR]
    python3 kernel_timing.py quickstart [--root DIR]

``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
this one), so that a parent unpacked with ``git archive`` beside a change is
timed by the same code: run parent, change, change, parent in one call.

``compressor`` times the compressor kernels at the main path's shapes beside
their plain versions and ``torch.topk`` (``chip_smoke.phase_timing``), the
keyed dither with its bound read from the SASS of the library it times;
then fused_topk at ``chip_smoke.TOPK_TIMED``, the quickstart and plan shapes
and the long rows up to FedNL's [60, 25e6], each instance forced where the
checkout has two (``chip_smoke.topk_shape_timing``), beside torch.topk.
``--topk-chunk`` fixes the grid instance's chunk (``ops.topk_chunk``'s
bounds were set by timing 4,096 to 32,768).

``topk`` is ``compressor``'s fused_topk part alone.  ``fednl`` times
FedNL's round at gisette width (d = 5000, rows of d² = 25e6 through
``fused_topk_grouped`` once a round), 10-round minus 1-round runs, three
times (``chip_smoke.fednl_round_ms``).

``flash-forward`` builds the flash-attention library with the extra nvcc
``-D`` flags given (the forward's KV tile ``REPRO_FWD_BK``, see
``flash_attention.cu``), holds the forward against its plain
version at every ``chip_smoke.FLASH_SHAPES`` shape and the serving shape
(and bitwise over two runs), and times it at the serving shape in float32
and bfloat16 beside the plain version, SDPA and the bound
(``chip_smoke.phase_flash_timing``).

``flash-backward`` builds the flash-attention library with the extra nvcc
``-D`` flags given (the backward's step tiles ``REPRO_BWD_DKDV_BQ`` and
``REPRO_BWD_DQ_BK``, see ``flash_attention.cu``), holds its backward against
the plain autograd at every ``chip_smoke.BWD_SHAPES`` shape, and times it at
the training shape in float32 and bfloat16 beside the plain autograd and
SDPA (``chip_smoke.flash_backward_timing``).

``dither`` times the codec kernels at the trainer's leaf shapes
(``chip_smoke.LEAF_SHAPES``): the u-taking encode, the keyed encode beside
the draw it replaces, and the decode beside ``torch.mul`` of the levels
and their scale (``chip_smoke.dither_timing``).  It
prints the keyed encode's main-loop instructions an element on each pipe,
read from the SASS of the library it times, from which that bound comes.

``quickstart`` runs Algorithm 1's rounds at quickstart size (d = 123) and
gisette width (d = 5000), with a dither64 and a topk0.1 Hessian
compressor: round ms by the host clock around rounds that end in a
synchronize, and device kernels and int64 elementwise launches a round from
a profile (``chip_smoke.round_timing``).  The rounds are host-bound and
vary between calls; compare two checkouts only within one call.

Each prints the card's name and power limit, the timing lines, and as its
last line one JSON object of the times.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Time one checkout's kernels on the card.")
    parser.add_argument("what", choices=("compressor", "topk", "fednl",
                                         "flash-forward", "flash-backward",
                                         "dither", "quickstart"))
    parser.add_argument("--root", type=Path, default=chip_smoke.ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("-D", dest="defines", action="append", default=[],
                        metavar="NAME=VALUE",
                        help="extra nvcc -D flag for the flash library")
    parser.add_argument("--topk-chunk", type=int, default=None,
                        help="elements a CTA of the grid-wide top-k reads")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device")
    sys.path.insert(0, str(args.root.resolve() / "src"))
    dev = torch.device("cuda")
    chip_smoke.log(chip_smoke.card_line())
    out = {"root": str(args.root), "what": args.what,
           "defines": args.defines}
    if args.what in ("compressor", "topk"):
        from repro_torch import random
        from repro_torch.kernels.compressor import build, ops, ref
        if args.topk_chunk:
            ops.TOPK_CHUNK_MIN = ops.TOPK_CHUNK_MAX = args.topk_chunk
        if args.what == "compressor":
            res = chip_smoke.phase_timing(dev, ops, ref, random,
                                          library=build.LIBRARY.build())
            out["times"] = {
                (f"{key[0]} [20,{key[1]}]" if isinstance(key, tuple)
                 else key):
                {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by") if k in r}
                for key, r in res.items()}
        out["topk"] = chip_smoke.topk_shape_timing(dev, ops, ref)
    elif args.what == "fednl":
        from repro_torch import experiments
        from repro_torch.core import api
        from repro_torch.data.logreg import make_problem
        out["round_ms"] = chip_smoke.fednl_round_ms(api, experiments,
                                                    make_problem)
    elif args.what == "quickstart":
        from repro_torch import quickstart
        out["rounds"] = chip_smoke.round_timing(quickstart)
    elif args.what == "dither":
        from repro_torch import random
        from repro_torch.kernels.dither import ops, ref
        res = chip_smoke.dither_timing(dev, ops, ref, random)
        out["times"] = {
            f"{name} {list(shape)}": {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "draw_ms")
                if k in r}
            for (name, shape), r in res.items()}
    else:
        from repro_torch.kernels.flash_attention import build, ops, ref
        from repro_torch.kernels.nvcc import CudaLibrary
        if args.defines:
            ops.LIBRARY = CudaLibrary(
                build.LIBRARY.source,
                flags=tuple(f"-D{d}" for d in args.defines),
                signatures=build.LIBRARY.signatures)
        out["times"] = {}
        if args.what == "flash-forward":
            out["max_abs_err_by_dtype"] = chip_smoke.phase_flash_kernel(
                dev, ops, ref)
            for name, r in chip_smoke.phase_flash_timing(dev, ops,
                                                         ref).items():
                out["times"][name] = {k: r[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms")}
        else:
            _, rel = chip_smoke.phase_flash_backward(dev, ops, ref,
                                                     need_wgmma=False)
            g = torch.Generator(device=dev).manual_seed(6)
            out["rel_err_by_dtype"] = rel
            for dtype in (torch.float32, torch.bfloat16):
                r = chip_smoke.flash_backward_timing(dev, dtype, ops, ref, g)
                out["times"][str(dtype).replace("torch.", "")] = {
                    k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms")}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
