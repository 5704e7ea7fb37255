"""Time kernels of one checkout on one card, to compare versions in one call.

    python3 kernel_timing.py compressor [--root DIR] [--topk-chunk N]
    python3 kernel_timing.py flash-forward [--root DIR] [-D NAME=VALUE ...]
    python3 kernel_timing.py flash-backward [--root DIR] [-D NAME=VALUE ...]
    python3 kernel_timing.py flash-jvp [--root DIR] [-D NAME=VALUE ...]
    python3 kernel_timing.py flash-families [--root DIR] [-D NAME=VALUE ...]
    python3 kernel_timing.py topk [--root DIR] [--topk-chunk N]
    python3 kernel_timing.py fednl [--root DIR]
    python3 kernel_timing.py dither [--root DIR]
    python3 kernel_timing.py quickstart [--root DIR]
    python3 kernel_timing.py remat

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

``flash-jvp`` builds the tangent library (``build.JVP_LIBRARY``) with the
extra nvcc ``-D`` flags given (the steps ``REPRO_JVP_FWD_BK``,
``REPRO_JVP_DKDV_BQ`` and ``REPRO_JVP_DQ_BK``, see
``csrc/flash_attention_jvp.cu``), prints ptxas's register and spill lines,
holds the forward- and backward-tangent kernels against their plain
versions at every ``chip_smoke.JVP_SHAPES`` shape (and bitwise over two
runs; this checkout's kernels must hold HMMA), and times them at the
training shape beside the plain versions and the bound
(``chip_smoke.phase_flash_jvp``, ``chip_smoke.flash_jvp_timing``), then
each of their kernels' device ms a call from a profile.  With
``--root`` it times DIR's kernels and this checkout's in one call, each run
in a process of its own (one package cannot be imported twice), in the
order DIR, this, this, DIR.

``flash-families`` builds the flash-attention library with the extra nvcc
``-D`` flags given (the wide backward's step ``REPRO_BWD_WIDE_STEP``, the
``wgmma`` forward's warpgroups ``REPRO_FWD_WG_GROUPS``; see
``flash_attention.cu``), prints ptxas's registers and spills of the
kernels at (256, 256) and (192, 128), then holds and times the forward at
``chip_smoke.FAMILY_FLASH_SHAPES`` in float32 and bfloat16 (rows 7b-7c of
PERF.md; ``chip_smoke.phase_flash_families``) and the float32 backward
there (rows 8b-8c; ``chip_smoke.phase_flash_bwd_families``: the plain
autograd, SDPA where it applies, the bound and each kernel's device ms
from a profile), and, where the checkout has it, the bf16 forward on
``wgmma`` beside the ``mma.sync`` kernel at
``chip_smoke.WGMMA_FWD_TIMED`` (``chip_smoke.wgmma_forward_beside``); last
the sha256 digests of the forward's untouched instances
(``chip_smoke.FWD_DIGEST_CASES``).  ``--root`` runs DIR, this, this, DIR
as ``flash-jvp`` does.

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

``remat`` times tinyllama-1.1b's adam step at full width (22 layers,
float32, batch 8 x 1024, 4 steps on one batch, the first left out) with
each layer's remat through ``torch.utils.checkpoint`` (the gradient pass's)
and through ``models/model._dual_remat`` (the Hessian-vector products'),
in the order checkpoint, dual, dual, checkpoint: step ms, peak GiB, and
whether the two routes' losses are the same bits.

Each prints the card's name and power limit, the timing lines, and as its
last line one JSON object of the times.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke


def remat_timing(dev) -> list:
    """``remat``: the adam step with each remat route, alternated."""
    import itertools
    import torch
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.tree import tree_flatten, tree_unflatten
    cfg, params = train.setup(chip_smoke.TINYLLAMA, smoke=False,
                              device=dev)
    batch = next(train.token_batches(cfg, *chip_smoke.TRAIN_BATCH, dev))
    checkpoint = model.checkpoint

    def dual_remat(fn, sp, x, m, cfg, positions, **kwargs):
        leaves, treedef = tree_flatten(sp)
        return model._dual_remat(
            lambda *ts: fn(tree_unflatten(treedef, list(ts[:-1])), ts[-1],
                           m, cfg, positions)[0],
            *leaves, x), torch.zeros((), device=x.device)

    runs = []
    try:
        for route in ("checkpoint", "dual_remat", "dual_remat",
                      "checkpoint"):
            model.checkpoint = (checkpoint if route == "checkpoint"
                                else dual_remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run = train.train(cfg, params, itertools.repeat(batch), 4)
            r = dict(route=route, step_ms=run["step_ms"][1:],
                     losses=[m["loss"] for m in run["metrics"]],
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            chip_smoke.log(f"remat {route}: adam step ms {r['step_ms']}; "
                           f"losses {r['losses']}; peak {r['peak_gib']!r} "
                           f"GiB")
            runs.append(r)
            del run
            torch.cuda.empty_cache()
    finally:
        model.checkpoint = checkpoint
    chip_smoke.check(len({tuple(r["losses"]) for r in runs}) == 1,
                     "remat: the routes' losses differ")
    return runs


def jvp_kernel_split(dev, ops, ref) -> dict:
    """Device ms a call of each kernel of the two tangent launches (the
    forward tangent; the backward tangent's row pass, dK/dV and dQ
    kernels) at the training shape, from torch.profiler over five calls of
    each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    shape = chip_smoke.SERVE_SHAPE + (True,)
    q, k, v, tq, tk, tv, do, tdo = chip_smoke.jvp_inputs(shape, dev, seed=5)
    out, tout, lse, tlse = ref.attention_jvp_ref(q, k, v, tq, tk, tv)
    args = (q, k, v, tq, tk, tv, do, tdo, out, lse, tout, tlse, 0, 0.0)
    chip_smoke.launch_jvp_pair(ops, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            chip_smoke.launch_jvp_pair(ops, *args)
        torch.cuda.synchronize()
    split = {name.split("_cu_")[-1]: us / 1e3 / 5
             for us, _, name in chip_smoke.device_rows(prof)}
    for name, ms in split.items():
        chip_smoke.log(f"  device ms a call: {ms!r} {name}")
    return split


def beside(args) -> None:
    """``flash-jvp`` or ``flash-families`` with ``--root DIR``: DIR's
    kernels and this checkout's, each run an ``--alone`` process of its
    own, in the order DIR, this, this, DIR; the runs' output as it comes,
    then each timing's ms side by side, and the four runs' JSON as the last
    line."""
    import subprocess
    runs = []
    for root in (args.root, chip_smoke.ROOT, chip_smoke.ROOT, args.root):
        cmd = [sys.executable, str(Path(__file__).resolve()), args.what,
               "--alone", "--root", str(root),
               *(f"-D{d}" for d in args.defines)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                              check=False, timeout=1200)
        print(proc.stdout, end="", flush=True)
        chip_smoke.check(proc.returncode == 0,
                         f"{args.what} of {root} failed ({proc.returncode})")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    names = dict.fromkeys(n for run in runs for n in run["times"])
    for name in names:
        chip_smoke.log(f"{name}: ms " + ", ".join(
            f"{run['root']} {run['times'][name]['ms']!r} (plain "
            f"{run['times'][name]['plain_ms']!r})" for run in runs
            if name in run["times"]))
    if "digests" in runs[0]:
        chip_smoke.log("digests equal in the four runs: " + repr(
            len({json.dumps(run["digests"], sort_keys=True)
                 for run in runs}) == 1))
    print(json.dumps({"what": args.what, "runs": runs}), flush=True)


def flash_families(dev, ops, ref, this: bool) -> dict:
    """``flash-families`` of one checkout (``this``: the checkout running
    the script, whose new kernels are checked too)."""
    import torch
    out = {"ptxas": {n: r for n, r in chip_smoke.ptxas_report(
        ops.LIBRARY.build_log()).items() if "Li256E" in n or "Li192E" in n}}
    for name, r in out["ptxas"].items():
        chip_smoke.log(f"  ptxas: {name}: {r}")
    fwd = chip_smoke.phase_flash_families(dev, ops, ref, need_wgmma=this)
    bwd = chip_smoke.phase_flash_bwd_families(dev, ops, ref, new=this)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    out["times"] = {
        f"forward {r['shape']} {r['dtype']}": {k: r[k] for k in keys}
        for r in fwd if "ms" in r}
    out["times"].update({
        f"backward {r['shape']}": {k: r[k] for k in keys + ("split",)}
        for r in bwd["instances"] if "ms" in r})
    out["rel_err_backward"] = bwd["rel_err_worst"]
    out["max_abs_err_forward"] = {
        f"{r['shape']} {r['dtype']}": r["max_abs_err"] for r in fwd}
    if hasattr(ops, "forward_plan"):
        for r in chip_smoke.wgmma_forward_beside(dev, ops, ref):
            for kernel in ("mma_sync", "wgmma"):
                out["times"][f"forward {r['shape']} bfloat16 on {kernel}"] = {
                    k: r[kernel][k] for k in keys + ("max_abs_err",)}
    out["digests"] = {" ".join(map(str, case)): chip_smoke.flash_digest(
        ops, case) for case in chip_smoke.FWD_DIGEST_CASES}
    for case, digest in out["digests"].items():
        chip_smoke.log(f"digest of the forward at {case}: {digest}")
    torch.cuda.synchronize()
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Time one checkout's kernels on the card.")
    parser.add_argument("what", choices=("compressor", "topk", "fednl",
                                         "flash-forward", "flash-backward",
                                         "flash-jvp", "flash-families",
                                         "dither", "quickstart", "remat"))
    parser.add_argument("--root", type=Path, default=chip_smoke.ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("-D", dest="defines", action="append", default=[],
                        metavar="NAME=VALUE",
                        help="extra nvcc -D flag for the flash library")
    parser.add_argument("--topk-chunk", type=int, default=None,
                        help="elements a CTA of the grid-wide top-k reads")
    parser.add_argument("--alone", action="store_true",
                        help="flash-jvp, flash-families: time --root's "
                             "kernels only")
    args = parser.parse_args(argv)
    if args.what in ("flash-jvp", "flash-families") and not args.alone and (
            args.root.resolve() != chip_smoke.ROOT):
        return beside(args)
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
    elif args.what == "flash-jvp":
        from repro_torch.kernels.flash_attention import build, ops, ref
        from repro_torch.kernels.nvcc import CudaLibrary
        if args.defines:
            ops.JVP_LIBRARY = CudaLibrary(
                build.JVP_LIBRARY.source,
                flags=tuple(f"-D{d}" for d in args.defines),
                signatures=build.JVP_LIBRARY.signatures,
                headers=build.JVP_LIBRARY.headers)
        chip_smoke.log(f"built {ops.JVP_LIBRARY.build().name}")
        for line in ops.JVP_LIBRARY.build_log().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                chip_smoke.log("  ptxas:", line.strip())
        out["max_abs_err"], out["rel_err"] = chip_smoke.phase_flash_jvp(
            dev, ops, ref,
            need_mma=args.root.resolve() == chip_smoke.ROOT)
        out["times"] = {
            name: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")}
            for name, r in chip_smoke.flash_jvp_timing(dev, ops,
                                                       ref).items()}
        out["split_ms"] = jvp_kernel_split(dev, ops, ref)
    elif args.what == "remat":
        out["runs"] = remat_timing(dev)
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
                signatures=build.LIBRARY.signatures,
                headers=build.LIBRARY.headers)
        out["times"] = {}
        if args.what == "flash-families":
            chip_smoke.log(f"built {ops.LIBRARY.build().name}")
            out.update(flash_families(
                dev, ops, ref, args.root.resolve() == chip_smoke.ROOT))
        elif args.what == "flash-forward":
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
