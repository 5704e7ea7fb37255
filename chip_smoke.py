#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure stops the script with a non-zero exit; nothing falls
back to the CPU):

1. Build the compressor kernels from ``src/repro_torch/kernels/compressor/
   csrc`` with nvcc for sm_90a; print the compiler's register report and
   the card's name and power limit.
2. Hold every kernel on the card against its plain PyTorch version on a CPU
   copy of the same inputs, at the main path's row shapes and on edge rows:
   the results must be bit-identical.
3. Quickstart (d=123, n=20, r=64, m=4, seed 0): 201 rounds with
   dither64/dither64 and 50 with a topk0.1 Hessian compressor, on the card
   and in the port on the CPU.  Ledgers must be equal every round, the
   dither run's final objective within rtol 1e-4 of the CPU run, and the
   launch counters (set to 0 before each run, read after it) must show
   that the card run went through the kernels.
4. Gisette width (d=5000, n=20, r=300, m=4): 10 rounds with each Hessian
   compressor on the card, with exact ledgers; the dither run's objective
   against the port on this machine's CPU; round time and peak memory.
5. A profile of a few rounds at both sizes, then each kernel's time by CUDA
   events beside its plain version, its bound and (top-k) ``torch.topk``.
6. Print the kernels line, then the device line as the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/compressor/csrc/compressor.cu"
REPLACES = {
    "fused_dither": "src/repro/kernels/compressor/compressor.py:71",
    "fused_topk": "src/repro/kernels/compressor/compressor.py:105",
    "dither_bits": "src/repro/kernels/compressor/compressor.py:161",
    "topk_bits": "src/repro/kernels/compressor/compressor.py:165",
}
QUICK = dict(d=123, n_workers=20, r=64, m=4, seed=0)
GISETTE = dict(d=5000, n_workers=20, r=300, m=4, seed=0)


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, backlog: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call.

    With ``backlog`` the card first runs a ~50 ms spin kernel, so the host
    enqueues every call before the first one starts: the events then time
    the device alone, not the host's rate of issuing launches (one Python
    wrapper call costs tens of microseconds, more than these kernels).
    Without it the time is that of the calls as issued from Python."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b| over positions where neither is NaN (0.0 when the two
    are bit-identical there); NaN positions must agree."""
    import torch
    a, b = a.cpu(), b.cpu()
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN positions differ")
    keep = ~torch.isnan(b)
    if not bool(keep.any()):
        return 0.0
    return float((a[keep].double() - b[keep].double()).abs().max())


def bit_identical(a, b) -> bool:
    import torch
    a, b = a.cpu(), b.cpu()
    keep = ~torch.isnan(b)
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a[keep].view(torch.int32),
                            b[keep].view(torch.int32)))


def phase_kernels(dev, ops, ref, random):
    """Phase 2: every kernel against its plain version, bit for bit."""
    import numpy as np
    import torch
    err = {name: 0.0 for name in REPLACES}
    rng = np.random.default_rng(0)

    def compare(name, got, want, what):
        check(bit_identical(got, want), f"{name} differs from its plain "
              f"version on {what}")
        err[name] = max(err[name], max_abs_err(got, want))

    cases = [(f"[20,{L}]", torch.as_tensor(
        (rng.normal(size=(20, L)) * 10).astype(np.float32)))
        for L in (123, 492, 5000, 20000)]
    for L in (1, 127, 128, 129):
        cases.append((f"[3,{L}]", torch.as_tensor(
            rng.normal(size=(3, L)).astype(np.float32))))
    inf, nan = float("inf"), float("nan")
    cases += [
        ("zero row", torch.zeros((2, 300))),
        ("inf row", torch.tensor([[1.0, inf, 3.0, -2.0, 0.5, 0.0, 7.0,
                                   -inf]])),
        ("nan row", torch.tensor([[1.0, nan, 3.0, -2.0, -0.0, 0.5, 2.0,
                                   1.0]])),
        ("integer ties", torch.as_tensor(
            rng.integers(-3, 4, size=(4, 1000)).astype(np.float32))),
    ]
    keys = random.split(random.key(7, "cpu"), 20)
    for what, x in cases:
        u = random.uniform(keys[:x.shape[0]], (x.shape[1],))
        out, bits = ops.fused_dither(x.to(dev), u.to(dev), 64.0)
        want, want_bits = ref.fused_dither_ref(x, u, 64.0)
        compare("fused_dither", out, want, what)
        compare("fused_dither", bits, want_bits, what + " (bits)")
        for frac in (0.1, 0.5):
            out, bits = ops.fused_topk(x.to(dev), frac)
            want, want_bits = ref.fused_topk_ref(x, frac)
            compare("fused_topk", out, want, f"{what} frac={frac}")
            compare("fused_topk", bits, want_bits, f"{what} (bits)")
    for d in (1, 123, 128, 129, 492, 5000, 20000):
        for s in (1.0, 64.0):
            compare("dither_bits", ops.dither_bits(s, d, dev),
                    ref.dither_bits_ref(s, d, "cpu"), f"s={s} d={d}")
        for frac in (0.1, 0.37, 1.0):
            compare("topk_bits", ops.topk_bits(frac, d, dev),
                    ref.topk_bits_ref(frac, d, "cpu"), f"frac={frac} d={d}")
    torch.cuda.synchronize()
    log(f"phase 2: {len(cases)} row sets, every kernel bit-identical to its "
        f"plain version; max_abs_err {err}")
    return err


def drive(quickstart, ops, counts_total, expect, label, iters, **kw):
    """One main-path run on the card, through the quickstart's pieces:
    the counters are set to 0 just before the recorded run and read just
    after, and each must equal ``expect``.  A second run of the same rounds
    without metrics is timed by the host clock around synchronize."""
    import torch
    from repro_torch.core.driver import run_experiment
    prob, step, state, key = quickstart.setup(device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    _, tr = run_experiment(step, state, key, iters,
                           record=lambda st: prob.metrics(st.w))
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: launches {counts}")
    for name, n in expect.items():
        check(counts[name] == n, f"{label}: {name} launched {counts[name]} "
              f"times, expected {n}")
    for name, n in counts.items():
        counts_total[name] += n
    t0 = time.perf_counter()
    run_experiment(step, state, key, iters)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / iters
    return prob, tr, round_ms, peak


def compare_ledgers_and_F(label, gpu, cpu, per_round, n_workers=20):
    """Exact ledgers (equal on both devices and ``per_round`` a round);
    returns the per-round relative difference of F, card against CPU."""
    import numpy as np
    bits_g = gpu["bits_per_node"].cpu().numpy()
    check(np.array_equal(bits_g, cpu["bits_per_node"].numpy()),
          f"{label}: card and CPU ledgers differ")
    want = per_round * np.arange(1, len(bits_g) + 1, dtype=np.float64)
    check(np.array_equal(bits_g, np.repeat(want[:, None], n_workers, 1)),
          f"{label}: ledger is not {per_round} a round")
    F_g = gpu["F"].cpu().numpy().astype(np.float64)
    F_c = cpu["F"].numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):
        rel = np.abs(F_g / F_c - 1)
    log(f"{label}: final bits {bits_g[-1, 0]:.0f}; F card "
        f"{float(F_g[-1])!r} cpu {float(F_c[-1])!r}; rel diff final "
        f"{float(rel[-1])!r} max {float(np.nanmax(rel))!r}")
    return F_g, rel


def phase_quickstart(quickstart, ops, counts_total):
    """Phase 3: the quickstart on the card against the port on the CPU."""
    import numpy as np
    out = {}
    for hess, iters, per_round in (("dither64", 201, 5432),
                                   ("topk0.1", 50, 3546)):
        n_top = iters if hess.startswith("topk") else 0
        expect = {"fused_dither": 2 * iters - n_top,
                  "dither_bits": 2 * iters - n_top,
                  "fused_topk": n_top, "topk_bits": n_top}
        label = f"quickstart {hess} x{iters}"
        _, gpu, round_ms, _ = drive(quickstart, ops, counts_total, expect,
                                    label, iters, hess=hess, **QUICK)
        _, _, cpu = quickstart.run(iters, device="cpu", hess=hess, **QUICK)
        F, rel = compare_ledgers_and_F(label, gpu, cpu, per_round)
        log(f"{label}: {round_ms!r} ms/round on the card")
        out[hess] = dict(round_ms=round_ms, F_final=float(F[-1]),
                         rel_final=float(rel[-1]))
        if n_top == 0:
            # the topk0.1 quickstart diverges (F -> inf) in the reference
            # itself, so only its ledger is held
            check(np.isfinite(F).all(), f"{label}: F not finite")
            check(rel[-1] <= 1e-4, f"{label}: final F beyond rtol 1e-4")
    return out


def phase_gisette(quickstart, ops, counts_total):
    """Phase 4: gisette width on the card: exact ledgers, F against the
    port on this machine's CPU (dither), round time and peak memory."""
    import numpy as np
    quickstart.run(2, record=False, device="cuda", **GISETTE)    # warm-up
    out = {}
    for hess, per_round in (("dither64", 200_512), ("topk0.1", 134_512)):
        n_top = 10 if hess.startswith("topk") else 0
        expect = {"fused_dither": 20 - n_top, "dither_bits": 20 - n_top,
                  "fused_topk": n_top, "topk_bits": n_top}
        label = f"gisette {hess} x10"
        _, gpu, round_ms, peak = drive(quickstart, ops, counts_total, expect,
                                       label, 10, hess=hess, **GISETTE)
        log(f"{label}: {round_ms!r} ms/round (host clock around "
            f"synchronize); peak memory {peak / 2**30!r} GiB; F "
            f"{gpu['F'].tolist()}")
        res = dict(round_ms=round_ms, peak_gib=peak / 2**30,
                   F=gpu["F"].tolist())
        if n_top == 0:
            _, _, cpu = quickstart.run(10, device="cpu", hess=hess,
                                       **GISETTE)
            F, rel = compare_ledgers_and_F(label, gpu, cpu, per_round)
            # a last-ulp difference moves a dithered value across a
            # rounding boundary now and then, and the run amplifies it
            # (scripts/torch_vs_reference.py shows the same spread between
            # the port and the JAX reference on the CPU)
            check(np.isfinite(F).all() and float(np.nanmax(rel)) <= 1e-3,
                  f"{label}: F not finite or beyond rtol 1e-3 of the CPU")
            res["rel_max"] = float(np.nanmax(rel))
        else:
            bits = gpu["bits_per_node"].cpu().numpy()
            want = per_round * np.arange(1, 11, dtype=np.float64)
            check(np.array_equal(bits, np.repeat(want[:, None], 20, 1)),
                  f"{label}: ledger is not {per_round} a round")
        out[hess] = res
    return out


def phase_profile(quickstart):
    """Where a round's device time goes: torch.profiler over 10 quickstart
    rounds and 3 gisette rounds; the top kernels by device time, each
    compressor kernel's device time per launch, and the device's busy share
    of the profiled window's wall time (the profiler slows the host, so the
    window is longer than an unprofiled round)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import run_experiment
    out = {}
    for label, iters, kw in (("quickstart", 10, QUICK),
                             ("gisette", 3, GISETTE)):
        _, step, state, key = quickstart.setup(device="cuda", **kw)
        run_experiment(step, state, key, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_experiment(step, state, key, iters)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        # device-side events only (kernels, copies): the operator events
        # that launched them carry the same time again
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        for name in REPLACES:
            mine = [r for r in rows if f"{name}_kernel" in r[2]]
            t = sum(r[0] for r in mine)
            n = sum(r[1] for r in mine)
            log(f"profile {label}: {name} {n / iters:g} launches/round, "
                f"{t / max(n, 1) / 1e3!r} ms device time per launch")
            out.setdefault(f"{label}_kernel_ms", {})[name] = (
                t / max(n, 1) / 1e3)
        busy = sum(r[0] for r in rows)
        rows.sort(reverse=True)
        log(f"profile {label} x{iters}: wall {wall_us / iters / 1e3!r} "
            f"ms/round, device busy {busy / iters / 1e3!r} ms/round "
            f"({100 * busy / wall_us:.1f}% of wall)")
        for t, count, name in rows[:12]:
            log(f"  {t / iters / 1e3:10.4f} ms/round  x{count / iters:6.1f}"
                f"  {name[:70]}")
        out[label] = dict(wall_ms=wall_us / iters / 1e3,
                          busy_ms=busy / iters / 1e3)
    return out


def phase_timing(dev, ops, ref, random):
    """Per-kernel device times at the gisette shapes, beside the plain
    version, the library call (top-k) and the bound."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 20
    rows = {L: torch.randn((n, L), generator=g).to(dev)
            for L in (5000, 20000)}
    us = {L: random.uniform(random.split(random.key(3, dev), n), (L,))
          for L in rows}
    res = {}
    for L, x in rows.items():
        u = us[L]
        elems = n * L
        k = ref.topk_keep_count(0.1, L)
        dither = lambda: ops.fused_dither(x, u, 64.0)       # noqa: E731
        topk = lambda: ops.fused_topk(x, 0.1)                # noqa: E731
        res[("fused_dither", L)] = dict(
            ms=cuda_ms(dither, 200), host_ms=cuda_ms(dither, 200, False),
            plain_ms=cuda_ms(lambda: ref.fused_dither_ref(x, u, 64.0), 20),
            library_ms=None,
            bytes=12 * elems + 4 * n, ops=10 * elems)
        res[("fused_topk", L)] = dict(
            ms=cuda_ms(topk, 200), host_ms=cuda_ms(topk, 200, False),
            plain_ms=cuda_ms(lambda: ref.fused_topk_ref(x, 0.1), 20),
            library_ms=cuda_ms(lambda: torch.topk(x.abs(), k, dim=1), 100),
            bytes=8 * elems + 4 * n, ops=34 * elems)
    for name, fn, plain in (
            ("dither_bits", lambda: ops.dither_bits(64.0, 20000, dev),
             lambda: ref.dither_bits_ref(64.0, 20000, dev)),
            ("topk_bits", lambda: ops.topk_bits(0.1, 20000, dev),
             lambda: ref.topk_bits_ref(0.1, 20000, dev))):
        res[(name, 1)] = dict(ms=cuda_ms(fn, 200),
                              host_ms=cuda_ms(fn, 200, False),
                              plain_ms=cuda_ms(plain, 20), library_ms=None,
                              bytes=4, ops=12)
    for r in res.values():
        t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * r["ops"] / F32_OPS_PER_S
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for (name, L), r in res.items():
        shape = f"[{n},{L}]" if L > 1 else "(scalar)"
        log(f"timing {name} {shape}: {r['ms']!r} ms (as issued from "
            f"Python {r['host_ms']!r} ms; plain "
            f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms by {r['bound_by']})")
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    from repro_torch import quickstart, random
    from repro_torch.kernels.compressor import build, ops, ref

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python",
        sys.version.split()[0])

    t0 = time.perf_counter()
    build.build()
    log(f"phase 1: built {build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas:", line.strip())
    card = card_line()
    log(card)

    err = phase_kernels(dev, ops, ref, random)
    counts = {name: 0 for name in REPLACES}
    quick = phase_quickstart(quickstart, ops, counts)
    gis = phase_gisette(quickstart, ops, counts)
    for name, n in counts.items():
        check(n > 0, f"{name} was never launched on the main path")
    log(f"main-path launches (sum of the four runs above): {counts}")
    prof = phase_profile(quickstart)
    timing = phase_timing(dev, ops, ref, random)

    kernels = []
    for name in REPLACES:
        L = 20000 if name.startswith("fused") else 1
        r = timing[(name, L)]
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name], "launches": counts[name],
                 "max_abs_err": err[name], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "host_ms": r["host_ms"], "shape": [20, L] if L > 1 else []}
        if name.startswith("fused"):
            entry["ms_by_shape"] = {f"[20,{Ls}]": timing[(name, Ls)]["ms"]
                                    for Ls in (5000, 20000)}
        kernels.append(entry)
    log(json.dumps({"quickstart": quick, "gisette": gis, "profile": prof}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
