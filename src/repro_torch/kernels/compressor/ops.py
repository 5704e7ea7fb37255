"""Entry points of the compressor kernels (counterpart of
``repro.kernels.compressor.ops``).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the kernel of ``csrc/compressor.cu`` (or the wrapper raises), a CPU tensor
takes the plain version in ``ref.py``.  There is no size gate and no
fallback from the card to the plain version.  Rows may have any length
L >= 1: the kernels need no padding.  ``fused_dither`` takes the uniforms
as a tensor, as the Pallas wrapper does; ``fused_dither_keyed`` takes the
parent key of the n workers' keys and draws the keys and the uniforms in
the kernel, bit for bit ``random.uniform(random.split(key, n), (L,))``.

Every launch adds one to ``launches[name]``, so a run can show which
kernels its path went through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.compressor import ref
from repro_torch.kernels.compressor.build import LIBRARY

#: Kernel launches since the last :func:`reset_launches`, per kernel.
launches = {"fused_dither": 0, "fused_dither_keyed": 0, "fused_topk": 0,
            "dither_bits": 0, "topk_bits": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_card(device) -> bool:
    device = torch.device(device)
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"compressor kernels run on cuda or cpu, got {device}")


def _check_rows(name: str, *tensors: torch.Tensor) -> None:
    x = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 rows required, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
            raise ValueError(f"{name}: rows [n >= 1, L >= 1] required, got "
                             f"shape {tuple(t.shape)}")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name}: operands differ in shape or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous rows required")


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(LIBRARY.load(), entry)(*args, stream)
    LIBRARY.check(name, rc)
    launches[name] += 1


def fused_dither(x: torch.Tensor, u: torch.Tensor, s):
    """Dither each row of x [n, L] with the uniforms u [n, L] to s levels:
    returns (Q(x) [n, L], payload bits [n]) — ``compressors._dither`` of
    each row, and ``spec_bits`` of a dither spec over L values."""
    _check_rows("fused_dither", x, u)
    if not _on_card(x.device):
        return ref.fused_dither_ref(x, u, s)
    n, L = x.shape
    out = torch.empty_like(x)
    bits = torch.empty(n, dtype=torch.float32, device=x.device)
    _launch("fused_dither", "repro_fused_dither", x.device, x.data_ptr(),
            u.data_ptr(), float(s), out.data_ptr(), bits.data_ptr(), n, L)
    return out, bits


#: fused_topk splits a row over a cluster only where each CTA gets at
#: least this many elements.
TOPK_MIN_SHARE = 1024
#: fused_dither_keyed's: its threefry makes each element some sixty integer
#: instructions, so a smaller share than top-k's keeps a CTA busy.
DITHER_MIN_SHARE = 256


def _cluster(n: int, L: int, sms: int, min_share: int) -> int:
    """The largest C in {8, 4, 2, 1} with n·C <= sms and L >= C·min_share."""
    c = 8
    while c > 1 and (n * c > sms or L < c * min_share):
        c //= 2
    return c


def topk_cluster(n: int, L: int, sms: int) -> int:
    """CTAs per row of ``fused_topk``: the largest C in {8, 4, 2, 1} with
    n·C <= sms (the card's SM count) and L >= C·TOPK_MIN_SHARE."""
    return _cluster(n, L, sms, TOPK_MIN_SHARE)


def dither_cluster(n: int, L: int, sms: int) -> int:
    """CTAs per row of ``fused_dither_keyed``: ``topk_cluster``'s rule with
    DITHER_MIN_SHARE."""
    return _cluster(n, L, sms, DITHER_MIN_SHARE)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_dither_keyed(x: torch.Tensor, key: torch.Tensor, s):
    """``fused_dither(x, random.uniform(random.split(key, n), (L,)), s)``
    bit for bit, with row i's key and its uniforms drawn inside the kernel.
    key: the int64 [2] key data of ``repro_torch.random`` on x's device
    (the kernel reads it there: no host synchronisation)."""
    _check_rows("fused_dither_keyed", x)
    if (key.dtype != torch.int64 or tuple(key.shape) != (2,)
            or key.device != x.device):
        raise ValueError(f"fused_dither_keyed: an int64 [2] key on x's "
                         f"device required, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")
    if not _on_card(x.device):
        return ref.fused_dither_keyed_ref(x, key, s)
    n, L = x.shape
    out = torch.empty_like(x)
    bits = torch.empty(n, dtype=torch.float32, device=x.device)
    key = key.contiguous()
    _launch("fused_dither_keyed", "repro_fused_dither_keyed", x.device,
            x.data_ptr(), key.data_ptr(), float(s), out.data_ptr(),
            bits.data_ptr(), n, L, dither_cluster(n, L, _sms(x.device)))
    return out, bits


def fused_topk(x: torch.Tensor, frac):
    """Keep the ⌈frac·L⌉ largest magnitudes of each row of x [n, L] (ties
    to the lowest index): returns (top-k(x) [n, L], payload bits [n])."""
    _check_rows("fused_topk", x)
    if not _on_card(x.device):
        return ref.fused_topk_ref(x, frac)
    n, L = x.shape
    out = torch.empty_like(x)
    bits = torch.empty(n, dtype=torch.float32, device=x.device)
    _launch("fused_topk", "repro_fused_topk", x.device, x.data_ptr(),
            float(frac), out.data_ptr(), bits.data_ptr(), n, L,
            topk_cluster(n, L, _sms(x.device)))
    return out, bits


def dither_bits(s, d, device: torch.device) -> torch.Tensor:
    """Ledger query: dither payload bits of a d-value message (0-d)."""
    if not _on_card(device):
        return ref.dither_bits_ref(s, d, device)
    out = torch.empty((), dtype=torch.float32, device=device)
    _launch("dither_bits", "repro_dither_bits", device, float(s), float(d),
            out.data_ptr())
    return out


def topk_bits(frac, d, device: torch.device) -> torch.Tensor:
    """Ledger query: top-k payload bits of a d-value message (0-d)."""
    if not _on_card(device):
        return ref.topk_bits_ref(frac, d, device)
    out = torch.empty((), dtype=torch.float32, device=device)
    _launch("topk_bits", "repro_topk_bits", device, float(frac), float(d),
            out.data_ptr())
    return out
