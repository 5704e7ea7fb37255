"""Entry points of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the kernel of ``csrc/flash_attention.cu`` (or the wrapper raises), a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from
the card to the plain version.  The checks below hold on both devices.

Queries sit at key positions 0..S-1, so Sq must equal Sk: the Pallas
kernel's docstring says queries align to the end of the KV sequence, but
its code aligns them to the start, and the two agree only when Sq == Sk,
the only case prefill uses.  Any S >= 1 is taken (the kernel masks the
ragged last tile; the Pallas wrapper asserts S % 128 == 0).

Every launch adds one to ``launches["flash_attention"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.build import LIBRARY

#: Head dimensions the kernel is built for.
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last :func:`reset_launches`.
launches = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def _check(q, k, v, window, cap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q [B, H, S, D] and k, v "
                         f"[B, KV, S, D] required, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, KV, Sk, Dk = k.shape
    if k.shape[0] != B or Dk != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (H must be a multiple of KV)")
    if Sq != Sk:
        raise ValueError(f"flash_attention: Sq == Sk required (queries sit "
                         f"at key positions 0..S-1), got {Sq} and {Sk}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not supported "
                         f"(built for {HEAD_DIMS})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 operands of "
                        f"one type required, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: operands on different devices")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if window < 0 or cap < 0:
        raise ValueError(f"flash_attention: window >= 0 and cap >= 0 "
                         f"required, got {window}, {cap}")


def _launch(q, k, v, out, window, cap) -> None:
    """The kernel on views of any batch/head/sequence strides whose head
    dimension is contiguous; writes ``out`` (q's shape and type)."""
    for t in (q, k, v, out):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention: the head dimension must be "
                             "contiguous")
    B, H, S, D = q.shape
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out)
                                         for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.load().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, k.shape[1], S, D, int(window),
            float(cap), ctypes.addressof(strides), stream)
    LIBRARY.check("flash_attention", rc)
    launches["flash_attention"] += 1


def flash_attention(q, k, v, window: int = 0, cap: float = 0.0):
    """q: [B, H, S, D]; k/v: [B, KV, S, D] (kernel layout).  Causal GQA
    attention with an optional sliding window and tanh soft-cap; float32
    arithmetic, result [B, H, S, D] in q's type."""
    _check(q, k, v, window, cap)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, window, cap)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, window, cap)
    return out


def attention(q, k, v, window: int = 0, cap: float = 0.0):
    """q: [B, S, H, D]; k/v: [B, S, KV, D] (model layout).  The kernel reads
    and writes the model layout in place through strides: no transposed
    copy is made on the card."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _check(qt, kt, vt, window, cap)
    if q.device.type == "cpu":
        return ref.attention_ref(qt, kt, vt, window, cap).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(qt, kt, vt, out.transpose(1, 2), window, cap)
    return out
