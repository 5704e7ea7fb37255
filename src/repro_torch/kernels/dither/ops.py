"""Entry points of the int8 dither codec (counterpart of
``repro.kernels.dither.ops`` and of the Pallas wrappers ``dither_encode`` /
``dither_decode`` in ``repro.kernels.dither.dither``).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the kernel of ``csrc/dither.cu`` (or the wrapper raises), a CPU tensor
takes the plain version in ``ref.py``.  ``dither_encode`` takes the
uniforms as a tensor, as the Pallas wrapper does; ``dither_encode_keyed``
takes a key and draws them in the kernel, ``random.uniform(key, x.shape)``
bit for bit, so they never reach device memory.  There is no fallback
from the card to the plain version.  ``dither_absmax_into`` and
``dither_levels_keyed`` are the keyed encode's two passes apart, for a norm
shared by several workers (``core/compressors.shared_scale_levels``): the
first merges each block's max |x| into a caller's int32 buffer, the second
quantizes from the norms it holds (one worker's tensor, or several
workers' under one key: a launch each on the card, one draw of the
uniforms for all on the CPU).  The Pallas wrappers' ``interpret``
flag has no counterpart, and the kernel takes any C (the Pallas one needs
C % 128 == 0).

``quantize`` / ``dequantize`` keep the reference's layout: the tensor is
flattened and zero-padded into rows of ``cols``, rows are padded to a
multiple of ``rb = min(block_rows, rows)``, and the uniforms are the
reference's own draw, ``uniform(key, padded_shape)`` (drawn by the keyed
encode), so the levels compare bit for bit.

Every launch adds one to ``launches[name]``.  A forward-AD dual operand on
the card raises (``kernels/dual.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.kernels.dither import ref
from repro_torch.kernels.dither.build import LIBRARY
from repro_torch.kernels.dual import refuse_duals

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last :func:`reset_launches`.
launches = {"dither_encode": 0, "dither_encode_keyed": 0,
            "dither_absmax": 0, "dither_levels_keyed": 0, "dither_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"dither kernels run on cuda or cpu, got {t.device}")


def _check_blocks(name, t, block_rows) -> None:
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name}: [R >= 1, C >= 1] required, got "
                         f"{tuple(t.shape)}")
    if block_rows < 1 or t.shape[0] % block_rows:
        raise ValueError(f"{name}: R = {t.shape[0]} is not a multiple of "
                         f"block_rows = {block_rows}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous operands required")


def _launch(name, entry, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(LIBRARY.load(), entry)(*args, stream)
    LIBRARY.check(name, rc)
    launches[name] += 1


def _encode(name, entry, x, operand, s, block_rows):
    """Launch an encode entry point on x [R, C] and its uniforms or key:
    (levels int8 [R, C], scale float32 [R // block_rows])."""
    refuse_duals(name, x, operand)
    R, C = x.shape
    nb = R // block_rows
    levels = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scale = torch.empty(nb, dtype=torch.float32, device=x.device)
    norm_bits = torch.empty(nb, dtype=torch.int32, device=x.device)
    _launch(name, entry, x.device, x.data_ptr(), _DTYPES[x.dtype],
            operand.data_ptr(), float(s), R, C, block_rows,
            norm_bits.data_ptr(), levels.data_ptr(), scale.data_ptr())
    return levels, scale


def dither_encode(x, u, *, s=127, block_rows: int = 256):
    """x [R, C] float32 or bfloat16, u [R, C] float32 uniforms, R a
    multiple of block_rows.  Returns (levels int8 [R, C], scale float32
    [R // block_rows])."""
    _check_blocks("dither_encode", x, block_rows)
    if x.dtype not in _DTYPES or u.dtype != torch.float32:
        raise TypeError(f"dither_encode: x float32 or bfloat16 and u float32"
                        f" required, got {x.dtype}, {u.dtype}")
    if u.shape != x.shape or u.device != x.device or not u.is_contiguous():
        raise ValueError("dither_encode: u must be contiguous, and of x's "
                         "shape and device")
    if not _on_card(x):
        return ref.dither_encode_ref(x, u, s, block_rows)
    return _encode("dither_encode", "repro_dither_encode", x, u, s,
                   block_rows)


def dither_encode_keyed(x, key, *, s=127, block_rows: int = 256):
    """``dither_encode(x, random.uniform(key, x.shape), s=s,
    block_rows=block_rows)``, bit for bit, with the uniforms drawn inside
    the kernel.  key: the int64 [2] key data of ``repro_torch.random`` on
    x's device (the kernel reads it there: no host synchronisation)."""
    _check_blocks("dither_encode_keyed", x, block_rows)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dither_encode_keyed: x float32 or bfloat16 "
                        f"required, got {x.dtype}")
    if (key.dtype != torch.int64 or tuple(key.shape) != (2,)
            or key.device != x.device):
        raise ValueError(f"dither_encode_keyed: an int64 [2] key on x's "
                         f"device required, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")
    if not _on_card(x):
        return ref.dither_encode_keyed_ref(x, key, s, block_rows)
    return _encode("dither_encode_keyed", "repro_dither_encode_keyed", x,
                   key.contiguous(), s, block_rows)


def _check_norm_bits(name, x, norm_bits, block_rows) -> None:
    nb = x.shape[0] // block_rows
    if (norm_bits.dtype != torch.int32 or tuple(norm_bits.shape) != (nb,)
            or norm_bits.device != x.device
            or not norm_bits.is_contiguous()):
        raise ValueError(f"{name}: a contiguous int32 [{nb}] norm_bits on "
                         f"x's device required, got {norm_bits.dtype} "
                         f"{tuple(norm_bits.shape)} on {norm_bits.device}")


def dither_absmax_into(x, norm_bits, *, block_rows: int = 256):
    """Pass 1 of the keyed encode: ``norm_bits[b] = max(norm_bits[b], bits
    of max |x| over block b)`` in place, for x [R, C] float32 or bfloat16
    and norm_bits int32 [R // block_rows] (the bits of non-negative
    floats, which order as their values do).  Zero norm_bits before the
    first leaf; each further leaf widens the maximum (several workers'
    leaves, one norm).  Returns norm_bits."""
    _check_blocks("dither_absmax", x, block_rows)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dither_absmax: x float32 or bfloat16 required, "
                        f"got {x.dtype}")
    _check_norm_bits("dither_absmax", x, norm_bits, block_rows)
    if not _on_card(x):
        return ref.dither_absmax_into_ref(x, norm_bits, block_rows)
    refuse_duals("dither_absmax", x)
    R, C = x.shape
    _launch("dither_absmax", "repro_dither_absmax", x.device, x.data_ptr(),
            _DTYPES[x.dtype], R, C, block_rows, norm_bits.data_ptr())
    return norm_bits


def dither_levels_keyed(x, key, norm_bits, *, s=127, block_rows: int = 256):
    """Pass 2 of the keyed encode from the norms in ``norm_bits`` (int32
    [R // block_rows], as :func:`dither_absmax_into` leaves them; a zero
    norm quantizes against 1): (levels int8 [R, C], scale float32
    [R // block_rows] = norm / s), with ``random.uniform(key, x.shape)``
    drawn in the kernel.  After ``dither_absmax_into`` on x alone it is
    ``dither_encode_keyed(x, key, ...)`` bit for bit.

    x may also be a sequence of tensors of one shape, dtype and device
    (several workers' leaves under one key and one norm): then (a list of
    levels, scale), a launch a tensor on the card, the uniforms drawn once
    for all of them by the plain version."""
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    for t in xs:
        _check_blocks("dither_levels_keyed", t, block_rows)
        if t.dtype not in _DTYPES:
            raise TypeError(f"dither_levels_keyed: x float32 or bfloat16 "
                            f"required, got {t.dtype}")
        if (t.shape, t.dtype, t.device) != (xs[0].shape, xs[0].dtype,
                                            xs[0].device):
            raise ValueError("dither_levels_keyed: the tensors must share "
                             "one shape, dtype and device")
    if (key.dtype != torch.int64 or tuple(key.shape) != (2,)
            or key.device != xs[0].device):
        raise ValueError(f"dither_levels_keyed: an int64 [2] key on x's "
                         f"device required, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")
    _check_norm_bits("dither_levels_keyed", xs[0], norm_bits, block_rows)
    if not _on_card(xs[0]):
        u = random.uniform(key, tuple(xs[0].shape))
        out = [ref.dither_levels_ref(t, u, norm_bits, s, block_rows)
               for t in xs]
    else:
        out = [_levels_keyed(t, key, norm_bits, s, block_rows) for t in xs]
    if isinstance(x, torch.Tensor):
        return out[0]
    return [lv for lv, _ in out], out[-1][1]


def _levels_keyed(x, key, norm_bits, s, block_rows):
    refuse_duals("dither_levels_keyed", x, key)
    R, C = x.shape
    levels = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scale = torch.empty(R // block_rows, dtype=torch.float32,
                        device=x.device)
    _launch("dither_levels_keyed", "repro_dither_levels_keyed", x.device,
            x.data_ptr(), _DTYPES[x.dtype], key.contiguous().data_ptr(),
            float(s), R, C, block_rows, norm_bits.data_ptr(),
            levels.data_ptr(), scale.data_ptr())
    return levels, scale


def dither_decode(levels, scale, *, block_rows: int = 256):
    """levels int8 [R, C], scale float32 [R // block_rows] -> float32
    [R, C], ``levels · scale`` of each element's block.  The levels may
    start at any address: the kernel loads four at a time where they are
    4-byte aligned and the block's length is a multiple of 4, one at a time
    otherwise."""
    _check_blocks("dither_decode", levels, block_rows)
    nb = levels.shape[0] // block_rows
    if levels.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dither_decode: int8 levels and float32 scales "
                        f"required, got {levels.dtype}, {scale.dtype}")
    if scale.shape != (nb,) or scale.device != levels.device:
        raise ValueError(f"dither_decode: scale [{nb}] on the levels' device"
                         f" required, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not _on_card(levels):
        return ref.dither_decode_ref(levels, scale, block_rows)
    refuse_duals("dither_decode", scale)
    R, C = levels.shape
    out = torch.empty((R, C), dtype=torch.float32, device=levels.device)
    _launch("dither_decode", "repro_dither_decode", levels.device,
            levels.data_ptr(), scale.contiguous().data_ptr(), R, C,
            block_rows, out.data_ptr())
    return out


def _to_2d(x, cols: int):
    n = x.numel()
    rows = -(-n // cols)
    flat = F.pad(x.reshape(-1), (0, rows * cols - n))
    return flat.reshape(rows, cols), n


def quantize(key, x, *, s=127, block_rows: int = 8, cols: int = 512):
    """Random-dithering quantize a tensor of any shape.  Returns (levels
    int8 [rows, cols], scales float32 [rows / rb], meta); decode with
    :func:`dequantize`."""
    x2, n = _to_2d(x.float(), cols)
    rows = x2.shape[0]
    rb = min(block_rows, rows)
    pad_rows = (-rows) % rb
    if pad_rows:
        x2 = F.pad(x2, (0, 0, 0, pad_rows))
    levels, scales = dither_encode_keyed(x2, key, s=s, block_rows=rb)
    return levels, scales, (tuple(x.shape), n, rb)


def dequantize(levels, scales, meta):
    shape, n, rb = meta
    out = dither_decode(levels, scales, block_rows=rb)
    return out.reshape(-1)[:n].reshape(shape)
