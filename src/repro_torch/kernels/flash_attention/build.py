"""Build and load the flash-attention kernels through
:class:`repro_torch.kernels.nvcc.CudaLibrary`: nvcc into ``_build/`` beside
this file at first use, loaded with ``ctypes``.  Two libraries, one nvcc
each (built side by side): ``csrc/flash_attention.cu`` (forward and
backward) and ``csrc/flash_attention_jvp.cu`` (their tangents), both on
the tensor-core helpers of ``csrc/tensor_core.cuh``."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import CudaLibrary

_CSRC = Path(__file__).resolve().parent / "csrc"

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int

LIBRARY = CudaLibrary(
    _CSRC / "flash_attention.cu",
    headers=(_CSRC / "tensor_core.cuh",),
    signatures={
        # q, k, v, o, lse, dtype, B, H, KV, S, D, Dv, window, cap,
        # strides, stream
        "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _P, _P),
        # q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, B, H, KV, S, D,
        # Dv, window, cap, strides, stream
        "repro_flash_attention_backward": (_P,) * 10 + (_I,) * 8 + (
            _F, _P, _P),
    })

JVP_LIBRARY = CudaLibrary(
    _CSRC / "flash_attention_jvp.cu",
    headers=(_CSRC / "tensor_core.cuh",),
    signatures={
        # q, k, v, o, lse, tq, tk, tv, tout, tlse, B, H, KV, S, D, window,
        # cap, strides, stream
        "repro_flash_attention_jvp": (_P,) * 10 + (_I,) * 6 + (_F, _P, _P),
        # q, k, v, out, dout, lse, tq, tk, tv, tout, tdout, tlse, delta,
        # tdelta, tdq, tdk, tdv, B, H, KV, S, D, window, cap, strides,
        # stream
        "repro_flash_attention_backward_jvp": (_P,) * 17 + (_I,) * 6 + (
            _F, _P, _P),
    })

build = LIBRARY.build
build_log = LIBRARY.build_log
