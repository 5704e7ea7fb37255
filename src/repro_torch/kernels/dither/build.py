"""Build and load the int8 dither codec (``csrc/dither.cu``) through
:class:`repro_torch.kernels.nvcc.CudaLibrary`: nvcc into ``_build/`` beside
this file at first use, loaded with ``ctypes``."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import CudaLibrary

_P, _F, _I, _L = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, \
    ctypes.c_longlong

_HERE = Path(__file__).resolve().parent

#: -fmad=false: no multiply-add is contracted into an FMA, so the levels
#: round exactly as the reference's separate operations do.
LIBRARY = CudaLibrary(
    _HERE / "csrc" / "dither.cu",
    headers=(_HERE.parent / "csrc" / "threefry.cuh",),
    flags=("-fmad=false",),
    signatures={
        # x, dtype, u, s, rows, cols, block_rows, norm_bits, levels, scale,
        # stream
        "repro_dither_encode": (_P, _I, _P, _F, _L, _L, _L, _P, _P, _P, _P),
        # x, dtype, key, s, rows, cols, block_rows, norm_bits, levels,
        # scale, stream
        "repro_dither_encode_keyed": (_P, _I, _P, _F, _L, _L, _L, _P, _P, _P,
                                      _P),
        # x, dtype, rows, cols, block_rows, norm_bits, stream
        "repro_dither_absmax": (_P, _I, _L, _L, _L, _P, _P),
        # x, dtype, key, s, rows, cols, block_rows, norm_bits, levels,
        # scale, stream
        "repro_dither_levels_keyed": (_P, _I, _P, _F, _L, _L, _L, _P, _P, _P,
                                      _P),
        # levels, scale, rows, cols, block_rows, out, stream
        "repro_dither_decode": (_P, _P, _L, _L, _L, _P, _P),
    })

build = LIBRARY.build
build_log = LIBRARY.build_log
