"""Build and load the compressor kernels (``csrc/compressor.cu``) through
:class:`repro_torch.kernels.nvcc.CudaLibrary`: nvcc into ``_build/`` beside
this file at first use, loaded with ``ctypes``."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import CudaLibrary

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int

_HERE = Path(__file__).resolve().parent

#: -fmad=false: no multiply-add is contracted into an FMA, so the kernels
#: round exactly as the reference's separate operations do (see the source
#: note).
LIBRARY = CudaLibrary(
    _HERE / "csrc" / "compressor.cu",
    headers=(_HERE.parent / "csrc" / "threefry.cuh",),
    flags=("-fmad=false",),
    signatures={
        "repro_fused_dither": (_P, _P, _F, _P, _P, _I, _I, _P),
        # x, key, s, out, bits, n, L, cluster, stream
        "repro_fused_dither_keyed": (_P, _P, _F, _P, _P, _I, _I, _I, _P),
        "repro_fused_topk": (_P, _F, _P, _P, _I, _I, _I, _P),
        "repro_dither_bits": (_F, _F, _P, _P),
        "repro_topk_bits": (_F, _F, _P, _P),
        # x, keys, s, out, bits, rows, L, n_group, cluster, stream
        "repro_fused_dither_keyed_grouped": (_P, _P, _P, _P, _P, _I, _I, _I,
                                             _I, _P),
        # x, frac, out, bits, rows, L, n_group, cluster, stream
        "repro_fused_topk_grouped": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        # s (or frac), d, out, G, stream
        "repro_dither_bits_grouped": (_P, _F, _P, _I, _P),
        "repro_topk_bits_grouped": (_P, _F, _P, _I, _P),
    })

build = LIBRARY.build
library_path = LIBRARY.path
build_log = LIBRARY.build_log
