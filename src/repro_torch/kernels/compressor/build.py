"""Build and load the compressor kernels (``csrc/compressor.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface, which ``ctypes`` loads: no PyTorch headers, so the build takes
seconds.  The library lands in ``_build/`` beside this file (listed in
``.gitignore``), named by a hash of the source and the flags, and is built
at first use only; a process that finds it built loads it as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "compressor.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: -fmad=false: no multiply-add is contracted into an FMA, so the kernels
#: round exactly as the reference's separate operations do (see the source
#: note).  -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_SIGNATURES = {
    "repro_fused_dither": (_P, _P, _F, _P, _P, _I, _I, _P),
    "repro_fused_topk": (_P, _F, _P, _P, _I, _I, _P),
    "repro_dither_bits": (_F, _F, _P, _P),
    "repro_topk_bits": (_F, _F, _P, _P),
}

_library = None


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)"
                           " — the compressor kernels build only where the "
                           "CUDA toolkit is installed")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcompressor_{digest}.so"


def build() -> Path:
    """Compile the library unless it is built already; return its path.

    The compiler's report (``-Xptxas -v``) is kept beside the library as
    ``.log``.  The output is written under a temporary name and renamed, so
    concurrent builders never load a half-written file."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler's report of the current build ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every entry
    point's argument types declared: pointers and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = (ctypes.c_int,)
        lib.repro_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library
