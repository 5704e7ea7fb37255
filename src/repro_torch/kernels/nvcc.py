"""Build and load a kernel library: one CUDA source compiled by ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``.

No PyTorch headers are involved, so a build takes seconds.  The library
lands in ``_build/`` beside its family's package (listed in
``.gitignore``), named by a hash of the source, the headers it includes
and the flags; it is built at first use only, and a process that finds it
built loads it as it is.  Every C entry point takes pointers and the
stream as ``void*``, returns ``cudaGetLastError()``, and each library
exports ``repro_error_string``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: Flags every library is built with; -Xptxas -v reports registers, shared
#: memory and spills into the build log.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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
                           " — the kernels build only where the CUDA toolkit "
                           "is installed")
    return str(path)


class CudaLibrary:
    """One kernel library: ``source`` (a ``.cu`` file under ``csrc/``), the
    ``headers`` it includes from the repo, extra nvcc ``flags``, and the C
    ``signatures`` (name -> argtypes, every entry point returning int)."""

    def __init__(self, source: Path, flags=(), signatures=None, headers=()):
        self.source = Path(source)
        self.headers = tuple(Path(h) for h in headers)
        self.flags = BASE_FLAGS + tuple(flags)
        self.signatures = dict(signatures or {})
        self.build_dir = self.source.parent.parent / "_build"
        self._lib = None

    def path(self) -> Path:
        text = b"".join(p.read_bytes() for p in (self.source, *self.headers))
        digest = hashlib.sha256(text + " ".join(self.flags).encode()
                                ).hexdigest()
        return self.build_dir / f"lib{self.source.stem}_{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless it is built already; return its path.

        The compiler's report is kept beside the library as ``.log``.  The
        output is written under a temporary name and renamed, so a process
        building at the same time never loads a half-written file."""
        out = self.path()
        if out.is_file():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{self.source}:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        return out

    def build_log(self) -> str:
        """The compiler's report of the current build ('' before a build)."""
        log = self.path().with_suffix(".log")
        return log.read_text() if log.is_file() else ""

    def load(self) -> ctypes.CDLL:
        """The loaded library (built first if needed), with every entry
        point's argument types declared: pointers and the stream as
        ``c_void_p``, so ctypes never cuts them to 32 bits."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = (ctypes.c_int,)
            lib.repro_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, name: str, rc: int) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if rc != 0:
            raise RuntimeError(
                f"{name}: launch failed with CUDA error {rc} "
                f"({self.load().repro_error_string(rc).decode()})")
