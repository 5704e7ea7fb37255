"""repro_torch.kernels.nvcc: a built library is named by what it is built
from, so a process never loads a library built from other sources.

No compiler is needed: ``CudaLibrary.path`` only hashes the files."""
from repro_torch.kernels.dither import build as dither_build
from repro_torch.kernels.nvcc import CudaLibrary


def test_library_name_follows_source_headers_and_flags(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    source, header = csrc / "k.cu", csrc / "k.cuh"
    source.write_text('#include "k.cuh"\n')
    header.write_text("// one\n")
    lib = CudaLibrary(source, headers=(header,))
    first = lib.path()
    assert first.parent == tmp_path / "_build"
    assert lib.path() == first
    header.write_text("// two\n")
    assert lib.path() != first
    assert CudaLibrary(source, headers=(header,), flags=("-DX=1",)).path() \
        != lib.path()
    assert CudaLibrary(source).path() != lib.path()


def test_dither_library_hashes_the_threefry_header_it_includes():
    lib = dither_build.LIBRARY
    names = [h.name for h in lib.headers]
    assert names == ["threefry.cuh"]
    assert all(h.is_file() for h in lib.headers)
    assert '#include "../../csrc/threefry.cuh"' in lib.source.read_text()
    assert (lib.source.parent / "../../csrc/threefry.cuh").resolve() == \
        lib.headers[0].resolve()
