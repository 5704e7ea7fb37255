"""The port stands alone: no module of src/repro_torch/, and neither
chip_smoke.py nor kernel_timing.py, imports jax or the JAX package
``repro`` (only the tests import both)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_timing.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_found():
    assert len(FILES) > 10 and all(f.is_file() for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module", [
    "tree.py", "kernels/dither/ops.py", "kernels/dither/ref.py",
    "kernels/dither/build.py", "models/loss.py", "optim/optimizers.py",
    "core/dl_flecs.py", "launch/train.py", "core/hessian.py",
    "checkpoint/store.py", "train_lm.py", "kernels/dual.py",
    "kernels/flash_attention/ops.py", "models/layers.py"])
def test_training_slice_modules_are_checked(module):
    """The training slice's modules are among the files held above."""
    assert ROOT / "src" / "repro_torch" / module in FILES
