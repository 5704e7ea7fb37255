"""Pytree checkpoints in ``.npz`` (counterpart of
``repro.checkpoint.store``), in the reference's file format, so that either
package restores what the other saved, bit for bit.

A checkpoint is a directory with ``arrays.npz`` (leaf i as ``a{i}``, in
``jax.tree.flatten`` order: dict keys sorted) and ``meta.json`` (``keys``,
the leaves' paths joined by "/"; ``step``; ``dtypes``, numpy's names).
bfloat16 leaves are stored widened to float32 and cast back on restore.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_paths, tree_unflatten

#: numpy's name of each dtype a tree may hold (``str(np.asarray(x).dtype)``
#: in the reference; ml_dtypes names bfloat16 "bfloat16").
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def save(path, tree, step: int = 0) -> None:
    """Write ``tree`` (nested dicts and lists of tensors) to the directory
    ``path``, created if missing."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        t = leaf.detach().cpu()
        dtypes.append(_NAMES[t.dtype])
        if t.dtype == torch.bfloat16:        # stored widened, as the
            t = t.float()                    # reference stores ml_dtypes
        arrays[f"a{i}"] = t.numpy()
    np.savez(path / "arrays.npz", **arrays)
    (path / "meta.json").write_text(json.dumps(
        {"keys": tree_paths(tree), "step": step, "dtypes": dtypes}))


def restore(path, like):
    """(tree, step): the checkpoint at ``path`` in the structure of
    ``like``, each leaf on ``like``'s leaf's device and in its dtype."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    data = np.load(path / "arrays.npz")
    assert meta["keys"] == tree_paths(like), \
        "checkpoint/model structure mismatch"
    leaves, treedef = tree_flatten(like)
    out = []
    for i, ref in enumerate(leaves):
        arr = data[f"a{i}"]
        assert tuple(arr.shape) == tuple(ref.shape), (arr.shape, ref.shape)
        out.append(torch.as_tensor(arr).to(device=ref.device,
                                           dtype=ref.dtype))
    return tree_unflatten(treedef, out), meta["step"]
