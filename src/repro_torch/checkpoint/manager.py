"""Checkpoint directories in the reference's on-disk format.

``save_pytree`` / ``load_pytree`` write and read the same layout as
``repro.checkpoint.manager``: ``arrays.npz`` with one array per leaf
(``a0``, ``a1``, ...) and ``manifest.json`` with the leaf ``names``,
``shapes``, ``dtypes``, ``step`` (always 0: training checkpoints come
with ROADMAP A4) and user ``metadata``. numpy alone reads
it, so the port loads an index the JAX package saved and the JAX package
loads one the port saved. The save is atomic: the directory is written
as ``<path>.tmp`` and renamed once complete.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.utils.pytree import tree_flatten_with_names, \
    tree_unflatten_like


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree: Any, *, metadata: dict | None = None) -> None:
    """Atomic single-checkpoint save of a nested dict/list of tensors or
    arrays to the directory ``path``."""
    path = pathlib.Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    named = [(name, _to_numpy(leaf))
             for name, leaf in tree_flatten_with_names(tree)]
    np.savez(tmp / "arrays.npz",
             **{f"a{i}": arr for i, (_, arr) in enumerate(named)})
    manifest = {
        "step": 0,
        "names": [n for n, _ in named],
        "shapes": [list(a.shape) for _, a in named],
        "dtypes": [str(a.dtype) for _, a in named],
        "metadata": metadata or {},
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_pytree(path, like: Any):
    """Restore the checkpoint at ``path`` into the nesting of ``like``
    (whose leaves only give the structure). Returns (tree of numpy
    arrays, manifest). Leaf names are checked against the manifest, so a
    structural mismatch fails loudly instead of permuting leaves."""
    path = pathlib.Path(path)
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    names = [n for n, _ in tree_flatten_with_names(like)]
    if names != manifest["names"]:
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  saved:   {manifest['names'][:5]}...\n"
            f"  current: {names[:5]}...")
    with np.load(path / "arrays.npz") as data:
        arrays = [data[f"a{i}"] for i in range(len(names))]
    arrays = [a if str(a.dtype) == dt else a.astype(np.dtype(dt))
              for a, dt in zip(arrays, manifest["dtypes"])]
    return tree_unflatten_like(like, arrays), manifest
