"""Checkpoint/restore for model parameters and optimizer state.

The reference has no persistent state at all (SURVEY.md §5.4 — its only
cross-frame state is the previous-frame VkImage); this build's learned
head (config 5) trains, so it checkpoints.  Format: a flat .npz of the
pytree leaves plus a structure descriptor — dependency-light and
array-exact (bitwise restore).
"""

from __future__ import annotations

import json
from typing import Any

import jax
import numpy as np


def save_pytree(path: str, tree: Any) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(str(treedef)).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (structure/shape/dtype-checked)."""
    data = np.load(path)
    leaves, treedef = jax.tree_util.tree_flatten(like)
    if "__treedef__" in data:
        saved_td = json.loads(bytes(data["__treedef__"]).decode())
        if saved_td != str(treedef):
            raise ValueError(
                f"{path}: checkpoint structure mismatch:\n"
                f"  saved:    {saved_td}\n  expected: {treedef}")
    restored = []
    for i, ref in enumerate(leaves):
        key = f"leaf_{i}"
        if key not in data:
            raise ValueError(f"{path}: missing {key} (incompatible checkpoint)")
        arr = data[key]
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(
                f"{path}: {key} shape {arr.shape} != expected {np.shape(ref)}")
        ref_dtype = np.dtype(getattr(ref, "dtype", np.asarray(ref).dtype))
        if arr.dtype != ref_dtype:
            raise ValueError(
                f"{path}: {key} dtype {arr.dtype} != expected {ref_dtype}")
        restored.append(arr)
    return jax.tree_util.tree_unflatten(treedef, restored)
