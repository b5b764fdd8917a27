"""Checkpoint / resume of solver state.

The reference has no checkpointing (SURVEY.md §5: persistence is limited
to output viewers); for a production deployment, solver state is
(mesh tree, partition parameters, current iterate / interface vectors) —
all trivially serializable.  Format: a single ``.npz`` with the tree
serialized via its binary format plus the patch arrays.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from .geometry import Tree


def _tree_bytes(tree: Tree) -> bytes:
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        path = f.name
    try:
        tree.to_file(path)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def save_checkpoint(
    path: str,
    tree: Tree,
    n: int,
    arrays: Dict[str, np.ndarray],
    meta: Optional[Dict] = None,
) -> None:
    """Write solver state: mesh + patch-cell arrays (u, f, gamma, ...)."""
    payload = {f"array_{k}": np.asarray(v) for k, v in arrays.items()}
    payload["tree"] = np.frombuffer(_tree_bytes(tree), dtype=np.uint8)
    payload["D"] = np.int64(tree.D)
    payload["n"] = np.int64(n)
    if meta:
        for k, v in meta.items():
            payload[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str) -> Tuple[Tree, int, Dict[str, np.ndarray], Dict]:
    """Read back (tree, n, arrays, meta)."""
    import tempfile

    data = np.load(path)
    D = int(data["D"])
    n = int(data["n"])
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(data["tree"].tobytes())
        tree_path = f.name
    try:
        tree = Tree.from_file(tree_path, D)
    finally:
        os.unlink(tree_path)
    arrays = {
        k[len("array_"):]: data[k] for k in data.files if k.startswith("array_")
    }
    meta = {k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")}
    return tree, n, arrays, meta
