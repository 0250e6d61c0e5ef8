"""Checkpoints in the JAX package's format (``train/checkpoint.py``), without
JAX: one ``.npz`` of leaves ``leaf_0 .. leaf_{n-1}`` in JAX's flatten order
(dict keys sorted, lists by index) plus a ``.json`` sidecar with each leaf's
key path (``['decoder']/['ode']/['dyn_hidden']/['W']``, ``[0]`` for a list
item), the tree structure as JAX prints it, and metadata.

A checkpoint written by either package restores in the other. Trees here are
in the JAX layout (nested dicts and lists of numpy arrays or tensors);
``interop.py`` converts them to and from the port's parameters.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}/[{i}]" if prefix else f"[{i}]")
        return out
    return [(prefix, tree)]


def _structure(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def _to_numpy(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **{f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)})
    side = {
        "paths": [p for p, _ in flat],
        "treedef": f"PyTreeDef({_structure(tree)})",
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(side, f)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (leaves need only a shape).

    Checked structurally as the JAX package checks it: the stored key paths
    are compared with ``like``'s and the first differing path is named in the
    error; then shapes leaf by leaf. Returns numpy leaves.
    """
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    ref = _flatten(like)
    ref_paths = [p for p, _ in ref]
    try:
        with open(path + ".json") as f:
            stored_paths = json.load(f).get("paths")
    except FileNotFoundError:
        stored_paths = None
    if stored_paths is not None:
        for i, (sp, rp) in enumerate(zip(stored_paths, ref_paths)):
            if sp != rp:
                raise ValueError(
                    f"checkpoint structure mismatch at leaf {i}: stored path "
                    f"{sp!r} != expected {rp!r}"
                )
        if len(stored_paths) > len(ref_paths):
            raise ValueError(
                f"checkpoint has {len(stored_paths)} leaves, expected "
                f"{len(ref_paths)}; first unexpected stored path: "
                f"{stored_paths[len(ref_paths)]!r}"
            )
        if len(stored_paths) < len(ref_paths):
            raise ValueError(
                f"checkpoint has {len(stored_paths)} leaves, expected "
                f"{len(ref_paths)}; first missing path: "
                f"{ref_paths[len(stored_paths)]!r}"
            )
    if len(leaves) != len(ref):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected {len(ref)}")
    for i, (a, (p, b)) in enumerate(zip(leaves, ref)):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"leaf {i} ({p}) shape {a.shape} != expected {tuple(b.shape)}")
    return _unflatten(like, iter(leaves))
