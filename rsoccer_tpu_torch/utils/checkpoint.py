"""Checkpoints in the JAX package's ``.npz`` format, read and written
without jax.

Port of ``rsoccer_tpu/utils/checkpoint.py``.  A checkpoint is an ``.npz``
of positional arrays ``leaf_0 .. leaf_{n-1}``, the leaves of a tree in
the JAX leaf order: dict keys sorted, tuple, list and NamedTuple fields in
order, ``None`` an empty subtree.  :func:`save` writes that file for a
tree of tensors or arrays; :func:`restore` fills the structure of ``like``
from one.  The JAX package's ``save`` also pickles its jax ``PyTreeDef``
beside the file; unpickling one needs jax, so here none is written or
read: the structure always comes from ``like``.  The JAX package's
``restore(path, like=...)`` reads a file written here as it stands.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def flatten(tree: Any) -> list:
    """Leaves of ``tree`` in the JAX leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in flatten(sub)]
    return [tree]


def unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure filled with ``leaves`` (JAX leaf order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(sub) for sub in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    n_like = len(flatten(like))
    if n_like != len(leaves):
        raise ValueError(f"the tree has {n_like} leaves, the checkpoint {len(leaves)}")
    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any) -> None:
    """Save a tree of tensors or arrays to ``path`` (``.npz`` appended
    unless given)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        _npz_path(path),
        **{f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(flatten(tree))},
    )


def load_leaves(path: str) -> list[np.ndarray]:
    """The positional leaves of a checkpoint, as numpy arrays."""
    with np.load(_npz_path(path)) as npz:
        return [npz[f"leaf_{i}"] for i in range(len(npz.files))]


def restore(path: str, like: Any) -> Any:
    """Restore a checkpoint into ``like``'s structure.  Where ``like`` holds
    a tensor the leaf comes back as a tensor on that tensor's device (with
    the file's dtype), elsewhere as a numpy array."""
    leaves = load_leaves(path)
    like_leaves = flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"{path}: {len(leaves)} leaves, the tree to restore into has {len(like_leaves)}"
        )
    leaves = [
        torch.from_numpy(arr).to(ref.device) if isinstance(ref, torch.Tensor) else arr
        for arr, ref in zip(leaves, like_leaves)
    ]
    return unflatten(like, leaves)
