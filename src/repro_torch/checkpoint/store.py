"""Tree store: one ``.npy`` a leaf and a JSON manifest (port of
``repro/checkpoint/store.py``, the same format).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars (None holds no leaf).  Leaves are numbered in JAX's
pytree order, dict keys sorted, so a checkpoint either package writes
loads in the other: ``leaf_NNNNN.npy`` files and a ``manifest.json`` of
``{"leaves": [{"path", "file", "dtype"}, ...]}``, paths as "/"-joined
keys and indices.  numpy has no bfloat16, so bf16 leaves are stored as
their uint16 bits with the tag "bfloat16".
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_SCALARS = (bool, int, float, np.generic)


def _flatten(tree, path=()) -> list:
    """``(path, leaf)`` pairs in JAX's order."""
    if tree is None:
        return []
    if type(tree) is dict:
        return [x for k in sorted(tree) for x in _flatten(tree[k],
                                                          path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (i,))]
    if not isinstance(tree, (torch.Tensor, np.ndarray) + _SCALARS):
        raise TypeError(f"checkpoint leaf at {'/'.join(map(str, path))!r} "
                        f"is a {type(tree).__name__}, not a tensor, array "
                        "or scalar")
    return [(path, tree)]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves`` (dict keys consumed sorted, kept in ``like``'s
    order)."""
    if like is None:
        return None
    if type(like) is dict:
        vals = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    return _rebuild(tree, iter([fn(x) for _, x in _flatten(tree)]))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    return [x for _, x in _flatten(tree)]


def tree_items(tree) -> list:
    """``(path, leaf)`` pairs in ``tree_leaves`` order; a path is the
    "/"-joined keys and indices (the manifest's)."""
    return [("/".join(map(str, p)), x) for p, x in _flatten(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    return _rebuild(like, iter(leaves))


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree, directory: str) -> None:
    """Write ``tree``'s leaves and manifest into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr, tag = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(directory, fname), arr, allow_pickle=False)
        manifest["leaves"].append({"path": "/".join(map(str, path)),
                                   "file": fname, "dtype": tag})
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_pytree(tree_like, directory: str):
    """The tree in ``directory``, in the structure of ``tree_like`` (same
    leaf order).  A leaf comes back as a tensor on the device of a tensor
    leaf of ``tree_like``, else as a numpy array (a bf16 leaf always as a
    tensor: numpy has no bfloat16)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        specs = json.load(f)["leaves"]
    likes = _flatten(tree_like)
    if len(likes) != len(specs):
        raise ValueError(f"leaf count mismatch: {len(likes)} in the tree, "
                         f"{len(specs)} in {directory}")
    out = []
    for spec, (_, like) in zip(specs, likes):
        arr = np.load(os.path.join(directory, spec["file"]),
                      allow_pickle=False)
        if spec["dtype"] == "bfloat16":
            leaf = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        elif isinstance(like, torch.Tensor):
            leaf = torch.from_numpy(arr)
        else:
            leaf = arr
        if isinstance(like, torch.Tensor):
            leaf = leaf.to(like.device)
        out.append(leaf)
    return _rebuild(tree_like, iter(out))
