"""Pytree checkpointing for long batched runs (the port of
`dftpav_tpu/utils/checkpoint.py`).

A tree of tensors or arrays (NamedTuples, tuples, lists, dicts; scenario
batches, SolveResults, replan state) is saved as a flat `.npz` whose leaves
are named `leaf_{i}`, with a `.json` sidecar holding `n_leaves` and
`metadata`. The `.npz` is the JAX package's; its sidecar also holds a
`treedef` string, which neither loader reads and this one does not write,
so the sidecar's keys here are a subset of JAX's. A checkpoint written by
either package loads in the other. Leaves are numbered in
`jax.tree.flatten`'s order: containers in field order, dict keys sorted
(an OrderedDict in its own order), and None an empty subtree, not a leaf.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _keys(d):
    return list(d) if isinstance(d, collections.OrderedDict) else sorted(d)


def tree_flatten(tree) -> list:
    """The leaves of `tree` in jax.tree.flatten's order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_flatten(x)]
    if isinstance(tree, dict):
        return [leaf for k in _keys(tree) for leaf in tree_flatten(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as `like` whose leaves are taken in order from the
    iterator `leaves`."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(tree_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(tree_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        out = {k: tree_unflatten(like[k], leaves) for k in _keys(like)}
        return type(like)((k, out[k]) for k in like)
    return next(leaves)


def _to_numpy(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree, metadata: dict | None = None):
    """Save a tree of tensors or arrays to `path` (.npz) and `path`.json
    (the leaf count and metadata)."""
    leaves = tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    np.savez_compressed(path, **arrays)
    side = dict(n_leaves=len(leaves), metadata=metadata or {})
    with open(path + ".json", "w") as f:
        json.dump(side, f)


def load_pytree(path: str, like):
    """Load a tree saved by save_pytree (of either package); `like` gives
    the structure (an example tree of the same shape, e.g. the object being
    resumed). A leaf whose counterpart in `like` is a tensor comes back as
    a tensor on that tensor's device, every other leaf as a numpy array.
    Returns (tree, metadata)."""
    if not path.endswith(".npz"):
        path_npz = path + ".npz" if os.path.exists(path + ".npz") else path
    else:
        path_npz = path
    with np.load(path_npz) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    like_leaves = tree_flatten(like)
    if len(arrays) != len(like_leaves):
        raise ValueError(f"{path_npz}: {len(arrays)} leaves, the structure "
                         f"given has {len(like_leaves)}")
    leaves = [torch.from_numpy(a).to(l.device) if torch.is_tensor(l) else a
              for a, l in zip(arrays, like_leaves)]
    meta = {}
    # the sidecar is the saved path + ".json": "x.npz.json" for "x.npz",
    # "x.json" for "x" (JAX's loader looks only for the first)
    for cand in (path_npz + ".json", path + ".json"):
        if os.path.exists(cand):
            with open(cand) as f:
                meta = json.load(f).get("metadata", {})
            break
    return tree_unflatten(like, iter(leaves)), meta
