"""Checkpoints: a tree of arrays in one directory, as
``cugp_tpu/utils/checkpoint.py`` writes them.

``arrays.npz`` holds the leaves as ``leaf_<i>`` and ``meta.json`` holds
``num_leaves``, ``step``, ``extra`` and a ``treedef`` string. The leaves
are numbered in jax's tree order: a dict's keys sorted, lists in order,
recursively. So a directory written by either package restores in the
other (the JAX package's ``restore`` reads only ``num_leaves`` of the
meta). ``save`` writes into a temporary directory and swaps it in; a
crash at any point leaves the old or the new checkpoint restorable (the
old one as ``<path>.old`` while the swap is under way). Only rank 0
writes.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from cugp_tpu_torch.utils.params import sorted_leaves, unflatten_sorted


def _treedef(tree):
    """A readable description of the nesting (leaves as '*')."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _rank():
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path, tree, step=None, extra_json=None):
    """Atomically save a tree of arrays (tensors or numpy) to `path`, a
    directory."""
    if _rank() != 0:
        return
    leaves = sorted_leaves(tree)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
        meta = {"treedef": f"PyTreeDef({_treedef(tree)})",
                "num_leaves": len(leaves), "step": step,
                "extra": extra_json or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        # move any existing checkpoint aside (rename, not rmtree), swing
        # tmp into place, then delete the old one: a crash at any point
        # leaves either the old or the new checkpoint restorable
        old = path.rstrip(os.sep) + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)  # stale leftover from a previous crash
        elif os.path.exists(old):
            os.remove(old)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        if os.path.isdir(old):
            shutil.rmtree(old, ignore_errors=True)
        elif os.path.exists(old):
            os.remove(old)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def peek_meta(path):
    """A checkpoint's meta.json without its arrays (from `path`, or from
    its `.old` copy after a crash mid-swap); None when there is none."""
    for p in (path, path.rstrip(os.sep) + ".old"):
        mp = os.path.join(p, "meta.json")
        if os.path.exists(mp) and os.path.exists(os.path.join(p,
                                                              "arrays.npz")):
            with open(mp) as f:
                return json.load(f)
    return None


def restore(path, example_tree):
    """Restore a tree saved by `save`, nested like example_tree, with
    numpy leaves. Returns (tree, meta), or (None, None) when `path` (and
    its `.old` copy) hold no checkpoint."""
    if not os.path.exists(os.path.join(path, "arrays.npz")):
        # a crash mid-swap in save() can leave only the renamed-aside copy
        old = path.rstrip(os.sep) + ".old"
        if os.path.exists(os.path.join(old, "arrays.npz")):
            path = old
        else:
            return None, None
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    n = len(sorted_leaves(example_tree))
    if meta["num_leaves"] != n:
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, "
                         f"example tree has {n}")
    with np.load(os.path.join(path, "arrays.npz")) as blob:
        leaves = [blob[f"leaf_{i}"] for i in range(n)]
    return unflatten_sorted(example_tree, leaves), meta
