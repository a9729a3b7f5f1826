"""Hyperparameter trees: the JAX package's params pytree <-> the port's.

Both packages keep hyperparameters as a dict of log-space values
(``log_lengthscale`` (d,), ``log_signal_var`` (), ``log_noise_var`` (),
plus family extras), or the nested ``terms``/``factors`` dict of a
composite kernel. The port holds fp32 tensors where the JAX package
holds jax arrays; numpy arrays carry weights across. ``sorted_leaves``
and ``ravel_pytree`` take the leaves in jax's tree order (a dict's keys
sorted), so checkpoints and the samplers' flat vectors line up with the
JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply fn to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a nested dict/list/tuple tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree, device):
    """Numpy (or jax, or python-scalar) leaves -> fp32 tensors on device."""
    return tree_map(
        lambda v: torch.from_numpy(np.array(v, np.float32)).to(device), tree)


def params_to_numpy(params):
    """Tensor leaves -> fp32 numpy arrays (same nesting)."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.float32),
                    params)


def sorted_leaves(tree):
    """Leaves in jax's order: sorted dict keys, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in sorted_leaves(v)]
    return [tree]


def unflatten_sorted(example, leaves):
    """example's nesting with its leaves replaced, in sorted_leaves'
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(example)


def ravel_pytree(tree):
    """(flat, unravel) as ``jax.flatten_util.ravel_pytree``: the tensor
    leaves concatenated in jax's order into one vector, and its inverse.
    unravel also takes leading batch dimensions: (..., D) -> leaves of
    shape (..., *leaf shape)."""
    leaves = sorted_leaves(tree)
    shapes = [tuple(t.shape) for t in leaves]
    flat = torch.cat([t.reshape(-1) for t in leaves])

    def unravel(q):
        out, i = [], 0
        for shape in shapes:
            k = int(np.prod(shape, dtype=np.int64))
            out.append(q[..., i:i + k].reshape(q.shape[:-1] + shape))
            i += k
        return unflatten_sorted(tree, out)

    return flat, unravel
