"""Hyperparameter trees: the JAX package's params pytree <-> the port's.

Both packages keep hyperparameters as a dict of log-space values
(``log_lengthscale`` (d,), ``log_signal_var`` (), ``log_noise_var`` (),
plus family extras), or the nested ``terms``/``factors`` dict of a
composite kernel. The port holds fp32 tensors where the JAX package
holds jax arrays; numpy arrays carry weights across.
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
