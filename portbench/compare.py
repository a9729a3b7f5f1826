"""The comparisons that decide ``correct``, and the limits they are held
to (``limits/<workload>.json``: each number's limit beside the readings
it was set from)."""

from __future__ import annotations

import json
import math
import pathlib
import statistics

import torch

LIMITS_DIR = pathlib.Path(__file__).resolve().parent / "limits"


def load_limits(workload):
    with open(LIMITS_DIR / f"{workload}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def _norm(t):
    return float(torch.linalg.vector_norm(
        torch.as_tensor(t, dtype=torch.float64).reshape(-1).cpu()))


def components(tree):
    """The hyperparameters one by one: a leaf of one number keeps its
    name, and each entry i of a wider leaf (the ARD lengthscales) becomes
    ``name[i]``, so a gradient handed to the wrong dimension changes the
    norms compared."""
    out = {}
    for k, v in tree.items():
        flat = torch.as_tensor(v).detach().reshape(-1)
        if flat.numel() == 1:
            out[k] = flat
        else:
            out.update({f"{k}[{i}]": flat[i:i + 1]
                        for i in range(flat.numel())})
    return out


def leaf_norm_gap(prog, ref, leaves=None):
    """Worst hyperparameter of | ||prog_leaf|| - ||ref_leaf|| | over the
    larger of the reference's norm of that leaf and of the median leaf,
    with each lengthscale a leaf of its own (``components``). prog and
    ref: dicts of tensors by leaf name; `leaves` restricts the names
    (of ``components``)."""
    prog, ref = components(prog), components(ref)
    names = list(ref) if leaves is None else list(leaves)
    norms = {k: _norm(ref[k]) for k in ref}
    median = statistics.median(norms.values())
    worst = 0.0
    for k in names:
        if k not in prog:
            return math.inf
        gap = abs(_norm(prog[k]) - norms[k]) / max(norms[k], median, 1e-300)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def moved_leaves(ref_grad):
    """Leaves (of ``components``) whose reference gradient is above a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone."""
    norms = {k: _norm(v) for k, v in components(ref_grad).items()}
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v > 1e-3 * median]


def rel_gap(a, b):
    a, b = float(a), float(b)
    gap = abs(a - b) / max(abs(b), 1e-300)
    return gap if math.isfinite(gap) else math.inf


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number finite and at most
    its limit; a number without a limit fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name, math.nan)
        value = float(value)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
