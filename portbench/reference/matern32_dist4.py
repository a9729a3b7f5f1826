"""Exact GP regression with an ARD Matern-3/2 kernel in float64, spread
over several devices from one process: ``matern32.lml_and_grad`` at sizes
whose float64 covariance fits no single card.

The equations are matern32's (its ``unpack``, ``unit_kernel`` and the
gradient sum of ``grad_from_w``); only the lower triangle of each n x n
quantity is held, in square tiles placed on the devices in a 2D cyclic
pattern, tile (i, j) on device ``(i % 2) * 2 + j % 2`` of four. One
buffer of tiles is K, then its factor L (a right-looking tiled
Cholesky), then W = L^-1 (a right-looking tiled triangular inverse), then
K^-1 = W^T W (its lower tiles), each tile computed on its own device from
copies (``.to()``) of the column or row it needs; the gradient is
1/2 sum_ik (a a^T - K^-1)_ik dK_ik/dt, the tiles below the diagonal
counted twice for the mirrored ones above. No collective, no process
group: every copy goes through the one process, and the devices run
concurrently because each launch returns at once. TF32 plays no part:
everything is float64. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference import matern32

F64 = torch.float64


class _Tiles:
    """The lower tiles of an n x n matrix: edges[i]..edges[i + 1] are
    tile i's rows, tile (i, j) (i >= j) lives on device dev(i, j)."""

    def __init__(self, n, tile, devices):
        self.edges = list(range(0, n, tile)) + [n]
        self.nt = len(self.edges) - 1
        self.devices = [torch.device(d) for d in devices]
        self.t = {}

    def dev(self, i, j):
        if len(self.devices) == 1:
            return self.devices[0]
        return self.devices[((i % 2) * 2 + j % 2) % len(self.devices)]

    def rows(self, i):
        return slice(self.edges[i], self.edges[i + 1])


def _on(copies, key, dev):
    """Tile `key` of `copies` on `dev`: its home copy there, or one copy
    made the first time it is asked for."""
    got = copies.get((key, dev))
    if got is None:
        home = copies[key]
        got = home if home.device == dev else home.to(dev)
        copies[key, dev] = got
    return got


def _covariance(T, Xs, sf2, diag):
    X_on = {d: Xs.to(d) for d in set(T.devices)}
    for i in range(T.nt):
        for j in range(i + 1):
            d = T.dev(i, j)
            k = sf2.to(d) * matern32.unit_kernel(X_on[d][T.rows(i)],
                                                 X_on[d][T.rows(j)])
            if i == j:
                k.diagonal().add_(diag.to(d))
            T.t[i, j] = k


def _cholesky(T):
    """L in place of K's lower tiles (right-looking)."""
    for k in range(T.nt):
        lkk = torch.linalg.cholesky_ex(T.t[k, k])[0]
        T.t[k, k] = lkk
        col = {(k, k): lkk}
        for i in range(k + 1, T.nt):
            d = T.dev(i, k)
            T.t[i, k] = torch.linalg.solve_triangular(
                _on(col, (k, k), d).mT, T.t[i, k], upper=True,
                left=False)
            col[i, k] = T.t[i, k]
        for i in range(k + 1, T.nt):
            for j in range(k + 1, i + 1):
                d = T.dev(i, j)
                T.t[i, j].sub_(_on(col, (i, k), d)
                               @ _on(col, (j, k), d).mT)


def _trtri(T):
    """W = L^-1 in place of L's lower tiles: row k of W is L_kk^-1
    B[k, :k+1], then B[i>k, :k+1] -= L[i, k] W[k, :k+1] (B the identity
    so updated)."""
    for k in range(T.nt):
        col = {(i, k): T.t[i, k] for i in range(k, T.nt)}
        for i in range(k + 1, T.nt):
            T.t[i, k] = torch.zeros_like(T.t[i, k])
        lkk = col[k, k]
        eye = torch.eye(lkk.shape[0], dtype=F64, device=lkk.device)
        T.t[k, k] = eye
        row = {}
        for j in range(k + 1):
            d = T.dev(k, j)
            T.t[k, j] = torch.linalg.solve_triangular(
                _on(col, (k, k), d), T.t[k, j], upper=False)
            row[k, j] = T.t[k, j]
        for i in range(k + 1, T.nt):
            for j in range(k + 1):
                d = T.dev(i, j)
                T.t[i, j].sub_(_on(col, (i, k), d)
                               @ _on(row, (k, j), d))


def _lauum(T):
    """The lower tiles of W^T W in place of W's: step l adds W[l, i]^T
    W[l, j] to each tile j <= i <= l."""
    for l in range(T.nt):
        row = {(l, j): T.t[l, j] for j in range(l + 1)}
        for j in range(l + 1):
            T.t[l, j] = torch.zeros_like(T.t[l, j])
        for i in range(l + 1):
            for j in range(i + 1):
                d = T.dev(i, j)
                T.t[i, j].add_(_on(row, (l, i), d).mT
                               @ _on(row, (l, j), d))


def lml_and_grad(X, y, params, jitter, devices, tile=8192):
    """(LML, its exact gradient) in float64, as matern32.lml_and_grad,
    with the n x n work in lower tiles of `tile` rows spread over
    `devices` (four CUDA devices, or "cpu" four times in the tests)."""
    dev0 = torch.device(devices[0])
    ell, sf2, sn2 = matern32.unpack(params, dev0)
    Xs = X.to(dev0, F64) / ell
    y64 = y.to(dev0, F64)
    n = Xs.shape[0]
    T = _Tiles(n, tile, devices)
    _covariance(T, Xs, sf2, sn2 + jitter * sf2)
    _cholesky(T)
    # a = L^-T L^-1 y by tile substitution: each tile's product on its
    # device, the diagonal solves on dev0
    def vec_on(v, i, dv):
        return v[T.rows(i)].to(dv)

    z = y64.clone()
    for i in range(T.nt):
        for j in range(i):
            z[T.rows(i)] -= (T.t[i, j] @ vec_on(z, j, T.dev(i, j))).to(dev0)
        z[T.rows(i)] = torch.linalg.solve_triangular(
            T.t[i, i].to(dev0), z[T.rows(i), None], upper=False)[:, 0]
    logdet_half = sum(torch.log(T.t[i, i].diagonal()).sum().to(dev0)
                      for i in range(T.nt))
    lml = float(-0.5 * torch.dot(z, z) - logdet_half
                - 0.5 * n * matern32.LOG2PI)
    a = z.clone()
    for i in range(T.nt - 1, -1, -1):
        for j in range(i + 1, T.nt):
            a[T.rows(i)] -= (T.t[j, i].mT
                             @ vec_on(a, j, T.dev(j, i))).to(dev0)
        a[T.rows(i)] = torch.linalg.solve_triangular(
            T.t[i, i].to(dev0).mT, a[T.rows(i), None], upper=True)[:, 0]
    _trtri(T)
    _lauum(T)
    d = Xs.shape[1]
    g_ell = torch.zeros(d, dtype=F64, device=dev0)
    s_k = torch.zeros((), dtype=F64, device=dev0)
    trace_w = torch.dot(a, a)
    parts = []
    for i in range(T.nt):
        for j in range(i + 1):
            dv = T.dev(i, j)
            ri, rj = T.rows(i), T.rows(j)
            xi, xj = Xs[ri].to(dv), Xs[rj].to(dv)
            W = a[ri].to(dv)[:, None] * a[rj].to(dv)[None, :] - T.t[i, j]
            if i == j:
                trace_w = trace_w - T.t[i, j].diagonal().sum().to(dev0)
            W = W * (2.0 if i > j else 1.0)
            s = matern32.SQRT3 * matern32._dist(xi, xj)
            e = torch.exp(-s)
            WE = W * (3.0 * e)
            parts.append(((W * ((1.0 + s) * e)).sum(),
                          (xi * xi * WE.sum(1)[:, None]).sum(0)
                          + (xj * xj).T @ WE.sum(0)
                          - 2.0 * (xi * (WE @ xj)).sum(0)))
    for sk, ge in parts:
        s_k += sk.to(dev0)
        g_ell += ge.to(dev0)
    T.t.clear()
    grad = {"log_lengthscale": 0.5 * sf2 * g_ell,
            "log_signal_var": 0.5 * (sf2 * s_k + jitter * sf2 * trace_w),
            "log_noise_var": 0.5 * sn2 * trace_w}
    return lml, grad
