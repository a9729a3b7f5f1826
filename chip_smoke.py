#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cugp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, one line of output each (or a few), failing fast with exit 1:
  0. device: card name and power limit (nvidia-smi), torch/CUDA/nvcc
     versions, TF32 off;
  1. build: nvcc compiles the three kernels under cugp_tpu_torch/csrc/;
  2. kernels against their plain PyTorch versions on the card, at the
     shapes of the main path: covariance tile, potrf, TRSM;
  3. main path: GP(kind="rbf", device="cuda").fit / predict /
     log_marginal_likelihood on the config-2 dataset (N=8000, d=4),
     checked against a float64 scipy posterior, with each kernel's launch
     counter read around the run;
  4. north-star shape: covariance + Cholesky at N=32768, d=8, gated on
     the reconstruction error of the first 4096 rows.
The line before the last is a JSON object with each kernel's launches,
error against its plain version and times; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from cugp_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True)
    nvcc_version = nvcc.stdout.strip().splitlines()[-1]
    say("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc_version))
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("TF32 is on")


def phase_build():
    from cugp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        library=so.name)


def _close(got, want, rtol, atol):
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return ok, float(err.max()), float(err.max() / want.abs().max())


def phase_cov(torch, dev, results):
    from cugp_tpu_torch.ops import cov_cuda, kernels

    rng = np.random.default_rng(0)
    rtol = atol = 1e-5
    worst = 0.0

    def scal(diag_add, kind):
        extra = {"rq": 0.7, "linear": 0.3}.get(kind, 1.0)
        return torch.tensor([1.3, diag_add, extra], dtype=torch.float32,
                            device=dev)

    def check(tag, xs1, xs2, kind, square, n1, n2, diag_add):
        nonlocal worst
        s = scal(diag_add, kind)
        got = cov_cuda.cov_tile(xs1, xs2, s, kind, square, n1, n2)
        want = cov_cuda.cov_tile_plain(xs1, xs2, s, kind, square, n1, n2)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"cov {tag}: shape {tuple(got.shape)} or non-finite")
        tol = atol
        if kind == "matern12":
            # exp(-r) has slope -1 at r = 0, and r = sqrt(d2) turns the
            # fp32 rounding of d2 = s1 + s2 - 2 cross (a few eps (s1+s2),
            # summed in another order by each build) into an r error of
            # its square root: near coincident points the bar is
            # sf2 sqrt(8 eps (s1 + s2)), elsewhere rtol = atol = 1e-5
            s12 = ((xs1 * xs1).sum(1)[:, None] + (xs2 * xs2).sum(1)[None, :])
            d2 = (s12 - 2.0 * xs1 @ xs2.T).clamp(min=0.0)
            slack = s[0] * torch.sqrt(8 * 1.1920929e-07 * s12)
            tol = torch.where(d2 < 1e-2, slack, 0.0) + atol
        ok, err, rel = _close(got, want, rtol, tol)
        worst = max(worst, err)
        if not ok:
            fail(f"cov {tag}: max abs err {err:.3e} over rtol=atol={rtol}")
        return f"{err:.3e}/{rel:.3e}"

    X = torch.as_tensor(rng.uniform(-2, 2, (8000, 4)), dtype=torch.float32,
                        device=dev)
    Xc = torch.as_tensor(rng.uniform(-2, 2, (2000, 4)), dtype=torch.float32,
                         device=dev)
    X40 = torch.as_tensor(rng.uniform(-2, 2, (2000, 40)),
                          dtype=torch.float32, device=dev) / 4.0
    for kind in ("rbf", "matern12", "matern32", "matern52", "rq", "linear",
                 "periodic"):
        if kind == "periodic":
            p = {"log_lengthscale": torch.zeros(4, device=dev),
                 "log_period": torch.full((4,), 0.5, device=dev)}
            _, xs, xc = kernels.periodic_rbf_view(p, X, Xc)
            base = "rbf"
        else:
            xs, xc, base = X, Xc, kind
        e_sq = check(f"{kind} square 8000", xs, xs, base, True, 7900, 7900,
                     0.1)
        e_x = check(f"{kind} cross 8000x2000", xs, xc, base, False, 7950,
                    2000, 0.0)
        e_40 = check(f"{kind} square 2000 d=40", X40, X40, base, True, 2000,
                     2000, 0.1)
        say("cov", kind=kind, abs_rel_err_square=e_sq, abs_rel_err_cross=e_x,
            abs_rel_err_d40=e_40)
    s = scal(0.1, "rbf")
    ms = cuda_ms(lambda: cov_cuda.cov_tile(X, X, s, "rbf", True, 8000,
                                           8000))
    plain_ms = cuda_ms(lambda: cov_cuda.cov_tile_plain(X, X, s, "rbf", True,
                                                       8000, 8000))
    say("cov", shape="8000x8000 d=4 rbf", kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", max_abs_err=f"{worst:.3e}")
    results["cov"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _spd(torch, n, dev, seed):
    """G G^T / n + I: eigenvalues in about [1, 5], cond about 5."""
    g = torch.randn(n, n, generator=torch.Generator().manual_seed(seed))
    return (g @ g.T / n + torch.eye(n)).to(dev)


def phase_potrf(torch, dev, results):
    from cugp_tpu_torch.ops import chol_cuda

    worst = 0.0

    def check(tag, L, A):
        nonlocal worst
        ref = torch.linalg.cholesky(A)
        rec = (L @ L.T - A).abs().max() / A.abs().max()
        err = float((L - ref).abs().max())
        worst = max(worst, err)
        if not (rec <= 1e-5 and err <= 1e-4 * float(ref.abs().max())):
            fail(f"potrf {tag}: recon relerr {float(rec):.3e} (bar 1e-5), "
                 f"L err {err:.3e} (bar 1e-4 rel)")
        return float(rec), err

    for n in (1000, 576, 1024):
        A = _spd(torch, n, dev, n)
        garbage = A + torch.triu(torch.full_like(A, 7.0), 1)  # upper ignored
        L = chol_cuda.potrf(garbage)
        torch.cuda.synchronize()
        if float(torch.triu(L, 1).abs().max()) != 0.0:
            fail(f"potrf n={n}: nonzero above the diagonal")
        rec, err = check(f"n={n}", L, A)
        say("potrf", n=n, recon_relerr=f"{rec:.3e}", L_err=f"{err:.3e}")

    # in place on a strided diagonal block of a 2048^2 buffer
    A = _spd(torch, 1024, dev, 7)
    buf = torch.randn(2048, 2048, generator=torch.Generator().manual_seed(1)
                      ).to(dev)
    blk = buf[512:1536, 512:1536]
    blk.copy_(torch.tril(A) + torch.triu(torch.full_like(A, -3.0), 1))
    before = buf.clone()
    chol_cuda.potrf_(blk)
    torch.cuda.synchronize()
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[512:1536, 512:1536] = False
    if not torch.equal(buf[outside], before[outside]):
        fail("potrf in place: wrote outside its block")
    rec, err = check("in place (2048^2 buffer)", blk.clone(), A)
    say("potrf", case="in place, lda=2048", recon_relerr=f"{rec:.3e}",
        L_err=f"{err:.3e}")

    # batch of 3 against a loop: bitwise equal
    As = torch.stack([_spd(torch, 576, dev, 100 + i) for i in range(3)])
    Lb = chol_cuda.potrf(As)
    Ll = torch.stack([chol_cuda.potrf(a) for a in As])
    torch.cuda.synchronize()
    if not torch.equal(Lb, Ll):
        fail("potrf: batched result differs from the looped one")
    say("potrf", case="batch of 3 vs loop", bitwise_equal=True)

    # a block that is not PD factors to NaN, not to clamped garbage
    bad = _spd(torch, 576, dev, 5)
    bad[300, 300] = -50.0
    Lbad = chol_cuda.potrf(bad)
    torch.cuda.synchronize()
    if bool(torch.isfinite(torch.diagonal(Lbad)).all()):
        fail("potrf: a non-PD block gave a finite factor")
    say("potrf", case="non-PD block", nan=True)

    A = _spd(torch, 1024, dev, 11)
    ms = cuda_ms(lambda: chol_cuda.potrf(A))
    plain_ms = cuda_ms(lambda: chol_cuda.potrf_plain(A))
    say("potrf", shape="1024", kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", max_abs_err=f"{worst:.3e}")
    results["potrf"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_trsm(torch, dev, results):
    from cugp_tpu_torch.ops import chol_cuda, trsm_cuda

    worst = 0.0
    gen = torch.Generator().manual_seed(3)
    for n in (1000, 1024):
        L = chol_cuda.potrf(_spd(torch, n, dev, 20 + n))
        for k in (1, 4096):
            for left in (True, False):
                for transpose in (False, True):
                    if left:
                        buf = torch.randn(n + 8, 2 * k, generator=gen)
                        buf = buf.to(dev)
                        B = buf[4:4 + n, ::2]
                    else:
                        buf = torch.randn(2 * k, n + 8, generator=gen)
                        buf = buf.to(dev)
                        B = buf[::2, 4:4 + n]
                    B0 = B.clone()
                    before = buf.clone()
                    trsm_cuda.trsm_(L, B, left, transpose)
                    torch.cuda.synchronize()
                    X = B
                    opL = L.T if transpose else L
                    res = (opL @ X if left else X @ opL) - B0
                    rel = float(res.abs().max() / B0.abs().max())
                    want = trsm_cuda.trsm_plain(L, B0, left, transpose)
                    err = float((X - want).abs().max())
                    worst = max(worst, err)
                    mask = torch.ones_like(buf, dtype=torch.bool)
                    if left:
                        mask[4:4 + n, ::2] = False
                    else:
                        mask[::2, 4:4 + n] = False
                    tag = (f"n={n} k={k} left={left} "
                           f"transpose={transpose}")
                    if not torch.equal(buf[mask], before[mask]):
                        fail(f"trsm {tag}: wrote outside B")
                    if not rel <= 1e-5:
                        fail(f"trsm {tag}: residual {rel:.3e} (bar 1e-5)")
                    say("trsm", case=tag.replace(" ", ","),
                        residual=f"{rel:.3e}", err_vs_plain=f"{err:.3e}")
    L = chol_cuda.potrf(_spd(torch, 1024, dev, 9))
    B = torch.randn(1024, 4096, generator=gen).to(dev)
    ms = cuda_ms(lambda: trsm_cuda.trsm(L, B))
    plain_ms = cuda_ms(lambda: trsm_cuda.trsm_plain(L, B))
    b1 = B[:, :1].contiguous()
    ms1 = cuda_ms(lambda: trsm_cuda.trsm(L, b1))
    plain_ms1 = cuda_ms(lambda: trsm_cuda.trsm_plain(L, b1))
    say("trsm", shape="n=1024 k=4096", kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", k1_kernel_ms=f"{ms1:.4f}",
        k1_plain_ms=f"{plain_ms1:.4f}", max_abs_err=f"{worst:.3e}")
    results["trsm"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _posterior64(params, X, y, Xs, jitter=1e-6):
    """Float64 scipy rbf posterior and LML at the given (numpy) params."""
    from scipy import linalg as sla

    ell = np.exp(np.asarray(params["log_lengthscale"], np.float64))
    sf2 = float(np.exp(params["log_signal_var"]))
    sn2 = float(np.exp(params["log_noise_var"]))

    def k(a, b):
        a, b = a / ell, b / ell
        d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T
        return sf2 * np.exp(-0.5 * np.maximum(d2, 0.0))

    K = k(X, X) + (sn2 + jitter * sf2) * np.eye(len(X))
    cf = sla.cho_factor(K, lower=True)
    alpha = sla.cho_solve(cf, y)
    Ks = k(X, Xs)
    mu = Ks.T @ alpha
    v = sla.solve_triangular(cf[0], Ks, lower=True)
    var = np.maximum(sf2 - (v * v).sum(0), 0.0)
    lml = (-0.5 * y @ alpha - np.log(np.diag(cf[0])).sum()
           - 0.5 * len(y) * np.log(2 * np.pi))
    return mu, var, lml


def phase_main(torch, dev):
    import cugp_tpu_torch
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.ops import chol_cuda, cov_cuda, trsm_cuda
    from cugp_tpu_torch.utils.params import params_to_numpy

    X, y, _ = synthetic.multidim_regression(n=8000, d=4, seed=0)
    Xs = np.random.default_rng(1).uniform(-2.0, 2.0, (2000, 4))
    steps = 10
    # one warm-up step: library handles, kernel loads and the caching
    # allocator's first N^2 buffers are set-up, not step time
    cugp_tpu_torch.GP(kind="rbf", device=dev).fit(X, y, steps=1)
    cov_cuda.LAUNCHES = chol_cuda.LAUNCHES = trsm_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = cugp_tpu_torch.GP(kind="rbf", device=dev)
    info = gp.fit(X, y, steps=steps, learning_rate=0.05)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, var = gp.predict(Xs)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    lml = float(gp.log_marginal_likelihood())
    launches = {"cov": cov_cuda.LAUNCHES, "potrf": chol_cuda.LAUNCHES,
                "trsm": trsm_cuda.LAUNCHES}

    loss = info["loss"].cpu().numpy()
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        fail(f"main path: loss trace {loss.tolist()}")
    mu, var = mu.cpu().numpy(), var.cpu().numpy()
    if mu.shape != (2000,) or var.shape != (2000,):
        fail(f"main path: predict shapes {mu.shape} {var.shape}")
    p64 = params_to_numpy(gp.params)
    mu64, var64, lml64 = _posterior64(p64, X, y, Xs)
    err_mu = float(np.abs(mu - mu64).max())
    err_var = float(np.abs(var - var64).max())
    err_lml = abs(lml - lml64) / len(y)
    say("main", n=len(y), d=X.shape[1], steps=steps,
        s_per_step=f"{t_fit / steps:.4f}", predict_s=f"{t_pred:.4f}",
        loss_first=f"{loss[0]:.4f}", loss_last=f"{loss[-1]:.4f}",
        lml=f"{lml:.4f}", lml64=f"{lml64:.4f}")
    say("main", err_mu=f"{err_mu:.3e}", err_var=f"{err_var:.3e}",
        err_lml_per_point=f"{err_lml:.3e}",
        launches=json.dumps(launches, separators=(",", ":")))
    if not (err_mu <= 1e-3 and err_var <= 1e-3 and err_lml <= 1e-3):
        fail("main path: posterior/LML off the float64 reference by more "
             "than 1e-3")
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path: the {name} kernel was never launched")
    return launches


def phase_north_star(torch, dev):
    from cugp_tpu_torch.ops import cholesky as chol_ops
    from cugp_tpu_torch.ops import kernels

    n, d, nb = 32768, 8, 4096
    X = torch.as_tensor(np.random.default_rng(0).uniform(-2.0, 2.0, (n, d)),
                        dtype=torch.float32, device=dev)
    params = kernels.init_params(d=d, lengthscale=2.0, noise_var=1e-2,
                                 device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t_cov = cuda_ms(lambda: kernels.train_covariance(params, X), iters=3,
                        warmup=1) / 1e3
        K = kernels.train_covariance(params, X)
        t_chol = cuda_ms(lambda: chol_ops.cholesky(K), iters=2,
                         warmup=1) / 1e3
        L = chol_ops.cholesky(K)
        r = L[:nb] @ L[:nb].T - K[:nb, :nb]
        relerr = float(r.abs().max() / K[:nb, :nb].abs().max())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = n ** 3 / 3 + 2 * n ** 2 * d
    say("north_star", n=n, d=d, t_cov_s=f"{t_cov:.5f}",
        t_chol_s=f"{t_chol:.5f}",
        gflops=f"{flops / (t_cov + t_chol) / 1e9:.2f}",
        recon_relerr=f"{relerr:.3e}", peak_bytes=peak)
    if not relerr < 2e-4:
        fail(f"north star: reconstruction relerr {relerr:.3e} (gate 2e-4)")


KERNELS = {
    "cov": ("cugp_tpu_torch/csrc/cov.cu", "cugp_tpu/ops/cov_pallas.py:48"),
    "potrf": ("cugp_tpu_torch/csrc/potrf.cu",
              "cugp_tpu/ops/chol_pallas.py:91"),
    "trsm": ("cugp_tpu_torch/csrc/trsm.cu",
             "cugp_tpu/ops/trsm_pallas.py:35"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    try:
        import cugp_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import cugp_tpu_torch beside this script: {e}")
    dev = torch.device("cuda", 0)
    phase_device(torch)
    phase_build()
    results = {}
    phase_cov(torch, dev, results)
    phase_potrf(torch, dev, results)
    phase_trsm(torch, dev, results)
    launches = phase_main(torch, dev)
    phase_north_star(torch, dev)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
