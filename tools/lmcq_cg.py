#!/usr/bin/env python3
"""How many CG iterations the matrix-free rank-Q LMC's solves need at
benchmarks/bench_lmcq.py's configuration.

    python3 tools/lmcq_cg.py [--n=32768] [--max-iters=6000] [--every=50]
                             [--mc=0,32,128] [--tol=1e-4] [--device=cuda]
                             [--jax]

Builds chip_smoke.py phase 10(c)'s problem (bench_lmcq's make_data at n,
d=2, p=2; rbf + matern32 latents at lengthscale 1.2, noise 0.05, init
seed 0) and runs conjugate gradients on its joint operator
(models/lmc.make_lmcq_matvec, inference/iterative.py's CG steps, no
preconditioner, as the model's solves) for each --mc: 0 is the mean
solve (r = 1), mc > 0 the cross columns of the first mc test points
X[:mc] + 0.05 (r = 2 mc, one predict_iterative chunk). Every --every
iterations it prints the largest column's relative residual (the
recursive one CG's loop tests) and the seconds so far; a solve stops at
--tol or --max-iters. For the mean solve it then prints the true
relative residual recomputed without the kernel
(chip_smoke._lmcq_plain_matvec). --device=cpu runs the plain versions
(a rehearsal at small n). --jax (beside the JAX package, on the CPU)
also runs the JAX package's cg_solve on its own make_lmcq_matvec for the
mean solve, at the same params, tol and cap, and prints its count and
true residual: whether the count is the operator's or the port's.
"""

from __future__ import annotations

import os
import sys
import time


def main(argv):
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cugp_tpu_torch.inference import iterative
    from cugp_tpu_torch.models import lmc

    import chip_smoke

    opts = dict(a.split("=", 1) if "=" in a else (a, "1") for a in argv)
    n = int(opts.get("--n", 32768))
    max_iters = int(opts.get("--max-iters", 6000))
    every = int(opts.get("--every", 50))
    tol = float(opts.get("--tol", 1e-4))
    dev = torch.device(opts.get("--device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: needs a CUDA device (or --device=cpu)", flush=True)
        return 1

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    kinds = chip_smoke.LMCQ_KINDS
    X, Y = chip_smoke._bench_lmcq_data(n, 2, 2, seed=0)
    X = torch.as_tensor(X, device=dev)
    Y = torch.as_tensor(Y, device=dev)
    params = lmc.init_lmcq_params(d=2, p=2, kinds=kinds, lengthscale=1.2,
                                  noise_var=0.05, seed=0, device=dev)
    if dev.type == "cuda":
        print(chip_smoke.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    with torch.no_grad():
        mv = lmc.make_lmcq_matvec(params, X, kinds)
        for mc in (int(m) for m in opts.get("--mc", "0,32,128").split(",")):
            b = (Y.mT.reshape(-1, 1) if mc == 0 else lmc.lmcq_covariance(
                params, X, X[:mc] + 0.05, kinds))
            bnorm = torch.linalg.vector_norm(b, dim=0)
            s = iterative.cg_init(b)
            sync()
            t0 = time.perf_counter()
            while s.it < max_iters:
                s = iterative.cg_segment(mv, s, min(every, max_iters - s.it))
                rel = float((torch.linalg.vector_norm(s.r, dim=0)
                             / bnorm).max())
                sync()
                print(f"[lmcq_cg] n={n} r={b.shape[1]} it={s.it} "
                      f"max_rel_residual={rel:.3e} "
                      f"seconds={time.perf_counter() - t0:.3f}", flush=True)
                if rel <= tol:
                    break
            if mc == 0:
                res = b - chip_smoke._lmcq_plain_matvec(torch, params, X,
                                                        kinds, s.x)
                true = float(torch.linalg.vector_norm(res) / bnorm[0])
                print(f"[lmcq_cg] n={n} r=1 it={s.it} true_rel_residual="
                      f"{true:.3e} (recomputed without the kernel)",
                      flush=True)
                if "--jax" in opts:
                    jax_mean_solve(params, X, kinds, b[:, 0], tol, max_iters,
                                   bnorm[0])
    return 0


def jax_mean_solve(params, X, kinds, b, tol, max_iters, bnorm):
    """The JAX package's CG on its own joint operator (blocked XLA
    route), on the CPU; its true residual recomputed as the port's."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from cugp_tpu.inference import iterative as jiterative
    from cugp_tpu.models import lmc as jlmc
    from cugp_tpu_torch.utils.params import params_to_numpy

    import chip_smoke

    mv = jlmc.make_lmcq_matvec(jax.tree.map(jnp.asarray,
                                            params_to_numpy(params)),
                               jnp.asarray(X.cpu().numpy()), kinds)
    t0 = time.perf_counter()
    x, it = jax.jit(lambda v: jiterative.cg_solve(
        mv, v, tol=tol, max_iters=max_iters))(jnp.asarray(b.cpu().numpy()))
    x = torch.as_tensor(np.asarray(x), device=X.device)
    res = b - chip_smoke._lmcq_plain_matvec(torch, params, X, kinds, x)[:, 0]
    print(f"[lmcq_cg] n={X.shape[0]} r=1 jax it={int(it)} true_rel_residual="
          f"{float(torch.linalg.vector_norm(res) / bnorm):.3e} "
          f"seconds={time.perf_counter() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
