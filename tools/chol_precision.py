#!/usr/bin/env python3
"""The Cholesky precision policies at the north-star shape, row block by
row block.

    python3 tools/chol_precision.py [--n=32768] [--emulate] [--block=4096]
                                    [--profile] [--k-chunk=0,4096]

Builds bench.py's north-star covariance (X ~ U(-2, 2)^8 from numpy seed
0, rbf, lengthscale 2, noise 1e-2) on the card, factors it under each
policy (None, "high", "mixed", "mixed_fast"; ops/cholesky.py) and prints,
a line each: the factor's time (CUDA events, median of 2), whether it is
finite, its first non-finite row, its smallest diagonal entry, and the
reconstruction error of every row block of `--block` rows, max |L L^T -
K| over max |K| on that block row (chip_smoke.py phase 4 reads the first
block only). --emulate runs the policies' TF32 GEMMs in fp32 on the same
TF32-rounded operands (the CPU's emulation), to split the tensor cores'
own accumulation from the operand rounding. --k-chunk runs the TF32
policies once for each given trsm.TF32_K_CHUNK (0: the whole k in one
GEMM; default: the module's). --profile adds each policy's device time
by kernel for one factorization (chip_smoke.profile_device). Needs one
CUDA card.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import sys

import numpy as np


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cugp_tpu_torch.ops import cholesky as chol_ops
    from cugp_tpu_torch.ops import kernels
    from cugp_tpu_torch.ops import trsm as trsm_ops

    import chip_smoke

    opts = dict(a.split("=", 1) if "=" in a else (a, "1") for a in argv)
    n, d = int(opts.get("--n", 32768)), 8
    nb = int(opts.get("--block", 4096))
    if "--emulate" in opts:
        trsm_ops.tf32_matmul = contextlib.nullcontext
    chunks = [int(c) for c in opts.get(
        "--k-chunk", str(trsm_ops.TF32_K_CHUNK)).split(",")]
    dev = torch.device("cuda", 0)
    X = torch.as_tensor(np.random.default_rng(0).uniform(-2.0, 2.0, (n, d)),
                        dtype=torch.float32, device=dev)
    params = kernels.init_params(d=d, lengthscale=2.0, noise_var=1e-2,
                                 device=dev)
    with torch.no_grad():
        K = kernels.train_covariance(params, X)
        kmax = float(K.abs().max())
        runs = [(None, chunks[0])] + [(p, c) for c in chunks
                                      for p in ("high", "mixed", "mixed_fast")]
        for policy, chunk in runs:
            trsm_ops.TF32_K_CHUNK = chunk or n
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                L = chol_ops.cholesky(K, precision=policy)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            bad = ~torch.isfinite(L).all(dim=1)
            first_bad = (int(torch.nonzero(bad)[0]) if bool(bad.any())
                         else -1)
            errs = []
            for r0 in range(0, n, nb):
                r1 = min(r0 + nb, n)
                res = L[r0:r1, :r1] @ L[:r1, :r1].T - K[r0:r1, :r1]
                errs.append(float(res.abs().max()) / kmax)
                del res
            print(f"[chol_precision] n={n} policy={policy} k_chunk={chunk} "
                  f"emulate={'--emulate' in opts} t_chol_s="
                  f"{statistics.median(times[1:]):.5f} finite="
                  f"{first_bad < 0} first_nonfinite_row={first_bad} "
                  f"min_diag={float(torch.diagonal(L).min()):.4e} "
                  f"block_relerr=" + ",".join(f"{e:.3e}" for e in errs),
                  flush=True)
            del L
            if "--profile" in opts:
                chip_smoke.profile_device(
                    torch, f"profile_chol_{policy}",
                    lambda: chol_ops.cholesky(K, precision=policy))
    print(f"[chol_precision] card={torch.cuda.get_device_name(0)} "
          f"allow_tf32_after={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
