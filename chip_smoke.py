#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cugp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phases=3,5 --profile   # a subset, profiled

Phases, one line of output each (or a few), failing fast with exit 1:
  0. device: card name and power limit (nvidia-smi), torch/CUDA/nvcc
     versions, TF32 off;
  1. build: nvcc compiles the kernels under cugp_tpu_torch/csrc/ (one
     process a source, in parallel) and ptxas reports the registers and
     spills of every kernel, a line each;
  2. kernels against their plain PyTorch versions on the card, at the
     shapes of the main paths: covariance tile (all kinds, square and
     cross, ragged 1000x777, d = 1, 4, 8, 40, against the plain version
     in fp32 and in float64, repeats and both store routes bitwise, the
     rbf diagonal exactly sf2 + diag_add, a row block built alone
     bitwise equal to the same rows of a larger build; timed at the four
     main-path shapes beside fill_ms, out.fill_(1.0) on an output of the
     same size), potrf (the grid it takes, small and ragged n, in place,
     batches and repeats bitwise, NaN on a non-PD block, a time per
     base-block size), TRSM (both routes,
     ragged n, k across the narrow/wide threshold, both sides, a stale
     upper triangle, an odd leading dimension, strided in place, repeats
     and slab widths bitwise) and the fused covariance matvec (all kinds
     at d = 4 and 40, r across the route and RC boundaries, strided V,
     repeats bitwise, the narrow route's columns bitwise independent of
     r; timed by route at N=100,000, with the linear kind beside rbf),
     each beside its bound and, where one exists, the one PyTorch call
     that computes the same function; then the batched launches of the
     covariance tile, potrf and TRSM (B = 1, 7, 256; n = 512 and 500;
     TRSM at k = 1, 16, 17, 512, both transposes, right-side and vector
     right-hand sides at B = 7): each bitwise equal to the loop over its
     elements and within the plain version's bars, potrf's cooperative
     and batch routes bitwise equal (the route each B takes printed, the
     two timed by B), a non-PD element NaN in its block only; config 3's
     shapes timed beside the loop, the batched library call and the
     bound; and the batched matvec (B = 1, 7, 8; n = 32768 and 5000,
     d = 1; r = 1, 17 narrow and 128 wide): each element bitwise its
     2-D launch and within the plain version's bar, timed at B=8,
     n=32768, r=17 beside the loop of 2-D launches and the plain
     version;
  3. dense path: GP(kind="rbf", device="cuda").fit / predict /
     log_marginal_likelihood on the config-2 dataset (N=8000, d=4),
     checked against the float64 oracle (the port's copy), with each
     kernel's launch counter read around the run;
  4. north-star shape: covariance + Cholesky at N=32768, d=8, gated on
     the reconstruction error of the first 4096 rows; then the opt-in
     precision policies ("high", "mixed", "mixed_fast"): time, GFLOP/s,
     that error and finiteness each, "high" and "mixed" gated at 2e-4
     and finite; the default factor bitwise unchanged after them and
     TF32 off;
  5. matrix-free path at N=100,000, d=4: GP.fit_iterative (3 steps after
     a warm-up step), predict_iterative (128 test points, gated on the
     mean solve's residual recomputed without the kernel) and
     log_marginal_likelihood_iterative, launch counters read around
     them; then, on the first 16,384 rows, the iterative posterior and
     LML against the dense path; the fit step's [y | z] solve at the
     fitted params timed on both CG routes (the tolerance loop, a host
     read an iteration; segments of 16, a host read a segment);
  6. the rest of the dense GP surface at config 2: GP(basis="linear")
     fit/predict/full_cov, GP.loo, fit(optimizer="lbfgs"),
     fit(restarts=3), the multi-output LML and posterior (8 outputs),
     analytic LML gradients against autograd (rbf, rq, periodic),
     sample_posterior (64 draws at 2000 points) and save/load, each
     gated against the float64 oracle or its own reference, launch
     counters read around them;
  7. BASELINE config 3 (sinusoid_1d(n=512), rbf, 256 chains): 8 chain
     states in one batched log density against the float64 oracle, one
     at a time and alone in a batch, and through the jitter ladder; HMC
     through GP.sample_hyperparams (32 leapfrog steps, 64 warm-up, 64
     draws: samples/s, accept rate, R-hat and ESS), NUTS (depth 6, 64
     warm-up, 128 draws), HMC on a standard Gaussian, mean-field VI
     through GP.fit_vi, each gated; launch counters read around the
     phase (the samplers path);
  8. matrix-free hyperparameter HMC at n=32768 (bench_hmc.py's
     iterative engine: sinusoid_1d, rbf, 8 chains, 16 frozen probes, 32
     SLQ steps, a rank-128 preconditioner): the batched log density
     against each chain alone and against the dense LML (value a point,
     gradient within 5 MC SE of its probes); then
     sample_hyperparams_checkpointed(engine="iterative") killed half way
     and resumed (3 warm-up transitions, 2 draws of 4 leapfrog steps):
     samples/s, s/transition, CG iterations, peak memory beside the
     dense engine's, launch counters read around the two calls (the
     iterative samplers path); a killed-and-resumed run bitwise equal
     to an uninterrupted one at n=2048 for both engines;
  9. the sparse and classification families: the kernels at the shapes
     this phase reaches first (TRSM at n=512 with 131,072 right-hand
     sides, the 512 x 131,072 cross covariance, the (3, 4096, 4096)
     Cholesky batch), each against its plain version and timed; (a)
     SGPR at benchmarks/bench_sgpr.py's configuration (n=131,072, d=4,
     m=512, 50 Adam steps) through GP.fit_sparse / predict_sparse,
     against a float64 evaluation of the same formulas and, with Z = X
     at n=2048, the dense LML; (b) SVGP: the gaussian warm start over
     131,072 rows in chunks against the collapsed bound, a gaussian fit,
     and bernoulli on two_moons(131,072) (2,000 steps, accuracy); (c)
     GPClassifier Laplace at n=8000 and EP at n=4096, (d) multiclass at
     n=4096, 3 classes (10 Adam steps each after a warm-up), each model
     gated at n=1024 against the float64 oracles (the port's copies, run
     in worker processes meanwhile); (e) the default random streams
     asked for the card bitwise the CPU's. Each of (a)-(d) is a path of
     its own for the launch counters (cov, potrf and TRSM, no matvec);
 10. the LMC multi-output family: (a) ICM, MultiOutputGP(kind="rbf",
     rank=2) at n=8000, d=4, p=4 (20 Adam steps after a warm-up,
     predict at 2,000 points with and without the full output
     covariance); (b) the dense rank-Q MultiOutputGPQ(kinds=("periodic",
     "rbf")) on the model-zoo data at n=4096, pn=8192 (20 steps); each
     gated at n=1024 against the float64 oracle (the port's copy, in
     worker processes meanwhile) at the fitted params; (c) the
     matrix-free rank-Q model at benchmarks/bench_lmcq.py's
     configuration (n=32768, d=2, p=2, rbf + matern32, 8 probes, tol
     1e-4, CG capped at 2,000 iterations where the harness's one TPU
     capture ran 600): the harness's small-n agreement check enforced on
     the mean
     and the variance, log_marginal_likelihood_iterative and
     predict_iterative (256 points) timed with their CG counts, the
     mean solve's residual recomputed without the kernel, the dense
     path at the same n (pn = 65,536) printed beside it, and its joint
     Cholesky timed and checked; (d) the matvec at (c)'s shapes (rbf and
     matern32, r = 1, 8, 256) and the (4, 8000, 8000) batched Cholesky,
     each against its plain version or the library. (a), (b), (c) are
     the paths lmc_icm, lmc_q_dense, lmc_q_iterative of the launch
     counters; the 65,536-row factor's library time
     (torch.linalg.cholesky) once the port's factor is freed;
 11. the CLI (python -m cugp_tpu_torch.cli, each verb run in this
     process through its main with --device=cuda, stdout captured):
     (a) fit at config 2 twice on one --checkpoint_dir (the second
     resumes; the --metrics_file holds a neg_lml line a step and a
     fit_done event a call), predict's 256-point mean against the
     float64 oracle, the native C++ oracle's LML on 2,048 rows against
     the numpy one; (b) fit --fit.engine=iterative at n=32768, 3 steps
     resumed to 6 against 6 uninterrupted (first losses bitwise, params
     1e-4); (c) the checkpointed HMC at config 3's width (256 chains,
     n=512), 4 draws resumed to 8, bitwise the uninterrupted posterior;
     (d) the matrix-free sampler at n=8192; (e) vi; (f) sgpr at
     n=131,072; (g) svgp bernoulli at n=131,072 (accuracy >= 0.95); (h)
     classify, 2 and 3 classes; (i) info; (j) --profile on a 3-step fit,
     the trace naming the cov, potrf and TRSM kernels; (k)
     utils.supervise over a CLI fit child SIGKILLed once its heartbeat
     appears. The verbs' launches are the path cli (all four kernels);
 12. the distributed tier (cugp_tpu_torch/parallel) in spawned rank
     processes that load the library the parent built: (a) one rank on
     NCCL at config 4's N=32768, d=8 (distributed_cholesky, chunk 8192,
     phase 4's gate; distributed_lml and its gradient against the
     single-device LML), with two ranks asking NCCL for the one card
     beside it (its answer printed); (b) four ranks, on NCCL one rank a
     card where the machine has four cards, else on gloo sharing the
     card, CUDA tensors, the collectives gloo does not carry for CUDA
     staged through the host and counted: config 4 (ring covariance
     against train_covariance's rows, the relayout round trip bitwise,
     block-cyclic and chunked Cholesky on phase 4's gate, distributed_lml
     and its gradient, two sharded MAP steps at N=8192 against map_opt.fit
     and bitwise across ranks), config 3's 256 chains over dp=4 with one
     process's draws replayed (adaptation equal on every rank), the
     large-N sampler at N=8192 (its density against the single-device
     one), config 5 at N=100,000 over a ring of four (the matvec at r=9
     against the matvec kernel, a preconditioned CG mean solve with
     phase 5's certificate, the posterior at 32 points against the
     single-device one), fit_iterative_sharded at n=32768 and the
     matrix-free sampler at n=4096. `[dist]` lines: each part's wall s,
     each rank's peak memory, staged bytes and launches, every gate's
     reading; the ranks' launches are the path distributed (cov, potrf,
     TRSM);
 13. the segmented schedule, the host-built preconditioner, blocked
     chains and the fetch-barrier timers: (a) GP.fit_iterative (1
     step, segments of 16 CG iterations, precond_where="host"),
     log_marginal_likelihood_iterative and predict_iterative (4 points)
     on segments at N=262,144, d=4 (phase 5's data), gated on finite
     losses and LML, the mean solve's residual without the kernel and
     0 <= var <= k**; (b) on 16,384 of those rows, segments composing
     bitwise, cg_solve_segmented bitwise the fixed-iteration cg_solve,
     slq_logdet_segmented bitwise slq_logdet, the segmented posterior
     against the one-call and float64 posteriors, the host and device
     preconditioners (Lk where the pivots agree, CG counts); (c) 256
     chains at n=2048: the density with chain_block=64 against one
     batch (value, gradient, peak memory), one HMC transition each way
     at eps 0.005 (each chain's energy error dH from its replayed
     leapfrog, the chains that moved most re-run alone in float64, and
     a gate: chains with |dH| < 0.1 take the same accept decision) and
     one NUTS transition each way on 128 of the chains; (a) also times the
     mean solve at the init on both CG routes; (d) the rank-Q LMC
     posterior with segment_iters=16 against 0 at n=2048; (e) the
     CLI's --fit.segment_iters (n=16384) and --sample.chain_block (64
     chains at n=512, 2 + 2); (f) profiling.rtt_overhead and timed_loop
     of the 8000^2 covariance build beside its CUDA-event time. The
     parts' launches summed are the path segmented_and_blocked.
`[timing]` lines give each phase's wall seconds and, after the last
phase, all of them with their sum.
--profile adds torch.profiler device times by kernel: 10 TRSM calls at
each timed shape (phase 2), 3 config-2 fit steps (phase 3), one
Cholesky at N=32768 (phase 4), one fit step at N=100,000 (phase 5), one
L-BFGS step and one loo() at config 2 (phase 6), one HMC transition
of 256 chains at config 3 (phase 7), and one evaluation of the 8-chain
matrix-free log density at the last draws (phase 8), and one SGPR step
and one step of each classifier (phase 9), one fit step of each dense
LMC model and one predict_iterative chunk of the matrix-free one (phase
10); phase 11 takes no --profile (its own --profile=DIR is step (j)).
The line before the last is a JSON object with each kernel's launches,
error against its plain version, times and bound; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np


# the H100 SXM's published peaks (NVIDIA data sheet, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound(nbytes, flops):
    """(least ms the card could take, what bounds it): bytes moved once
    over the HBM rate, or fp32 operations over the non-tensor peak."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return ((1e3 * t_bytes, "bytes") if t_bytes >= t_ops
            else (1e3 * t_ops, "operations"))


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, iters=10, warmup=2, reps=1):
    """Median milliseconds of fn() by CUDA events, after warm-up. With
    reps > 1 each sample times reps calls back to back and divides, so a
    call shorter than the host's time to issue it is not charged the
    device's idle gaps (up to the one before the first call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
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
    print_ptxas("cov.cu")
    print_ptxas("potrf.cu")
    print_ptxas("trsm.cu")
    print_ptxas("cov_matvec.cu")


def kernel_name(mangled):
    """'_ZN<namespace>17cov_matvec_narrowILi0ELi9EEEv...' ->
    'cov_matvec_narrow<0,9>': the nested name's last part, then its
    integer and bool template arguments."""
    pos, name = 3 if mangled.startswith("_ZN") else 0, mangled
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        k = int(m.group())
        name = mangled[pos + m.end():pos + m.end() + k]
        pos += m.end() + k
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    if args:
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
    return name


def print_ptxas(source):
    """ptxas's registers and spills for one source's kernels, a line each."""
    from cugp_tpu_torch.ops import _build

    report = _build.ptxas_report().get(source, "")
    for block in report.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        say("ptxas", source=source, kernel=kernel_name(block.split("'")[0]),
            registers=regs.group(1) if regs else "?",
            spill_stores=spill.group(1) if spill else "?",
            spill_loads=spill.group(2) if spill else "?")


def _close(got, want, rtol, atol):
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return ok, float(err.max()), float(err.max() / want.abs().max())


COV_KINDS = ("rbf", "matern12", "matern32", "matern52", "rq", "linear",
             "periodic")
# (m, n, d, square) of the main paths' builds: config 2's LML, the north
# star, the matrix-free AD sweep's 4096-row blocks, K(X, X*) of predict
COV_TIMED = ((8000, 8000, 4, True), (32768, 32768, 8, True),
             (4096, 100_000, 4, False), (100_000, 128, 4, False))


def cov_against_plain(torch, tag, got, xs1, xs2, s, kind, square, n1, n2):
    """A build (2-D or batched) against the plain version and against the
    plain version in float64 on the same inputs (the witness). The fp32
    plain version strays from the witness where its exponent cross -
    s1/2 - s2/2 cancels (about eps s sf2 on the diagonal of the periodic
    view at d = 40, where a row's s is about 160): that stray is allowed
    on top of rtol and atol in the comparison with it, not in the one
    with the witness. Returns the two max abs errors."""
    from cugp_tpu_torch.ops import cov_cuda

    rtol = atol = 1e-5
    want = cov_cuda.cov_tile_plain(xs1, xs2, s, kind, square, n1, n2)
    exact = cov_cuda.cov_tile_plain(xs1.double(), xs2.double(), s.double(),
                                    kind, square, n1, n2)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"cov {tag}: shape {tuple(got.shape)} or non-finite")
    tol = atol
    if kind == "matern12":
        # exp(-r) has slope -1 at r = 0, and r = sqrt(d2) turns the fp32
        # rounding of d2 = s1 + s2 - 2 cross (a few eps (s1+s2), summed in
        # another order by each build) into an r error of its square
        # root: near coincident points the bar is sf2 sqrt(8 eps (s1 +
        # s2)), elsewhere rtol = atol = 1e-5
        s12 = ((xs1 * xs1).sum(-1)[..., :, None]
               + (xs2 * xs2).sum(-1)[..., None, :])
        d2 = (s12 - 2.0 * xs1 @ xs2.mT).clamp(min=0.0)
        slack = s[..., 0, None, None] * torch.sqrt(8 * 1.1920929e-07 * s12)
        tol = torch.where(d2 < 1e-2, slack, 0.0) + atol
    ok_x, err_x, _ = _close(got.double(), exact, rtol, tol)
    if not ok_x:
        fail(f"cov {tag}: max abs err {err_x:.3e} against float64 over "
             f"rtol=atol={rtol}")
    stray = (want.double() - exact).abs()
    ok, err, _ = _close(got, want, rtol, tol + stray)
    if not ok:
        fail(f"cov {tag}: max abs err {err:.3e} over rtol=atol={rtol} "
             f"plus the plain version's own error ({float(stray.max()):.3e})")
    return err, err_x


def _cov_bound(m, n, d, square):
    """X1 and X2 read once (one tensor when square), K written once;
    2d + 3 flops an entry."""
    return bound(4 * (m * d + (0 if square else n * d) + m * n),
                 m * n * (2 * d + 3))


def phase_cov(torch, dev, results):
    from cugp_tpu_torch.ops import cov_cuda, kernels

    rng = np.random.default_rng(0)
    worst = 0.0

    def scal(diag_add, kind):
        extra = {"rq": 0.7, "linear": 0.3}.get(kind, 1.0)
        return torch.tensor([1.3, diag_add, extra], dtype=torch.float32,
                            device=dev)

    def uniform(rows, d, scale=1.0):
        return torch.as_tensor(rng.uniform(-2, 2, (rows, d)) * scale,
                               dtype=torch.float32, device=dev)

    def view(kind, *xs):
        """The base kind and the inputs it sees (periodic: the rbf view)."""
        if kind != "periodic":
            return (kind, *xs)
        d = xs[0].shape[1]
        p = {"log_lengthscale": torch.zeros(d, device=dev),
             "log_period": torch.full((d,), 0.5, device=dev)}
        _, *vs = kernels.periodic_rbf_view(p, *xs)
        return ("rbf", *vs)

    def route(k):
        return cov_cuda.route(k.stride(0), k.data_ptr())

    def check(tag, xs1, xs2, kind, square, n1, n2, diag_add):
        """The kernel against the plain version and its float64 witness
        (cov_against_plain), and a repeat bitwise. Returns the two max abs
        errors and the build."""
        nonlocal worst
        s = scal(diag_add, kind)
        got = cov_cuda.cov_tile(xs1, xs2, s, kind, square, n1, n2)
        again = cov_cuda.cov_tile(xs1, xs2, s, kind, square, n1, n2)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"cov {tag}: two launches differ")
        err, err_x = cov_against_plain(torch, tag, got, xs1, xs2, s, kind,
                                       square, n1, n2)
        worst = max(worst, err)
        del again
        return f"{err:.3e}/{err_x:.3e}", got

    X = uniform(8000, 4)
    Xc = uniform(2000, 4)
    X40 = uniform(2000, 40, 0.25)
    X1, X8 = uniform(2000, 1), uniform(2000, 8, 0.5)
    Xr, Xr2 = uniform(1000, 4), uniform(777, 4)
    for kind in COV_KINDS:
        base, xs, xc = view(kind, X, Xc)
        e_sq, k_sq = check(f"{kind} square 8000", xs, xs, base, True, 7900,
                           7900, 0.1)
        e_x, k_x = check(f"{kind} cross 8000x2000", xs, xc, base, False,
                         7950, 2000, 0.0)
        routes = [route(k_sq), route(k_x)]
        del k_sq, k_x
        errs = []
        for d, Xd in ((1, X1), (8, X8), (40, X40)):
            base, xd = view(kind, Xd)
            errs.append(check(f"{kind} square 2000 d={d}", xd, xd, base,
                              True, 1990, 1990, 0.1)[0])
        # the two store routes on the same entries: the 1000 x 777 build
        # (4-byte) against the first 777 columns of a 1000 x 780 build of
        # X2 padded by 3 rows past n2_true (16-byte)
        base, xr, xr2 = view(kind, Xr, Xr2)
        e_r, narrow = check(f"{kind} cross 1000x777", xr, xr2, base, False,
                            1000, 777, 0.0)
        wide = cov_cuda.cov_tile(xr, torch.cat([xr2, xr2[:3]]),
                                 scal(0.0, base), base, False, 1000, 777)
        routes += [route(narrow), route(wide)]
        if routes[2:] != ["4-byte", "16-byte"]:
            fail(f"cov {kind} cross 1000x777: took the routes {routes[2:]}")
        if not torch.equal(narrow, wide[:, :777]):
            fail(f"cov {kind} cross 1000x777: the 4-byte and 16-byte store "
                 "routes differ")
        say("cov", kind=kind, err_plain_f64_square=e_sq,
            err_plain_f64_cross=e_x, err_plain_f64_d1_d8_d40=",".join(errs),
            err_plain_f64_cross_1000x777=e_r, routes=",".join(routes),
            repeats_and_routes_bitwise=True)

    # the rbf diagonal is sf2 + diag_add exactly (exponent 0), and rows
    # [4096, 8192) of a 10,000-row build are those rows built alone, as
    # a square build's rows are the cross build of their block (the AD
    # sweep's blocks against the dense K)
    s = scal(0.1, "rbf")
    K = cov_cuda.cov_tile(X, X, s, "rbf", True, 7900, 7900)
    if not torch.equal(torch.diagonal(K)[:7900],
                       (s[0] + s[1]).expand(7900)):
        fail("cov rbf square: the diagonal is not sf2 + diag_add bitwise")
    X10 = uniform(10_000, 4)
    rows = cov_cuda.cov_tile(X10, Xc, s, "rbf", False, 10_000, 2000)
    alone = cov_cuda.cov_tile(X10[4096:8192], Xc, s, "rbf", False, 4096,
                              2000)
    s0 = scal(0.0, "rbf")
    dense = cov_cuda.cov_tile(X, X, s0, "rbf", True, 8000, 8000)
    block = cov_cuda.cov_tile(X[4096:8000], X, s0, "rbf", False, 3904, 8000)
    if not (torch.equal(rows[4096:8192], alone)
            and torch.equal(dense[4096:], block)):
        fail("cov: a row block built alone differs from the same rows of "
             "a larger build")
    say("cov", diagonal_is_sf2_plus_diag_add=True,
        rows_4096_8192_of_10000_equal_alone=True,
        square_rows_equal_cross_block=True)
    del K, rows, alone, dense, block

    by_shape = time_cov(torch, dev)
    first = next(iter(by_shape.values()))  # config 2: 8000^2, d=4
    say("cov", max_abs_err=f"{worst:.3e}")
    results["cov"] = {"max_abs_err": worst, **first, "by_shape": by_shape}


def time_cov(torch, dev):
    """The kernel (rbf) at the main paths' shapes by CUDA events, beside
    its byte bound, the plain version and fill_ms (out.fill_(1.0) on an
    output of the same size: the card's practical write rate)."""
    from cugp_tpu_torch.ops import cov_cuda

    rng = np.random.default_rng(5)
    s = torch.tensor([1.3, 0.1, 1.0], dtype=torch.float32, device=dev)
    by_shape = {}
    for m, n, d, square in COV_TIMED:
        X1 = torch.as_tensor(rng.uniform(-2, 2, (m, d)), dtype=torch.float32,
                             device=dev)
        X2 = X1 if square else torch.as_tensor(
            rng.uniform(-2, 2, (n, d)), dtype=torch.float32, device=dev)
        # 5 calls back to back a sample: the device's time, not the
        # host's to issue a call
        iters = 3 if m * n > 2e9 else 10
        ms = cuda_ms(lambda: cov_cuda.cov_tile(X1, X2, s, "rbf", square, m,
                                               n), iters=iters, reps=5)
        fill = torch.empty(m, n, device=dev)
        fill_ms = cuda_ms(lambda: fill.fill_(1.0), iters=iters, reps=5)
        del fill
        plain_ms = cuda_ms(lambda: cov_cuda.cov_tile_plain(
            X1, X2, s, "rbf", square, m, n), iters=2, warmup=1)
        b_ms, b_by = _cov_bound(m, n, d, square)
        tag = f"{m}x{n} d={d}"
        row = {"ms": ms, "fill_ms": fill_ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        say("cov", shape=tag + (" square" if square else " cross"),
            kernel_ms=f"{ms:.4f}", fill_ms=f"{fill_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, share_of_bound=f"{b_ms / ms:.3f}")
        by_shape[tag] = row
        del X1, X2
        torch.cuda.empty_cache()
    return by_shape


def _matvec_bound(n, d, r):
    """Each entry of K: 2d flops of cross term, 3 of exponent, 2r of
    contraction; the bytes are X and V read once and the output written
    once."""
    return bound(4 * (n * d + 2 * n * r), n * n * (2 * d + 3 + 2 * r))


MATVEC_R = (1, 4, 9, 12, 16, 17, 32, 33, 128, 129)  # route/RC boundaries
MATVEC_TIMED_R = (1, 9, 17, 128)


def phase_cov_matvec(torch, dev, results, n=8000, n_time=100_000):
    from cugp_tpu_torch.ops import cov_matvec_cuda as cm
    from cugp_tpu_torch.ops import kernels

    rng = np.random.default_rng(4)
    rel_bar = 1e-4
    worst = worst_rel = 0.0
    V = torch.as_tensor(rng.standard_normal((n, 130)), dtype=torch.float32,
                        device=dev)

    def v_of(r):
        """Strided column slices of one buffer, as CG passes sol[:, 1:]."""
        return V[:, :1] if r == 1 else V[:, 1:1 + r]

    def matern12_slack(xs, sf2, v):
        """|K error| near coincident points is up to sf2 sqrt(8 eps
        (s1 + s2)) (see phase_cov); each output sums it against |v|."""
        s12 = ((xs * xs).sum(1)[:, None] + (xs * xs).sum(1)[None, :])
        d2 = (s12 - 2.0 * xs @ xs.T).clamp(min=0.0)
        slack = torch.where(d2 < 1e-2,
                            sf2 * torch.sqrt(8 * 1.1920929e-07 * s12), 0.0)
        return slack @ v.abs()

    for kind in COV_KINDS:
        errs = []
        for d in (4, 40):
            X = torch.as_tensor(rng.uniform(-2, 2, (n, d)),
                                dtype=torch.float32, device=dev)
            if d == 40:
                X = X / 4.0
            if kind == "periodic":
                p = {"log_lengthscale": torch.zeros(d, device=dev),
                     "log_period": torch.full((d,), 0.5, device=dev)}
                _, xs = kernels.periodic_rbf_view(p, X)
                base = "rbf"
            else:
                xs, base = X, kind
            extra = {"rq": 0.7, "linear": 0.3}.get(base, 1.0)
            scal = torch.tensor([1.3, 0.1, extra], dtype=torch.float32,
                                device=dev)
            outs = {}
            for r in MATVEC_R:
                v = v_of(r)
                got = cm.cov_matvec(xs, v, scal, base, n)
                again = cm.cov_matvec(xs, v, scal, base, n)
                want = cm.cov_matvec_plain(xs, v, scal, base, n)
                torch.cuda.synchronize()
                tag = f"{kind} d={d} r={r} ({cm.route(r)})"
                if got.shape != (n, r) or not torch.isfinite(got).all():
                    fail(f"cov_matvec {tag}: shape {tuple(got.shape)} or "
                         "non-finite")
                if not torch.equal(got, again):
                    fail(f"cov_matvec {tag}: two launches differ")
                err = (got - want).abs()
                scale = float(want.abs().max())
                tol = rel_bar * scale
                if kind == "matern12":
                    tol = tol + matern12_slack(xs, 1.3, v)
                if not bool((err <= tol).all()):
                    fail(f"cov_matvec {tag}: max abs err "
                         f"{float(err.max()):.3e} over {rel_bar} max|plain|"
                         f" = {rel_bar * scale:.3e}")
                worst = max(worst, float(err.max()))
                worst_rel = max(worst_rel, float(err.max()) / scale)
                errs.append(f"{float(err.max()) / scale:.1e}")
                outs[r] = got
            # narrow route: a column's output does not depend on r (the
            # same sums in the same order at every RC and rows a lane)
            lead = outs[32]
            for r in (4, 9, 12, 16, 17):
                if not torch.equal(outs[r], lead[:, :r]):
                    fail(f"cov_matvec {kind} d={d}: r={r} differs from the "
                         "leading columns of r=32")
            if not torch.equal(cm.cov_matvec(xs, V[:, 1:2], scal, base, n),
                               lead[:, :1]):
                fail(f"cov_matvec {kind} d={d}: r=1 differs from the first "
                     "column of r=32")
        say("cov_matvec", kind=kind, n=n,
            r=",".join(map(str, MATVEC_R)), rel_err_d4_then_d40=
            ",".join(errs), bitwise_repeat=True,
            narrow_columns_independent_of_r=True)

    # time at the main path's width: N = 100,000, d = 4, rbf
    n, d = n_time, 4
    X = torch.as_tensor(rng.uniform(-3, 3, (n, d)) / 0.6,
                        dtype=torch.float32, device=dev)
    scal = torch.tensor([0.3, 0.3, 1.0], dtype=torch.float32, device=dev)
    out = {}
    for r in MATVEC_TIMED_R:
        v = torch.as_tensor(rng.standard_normal((n, r)), dtype=torch.float32,
                            device=dev)
        got = cm.cov_matvec(X, v, scal, "rbf", n)
        want = cm.cov_matvec_plain(X, v, scal, "rbf", n)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= rel_bar * scale:
            fail(f"cov_matvec n={n} r={r}: max abs err {err:.3e} over "
                 f"{rel_bar} max|plain| = {rel_bar * scale:.3e}")
        del got, want
        ms = cuda_ms(lambda: cm.cov_matvec(X, v, scal, "rbf", n), iters=5,
                     warmup=1)
        b_ms, b_by = _matvec_bound(n, d, r)
        row = {"route": cm.route(r), "ms": ms, "bound_ms": b_ms,
               "bound_by": b_by, "rel_err": err / scale}
        if r in (9, 128):
            row["plain_ms"] = cuda_ms(
                lambda: cm.cov_matvec_plain(X, v, scal, "rbf", n), iters=2,
                warmup=1)
            # no exponent: splits the epilogue's cost from the FMAs
            row["linear_ms"] = cuda_ms(
                lambda: cm.cov_matvec(X, v, scal, "linear", n), iters=5,
                warmup=1)
            say("cov_matvec", split=f"n={n} d={d} r={r}", route=row["route"],
                rbf_ms=f"{ms:.4f}", linear_ms=f"{row['linear_ms']:.4f}",
                exponent_share=f"{1.0 - row['linear_ms'] / ms:.4f}")
        say("cov_matvec", shape=f"n={n} d={d} r={r} rbf", route=row["route"],
            kernel_ms=f"{ms:.4f}",
            plain_ms=f"{row['plain_ms']:.4f}" if "plain_ms" in row else "-",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            rel_err=f"{err / scale:.3e}")
        out[r] = row
    r9, r128 = out[9], out[128]
    results["cov_matvec"] = {
        "max_abs_err": worst, "max_rel_err": worst_rel, "ms": r9["ms"],
        "plain_ms": r9["plain_ms"], "bound_ms": r9["bound_ms"],
        "bound_by": r9["bound_by"], "library_ms": None,
        "shape": f"n={n} d={d} r=9", "routes": {
            f"r={r}": row["route"] for r, row in out.items()},
        "r128_ms": r128["ms"], "r128_plain_ms": r128["plain_ms"],
        "r128_bound_ms": r128["bound_ms"],
        "by_r": {f"r={r}": row for r, row in out.items()}}


def _spd(torch, n, dev, seed):
    """G G^T / n + I: eigenvalues in about [1, 5], cond about 5."""
    g = torch.randn(n, n, generator=torch.Generator().manual_seed(seed))
    return (g @ g.T / n + torch.eye(n)).to(dev)


POTRF_SIZES = (128, 512, 576, 768, 1024)  # the base blocks the paths use


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

    grid = {n: chol_cuda.grid_size(n, dev) for n in POTRF_SIZES}
    say("potrf", grid_by_n=json.dumps(grid, separators=(",", ":")))
    if grid[1024] <= 1:
        fail(f"potrf: one CTA at n=1024 (grid {grid[1024]})")

    # small, ragged and base-block sizes; the upper triangle is ignored.
    # At 48 and 64 the grid is one CTA, which solves both panel tiles.
    for n in (8, 48, 64, 100, 200, 576, 1000, 1024):
        A = _spd(torch, n, dev, n)
        garbage = A + torch.triu(torch.full_like(A, 7.0), 1)
        L = chol_cuda.potrf(garbage)
        torch.cuda.synchronize()
        if float(torch.triu(L, 1).abs().max()) != 0.0:
            fail(f"potrf n={n}: nonzero above the diagonal")
        rec, err = check(f"n={n}", L, A)
        say("potrf", n=n, grid=chol_cuda.grid_size(n, dev),
            recon_relerr=f"{rec:.3e}", L_err=f"{err:.3e}")

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

    # batches against the loop, and two launches: bitwise equal
    for n, count in ((576, 3), (1024, 2)):
        As = torch.stack([_spd(torch, n, dev, 100 + i) for i in range(count)])
        Lb = chol_cuda.potrf(As)
        Ll = torch.stack([chol_cuda.potrf(a) for a in As])
        torch.cuda.synchronize()
        if not torch.equal(Lb, Ll):
            fail(f"potrf: batch of {count} at n={n} differs from the loop")
        say("potrf", case=f"batch of {count} at n={n} vs loop",
            bitwise_equal=True)
    A = _spd(torch, 1024, dev, 13)
    if not torch.equal(chol_cuda.potrf(A), chol_cuda.potrf(A)):
        fail("potrf: two launches at n=1024 differ")
    say("potrf", case="two launches at n=1024", bitwise_equal=True)

    # the grid size changes no bit: a block factored alone (G of its n)
    # and as the leading block of diag(A, I) at n=1024 (G of 1024) runs
    # the same tile sums
    for n in (128, 576):
        A = _spd(torch, n, dev, 17)
        big = torch.eye(1024, device=dev)
        big[:n, :n] = A
        if not torch.equal(chol_cuda.potrf(big)[:n, :n], chol_cuda.potrf(A)):
            fail(f"potrf: n={n} factored at G={grid[n]} and G={grid[1024]} "
                 "differ")
        say("potrf", case=f"n={n} at G={grid[n]} vs G={grid[1024]}",
            bitwise_equal=True)

    # a block that is not PD factors to NaN, not to clamped garbage
    bad = _spd(torch, 576, dev, 5)
    bad[300, 300] = -50.0
    Lbad = chol_cuda.potrf(bad)
    torch.cuda.synchronize()
    if bool(torch.isfinite(torch.diagonal(Lbad)).all()):
        fail("potrf: a non-PD block gave a finite factor")
    say("potrf", case="non-PD block", nan=True)

    by_n = {}
    for n in POTRF_SIZES:
        A = _spd(torch, n, dev, 11)
        ms = cuda_ms(lambda: chol_cuda.potrf(A), reps=10)
        plain_ms = cuda_ms(lambda: chol_cuda.potrf_plain(A), reps=10)
        library_ms = cuda_ms(lambda: torch.linalg.cholesky(A), reps=10)
        # the block read once and L written once; n^3/3 fp32 flops
        b_ms, b_by = bound(4 * 2 * n ** 2, n ** 3 / 3)
        say("potrf", shape=n, grid=grid[n], kernel_ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{b_ms:.5f}", bound_by=b_by)
        by_n[n] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "grid": grid[n]}
    say("potrf", max_abs_err=f"{worst:.3e}")
    results["potrf"] = {"max_abs_err": worst, **by_n[1024], "by_n": by_n}


TRSM_GATE_N = (8, 100, 128, 1000, 1024)
TRSM_GATE_K = (1, 9, 16, 17, 100, 1024)  # narrow up to 16, wide from 17
TRSM_TIMED = ((1024, 1), (1024, 16), (1024, 1024), (1024, 4096), (128, 9))


def _trsm_residual(L, X, B0, left, transpose):
    """max |op(L) X - B| / max |B| (op(L) X for left, X op(L) for right)."""
    opL = L.T if transpose else L
    res = (opL @ X if left else X @ opL) - B0
    return float(res.abs().max() / B0.abs().max())


def phase_trsm(torch, dev, results, profile=False):
    from cugp_tpu_torch.ops import chol_cuda, trsm_cuda

    worst = 0.0
    gen = torch.Generator().manual_seed(3)

    def check(tag, Lk, L, B, left, transpose):
        """Solve in place with the kernel on Lk (L, or L with a stale
        upper triangle), gate the residual against the clean L."""
        nonlocal worst
        B0 = B.clone()
        trsm_cuda.trsm_(Lk, B, left, transpose)
        torch.cuda.synchronize()
        rel = _trsm_residual(L, B, B0, left, transpose)
        err = float((B - trsm_cuda.trsm_plain(L, B0, left, transpose)
                     ).abs().max())
        worst = max(worst, err)
        if not rel <= 1e-5:
            fail(f"trsm {tag}: residual {rel:.3e} (bar 1e-5)")
        return rel

    # both routes, ragged n, the k threshold, both sides and transposes,
    # L with 7.0 above its diagonal (only the lower triangle is read)
    for n in TRSM_GATE_N:
        L = chol_cuda.potrf(_spd(torch, n, dev, 20 + n))
        stale = L + torch.triu(torch.full_like(L, 7.0), 1)
        rels = []
        for k in TRSM_GATE_K:
            for left in (True, False):
                for transpose in (False, True):
                    shape = (n, k) if left else (k, n)
                    B = torch.randn(*shape, generator=gen).to(dev)
                    rels.append(check(f"n={n} k={k} left={left} transpose="
                                      f"{transpose} (stale upper)", stale, L,
                                      B, left, transpose))
        say("trsm", n=n, ks=",".join(map(str, TRSM_GATE_K)),
            cases=len(rels), stale_upper=7.0,
            max_residual=f"{max(rels):.3e}")

    # in place on strided views of larger buffers (column stride 2, as
    # the recursion's views can be): nothing outside B is written
    for n in (1000, 1024):
        L = chol_cuda.potrf(_spd(torch, n, dev, 20 + n))
        for k in (1, 4096):
            for left in (True, False):
                for transpose in (False, True):
                    if left:
                        buf = torch.randn(n + 8, 2 * k, generator=gen).to(dev)
                        B = buf[4:4 + n, ::2]
                    else:
                        buf = torch.randn(2 * k, n + 8, generator=gen).to(dev)
                        B = buf[::2, 4:4 + n]
                    before = buf.clone()
                    tag = f"n={n} k={k} left={left} transpose={transpose}"
                    rel = check(tag + " strided", L, L, B, left, transpose)
                    mask = torch.ones_like(buf, dtype=torch.bool)
                    if left:
                        mask[4:4 + n, ::2] = False
                    else:
                        mask[::2, 4:4 + n] = False
                    if not torch.equal(buf[mask], before[mask]):
                        fail(f"trsm {tag}: wrote outside B")
                    say("trsm", case=tag.replace(" ", ",") + ",strided",
                        residual=f"{rel:.3e}")

    # L as a view with an odd leading dimension: the scalar-load path
    n = 1000
    A = _spd(torch, n, dev, 31)
    big = torch.zeros(n + 3, n + 5, device=dev)
    Lv = big[1:1 + n, 3:3 + n]
    Lv.copy_(chol_cuda.potrf(A) + torch.triu(torch.full_like(A, 7.0), 1))
    L = torch.tril(Lv)
    for k in (1, 9, 100):
        for transpose in (False, True):
            B = torch.randn(n, k, generator=gen).to(dev)
            rel = check(f"odd ldl={Lv.stride(0)} k={k} transpose={transpose}",
                        Lv, L, B, True, transpose)
            say("trsm", case=f"ldl={Lv.stride(0)},offset=3,k={k},"
                f"transpose={transpose}", residual=f"{rel:.3e}")

    # two launches bitwise equal (both routes); the leading 64 columns of
    # a k=4096 solve (32-column slabs) equal the same columns solved at
    # k=64 (8-column slabs)
    L = chol_cuda.potrf(_spd(torch, 1024, dev, 9))
    for transpose in (False, True):
        for k in (1, 9, 1024):
            B = torch.randn(1024, k, generator=gen).to(dev)
            if not torch.equal(trsm_cuda.trsm(L, B, True, transpose),
                               trsm_cuda.trsm(L, B, True, transpose)):
                fail(f"trsm: two launches at k={k} transpose={transpose} "
                     "differ")
        B = torch.randn(1024, 4096, generator=gen).to(dev)
        wide = trsm_cuda.trsm(L, B, True, transpose)[:, :64]
        if not torch.equal(wide, trsm_cuda.trsm(L, B[:, :64].contiguous(),
                                                True, transpose)):
            fail(f"trsm: k=4096 and k=64 differ in the leading 64 columns "
                 f"(transpose={transpose})")
        say("trsm", case="repeat_k=1/9/1024,slab_width_k=4096_vs_64",
            transpose=transpose, bitwise_equal=True)

    by_shape = {}
    for n, k in TRSM_TIMED:
        L = chol_cuda.potrf(_spd(torch, n, dev, 9 + n))
        B = torch.randn(n, k, generator=gen).to(dev)
        ms = cuda_ms(lambda: trsm_cuda.trsm(L, B), reps=10)
        plain_ms = cuda_ms(lambda: trsm_cuda.trsm_plain(L, B), reps=10)
        library_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
            L, B, upper=False), reps=10)
        # the host's time to issue one call (no synchronize inside)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            trsm_cuda.trsm(L, B)
        host_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        b_ms, b_by = _trsm_bound(n, k)
        say("trsm", shape=f"n={n} k={k}", kernel_ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{b_ms:.7f}", bound_by=b_by,
            host_issue_ms=f"{host_ms:.4f}")
        by_shape[f"n={n} k={k}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "host_issue_ms": host_ms}
        if profile:  # device time by kernel: the trtri pass and the route
            profile_device(torch, f"profile_trsm_n{n}_k{k}", lambda: [
                trsm_cuda.trsm(L, B) for _ in range(10)])
    say("trsm", max_abs_err_vs_plain=f"{worst:.3e}")
    results["trsm"] = {"max_abs_err": worst, **by_shape["n=1024 k=4096"],
                       "by_shape": by_shape}


def _trsm_bound(n, k):
    """L's lower triangle and B read once, X written once; n^2 k fp32
    flops."""
    return bound(4 * (n * (n + 1) // 2 + 2 * n * k), n ** 2 * k)


BATCH_SIZES = (1, 7, 256)
BATCH_N = (512, 500)  # config 3's block, and a ragged one
BATCH_K = (1, 16, 17, 512)  # alpha, the narrow/wide edge, Murray's solves
BASE_KINDS = ("rbf", "matern12", "matern32", "matern52", "rq", "linear")


def _time_batched(torch, tag, fn, loop, plain, library, bound_ms_by,
                  iters=10):
    """A batched launch by CUDA events beside the loop over its elements
    (the 2-D call each), its plain version, the batched library call (or
    None) and its bound; one line and its row."""
    ms = cuda_ms(fn, iters=iters, reps=3)
    loop_ms = cuda_ms(loop, iters=3, warmup=1)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    library_ms = (cuda_ms(library, iters=iters, reps=3)
                  if library is not None else None)
    b_ms, b_by = bound_ms_by
    say("batched", shape=tag, kernel_ms=f"{ms:.4f}",
        loop_ms=f"{loop_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms="none" if library_ms is None else f"{library_ms:.4f}",
        bound_ms=f"{b_ms:.5f}", bound_by=b_by)
    return {"ms": ms, "loop_ms": loop_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def _spd_batch(torch, B, n, dev, seed):
    """B blocks G G^T / n + I (eigenvalues in about [1, 5]), made on the
    card."""
    g = torch.randn(B, n, n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    return g @ g.mT / n + torch.eye(n, device=dev)


def phase_batched(torch, dev, results, sizes=BATCH_SIZES, ns=BATCH_N,
                  timed=(256, 512)):
    """The three dense kernels on a leading batch (B = 1, 7, 256; n = 512
    and a ragged 500): each batched launch bitwise equal to the loop over
    its elements through the 2-D call, and within the plain version's
    bars; potrf's cooperative and batch routes bitwise equal; config 3's
    shapes timed."""
    from cugp_tpu_torch.ops import chol_cuda, cov_cuda, trsm_cuda

    rng = np.random.default_rng(7)

    def t32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def scal(B):
        return t32(np.stack([rng.uniform(0.5, 2.0, B),
                             rng.uniform(0.01, 0.2, B),
                             rng.uniform(0.3, 2.0, B)], axis=1))

    # covariance: square builds (every base kind at B = 7) and a ragged
    # cross build with padded rows
    worst = 0.0
    for B in sizes:
        for n in ns:
            for d in (1, 4):
                for kind in BASE_KINDS if B == 7 else ("rbf",):
                    xs, s = t32(rng.uniform(-2, 2, (B, n, d))), scal(B)
                    got = cov_cuda.cov_tile(xs, xs, s, kind, True, n, n)
                    loop = torch.stack([cov_cuda.cov_tile(
                        xs[b], xs[b], s[b], kind, True, n, n)
                        for b in range(B)])
                    tag = f"B={B} n={n} d={d} {kind} square"
                    if not torch.equal(got, loop):
                        fail(f"cov batched {tag}: differs from the loop")
                    err, _ = cov_against_plain(torch, tag, got, xs, xs, s,
                                               kind, True, n, n)
                    worst = max(worst, err)
                    if B == 7 and n == 500:
                        x2 = t32(rng.uniform(-2, 2, (B, 300, d)))
                        got = cov_cuda.cov_tile(xs, x2, s, kind, False,
                                                n - 3, 300)
                        loop = torch.stack([cov_cuda.cov_tile(
                            xs[b], x2[b], s[b], kind, False, n - 3, 300)
                            for b in range(B)])
                        if not torch.equal(got, loop):
                            fail(f"cov batched B=7 {n}x300 d={d} {kind} "
                                 "cross: differs from the loop")
                        err, _ = cov_against_plain(
                            torch, f"B=7 {n}x300 d={d} {kind} cross", got,
                            xs, x2, s, kind, False, n - 3, 300)
                        worst = max(worst, err)
            say("batched", kernel="cov", B=B, n=n, d="1,4",
                kinds="all base" if B == 7 else "rbf",
                loop_bitwise=True, max_abs_err_vs_plain=f"{worst:.3e}")
    (B, n), d = timed, 1
    xs, s = t32(rng.uniform(-3, 3, (B, n, d))), scal(B)
    cov_row = _time_batched(
        torch, f"cov B={B} n={n} d={d} rbf square",
        lambda: cov_cuda.cov_tile(xs, xs, s, "rbf", True, n, n),
        lambda: [cov_cuda.cov_tile(xs[b], xs[b], s[b], "rbf", True, n, n)
                 for b in range(B)],
        lambda: cov_cuda.cov_tile_plain(xs, xs, s, "rbf", True, n, n),
        None, bound(4 * (B * n * d + B * 3 + B * n * n),
                    B * n * n * (2 * d + 3)))
    results["cov"]["batched"] = {f"B={B} n={n} d={d}": {
        "max_abs_err": worst, **cov_row}}

    # potrf: both routes and the loop, bitwise; a non-PD element gives NaN
    # in its block only
    worst, factors = 0.0, {}
    for B in sizes:
        for n in ns:
            A = _spd_batch(torch, B, n, dev, seed=B * 1000 + n)
            auto = chol_cuda.potrf(A)
            coop = chol_cuda.potrf(A, "cooperative")
            batch = chol_cuda.potrf(A, "batch")
            loop = torch.stack([chol_cuda.potrf(a) for a in A])
            torch.cuda.synchronize()
            if not (torch.equal(coop, batch) and torch.equal(auto, loop)
                    and torch.equal(auto, coop)):
                fail(f"potrf batched B={B} n={n}: the routes or the loop "
                     "differ")
            ref = torch.linalg.cholesky(A)
            rec = float(((auto @ auto.mT - A).abs().amax((-2, -1))
                         / A.abs().amax((-2, -1))).max())
            err = float((auto - ref).abs().max())
            worst = max(worst, err)
            if not (rec <= 1e-5 and err <= 1e-4 * float(ref.abs().max())):
                fail(f"potrf batched B={B} n={n}: recon relerr {rec:.3e} "
                     f"(bar 1e-5), L err {err:.3e} (bar 1e-4 rel)")
            say("batched", kernel="potrf", B=B, n=n,
                route=chol_cuda.route(B, dev),
                routes_and_loop_bitwise=True, recon_relerr=f"{rec:.3e}",
                L_err=f"{err:.3e}")
            factors[B, n] = auto
            del A, coop, batch, loop, ref
    A = _spd_batch(torch, 7, ns[0], dev, seed=5)
    A[3, ns[0] // 2, ns[0] // 2] = -50.0
    L = chol_cuda.potrf(A)
    fine = torch.isfinite(L).flatten(1).all(1).tolist()
    same = all(torch.equal(L[b], chol_cuda.potrf(A[b]))
               for b in range(7) if b != 3)
    if fine != [b != 3 for b in range(7)] or not same:
        fail(f"potrf batched: a non-PD element 3 gave finite flags {fine}, "
             f"the others equal to the loop: {same}")
    say("batched", kernel="potrf", case="non-PD element 3 of 7",
        nan_only_there=True, others_equal_loop=True)
    B, n = timed
    A = _spd_batch(torch, B, n, dev, seed=11)
    potrf_row = _time_batched(
        torch, f"potrf B={B} n={n} route={chol_cuda.route(B, dev)}",
        lambda: chol_cuda.potrf(A), lambda: [chol_cuda.potrf(a) for a in A],
        lambda: chol_cuda.potrf_plain(A), lambda: torch.linalg.cholesky(A),
        bound(4 * 2 * B * n * n, B * n ** 3 / 3))
    potrf_row["cooperative_ms"] = cuda_ms(
        lambda: chol_cuda.potrf(A, "cooperative"), iters=3, warmup=1)
    results["potrf"]["batched"] = {f"B={B} n={n}": {
        "max_abs_err": worst, **potrf_row}}
    for Bs in (2, 4, 8, 16, 32, 64):
        As = A[:Bs].contiguous()
        say("batched", kernel="potrf", case="routes by B", B=Bs, n=n,
            auto=chol_cuda.route(Bs, dev),
            cooperative_ms=f"{cuda_ms(lambda: chol_cuda.potrf(As, 'cooperative'), iters=5):.4f}",
            batch_ms=f"{cuda_ms(lambda: chol_cuda.potrf(As, 'batch'), iters=5):.4f}")
    del A

    # TRSM: left solves of both transposes at every B, n, k; at B = 7 also
    # right-side and vector right-hand sides
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(9)
    for (B, n), L in factors.items():
        rels = []
        for k in BATCH_K:
            for transpose in (False, True):
                for left in (True, False) if B == 7 else (True,):
                    for vec in (False, True) if B == 7 and k == 1 else (
                            False,):
                        shape = ((B, n) if vec else
                                 (B, n, k) if left else (B, k, n))
                        Bm = torch.randn(*shape, device=dev, generator=gen)
                        got = trsm_cuda.trsm(L, Bm, left, transpose)
                        loop = torch.stack([trsm_cuda.trsm(
                            L[b], Bm[b], left, transpose) for b in range(B)])
                        tag = (f"B={B} n={n} k={k} transpose={transpose} "
                               f"left={left} vector={vec}")
                        if not torch.equal(got, loop):
                            fail(f"trsm batched {tag}: differs from the "
                                 "loop")
                        g2 = got[..., None] if vec and left else (
                            got[..., None, :] if vec else got)
                        b2 = Bm[..., None] if vec and left else (
                            Bm[..., None, :] if vec else Bm)
                        opL = L.mT if transpose else L
                        res = (opL @ g2 if left else g2 @ opL) - b2
                        rel = float((res.abs().amax((-2, -1))
                                     / b2.abs().amax((-2, -1))).max())
                        rels.append(rel)
                        err = float((got - trsm_cuda.trsm_plain(
                            L, Bm, left, transpose)).abs().max())
                        worst = max(worst, err)
                        if not rel <= 1e-5:
                            fail(f"trsm batched {tag}: residual {rel:.3e} "
                                 "(bar 1e-5)")
        say("batched", kernel="trsm", B=B, n=n,
            ks=",".join(map(str, BATCH_K)), cases=len(rels),
            loop_bitwise=True, max_residual=f"{max(rels):.3e}")
    B, n = timed
    L = factors[B, n]
    trsm_rows = {}
    for k in (1, 512):
        Bm = torch.randn(B, n, k, device=dev, generator=gen)
        trsm_rows[f"B={B} n={n} k={k}"] = _time_batched(
            torch, f"trsm B={B} n={n} k={k}",
            lambda: trsm_cuda.trsm(L, Bm),
            lambda: [trsm_cuda.trsm(L[b], Bm[b]) for b in range(B)],
            lambda: trsm_cuda.trsm_plain(L, Bm),
            lambda: torch.linalg.solve_triangular(L, Bm, upper=False),
            bound(4 * B * (n * (n + 1) // 2 + 2 * n * k), B * n * n * k))
    for row in trsm_rows.values():
        row["max_abs_err"] = worst
    results["trsm"]["batched"] = trsm_rows
    del factors
    torch.cuda.empty_cache()


MATVEC_BATCH = (1, 7, 8)
MATVEC_BATCH_N = (32768, 5000)  # phase 8's n, and one not a tile multiple
MATVEC_BATCH_R = (1, 17, 128)  # cg_diagnostic, CG for [y | 16 probes], wide


def phase_batched_matvec(torch, dev, results, sizes=MATVEC_BATCH,
                         ns=MATVEC_BATCH_N, rs=MATVEC_BATCH_R,
                         timed=(8, 32768, 17)):
    """The fused matvec on a batch of chains (phase 8's shape: d = 1, each
    element its own lengthscale, sf2, diag_add): every element bitwise
    equal to its 2-D launch, within phase 2's matvec bar of the plain
    version; timed at B=8, n=32768, r=17 beside the loop of 2-D launches
    and the plain version."""
    from cugp_tpu_torch.ops import cov_matvec_cuda as cm

    rng = np.random.default_rng(8)
    rel_bar = 1e-4
    worst = worst_rel = 0.0
    Bmax = max(sizes)
    for n in ns:
        X = torch.as_tensor(rng.uniform(-10.0, 10.0, (n, 1)),
                            dtype=torch.float32, device=dev)
        ell = torch.as_tensor(rng.uniform(0.5, 1.2, (Bmax, 1)),
                              dtype=torch.float32, device=dev)
        xs_all = X / ell[:, None, :]
        scal_all = torch.as_tensor(np.stack([
            rng.uniform(0.5, 2.0, Bmax), rng.uniform(0.02, 0.2, Bmax),
            np.ones(Bmax)], axis=-1), dtype=torch.float32, device=dev)
        V = torch.as_tensor(rng.standard_normal((Bmax, n, max(rs) + 1)),
                            dtype=torch.float32, device=dev)
        for B in sizes:
            xs, scal = xs_all[:B], scal_all[:B]
            for r in rs:
                v = V[:B, :, 1:1 + r]  # strided, as CG passes sol[..., 1:]
                got = cm.cov_matvec(xs, v, scal, "rbf", n)
                loop = torch.stack([cm.cov_matvec(xs[b], v[b], scal[b],
                                                  "rbf", n)
                                    for b in range(B)])
                want = cm.cov_matvec_plain(xs, v, scal, "rbf", n)
                torch.cuda.synchronize()
                tag = f"B={B} n={n} r={r} ({cm.route(r)})"
                if got.shape != (B, n, r) or not torch.isfinite(got).all():
                    fail(f"cov_matvec batched {tag}: shape "
                         f"{tuple(got.shape)} or non-finite")
                if not torch.equal(got, loop):
                    fail(f"cov_matvec batched {tag}: differs from the loop "
                         "of 2-D launches")
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                if not err <= rel_bar * scale:
                    fail(f"cov_matvec batched {tag}: max abs err {err:.3e} "
                         f"over {rel_bar} max|plain| = {rel_bar * scale:.3e}")
                worst = max(worst, err)
                worst_rel = max(worst_rel, err / scale)
                del got, loop, want
            say("batched", kernel="cov_matvec", B=B, n=n, d=1,
                rs=",".join(map(str, rs)), loop_bitwise=True,
                max_rel_err=f"{worst_rel:.3e}")
    B, n, r = timed
    X = torch.as_tensor(rng.uniform(-10.0, 10.0, (n, 1)),
                        dtype=torch.float32, device=dev)
    xs = X / torch.as_tensor(rng.uniform(0.5, 1.2, (B, 1)),
                             dtype=torch.float32, device=dev)[:, None, :]
    scal = torch.tensor([[1.0, 0.05, 1.0]] * B, device=dev)
    v = torch.as_tensor(rng.standard_normal((B, n, r)), dtype=torch.float32,
                        device=dev)
    b_ms, b_by = _matvec_bound(n, 1, r)
    row = _time_batched(
        torch, f"cov_matvec B={B} n={n} d=1 r={r}",
        lambda: cm.cov_matvec(xs, v, scal, "rbf", n),
        lambda: [cm.cov_matvec(xs[b], v[b], scal[b], "rbf", n)
                 for b in range(B)],
        lambda: cm.cov_matvec_plain(xs, v, scal, "rbf", n), None,
        (B * b_ms, b_by))
    row.update(max_abs_err=worst, max_rel_err=worst_rel,
               route=cm.route(r))
    results["cov_matvec"]["batched"] = {f"B={B} n={n} d=1 r={r}": row}


def _wrappers():
    from cugp_tpu_torch.ops import (chol_cuda, cov_cuda, cov_matvec_cuda,
                                    trsm_cuda)

    return {"cov": cov_cuda, "potrf": chol_cuda, "trsm": trsm_cuda,
            "cov_matvec": cov_matvec_cuda}


def reset_launches():
    for mod in _wrappers().values():
        mod.LAUNCHES = 0


def read_launches():
    return {name: mod.LAUNCHES for name, mod in _wrappers().items()}


def phase_main(torch, dev, profile=False):
    import cugp_tpu_torch
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.oracle import exact_gp_np as oracle
    from cugp_tpu_torch.utils.params import params_to_numpy

    X, y, _ = synthetic.multidim_regression(n=8000, d=4, seed=0)
    Xs = np.random.default_rng(1).uniform(-2.0, 2.0, (2000, 4))
    steps = 10
    # one warm-up step: library handles, kernel loads and the caching
    # allocator's first N^2 buffers are set-up, not step time
    cugp_tpu_torch.GP(kind="rbf", device=dev).fit(X, y, steps=1)
    reset_launches()
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
    launches = read_launches()

    loss = info["loss"].cpu().numpy()
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        fail(f"main path: loss trace {loss.tolist()}")
    mu, var = mu.cpu().numpy(), var.cpu().numpy()
    if mu.shape != (2000,) or var.shape != (2000,):
        fail(f"main path: predict shapes {mu.shape} {var.shape}")
    p64 = params_to_numpy(gp.params)
    mu64, var64 = oracle.posterior(p64, X, y, Xs)
    lml64 = oracle.log_marginal_likelihood(p64, X, y)
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
    for name in ("cov", "potrf", "trsm"):
        if launches[name] <= 0:
            fail(f"main path: the {name} kernel was never launched")
    if profile:
        profile_device(torch, "profile_dense", lambda: cugp_tpu_torch.GP(
            kind="rbf", device=dev).fit(X, y, steps=3, learning_rate=0.05))
    return launches


def phase_north_star(torch, dev, profile=False):
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
    # the opt-in precision policies at the same shape: "high" and "mixed"
    # gated as the default on the first 4096 rows (bench.py's gate) and
    # finite everywhere; "mixed_fast" (one TF32 pass off the diagonal;
    # non-finite at this shape on an H100, PERF.md §6) measured and
    # reported. tools/chol_precision.py reads every row block.
    with torch.no_grad():
        for policy in ("high", "mixed", "mixed_fast"):
            t_p = cuda_ms(lambda: chol_ops.cholesky(K, precision=policy),
                          iters=2, warmup=1) / 1e3
            Lp = chol_ops.cholesky(K, precision=policy)
            r = Lp[:nb] @ Lp[:nb].T - K[:nb, :nb]
            rel_p = float(r.abs().max() / K[:nb, :nb].abs().max())
            finite = bool(torch.isfinite(Lp).all())
            del Lp, r
            say("north_star", precision=policy, t_chol_s=f"{t_p:.5f}",
                gflops=f"{flops / (t_cov + t_p) / 1e9:.2f}",
                speedup_over_fp32=f"{t_chol / t_p:.4f}",
                recon_relerr=f"{rel_p:.3e}", finite=finite)
            if policy != "mixed_fast" and not rel_p < 2e-4:
                fail(f"north star, precision={policy}: reconstruction "
                     f"relerr {rel_p:.3e} (gate 2e-4)")
            if policy != "mixed_fast" and not finite:
                fail(f"north star, precision={policy}: non-finite factor")
        again = chol_ops.cholesky(K)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    say("north_star", default_bitwise_after_policies=bool(
        torch.equal(again, L)), allow_tf32_after=tf32)
    if not torch.equal(again, L):
        fail("north star: the default factor changed after the policy calls")
    if tf32:
        fail("north star: allow_tf32 left on after the policy calls")
    del again
    if profile:
        with torch.no_grad():
            profile_device(torch, "profile_chol",
                           lambda: chol_ops.cholesky(K))


def rff_gp_draw(n, d, ell, sf2, noise_std, seed=0, features=4096,
                device="cpu", chunk=16384):
    """y ~ GP(0, sf2 * rbf(ell)) + N(0, noise_std^2) by random Fourier
    features (benchmarks/bench_fit_iterative.py's draw: the same numpy
    draws in the same order). The (n, features) feature map is formed
    in row chunks, in float64 on `device`, so memory stays bounded.
    Returns (X, y) float32 numpy arrays."""
    import torch

    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, size=(n, d))
    W = rng.standard_normal((d, features)) / ell
    b = rng.uniform(0, 2 * np.pi, size=features)
    w = rng.standard_normal(features)  # the feature map draws nothing
    Xt, Wt, bt, wt = (torch.as_tensor(a, dtype=torch.float64, device=device)
                      for a in (X, W, b, w))
    scale = np.sqrt(2.0 * sf2 / features)
    f = torch.cat([scale * torch.cos(Xt[lo:lo + chunk] @ Wt + bt) @ wt
                   for lo in range(0, n, chunk)]).cpu().numpy()
    y = f + noise_std * rng.standard_normal(n)
    return X.astype(np.float32), y.astype(np.float32)


def phase_matrix_free(torch, dev, profile=False, n=100_000, n_acc=16384):
    import math

    import cugp_tpu_torch
    from cugp_tpu_torch.ops import cov_matvec_cuda, kernels

    d = 4
    truth = {"ell": 1.5, "sf2": 1.0, "sn2": 0.04}
    t0 = time.perf_counter()
    X, y = rff_gp_draw(n, d, truth["ell"], truth["sf2"],
                       math.sqrt(truth["sn2"]), seed=0, device=dev)
    rng = np.random.default_rng(2)
    Xs = rng.uniform(-3.0, 3.0, (512, d)).astype(np.float32)
    say("matrix_free", n=n, d=d, data_s=f"{time.perf_counter() - t0:.3f}")

    init = kernels.init_params(d=d, lengthscale=0.6, signal_var=0.3,
                               noise_var=0.3, device=dev)
    # bench_fit_iterative's config C: warm-started, adaptively refreshed
    kw = dict(learning_rate=0.15, precond_rank=128, num_probes=8, tol=1e-4,
              max_iters=300, probe_mode="frozen", warm_start=True)
    steps = 3
    # one warm-up step: kernel loads and the allocator's first buffers
    cugp_tpu_torch.GP(kind="rbf", device=dev).fit_iterative(
        X, y, steps=1, init=init, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, last = [], [time.perf_counter()]

    def step_wall(step, params, value, grads):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - last[0])
        last[0] = now

    gp = cugp_tpu_torch.GP(kind="rbf", device=dev)
    info = gp.fit_iterative(X, y, steps=steps, init=init, callback=step_wall,
                            **kw)
    torch.cuda.synchronize()
    peak_fit = torch.cuda.max_memory_allocated()
    ll0 = init["log_lengthscale"].cpu().numpy()
    ll = gp.params["log_lengthscale"].cpu().numpy()
    loss = info["loss"].numpy()
    say("matrix_free", steps=steps,
        s_per_step=",".join(f"{w:.4f}" for w in walls),
        cg_iters=",".join(map(str, info["cg_iters"].tolist())),
        precond_rebuilds=info["precond_rebuilds"],
        lengthscales=",".join(f"{v:.4f}" for v in np.exp(ll)),
        sf2=f"{float(torch.exp(gp.params['log_signal_var'])):.4f}",
        sn2=f"{float(torch.exp(gp.params['log_noise_var'])):.4f}",
        peak_bytes=peak_fit)
    target = math.log(truth["ell"])
    if not (np.isfinite(loss).all() and np.isfinite(ll).all()):
        fail(f"matrix-free fit: non-finite loss {loss} or params {ll}")
    if not (np.abs(ll - target) < np.abs(ll0 - target)).all():
        fail(f"matrix-free fit: log-lengthscales {ll} did not move from "
             f"{ll0} toward log {truth['ell']}")

    tol = 1e-4
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu, var = gp.predict_iterative(Xs[:128], tol=tol, stats=stats)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    lml = float(gp.log_marginal_likelihood_iterative())
    torch.cuda.synchronize()
    t_lml = time.perf_counter() - t0
    launches = read_launches()
    # the mean solve's residual, recomputed without the kernel
    p = gp.params
    xs = gp.X / torch.exp(p["log_lengthscale"])
    sf2 = torch.exp(p["log_signal_var"])
    scal = torch.stack([sf2, torch.exp(p["log_noise_var"]) + gp.jitter * sf2,
                        torch.ones_like(sf2)])
    alpha = stats["alpha"]
    res = gp.y - cov_matvec_cuda.cov_matvec_plain(xs, alpha[:, None], scal,
                                                  "rbf", n)[:, 0]
    rel_res = float(torch.linalg.vector_norm(res)
                    / torch.linalg.vector_norm(gp.y))
    say("matrix_free", predict_points=128, predict_s=f"{t_pred:.4f}",
        mean_cg_iters=stats["mean_iters"],
        var_cg_iters=",".join(map(str, stats["var_iters"])),
        mean_rel_residual=f"{rel_res:.3e}", lml=f"{lml:.4f}",
        lml_s=f"{t_lml:.4f}",
        launches=json.dumps(launches, separators=(",", ":")))
    mu, var = mu.cpu().numpy(), var.cpu().numpy()
    if not (mu.shape == var.shape == (128,) and np.isfinite(mu).all()
            and np.isfinite(var).all() and math.isfinite(lml)):
        fail("matrix-free predict/LML: wrong shape or non-finite")
    if not rel_res <= 10 * tol:
        fail(f"matrix-free predict: mean-solve residual {rel_res:.3e} "
             f"over 10 tol = {10 * tol:.1e}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"matrix-free path: the {name} kernel was never launched")

    # accuracy: the iterative tier against the dense path on 16,384 rows
    gp_s = cugp_tpu_torch.GP(kind="rbf", device=dev).condition(
        X[:n_acc], y[:n_acc], params=gp.params)
    stats = {}
    mu_i, var_i = gp_s.predict_iterative(Xs, tol=1e-6, stats=stats)
    mu_d, var_d = gp_s.predict(Xs)
    lml_i = float(gp_s.log_marginal_likelihood_iterative())
    lml_d = float(gp_s.log_marginal_likelihood())
    err_mu = float((mu_i - mu_d).abs().max())
    err_var = float((var_i - var_d).abs().max())
    err_lml = abs(lml_i - lml_d) / n_acc
    say("matrix_free", accuracy_n=n_acc, test_points=len(Xs),
        mean_cg_iters=stats["mean_iters"],
        var_cg_iters=",".join(map(str, stats["var_iters"])),
        err_mu=f"{err_mu:.3e}", err_var=f"{err_var:.3e}",
        lml_iterative=f"{lml_i:.4f}", lml_dense=f"{lml_d:.4f}",
        err_lml_per_point=f"{err_lml:.3e}")
    if not (err_mu <= 1e-3 and err_var <= 1e-3):
        fail("matrix-free posterior off the dense one by more than 1e-3")
    if not err_lml <= 0.05:
        fail("matrix-free LML off the dense one by more than 0.05/point")
    # the fit step's [y | z] solve at the fitted params on both CG routes
    from cugp_tpu_torch.inference import iterative

    B = torch.cat([gp.y[:, None], iterative.rademacher(n, 8, dev)], dim=1)
    routes = _cg_routes(torch, iterative.make_matvec(p, gp.X), B,
                        iterative.make_pivoted_precond(p, gp.X, 128),
                        tol=tol, max_iters=300)
    say("matrix_free", part="cg_routes", n=n, rhs=B.shape[1], tol=tol,
        **routes)
    if profile:  # one fit step at the fitted params
        profile_device(torch, "profile", lambda: cugp_tpu_torch.GP(
            kind="rbf", device=dev).fit_iterative(X, y, steps=1,
                                                  init=gp.params, **kw))
    return launches


def phase_dense_api(torch, dev, profile=False, n=8000, n_test=2000,
                    n_cov=256, p=8):
    """The dense GP surface beyond fit/predict at config 2 (N=8000, d=4):
    explicit basis, LOO, L-BFGS, restarts, multi-output, analytic
    gradients, posterior draws, save/load. Every entry point is timed by
    the host clock around synchronized work (after one warm-up fit) and
    gated; the float64 oracle (the port's copy, on the host) times
    itself, and the phase its whole wall. All gates are checked before
    the phase fails. profile: one L-BFGS step and one loo() under
    torch.profiler."""
    import tempfile

    import cugp_tpu_torch
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.models import exact_gp
    from cugp_tpu_torch.ops import kernels
    from cugp_tpu_torch.oracle import exact_gp_np as oracle
    from cugp_tpu_torch.utils.params import params_to_numpy

    X, y, _ = synthetic.multidim_regression(n=n, d=4, seed=0)
    Xs = np.random.default_rng(1).uniform(-2.0, 2.0, (n_test, 4))
    Xt = torch.as_tensor(X, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    X32 = Xt.cpu().numpy().astype(np.float64)
    y32 = yt.cpu().numpy().astype(np.float64)
    Xs32 = np.asarray(Xs, np.float32).astype(np.float64)
    failures, oracle_s = [], [0.0]

    def gate(ok, what):
        if not ok:
            failures.append(what)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def oracle_call(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        oracle_s[0] += time.perf_counter() - t0
        return out

    def err(a, b):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        return float(np.abs(np.asarray(a, np.float64) - b).max())

    t_phase = time.perf_counter()
    reset_launches()
    cugp_tpu_torch.GP(kind="rbf", basis="linear", device=dev).fit(X, y,
                                                                  steps=1)

    # explicit linear basis: fit, predict (diagonal and full_cov), LML
    gp_b = cugp_tpu_torch.GP(kind="rbf", basis="linear", device=dev)
    info, t_fit = timed(lambda: gp_b.fit(X, y, steps=5))
    (mu, var), t_pred = timed(lambda: gp_b.predict(Xs))
    (mu_f, cov), t_full = timed(lambda: gp_b.predict(Xs[:n_cov],
                                                     full_cov=True))
    lml = float(gp_b.log_marginal_likelihood())
    p64 = params_to_numpy(gp_b.params)
    mu64, var64, beta64 = oracle_call(oracle.posterior_basis, p64, X32, y32,
                                      Xs32, basis="linear")
    muf64, cov64, _ = oracle_call(oracle.posterior_basis_full_cov, p64, X32,
                                  y32, Xs32[:n_cov], basis="linear")
    lml64 = oracle_call(oracle.log_marginal_likelihood_basis, p64, X32, y32,
                        basis="linear")
    e = {"mu": err(mu, mu64), "var": err(var, var64),
         "full_mu": err(mu_f, muf64), "full_cov": err(cov, cov64),
         "beta": err(gp_b.beta, beta64), "lml_per_point": abs(lml - lml64) / n}
    say("api", entry="basis", n=n, fit_s_per_step=f"{t_fit / 5:.4f}",
        predict_s=f"{t_pred:.4f}", full_cov_s=f"{t_full:.4f}",
        full_cov_points=n_cov, lml=f"{lml:.4f}", lml64=f"{lml64:.4f}",
        **{f"err_{k}": f"{v:.3e}" for k, v in e.items()})
    gate(all(v <= 1e-3 for v in e.values()),
         "basis: posterior/LML off float64 by more than 1e-3")
    gate(np.isfinite(info["loss"].cpu().numpy()).all(),
         "basis: non-finite loss")
    params = gp_b.params

    # LOO from one factorization (identity solve: TRSM at k = n)
    gp0 = cugp_tpu_torch.GP(kind="rbf", device=dev).condition(X, y,
                                                              params=params)
    r, t_loo = timed(gp0.loo)
    mu_o, var_o, logp_o = oracle_call(oracle.loo_cv, p64, X32, y32)
    e_mu, e_logp = err(r["mean"], mu_o), err(r["logp"], logp_o)
    e_var = float(np.max(np.abs(r["var"].cpu().numpy() - var_o) / var_o))
    say("api", entry="loo", loo_s=f"{t_loo:.4f}", err_mean=f"{e_mu:.3e}",
        rel_err_var=f"{e_var:.3e}", err_logp=f"{e_logp:.3e}",
        pseudo_likelihood=f"{float(r['pseudo_likelihood']):.4f}")
    gate(e_mu <= 2e-3 and e_var <= 2e-3 and e_logp <= 5e-3,
         "loo: off float64 beyond tests/test_loo.py's bars")

    # L-BFGS (optax.lbfgs's zoom line search)
    gp_l = cugp_tpu_torch.GP(kind="rbf", device=dev)
    info, t_lbfgs = timed(lambda: gp_l.fit(X, y, steps=10,
                                           optimizer="lbfgs"))
    loss = info["loss"].cpu().numpy()
    trials = info["linesearch_steps"]
    mu_l, var_l = gp_l.predict(Xs)
    mu64, var64 = oracle_call(oracle.posterior, params_to_numpy(gp_l.params),
                              X32, y32, Xs32)
    e_mu, e_var = err(mu_l, mu64), err(var_l, var64)
    say("api", entry="lbfgs", steps=10, s_per_step=f"{t_lbfgs / 10:.4f}",
        evals_per_step=f"{1 + trials.mean():.2f}",
        linesearch_trials=",".join(map(str, trials.tolist())),
        loss_first=f"{loss[0]:.4f}", loss_last=f"{loss[-1]:.4f}",
        max_rise=f"{np.diff(loss).max():.3e}", err_mu=f"{e_mu:.3e}",
        err_var=f"{e_var:.3e}")
    gate(np.isfinite(loss).all() and (np.diff(loss) <= 0).all(),
         f"lbfgs: loss trace not finite and non-increasing: {loss.tolist()}")
    gate(e_mu <= 1e-3 and e_var <= 1e-3,
         "lbfgs: posterior off float64 by more than 1e-3")

    # restarts (a loop of Adam fits; start 0 is the init exactly)
    gp_r = cugp_tpu_torch.GP(kind="rbf", device=dev)
    info, t_rst = timed(lambda: gp_r.fit(
        X, y, steps=10, restarts=3,
        generator=torch.Generator().manual_seed(0)))
    lmls = info["restart_lmls"].cpu().numpy()
    plain = cugp_tpu_torch.GP(kind="rbf", device=dev).fit(X, y, steps=10)
    rel0 = abs(lmls[0] - float(plain["lml"])) / abs(float(plain["lml"]))
    say("api", entry="restarts", restarts=3, steps=10,
        s_per_step=f"{t_rst / 30:.4f}",
        restart_lmls=",".join(f"{v:.4f}" for v in lmls),
        best_restart=info["best_restart"], rel_err_start0=f"{rel0:.3e}")
    gate(info["best_restart"] == int(np.argmax(lmls))
         and float(info["lml"]) == float(lmls.max()),
         "restarts: best_restart does not hold the least final loss")
    gate(rel0 <= 1e-6, "restarts: start 0 differs from a plain fit")

    # multi-output: one factor, p right-hand sides (TRSM at k = p), at
    # the default hyperparameters. A mean is a sum of n terms K*_ij alpha_i
    # that cancel; the multi and single paths sum them in other orders
    # (GEMM against GEMV), so their gap is held relative to sum |terms|.
    pm = kernels.default_init("rbf", d=4, device=dev)
    Y = torch.stack([yt + 0.1 * j * torch.cos(Xt[:, j % 4])
                     for j in range(p)], dim=1)
    Xst = torch.as_tensor(Xs, dtype=torch.float32, device=dev)
    with torch.no_grad():
        lml_m, t_lm = timed(lambda: exact_gp.log_marginal_likelihood_multi(
            pm, Xt, Y))
        (mu_m, var_m), t_pm = timed(lambda: exact_gp.posterior_multi(
            pm, Xt, Y, Xst))
        singles = [exact_gp.posterior(pm, Xt, Y[:, j], Xst)
                   for j in range(p)]
        lml_s = sum(float(exact_gp.log_marginal_likelihood(pm, Xt, Y[:, j]))
                    for j in range(p))
        L, alpha = exact_gp._factorize(pm, Xt, Y, "rbf", 1e-6, "auto")
        terms = kernels.cross_covariance(pm, Xt, Xst).abs().mT @ alpha.abs()
    rel_lml = abs(float(lml_m) - lml_s) / abs(lml_s)
    gaps = torch.stack([(mu_m[:, j] - m).abs() for j, (m, _) in
                        enumerate(singles)], dim=1)
    e_mu, e_scaled = float(gaps.max()), float((gaps / terms).max())
    e_var = float((var_m - singles[0][1]).abs().max())
    mu64, _ = oracle_call(oracle.posterior, params_to_numpy(pm), X32,
                          Y[:, p - 1].double().cpu().numpy(), Xs32)
    e64 = err(mu_m[:, p - 1], mu64)
    say("api", entry="multi_output", p=p, lml_s=f"{t_lm:.4f}",
        posterior_s=f"{t_pm:.4f}", rel_err_lml=f"{rel_lml:.3e}",
        err_mu=f"{e_mu:.3e}", err_mu_over_sum_abs_terms=f"{e_scaled:.3e}",
        err_var=f"{e_var:.3e}", err_mu_last_vs_float64=f"{e64:.3e}")
    gate(rel_lml <= 1e-5 and e_scaled <= 1e-5 and e_var <= 1e-5
         and e64 <= 1e-3, "multi-output: off the single-output path")

    # analytic LML gradients against autograd
    for kind in ("rbf", "rq", "periodic"):
        pk = kernels.default_init(kind, d=4, device=dev)
        g_an, t_an = timed(lambda: exact_gp.lml_gradients_analytic(
            pk, Xt, yt, kind=kind))
        (_, g_ad), t_ad = timed(lambda: exact_gp.lml_value_and_grad(
            pk, Xt, yt, kind=kind))
        rel = max(float(((g_an[k] - g_ad[k]).abs()
                         / g_ad[k].abs()).max()) for k in g_ad)
        say("api", entry="analytic_gradients", kind=kind,
            analytic_s=f"{t_an:.4f}", autograd_s=f"{t_ad:.4f}",
            max_rel_err=f"{rel:.3e}")
        gate(rel <= 1e-3, f"analytic gradients ({kind}) off autograd")
        del g_an, g_ad
    torch.cuda.empty_cache()

    # posterior draws (full covariance, jitter ladder, potrf base blocks);
    # zero-mean, as the JAX GP draws them whatever its basis
    draws, t_draw = timed(lambda: gp0.sample_posterior(
        Xs, num_samples=64, generator=torch.Generator().manual_seed(0)))
    mu_d, var_d = (a.cpu().numpy() for a in gp0.predict(Xs))
    draws = draws.cpu().numpy()
    sd = np.sqrt(var_d + 1e-6)
    z = np.abs(draws.mean(axis=0) - mu_d) / (5.0 * sd / np.sqrt(64) + 1e-3)
    ratio = draws.var(axis=0) / (var_d + 1e-6)
    say("api", entry="sample_posterior", points=n_test, draws=64,
        s=f"{t_draw:.4f}", max_mean_over_bound=f"{z.max():.3f}",
        var_ratio_min=f"{ratio.min():.3f}",
        var_ratio_max=f"{ratio.max():.3f}")
    gate(draws.shape == (64, n_test) and np.isfinite(draws).all()
         and z.max() <= 1.0 and ((ratio > 0.3) & (ratio < 3.0)).all(),
         "sample_posterior: draws outside tests/test_api.py's bounds")

    # save/load: the loaded model predicts bitwise as before
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gp")
        _, t_save = timed(lambda: gp_b.save(path))
        back, t_load = timed(lambda: cugp_tpu_torch.GP.load(path,
                                                            device=dev))
        before, after = gp_b.predict(Xs), back.predict(Xs)
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    say("api", entry="save_load", save_s=f"{t_save:.4f}",
        load_s=f"{t_load:.4f}", bitwise=same,
        device=str(back.X.device))
    gate(same, "save/load: predictions changed")
    gate(back.X.is_cuda, "save/load: the loaded model is not on the card")

    launches = read_launches()
    say("api", wall_s=f"{time.perf_counter() - t_phase:.3f}",
        oracle_s=f"{oracle_s[0]:.3f}",
        launches=json.dumps(launches, separators=(",", ":")))
    for name in ("cov", "potrf", "trsm"):
        gate(launches[name] > 0, f"dense API: the {name} kernel was never "
             "launched")
    # the basis factor's sizes (m_b = 1 for "constant", d + 1 for
    # "linear"), which phase 2 does not reach, against the plain version
    from cugp_tpu_torch.ops import chol_cuda

    for m in range(1, 6):
        A = _spd(torch, m, dev, seed=m)
        got = chol_cuda.potrf_(A.clone())
        e = float((got.tril() - chol_cuda.potrf_plain(A)).abs().max())
        say("api", entry="potrf_basis_size", n=m, max_abs_err=f"{e:.3e}")
        gate(e <= 1e-5, f"potrf at n={m} off its plain version")
    if failures:
        fail("dense API: " + "; ".join(failures))
    if profile:
        profile_device(torch, "profile_api_lbfgs", lambda: cugp_tpu_torch.GP(
            kind="rbf", device=dev).fit(X, y, steps=1, optimizer="lbfgs"))
        profile_device(torch, "profile_api_loo", gp0.loo)
    return launches


def _flat_of(samples):
    """The samplers' (S, C, D) flat draws from their params tree, in
    jax's tree order."""
    import torch

    from cugp_tpu_torch.utils.params import sorted_leaves

    return torch.cat([t.reshape(t.shape[0], t.shape[1], -1)
                      for t in sorted_leaves(samples)], dim=-1)


def _chain_stats(torch, flat):
    """Per coordinate of (S, C, D) draws: mean, variance, split R-hat,
    ESS, and the Monte Carlo standard error of the mean."""
    from cugp_tpu_torch.inference import sampling

    out = []
    for j in range(flat.shape[-1]):
        x = flat[..., j].double()
        var = float(x.var())
        ess = float(sampling.effective_sample_size(x))
        out.append({"mean": float(x.mean()), "var": var,
                    "rhat": float(sampling.potential_scale_reduction(x)),
                    "ess": ess, "se": (var / max(ess, 1.0)) ** 0.5})
    return out


def phase_samplers(torch, dev, profile=False, n=512, chains=256, warmup=64,
                   draws=64, nuts_warmup=64, nuts_draws=128, vi_steps=300):
    """BASELINE config 3: hyperparameter HMC, NUTS and VI over 256
    batched chains on sinusoid_1d(n=512), rbf (benchmarks/bench_hmc.py's
    data and init), every chain in one batched LML an evaluation."""
    import cugp_tpu_torch
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import hmc, sampling
    from cugp_tpu_torch.ops import cholesky, kernels
    from cugp_tpu_torch.oracle import exact_gp_np as oracle

    failures = []

    def gate(ok, what):
        if not ok:
            say("samplers", FAILED=repr(what))
            failures.append(what)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_launches()
    t_phase = time.perf_counter()
    X, y, _ = synthetic.sinusoid_1d(n=n, noise_std=0.1, seed=0)
    gp = cugp_tpu_torch.GP(kind="rbf", device=dev).condition(
        X, y, params=kernels.init_params(d=1, lengthscale=0.8,
                                         noise_var=0.05))
    lpg, unravel, q0 = sampling.make_flat_logprob(gp.params, gp.X, gp.y)
    names = ["log_lengthscale", "log_noise_var", "log_signal_var"]  # q's

    # (a) 8 chain states in one batched call: against the float64 oracle
    # (LML and its gradient plus the prior), against the same states one
    # at a time, each state alone in a batch of 8 copies of itself, and
    # with one chain forced through the jitter ladder
    qs = q0[None, :] + 0.3 * torch.randn(8, q0.numel(), device=dev,
                                         generator=gen(2))
    (logp, grad), t_eval = synced(lambda: lpg(qs))
    worst = {"oracle_logp": 0.0, "oracle_grad": 0.0,
             "oracle_grad_single": 0.0, "single_logp": 0.0,
             "single_grad": 0.0}
    alone = True
    for i in range(8):
        q = qs[i].double().cpu().numpy()
        p64 = {"log_lengthscale": q[:1], "log_noise_var": q[1],
               "log_signal_var": q[2]}
        lp64 = (oracle.log_marginal_likelihood(p64, X, y)
                - 0.5 * float(np.sum((q / 3.0) ** 2)))
        g = oracle.lml_gradients(p64, X, y)
        g64 = np.array([float(np.ravel(g[k])[0]) for k in names]) - q / 9.0
        lp1, g1 = lpg(qs[i:i + 1])
        gi = grad[i].double().cpu().numpy()
        worst["oracle_logp"] = max(worst["oracle_logp"],
                                   abs(float(logp[i]) - lp64) / abs(lp64))
        worst["oracle_grad"] = max(worst["oracle_grad"], float(
            np.abs(gi - g64).max() / np.abs(g64).max()))
        worst["oracle_grad_single"] = max(worst["oracle_grad_single"], float(
            np.abs(g1[0].double().cpu().numpy() - g64).max()
            / np.abs(g64).max()))
        worst["single_logp"] = max(worst["single_logp"], abs(
            float(lp1[0]) - float(logp[i])) / abs(float(logp[i])))
        worst["single_grad"] = max(worst["single_grad"], float(
            (g1[0] - grad[i]).abs().max() / grad[i].abs().max()))
        lp8, g8 = lpg(qs[i].expand(8, -1).contiguous())
        alone &= bool(torch.equal(lp8[0], logp[i])
                      and torch.equal(g8[0], grad[i]))
    say("samplers", case="8 states, one batched call",
        eval_s=f"{t_eval:.4f}",
        **{f"rel_err_{k}": f"{v:.3e}" for k, v in worst.items()},
        each_alone_in_a_batch_of_8_bitwise=alone)
    gate(worst["oracle_logp"] <= 1e-3 and worst["oracle_grad"] <= 1e-3
         and worst["oracle_grad_single"] <= 1e-3,
         "log density or gradient (batched or one at a time) off the "
         "float64 oracle by more than 1e-3")
    # What a batch of 1 computes otherwise than a batch of 8: element 0
    # of each of the path's torch primitives at both sizes, bitwise or
    # not (the hand kernels are held bitwise to the loop in phase 2).
    Ls = cholesky.cholesky(kernels.train_covariance(unravel(qs), gp.X))
    Lbar = torch.randn(Ls.shape, device=dev, generator=gen(6))
    probes = {
        "gemm_LT_Lbar_n3": lambda b: Ls[:b].mT @ Lbar[:b],
        "gemm_nxn_by_nx1": lambda b: Lbar[:b] @ Ls[:b, :, :1],
        "sum_over_nxn": lambda b: (Ls[:b] * Lbar[:b]).sum((-2, -1)),
        "sum_over_n": lambda b: Lbar[:b, :, 0].sum(-1),
    }
    for name, f in probes.items():
        one, eight = f(1)[0], f(8)[0]
        say("samplers", case="batch of 1 against element 0 of 8",
            primitive=name, bitwise=bool(torch.equal(one, eight)),
            max_rel=f"{float((one - eight).abs().max() / eight.abs().max()):.3e}")
    del Ls, Lbar
    # one at a time (a batch of 1): the log density at 1e-5; the gradient
    # at 1e-4 of its largest component. The primitives above that differ
    # at a batch of 1 move the gradient, whose terms cancel. On an H100
    # 80GB HBM3 at 700 W both GEMMs and the sum over n differed; the
    # gradient one at a time lay 1.647e-05 of its largest component off
    # float64, the batched one 6.100e-06, the two 1.556e-05 apart: a
    # 1e-5 bar between them is finer than fp32 computes the gradient. A
    # chain alone in a batch of 8 is bitwise its value in the mixed batch
    # (the gate below)
    gate(worst["single_logp"] <= 1e-5 and worst["single_grad"] <= 1e-4,
         "batched evaluation off the one-at-a-time one (log density 1e-5, "
         "gradient 1e-4)")
    gate(alone, "a chain's log density or gradient depends on the other "
         "chains of its batch")
    bad = qs.clone()
    bad[3] = torch.tensor([0.0, -20.0, 0.0], device=dev)  # ell 1, sn2 2e-9
    K3 = kernels.train_covariance(unravel(bad[3]), gp.X)
    first = bool(torch.isfinite(cholesky.cholesky(K3)).all())
    logp_b, grad_b = lpg(bad)
    keep = [i for i in range(8) if i != 3]
    kept = torch.equal(logp_b[keep], logp[keep])
    retried = bool(torch.isfinite(logp_b[3]) and torch.isfinite(grad_b[3]).all())
    say("samplers", case="chain 3 not PD", first_factor_finite=first,
        retried_finite=retried, others_bitwise=kept)
    gate(not first and retried and kept,
         "the jitter ladder: chain 3 not forced, not repaired, or the "
         "others' values changed")
    del K3

    # (b) HMC through GP.sample_hyperparams: 32 leapfrog steps,
    # warmup + draws transitions
    out, t_hmc = synced(lambda: gp.sample_hyperparams(
        sampler="hmc", num_chains=chains, num_warmup=warmup,
        num_samples=draws, generator=gen(3)))
    flat_h = _flat_of(out["samples"])
    kernel = hmc.make_hmc_kernel(lpg, n_leapfrog=32)
    state = hmc.init_state(flat_h[-1].contiguous(), lpg)
    seg_draws = 8
    _, t_seg = synced(lambda: hmc.sample_segment(
        state, gen(4), kernel, out["eps"], out["inv_mass"], seg_draws))
    st_h = _chain_stats(torch, flat_h)
    acc = float(out["accept_rate"])
    say("samplers", sampler="hmc", chains=chains, warmup=warmup,
        draws=draws, leapfrog=32, wall_s=f"{t_hmc:.3f}",
        samples_per_s_total=f"{draws * chains / t_hmc:.2f}",
        samples_per_s_after_warmup=f"{seg_draws * chains / t_seg:.2f}",
        s_per_transition=f"{t_seg / seg_draws:.4f}",
        accept_rate=f"{acc:.4f}", eps=f"{float(out['eps']):.4f}")
    for name, st in zip(names, st_h):
        say("samplers", sampler="hmc", hyperparameter=name,
            mean=f"{st['mean']:.4f}", sd=f"{st['var'] ** 0.5:.4f}",
            rhat=f"{st['rhat']:.4f}", ess=f"{st['ess']:.1f}")
        gate(st["rhat"] <= 1.1, f"HMC R-hat of {name} over 1.1")
    gate(0.5 <= acc <= 0.95, "HMC accept rate outside 0.5-0.95")

    # (c) NUTS, max_tree_depth 6
    out_n, t_nuts = synced(lambda: gp.sample_hyperparams(
        sampler="nuts", num_chains=chains, num_warmup=nuts_warmup,
        num_samples=nuts_draws, max_tree_depth=6, generator=gen(5)))
    st_n = _chain_stats(torch, _flat_of(out_n["samples"]))
    say("samplers", sampler="nuts", chains=chains, warmup=nuts_warmup,
        draws=nuts_draws, max_tree_depth=6, wall_s=f"{t_nuts:.3f}",
        samples_per_s_total=f"{nuts_draws * chains / t_nuts:.2f}",
        accept_rate=f"{float(out_n['accept_rate']):.4f}",
        divergence_rate=f"{float(out_n['divergence_rate']):.4f}",
        mean_leapfrog=f"{float(out_n['mean_leapfrog']):.2f}")
    for name, a, b in zip(names, st_h, st_n):
        z = abs(a["mean"] - b["mean"]) / (a["se"] ** 2 + b["se"] ** 2) ** 0.5
        say("samplers", sampler="nuts", hyperparameter=name,
            mean=f"{b['mean']:.4f}", sd=f"{b['var'] ** 0.5:.4f}",
            rhat=f"{b['rhat']:.4f}", ess=f"{b['ess']:.1f}",
            hmc_gap_in_se=f"{z:.3f}")
        gate(b["rhat"] <= 1.1, f"NUTS R-hat of {name} over 1.1")
        gate(z <= 5.0, f"HMC and NUTS means of {name} over 5 MC SE apart")

    # (d) a standard Gaussian target at 256 chains on the card
    def gauss(q):
        return -0.5 * torch.sum(q * q, dim=-1), -q

    out_g = hmc.run_hmc(torch.randn(chains, 3, device=dev, generator=gen(6)),
                        gen(7), gauss, n_leapfrog=16, num_warmup=100,
                        num_samples=100, eps0=0.2)
    st_g = _chain_stats(torch, out_g["samples_flat"])
    z_g = max(abs(st["mean"]) / st["se"] for st in st_g)
    ratios = [st["var"] for st in st_g]
    say("samplers", target="standard gaussian, dim 3", chains=chains,
        max_mean_in_se=f"{z_g:.3f}",
        var_ratios=",".join(f"{r:.4f}" for r in ratios))
    gate(z_g <= 5.0 and all(0.8 <= r <= 1.25 for r in ratios),
         "HMC on a standard Gaussian: a mean over 5 MC SE or a variance "
         "ratio outside 0.8-1.25")

    # (e) VI, mean-field
    out_v, t_vi = synced(lambda: gp.fit_vi(steps=vi_steps,
                                           learning_rate=0.02, num_mc=8,
                                           generator=gen(8)))
    elbo = out_v["elbo"].cpu().numpy()
    m_v = out_v["vp"]["mean"].cpu().numpy()
    z_v = [abs(m - st["mean"]) / st["var"] ** 0.5 for m, st in zip(m_v, st_h)]
    say("samplers", vi="meanfield", steps=vi_steps, num_mc=8,
        s_per_step=f"{t_vi / vi_steps:.4f}",
        elbo_first=f"{elbo[:30].mean():.3f}",
        elbo_last=f"{elbo[-30:].mean():.3f}",
        mean_gap_in_hmc_sd=",".join(f"{z:.3f}" for z in z_v))
    gate(elbo[-30:].mean() > elbo[:30].mean(), "VI: the ELBO did not rise")
    gate(max(z_v) <= 3.0, "VI mean over 3 HMC posterior SDs from HMC's")

    launches = read_launches()
    say("samplers", wall_s=f"{time.perf_counter() - t_phase:.3f}",
        launches=json.dumps(launches, separators=(",", ":")))
    for name in ("cov", "potrf", "trsm"):
        gate(launches[name] > 0, f"samplers: the {name} kernel was never "
             "launched")
    if failures:
        fail("samplers: " + "; ".join(failures))
    if profile:
        profile_device(torch, "profile_samplers_hmc_transition",
                       lambda: kernel(state, gen(9), out["eps"],
                                      out["inv_mass"]))
    return launches


def _per_probe_grads(torch, lpg_args, q, precond, Z, block=2048):
    """The gradient estimate of one chain state q (D,) split over its
    probes: (P, D), whose mean is make_iterative_logprob's LML gradient
    (without the prior) and whose spread gives its Monte Carlo standard
    error. One batched AD sweep: element j is the estimator with probe j
    alone, 1/2 (alpha^T K alpha - w_j^T K z_j)."""
    from cugp_tpu_torch.inference import iterative

    X, y, unravel, kind, tol = lpg_args
    n, P = Z.shape
    with torch.no_grad():
        mv = iterative.make_matvec(unravel(q), X, kind=kind)
        sol, _ = iterative.cg_solve(
            mv, torch.cat([y[:, None], Z], dim=1), tol=tol, max_iters=500,
            precond_apply=iterative.precond_apply_from_factors(*precond))
    alpha, w = sol[:, 0], sol[:, 1:]
    qs = q.expand(P, -1).clone().requires_grad_(True)
    with torch.enable_grad():
        mvp = iterative.make_matvec(unravel(qs), X, kind=kind, block=block,
                                    method="blocked")
        rhs = torch.stack([alpha.expand(P, n), Z.mT], dim=-1)  # (P, n, 2)
        out = mvp(rhs)
        est = 0.5 * (torch.sum(alpha * out[..., 0], dim=-1)
                     - torch.sum(w.mT * out[..., 1], dim=-1))
        (g,) = torch.autograd.grad(est.sum(), qs)
    return g


def phase_iterative_sampling(torch, dev, profile=False, n=32768, chains=8,
                             warmup=2, draws=2, n_leapfrog=4, probes=16,
                             steps=32, rank=128, n_gate=8, resume_n=2048):
    """Matrix-free hyperparameter HMC at n=32768 (benchmarks/bench_hmc.py's
    iterative engine: sinusoid_1d(n), rbf, init lengthscale 0.8, noise
    0.05; 8 chains, 16 frozen probes, 32 SLQ steps, a rank-128
    preconditioner, CG tol 1e-5), through
    sample_hyperparams_checkpointed(engine="iterative"): half the draws
    into a checkpoint, then a resumed call to all of them (cut to
    num_warmup=2, three warm-up transitions, and 2 draws of 4 leapfrog
    steps, JAX's 16; PERF.md §4).
    Gates: the batched
    density against each chain alone; against the dense exact LML (value
    per point, gradient within 5 MC SE of its probes); finite draws; a
    killed-and-resumed run bitwise at n=2048 for both engines."""
    import shutil
    import tempfile

    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import iterative, sampling
    from cugp_tpu_torch.ops import kernels

    failures = []

    def gate(ok, what):
        if not ok:
            say("iterative_hmc", FAILED=repr(what))
            failures.append(what)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t_phase = time.perf_counter()
    tol = 1e-5
    Xn, yn, _ = synthetic.sinusoid_1d(n=n, noise_std=0.1, seed=0)
    X = torch.as_tensor(Xn, dtype=torch.float32, device=dev)
    y = torch.as_tensor(yn, dtype=torch.float32, device=dev)
    init = kernels.init_params(d=1, lengthscale=0.8, noise_var=0.05,
                               device=dev)
    precond, t_pre = synced(lambda: iterative.precond_factors(init, X, rank))
    lpg, unravel, q0 = sampling.make_iterative_logprob(
        init, X, y, num_probes=probes, num_steps=steps, tol=tol,
        precond=precond)
    Z = iterative.rademacher(n, probes, dev, torch.Generator().manual_seed(
        sampling.DEFAULT_PROBE_SEED))  # lpg's default: a CPU generator's
    qs = sampling.init_chains(q0, gen(2), chains)
    lpg(qs)  # kernel loads and the allocator's first buffers
    (logp, grad), t_eval = synced(lambda: lpg(qs))
    say("iterative_hmc", n=n, chains=chains, probes=probes, slq_steps=steps,
        precond_rank=rank, precond_s=f"{t_pre:.4f}",
        eval_s=f"{t_eval:.4f}",
        cg_diagnostic_init=sampling.cg_diagnostic(init, precond, X, y,
                                                  tol=tol))

    # (a) each chain alone on the same probes and factors
    worst_lp = worst_g = 0.0
    for i in range(chains):
        lp1, g1 = lpg(qs[i:i + 1])
        worst_lp = max(worst_lp, abs(float(lp1[0]) - float(logp[i]))
                       / abs(float(logp[i])))
        worst_g = max(worst_g, float((g1[0] - grad[i]).abs().max()
                                     / grad[i].abs().max()))
    say("iterative_hmc", case="batched against each chain alone",
        rel_err_logp=f"{worst_lp:.3e}", rel_err_grad=f"{worst_g:.3e}")
    gate(worst_lp <= 1e-5 and worst_g <= 1e-4,
         "batched matrix-free density off each chain alone (log density "
         "1e-5 rel, gradient 1e-4 of its largest component)")

    # (b) against the dense exact LML, one chain at a time
    dense, _, _ = sampling.make_flat_logprob(init, X, y)
    worst_v, worst_z, dense_peak = 0.0, 0.0, 0
    for i in range(min(n_gate, chains)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lp_d, g_d = dense(qs[i:i + 1])
        torch.cuda.synchronize()
        dense_peak = max(dense_peak, torch.cuda.max_memory_allocated())
        gp = _per_probe_grads(torch, (X, y, unravel, "rbf", tol), qs[i],
                              precond, Z)
        se = gp.std(0, correction=1) / probes ** 0.5
        z = ((grad[i] - g_d[0]).abs() / se).cpu().numpy()
        dv = abs(float(logp[i]) - float(lp_d[0])) / n
        worst_v, worst_z = max(worst_v, dv), max(worst_z, float(z.max()))
        say("iterative_hmc", case=f"chain {i} against the dense LML",
            logp=f"{float(logp[i]):.4f}", logp_dense=f"{float(lp_d[0]):.4f}",
            err_per_point=f"{dv:.3e}",
            grad=",".join(f"{v:.4f}" for v in grad[i].tolist()),
            grad_dense=",".join(f"{v:.4f}" for v in g_d[0].tolist()),
            grad_gap_in_se=",".join(f"{v:.3f}" for v in z))
        del gp
    gate(worst_v <= 0.05, "matrix-free log density off the dense one by "
         "more than 0.05 a point (phase 5's SLQ bar)")
    gate(worst_z <= 5.0, "matrix-free gradient over 5 MC SE off the dense "
         "one")
    del dense
    torch.cuda.empty_cache()

    # (c) the main path: the checkpointed sampler, killed half way; the
    # preconditioner builds and each batched CG solve's iterations (the
    # slowest chain's, which the loop runs, and the chains' mean) counted
    builds, cg_max, cg_mean = [0], [], []
    build, solve = iterative.precond_factors, iterative.cg_solve

    def counted(*a, **kw):
        builds[0] += 1
        return build(*a, **kw)

    def counted_solve(*a, **kw):
        x, its = solve(*a, **kw)
        if isinstance(its, torch.Tensor):
            cg_max.append(int(its.max()))
            cg_mean.append(float(its.double().mean()))
        return x, its

    iterative.precond_factors = counted
    iterative.cg_solve = counted_solve
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    kw = dict(checkpoint_every=draws // 2, num_chains=chains,
              num_warmup=warmup,
              sampler="hmc", n_leapfrog=n_leapfrog, engine="iterative",
              cg_tol=tol, num_probes=probes, num_steps=steps,
              precond_rank=rank)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        part, t_part = synced(lambda: sampling.sample_hyperparams_checkpointed(
            init, X, y, checkpoint_dir=os.path.join(tmp, "run"),
            num_samples=draws // 2, rng=gen(3), **kw))
        out, t_rest = synced(lambda: sampling.sample_hyperparams_checkpointed(
            init, X, y, checkpoint_dir=os.path.join(tmp, "run"),
            num_samples=draws, rng=gen(3), **kw))
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        iterative.precond_factors, iterative.cg_solve = build, solve
        shutil.rmtree(tmp, ignore_errors=True)
    flat = out["samples_flat"]
    end = unravel(flat[-1].mean(0))
    cg_end = sampling.cg_diagnostic(end, precond, X, y, tol=tol)
    seg_iters = part["cg_iters_per_segment"] + out["cg_iters_per_segment"]
    transitions = draws - draws // 2
    dense_est = chains * dense_peak
    say("iterative_hmc", sampler="hmc", chains=chains, warmup=warmup,
        draws=draws, leapfrog=n_leapfrog, first_call_s=f"{t_part:.3f}",
        resumed_call_s=f"{t_rest:.3f}", resumed=out["resumed"],
        samples_per_s=f"{draws * chains / (t_part + t_rest):.4f}",
        s_per_transition=f"{t_rest / transitions:.4f}",
        accept_rate=f"{float(out['accept_rate']):.4f}",
        eps=f"{float(out['eps']):.5f}",
        cg_iters_per_segment=",".join(f"{v:.0f}" for v in seg_iters),
        precond_refreshes=builds[0] - 1,
        cg_diagnostic_end=f"{cg_end:.0f}", evaluations=len(cg_max),
        cg_iters_slowest_chain_mean=f"{np.mean(cg_max):.2f}",
        cg_iters_slowest_chain_max=max(cg_max),
        cg_iters_chain_mean=f"{np.mean(cg_mean):.2f}", peak_bytes=peak,
        dense_engine_bytes_est=dense_est,
        launches=json.dumps(launches, separators=(",", ":")))
    gate(part["draws_done"] == draws // 2 and not part["resumed"]
         and out["resumed"] and out["draws_done"] == draws
         and tuple(flat.shape) == (draws, chains, q0.numel()),
         "the checkpointed run did not resume to the full draw count")
    gate(bool(torch.equal(flat[:draws // 2], part["samples_flat"])),
         "the resumed run changed the first call's draws")
    gate(bool(torch.isfinite(flat).all()), "non-finite draws")
    for name, count in launches.items():
        gate(count > 0, f"the {name} kernel was never launched")

    # (d) killed-and-resumed equals uninterrupted, both engines, n=2048
    Xs = X[:: n // resume_n][:resume_n].contiguous()
    ys = y[:: n // resume_n][:resume_n].contiguous()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        for engine, extra in (("dense", {}), ("iterative", dict(
                precond_rank=rank, num_probes=probes, num_steps=steps,
                refresh_factor=1e-3))):
            small = dict(checkpoint_every=2, num_chains=4, num_warmup=4,
                         sampler="hmc", n_leapfrog=4, engine=engine,
                         **extra)

            def run(name, k):
                return sampling.sample_hyperparams_checkpointed(
                    init, Xs, ys, checkpoint_dir=os.path.join(tmp, name),
                    num_samples=k, rng=gen(4), **small)

            full = run(engine + "_full", 6)
            run(engine + "_part", 2)
            res = run(engine + "_part", 6)
            same = bool(torch.equal(res["samples_flat"],
                                    full["samples_flat"]))
            say("iterative_hmc", case="killed and resumed", engine=engine,
                n=resume_n, chains=4, draws=6, resumed=res["resumed"],
                bitwise=same)
            gate(same and res["resumed"],
                 f"{engine} engine: resumed draws differ from the "
                 "uninterrupted run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("iterative_hmc", wall_s=f"{time.perf_counter() - t_phase:.3f}")
    if failures:
        fail("iterative samplers: " + "; ".join(failures))
    if profile:  # one evaluation of the 8 chains at their last draws
        last = flat[-1].contiguous()
        profile_device(torch, "profile_iterative_eval", lambda: lpg(last))
    return launches


class Gates:
    """A phase's gates and launch-counted paths: a failed gate prints a
    FAILED line and is collected, so that the phase reports every failed
    gate before it fails (finish)."""

    def __init__(self, torch, tag):
        self.torch, self.tag = torch, tag
        self.failures, self.paths = [], {}

    def gate(self, ok, what):
        if not ok:
            say(self.tag, FAILED=repr(what))
            self.failures.append(what)

    def synced(self, fn):
        """(fn(), host seconds around it between two synchronizations)."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def path(self, part, fn, launched, not_launched=()):
        """fn() as a path: launch counters and peak memory around it; each
        kernel named in `launched` must have launched, none in
        `not_launched`. Returns (fn(), seconds, peak bytes)."""
        cuda = self.torch.cuda
        cuda.synchronize()
        cuda.reset_peak_memory_stats()
        reset_launches()
        out, wall = self.synced(fn)
        launches = read_launches()
        self.paths[part] = launches
        peak = cuda.max_memory_allocated()
        say(self.tag, part=part, wall_s=f"{wall:.4f}", peak_bytes=peak,
            launches=json.dumps(launches, separators=(",", ":")))
        for name in launched:
            self.gate(launches[name] > 0,
                      f"{part}: the {name} kernel was never launched")
        for name in not_launched:
            self.gate(launches[name] == 0,
                      f"{part}: the {name} kernel was launched")
        return out, wall, peak

    def finish(self, phase):
        if self.failures:
            fail(f"{phase}: {len(self.failures)} gate(s) failed: "
                 f"{self.failures}")


# ---- phase 9: the sparse and classification families ----

GPC_GATE_N = 1024  # the JAX CLI's default n for classify


def _gpc_gate_problem(kind):
    """(float32 params, X, y (labels in {-1,+1}) or one-hot Y, Xs) of the
    n=1024 gates: the JAX tests' hyperparameters, 200 test points."""
    from cugp_tpu_torch.data import synthetic

    def params(ell, sf2):
        return {"log_lengthscale": np.full(2, np.log(ell), np.float32),
                "log_signal_var": np.float32(np.log(sf2)),
                "log_noise_var": np.float32(np.log(1e-2))}

    rng = np.random.default_rng(2)
    if kind == "multiclass":
        X, y = synthetic.gaussian_blobs(n=GPC_GATE_N, num_classes=3, seed=1)
        Xs = rng.uniform(-3.0, 3.0, (200, 2)).astype(np.float32)
        return params(0.9, 1.5), X, np.eye(3, dtype=np.float32)[y], Xs
    X, y = synthetic.two_moons(n=GPC_GATE_N, seed=1)
    Xs = rng.uniform(-1.0, 2.0, (200, 2)).astype(np.float32)
    return params(0.7, 2.0), X, y, Xs


def _gpc_oracle(kind):
    """The float64 oracle of a gate (the port's copies), run in a worker
    process while the card works."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cugp_tpu_torch.oracle import gpc_ep_np, gpc_multiclass_np, gpc_np

    p, X, y, Xs = _gpc_gate_problem(kind)
    p = {k: np.asarray(v, np.float64) for k, v in p.items()}
    X, y, Xs = (a.astype(np.float64) for a in (X, y, Xs))
    if kind == "laplace":
        return gpc_np.laplace_lml(p, X, y), gpc_np.predict_proba(p, X, y, Xs)
    if kind == "ep":
        return gpc_ep_np.ep_lml(p, X, y), gpc_ep_np.predict_proba(p, X, y,
                                                                  Xs)
    return (gpc_multiclass_np.laplace_lml(p, X, y),
            gpc_multiclass_np.latent_predictive(p, X, y, Xs),
            gpc_multiclass_np.predict_proba(p, X, y, Xs[:50],
                                            num_samples=40000)[0])


def _sgpr_oracle(p, Z, X, y, Xs, jitter=1e-6):
    """models/sgpr's collapsed ELBO and posterior (rbf) in float64 NumPy
    at the given params and inducing rows: (elbo, mean, var)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scipy import linalg as sla

    from cugp_tpu_torch.oracle import exact_gp_np as oracle

    p = {k: np.asarray(v, np.float64) for k, v in p.items()}
    Z, X, y, Xs = (np.asarray(a, np.float64) for a in (Z, X, y, Xs))
    m, n = Z.shape[0], X.shape[0]
    sn2, sf2 = np.exp(p["log_noise_var"]), np.exp(p["log_signal_var"])
    L = sla.cholesky(oracle.kernel_matrix(p, Z, Z, "rbf")
                     + (jitter * sf2 + 1e-6) * np.eye(m), lower=True)
    A = sla.solve_triangular(L, oracle.kernel_matrix(p, Z, X, "rbf"),
                             lower=True) / np.sqrt(sn2)
    LB = sla.cholesky(np.eye(m) + A @ A.T, lower=True)
    c = sla.solve_triangular(LB, A @ y, lower=True) / np.sqrt(sn2)
    elbo = (-0.5 * n * (np.log(2 * np.pi) + np.log(sn2))
            - np.sum(np.log(np.diag(LB))) - 0.5 * (y @ y) / sn2
            + 0.5 * (c @ c) - 0.5 * n * sf2 / sn2 + 0.5 * np.sum(A * A))
    t1 = sla.solve_triangular(L, oracle.kernel_matrix(p, Z, Xs, "rbf"),
                              lower=True)
    t2 = sla.solve_triangular(LB, t1, lower=True)
    var = sf2 - np.sum(t1 * t1, axis=0) + np.sum(t2 * t2, axis=0)
    return float(elbo), t2.T @ c, np.maximum(var, 0.0)


def phase9_kernel_shapes(torch, dev, gate, k=131072, n_batch=4096):
    """The kernels at the shapes phase 9 is the first to reach, each
    against its plain version and timed beside the library call and its
    bound: TRSM at n=512 with 131,072 right-hand sides (SGPR's L^-1 K_mn),
    the 512 x 131,072 cross covariance (K_mn), the (3, 4096, 4096)
    Cholesky batch of the multiclass model (base blocks on potrf's
    cooperative route)."""
    from cugp_tpu_torch.ops import chol_cuda, cov_cuda, trsm_cuda
    from cugp_tpu_torch.ops import cholesky as chol_ops

    rows = {}
    n = 512
    L = chol_cuda.potrf(_spd(torch, n, dev, 21))
    B = torch.randn(n, k, generator=torch.Generator().manual_seed(3)).to(dev)
    Xk = trsm_cuda.trsm_(L, B.clone())
    res = float(_trsm_residual(L, Xk, B, True, False))
    err = float((Xk - trsm_cuda.trsm_plain(L, B)).abs().max())
    gate(res <= 1e-5, f"trsm n={n} k={k}: residual {res:.3e} (bar 1e-5)")
    ms = cuda_ms(lambda: trsm_cuda.trsm_(L, B.clone()), iters=5)
    plain_ms = cuda_ms(lambda: trsm_cuda.trsm_plain(L, B), iters=5)
    lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(L, B,
                                                           upper=False),
                     iters=5)
    rows["trsm"] = (f"n={n} k={k}", ms, plain_ms, lib_ms, *_trsm_bound(n, k),
                    f"residual={res:.3e} max_abs_err={err:.3e}")
    del B, Xk

    rng = np.random.default_rng(8)
    xs1 = torch.as_tensor(rng.uniform(-2, 2, (512, 4)) / 1.5,
                          dtype=torch.float32, device=dev)
    xs2 = torch.as_tensor(rng.uniform(-2, 2, (k, 4)) / 1.5,
                          dtype=torch.float32, device=dev)
    scal = torch.tensor([1.0, 0.0, 1.0], device=dev)
    got = cov_cuda.cov_tile(xs1, xs2, scal, "rbf", False, 512, k)
    err, err64 = cov_against_plain(torch, f"512x{k}", got, xs1, xs2, scal,
                                   "rbf", False, 512, k)
    ms = cuda_ms(lambda: cov_cuda.cov_tile(xs1, xs2, scal, "rbf", False,
                                           512, k), reps=5)
    plain_ms = cuda_ms(lambda: cov_cuda.cov_tile_plain(
        xs1, xs2, scal, "rbf", False, 512, k), iters=3)
    rows["cov"] = (f"512x{k} d=4 cross", ms, plain_ms, None,
                   *_cov_bound(512, k, 4, False),
                   f"max_abs_err={err:.3e} float64={err64:.3e}")
    del got, xs2

    A = _spd_batch(torch, 3, n_batch, dev, 4)
    Lb = chol_ops.cholesky(A)
    rec = float(((Lb @ Lb.mT - A).abs().amax((1, 2))
                 / A.abs().amax((1, 2))).max())
    ref = torch.linalg.cholesky(A)
    err = float((Lb - ref).abs().max())
    gate(rec <= 1e-5, f"cholesky (3, {n_batch}, {n_batch}): recon relerr "
         f"{rec:.3e} (bar 1e-5)")
    ms = cuda_ms(lambda: chol_ops.cholesky(A), iters=5)
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky(A), iters=5)
    rows["potrf"] = (f"cholesky B=3 n={n_batch} (base blocks: route "
                     f"{chol_cuda.route(3, dev)})", ms, None, lib_ms,
                     *bound(4 * 3 * 2 * n_batch ** 2, 3 * n_batch ** 3 / 3),
                     f"recon_relerr={rec:.3e} L_err_vs_library={err:.3e}")
    del A, Lb, ref
    torch.cuda.empty_cache()
    for name, (tag, ms, plain_ms, lib_ms, b_ms, b_by, note) in rows.items():
        say("sparse_gpc", kernel=name, shape=repr(tag), kernel_ms=f"{ms:.4f}",
            plain_ms="none" if plain_ms is None else f"{plain_ms:.4f}",
            library_ms="none" if lib_ms is None else f"{lib_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, check=repr(note))


def phase_sparse_classification(torch, dev, profile=False, n_sgpr=131072,
                                m_sgpr=512, sgpr_steps=50, n_svgp=131072,
                                svgp_steps=2000, n_laplace=8000, n_ep=4096,
                                n_multi=4096, gpc_steps=10):
    """The sparse and classification families at the sizes users run:
    (a) SGPR at benchmarks/bench_sgpr.py's configuration through
    GP.fit_sparse / predict_sparse, against a float64 evaluation of the
    same formulas and, with Z = X at n=2048, against the dense LML; (b)
    SVGP bernoulli on two_moons through the SVGP facade, and the
    gaussian warm start over n rows in chunks against the collapsed
    bound; (c) GPClassifier Laplace and EP, (d) multiclass, each gated at
    n=1024 against the float64 oracles; (e) the default random streams
    asked for the card bitwise the CPU's. Each of (a)-(d) is a path of
    its own for the launch counters. Returns {part: launches}."""
    import multiprocessing

    import cugp_tpu_torch
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import hmc, iterative, sampling
    from cugp_tpu_torch.models import (exact_gp, gpc, gpc_ep, gpc_multiclass,
                                       sgpr, svgp)
    from cugp_tpu_torch.ops import kernels

    gates = Gates(torch, "sparse_gpc")
    gate, synced = gates.gate, gates.synced

    def path(part, fn):
        return gates.path(part, fn, ("cov", "potrf", "trsm"),
                          ("cov_matvec",))

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    t_phase = time.perf_counter()
    phase9_kernel_shapes(torch, dev, gate)
    # the float64 oracles run in worker processes while the card works
    pool = multiprocessing.get_context("spawn").Pool(3)
    try:
        oracles = {k: pool.apply_async(_gpc_oracle, (k,))
                   for k in ("laplace", "ep", "multiclass")}

        # (a) SGPR, bench_sgpr.py's configuration
        Xn, yn, _ = synthetic.multidim_regression(n=n_sgpr, d=4,
                                                  noise_std=0.2, seed=0)
        X, y = t32(Xn), t32(yn)
        Xs_n = np.random.default_rng(3).uniform(-2.0, 2.0, (2000, 4))
        init = kernels.init_params(d=4, lengthscale=1.5, noise_var=0.05,
                                   device=dev)

        def sparse_gp():
            gp = cugp_tpu_torch.GP(kind="rbf", device=dev)
            gp.params = init
            return gp

        sparse_gp().fit_sparse(X, y, num_inducing=m_sgpr, steps=1)  # warm-up
        gp = sparse_gp()
        info, t_fit, peak = path("sgpr", lambda: (
            gp.fit_sparse(X, y, num_inducing=m_sgpr, steps=sgpr_steps,
                          learning_rate=0.05), gp.predict_sparse(Xs_n))[0])
        (mu_s, var_s), t_pred = synced(lambda: gp.predict_sparse(Xs_n))
        loss = info["loss"].cpu().numpy()
        with torch.no_grad():
            elbo = float(sgpr.elbo(gp.params, gp.Z, X, y))
        p_np = {k: v.cpu().numpy() for k, v in gp.params.items()}
        sgpr64 = pool.apply_async(_sgpr_oracle, (
            p_np, gp.Z.cpu().numpy(), Xn.astype(np.float32),
            yn.astype(np.float32), Xs_n.astype(np.float32)))
        say("sparse_gpc", part="sgpr", n=n_sgpr, m=m_sgpr, steps=sgpr_steps,
            s_per_step=f"{t_fit / sgpr_steps:.4f}",
            predict_2000_s=f"{t_pred:.4f}", peak_bytes=peak,
            elbo_first=f"{-loss[0]:.4f}", elbo_last=f"{-loss[-1]:.4f}")
        gate(np.isfinite(loss).all() and loss[-1] < loss[0],
             "sgpr: the ELBO did not rise over the fit")
        if profile:
            profile_device(torch, "profile_sgpr_step", lambda: sparse_gp(
            ).fit_sparse(X, y, num_inducing=m_sgpr, steps=1))
        # Z = X at n=2048: the bound is the exact LML, on tests/test_sgpr.py's
        # data and hyperparameters (on (a)'s, lengthscale 1.5 in 4-d, K_mm's
        # spectrum falls far below the 2e-6 jitter and the bound sits 6.6e-3
        # a point under the LML in both packages: a gap of the model)
        Xg, yg, _ = synthetic.sinusoid_1d(n=2048, noise_std=0.2, seed=0)
        Xg, yg = t32(Xg), t32(yg)
        p_g = kernels.init_params(d=1, lengthscale=0.8, noise_var=0.05,
                                  device=dev)
        with torch.no_grad():
            bound = float(sgpr.elbo(p_g, Xg, Xg, yg))
            lml = float(exact_gp.log_marginal_likelihood(p_g, Xg, yg))
        say("sparse_gpc", part="sgpr", case="Z = X at n=2048",
            elbo=f"{bound:.4f}", dense_lml=f"{lml:.4f}",
            err_per_point=f"{abs(bound - lml) / 2048:.3e}")
        gate(abs(bound - lml) / 2048 < 2e-3,
             "sgpr: with Z = X the bound is off the dense LML by more than "
             "2e-3 a point")
        del Xg, yg

        # (b) SVGP: the gaussian warm start over n rows in chunks, at the
        # initial params and inducing rows (sf2 = 1: both bounds then
        # carry the same K_mm jitter)
        Z0 = sgpr.init_inducing(X, m_sgpr, seed=0)
        ws64 = pool.apply_async(_sgpr_oracle, (
            {k: v.cpu().numpy() for k, v in init.items()}, Z0.cpu().numpy(),
            Xn.astype(np.float32), yn.astype(np.float32),
            Xs_n[:2].astype(np.float32), svgp.KMM_JITTER_FLOOR))
        with torch.no_grad():
            vp, t_ws = synced(lambda: svgp.optimal_variational(init, Z0, X,
                                                               y))
            full = float(svgp.elbo(init, Z0, vp, X, y))
            coll = float(sgpr.elbo(init, Z0, X, y,
                                   jitter=svgp.KMM_JITTER_FLOOR))
        coll64 = ws64.get()[0]
        say("sparse_gpc", part="svgp", case="gaussian warm start",
            n=n_sgpr, m=m_sgpr, warm_start_s=f"{t_ws:.4f}",
            elbo=f"{full:.4f}", collapsed=f"{coll:.4f}",
            collapsed64=f"{coll64:.4f}",
            rel_err=f"{abs(full - coll) / abs(coll):.3e}",
            elbo_rel_err64=f"{abs(full - coll64) / abs(coll64):.3e}",
            collapsed_rel_err64=f"{abs(coll - coll64) / abs(coll64):.3e}")
        # tests/test_svgp.py's bar for the identity: each fp32 bound is
        # itself ~1e-4 of itself off float64 at this n (ROADMAP.md §3)
        gate(abs(full - coll) <= 2e-3 * abs(coll),
             "svgp: the warm start's bound is off the collapsed bound by "
             "more than 2e-3 relative")
        g_svgp = cugp_tpu_torch.SVGP(device=dev)
        _, t_g = synced(lambda: g_svgp.fit(X, y, num_inducing=m_sgpr,
                                           steps=100, batch=256))
        say("sparse_gpc", part="svgp", case="gaussian fit (warm start and "
            "100 steps)", s_per_step=f"{t_g / 100:.4f}")
        del X, y, Z0, vp, g_svgp, gp
        torch.cuda.empty_cache()

        Xm, ym = synthetic.two_moons(n=n_svgp, seed=0)
        cugp_tpu_torch.SVGP(likelihood="bernoulli", device=dev).fit(
            Xm, ym, steps=1)                                  # warm-up
        clf = cugp_tpu_torch.SVGP(likelihood="bernoulli", device=dev)
        info, t_fit, peak = path("svgp", lambda: clf.fit(
            Xm, ym, steps=svgp_steps))
        acc = float(np.mean(clf.predict(Xm) == ym))
        loss = info["loss"].cpu().numpy()
        say("sparse_gpc", part="svgp", likelihood="bernoulli", n=n_svgp,
            m=256, batch=256, steps=svgp_steps,
            s_per_step=f"{t_fit / svgp_steps:.5f}",
            train_accuracy=f"{acc:.4f}",
            loss_first=f"{loss[0]:.2f}",
            loss_last_100_mean=f"{loss[-100:].mean():.2f}")
        gate(np.isfinite(loss).all(), "svgp: a non-finite loss")
        gate(acc > 0.95, "svgp: train accuracy on two_moons not above 0.95")
        del clf
        torch.cuda.empty_cache()

        # (c), (d): the classifiers' fits at their n, then the n=1024 gates
        for part, inference, n_fit in (("gpc_laplace", "laplace", n_laplace),
                                       ("gpc_ep", "ep", n_ep),
                                       ("gpc_multiclass", "laplace",
                                        n_multi)):
            if part == "gpc_multiclass":
                Xc, yc = synthetic.gaussian_blobs(n=n_fit, num_classes=3,
                                                  seed=0)
            else:
                Xc, yc = synthetic.two_moons(n=n_fit, seed=0)
            cugp_tpu_torch.GPClassifier(inference=inference, device=dev).fit(
                Xc, yc, steps=1)                              # warm-up
            clf = cugp_tpu_torch.GPClassifier(inference=inference,
                                              device=dev)
            info, t_fit, peak = path(part, lambda: clf.fit(
                Xc, yc, steps=gpc_steps))
            loss = info["loss"].cpu().numpy()
            acc = float(np.mean(clf.predict(Xc[:2000]) == yc[:2000]))
            say("sparse_gpc", part=part, n=n_fit, steps=gpc_steps,
                s_per_step=f"{t_fit / gpc_steps:.4f}", peak_bytes=peak,
                lml_first=f"{-loss[0]:.4f}", lml_last=f"{-loss[-1]:.4f}",
                train_accuracy_2000=f"{acc:.4f}")
            gate(np.isfinite(loss).all() and loss[-1] < loss[0],
                 f"{part}: the LML did not rise over the fit")
            del clf
            torch.cuda.empty_cache()
            if profile:
                profile_device(torch, f"profile_{part}_step",
                               lambda: cugp_tpu_torch.GPClassifier(
                                   inference=inference, device=dev).fit(
                                       Xc, yc, steps=1))

        models = {"laplace": (gpc, "laplace_lml"), "ep": (gpc_ep, "ep_lml"),
                  "multiclass": (gpc_multiclass, "laplace_lml")}
        for kind, (mod, fn) in models.items():
            p_np, Xg, yg, Xs_g = _gpc_gate_problem(kind)
            p = {k: t32(v).requires_grad_(True) for k, v in p_np.items()}
            kw = {"num_newton": 30} if kind == "multiclass" else {}
            lml = getattr(mod, fn)(p, t32(Xg), t32(yg), **kw)
            grads = torch.autograd.grad(lml, list(p.values()))
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            lml = float(lml.detach())
            p = {k: v.detach() for k, v in p.items()}
            with torch.no_grad():
                if kind == "multiclass":
                    probs, mu, sig = mod.predict_proba(
                        p, t32(Xg), t32(yg), t32(Xs_g), num_newton=30,
                        num_samples=8192)
                    ref_lml, (mu64, sig64), p64 = oracles[kind].get()
                    errs = {"mu": np.abs(mu.cpu().numpy() - mu64).max(),
                            "sigma": np.abs(sig.cpu().numpy() - sig64).max(),
                            "probs_mc": np.abs(probs[:50].cpu().numpy()
                                               - p64).max()}
                    # the latent mean and covariance are printed: at n=1024
                    # fp32 strays past the n=48 test's 1e-3 (the JAX
                    # package's own by 4.7e-3 in mu on the CPU)
                    bars = {"probs_mc": 0.03}
                    lml_ok = abs(lml - ref_lml) < 1e-3 * max(1.0,
                                                             abs(ref_lml))
                else:
                    out = mod.predict_proba(p, t32(Xg), t32(yg), t32(Xs_g))
                    ref_lml, ref = oracles[kind].get()
                    errs = {k: np.abs(a.cpu().numpy() - b).max() for k, a, b
                            in zip(("prob", "mu", "var"), out, ref)}
                    if kind == "laplace":
                        bars = {"prob": 2e-3, "mu": 5e-3, "var": 5e-3}
                        lml_ok = abs(lml - ref_lml) / GPC_GATE_N < 1e-3
                    else:
                        bars = {"prob": 2e-3, "mu": 2e-3, "var": 2e-3}
                        lml_ok = abs(lml - ref_lml) < 1e-3 * max(
                            1.0, abs(ref_lml)) + 5e-3
            say("sparse_gpc", part=f"gate {kind}", n=GPC_GATE_N,
                lml=f"{lml:.4f}", lml64=f"{ref_lml:.4f}",
                grad_finite=finite,
                **{f"err_{k}": f"{v:.3e}" for k, v in errs.items()})
            gate(lml_ok, f"{kind}: LML off the float64 oracle past the JAX "
                 "test's bar")
            gate(finite, f"{kind}: a non-finite LML gradient")
            for k, bar in bars.items():
                gate(errs[k] <= bar, f"{kind}: {k} off the float64 oracle by "
                     f"{errs[k]:.3e} (bar {bar})")

        # (a)'s float64 gate, computed meanwhile
        elbo64, mu64, var64 = sgpr64.get()
        err_elbo = abs(elbo - elbo64) / n_sgpr
        err_mu = float(np.abs(mu_s.cpu().numpy() - mu64).max())
        err_var = float(np.abs(var_s.cpu().numpy() - var64).max())
        say("sparse_gpc", part="sgpr", case="against float64",
            elbo=f"{elbo:.4f}", elbo64=f"{elbo64:.4f}",
            err_elbo_per_point=f"{err_elbo:.3e}", err_mu=f"{err_mu:.3e}",
            err_var=f"{err_var:.3e}")
        # the mean at tests/test_sgpr.py's posterior bar, 5e-3: fp32 inputs
        # alone put it past BASELINE's 1e-3 at this n (ROADMAP.md §3)
        gate(err_elbo <= 1e-3 and err_var <= 1e-3 and err_mu <= 5e-3,
             "sgpr: ELBO (a point) or variance off float64 by more than "
             "1e-3, or the mean by more than 5e-3")
    finally:
        pool.terminate()
        pool.join()

    # (e) the default random streams asked for the card are the CPU's
    cuda, cpu = dev, torch.device("cpu")
    key = np.asarray([7, 11], np.uint32)
    same = {
        "probes": torch.equal(sampling._probes(4096, 16, None, None,
                                               cuda).cpu(),
                              sampling._probes(4096, 16, None, None, cpu)),
        "rademacher": torch.equal(iterative.rademacher(4096, 8, cuda).cpu(),
                                  iterative.rademacher(4096, 8, cpu)),
        "segment": torch.equal(
            hmc.Draws(sampling.segment_generator(key, 64, cuda)).normal(
                (8, 3), cuda).cpu(),
            hmc.Draws(sampling.segment_generator(key, 64, cpu)).normal(
                (8, 3), cpu)),
        "as_draws": torch.equal(
            hmc.as_draws(None, cuda).normal((8, 3), cuda).cpu(),
            hmc.as_draws(None, cpu).normal((8, 3), cpu)),
    }
    say("sparse_gpc", part="default streams on the card",
        **{k: v for k, v in same.items()})
    for k, v in same.items():
        gate(v, f"the default {k} drawn for the card differ from the CPU's")
    say("sparse_gpc", phase_s=f"{time.perf_counter() - t_phase:.3f}")
    gates.finish("sparse and classification phase")
    return gates.paths


# ---- phase 10: the LMC multi-output family ----

LMC_GATE_N = 1024  # bench_lmcq.py's check_n; the n of every float64 gate
LMCQ_KINDS = ("rbf", "matern32")  # bench_lmcq.py's latents
# CG's cap in phase 10(c). bench_lmcq.py's one TPU capture ran 600: there
# the mean solve stops at a relative residual of 5.8e-2 (tools/lmcq_cg.py
# on an H100), far from its tol of 1e-4, which it reaches at ~1,600
# iterations (no preconditioner); a variance chunk needs ~900.
LMCQ_MAX_ITERS = 2000


def _icm_data(n, seed=0):
    """Phase 10(a)'s data: X ~ U(-2, 2)^4 (config 2's size); four outputs
    mixing two smooth latent functions, f1 = sin(1.3 x0) cos(0.7 x1) and
    f2 = tanh(x2) + 0.3 x3, through the weights W below (correlated and
    anti-correlated pairs), plus N(0, 0.05^2) noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, 4))
    F = np.stack([np.sin(1.3 * X[:, 0]) * np.cos(0.7 * X[:, 1]),
                  np.tanh(X[:, 2]) + 0.3 * X[:, 3]], axis=1)
    W = np.array([[1.0, 0.2], [0.8, -0.5], [-0.6, 0.9], [0.3, 1.0]])
    Y = F @ W.T + 0.05 * rng.standard_normal((n, 4))
    return X.astype(np.float32), Y.astype(np.float32)


def _lmcq_zoo_data(n, seed=0):
    """tests/test_lmc.py's model-zoo data (_toy_q) at n rows: two outputs
    mixing a period-1 latent sin(2 pi x) and a smooth latent tanh(x) with
    weights A = [[1, -0.8], [0.3, 0.4]], X sorted in U(-3, 1), plus
    N(0, 0.05^2) noise."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3.0, 1.0, size=(n, 1)), axis=0)
    A = np.array([[1.0, -0.8], [0.3, 0.4]])
    F = np.stack([np.sin(2 * np.pi * X[:, 0]), np.tanh(X[:, 0])], axis=1)
    Y = F @ A + 0.05 * rng.standard_normal((n, 2))
    return X.astype(np.float32), Y.astype(np.float32)


def _lmcq_gate_inputs(Xq, Yq, gate_n):
    """Phase 10(b)'s gate cell: gate_n rows spread evenly over (Xq, Yq)
    and 200 test points on [-3, 3] (past the training range's right end,
    where the periodic latent carries its pattern forward)."""
    step = max(1, Xq.shape[0] // gate_n)
    Xs = np.linspace(-3.0, 3.0, 200, dtype=np.float32)[:, None]
    return Xq[::step][:gate_n], Yq[::step][:gate_n], Xs


def _bench_lmcq_data(n, d, p, seed=0):
    """benchmarks/bench_lmcq.py's make_data (copied: the harness imports
    jax): smooth correlated p-output targets on X ~ U(-3, 3)^d."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, size=(n, d)).astype(np.float32)
    r = np.linalg.norm(X, axis=1)
    base = np.sin(1.7 * r) + 0.3 * np.cos(3.1 * X[:, 0])
    cols = [base + 0.2 * np.sin(2.3 * X[:, min(a, d - 1)] + a)
            for a in range(p)]
    Y = np.stack(cols, axis=1) + 0.1 * rng.standard_normal((n, p))
    return X, Y.astype(np.float32)


def _lmc_oracle(model, p_np, X, Y, Xs, kinds=None):
    """The float64 oracle of a phase-10 gate (the port's copy), run in a
    worker process: (LML, mean, full output covariance) for "icm",
    (LML, mean, variance) for "lmcq"."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cugp_tpu_torch.oracle import lmc_np

    X, Y, Xs = (np.asarray(a, np.float64) for a in (X, Y, Xs))
    if model == "icm":
        return (lmc_np.log_marginal_likelihood(p_np, X, Y),
                *lmc_np.posterior(p_np, X, Y, Xs))
    return (lmc_np.log_marginal_likelihood_q(p_np, X, Y, kinds),
            *lmc_np.posterior_q(p_np, X, Y, Xs, kinds))


def _tree_tolist(tree):
    """A params tree of numpy arrays as nested lists (for JSON)."""
    if isinstance(tree, dict):
        return {k: _tree_tolist(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_tolist(v) for v in tree]
    return np.asarray(tree).tolist()


def _lmcq_plain_matvec(torch, params, X, kinds, v, jitter=1e-6):
    """The joint operator's product without the kernel: cov_matvec_plain
    per (non-periodic base) latent, with the mixing and the diagonal."""
    from cugp_tpu_torch.ops import cov_matvec_cuda as cm
    from cugp_tpu_torch.ops import kernels

    A = params["lmc_a"]
    Q, p = A.shape
    n = X.shape[0]
    V = v.reshape(p, n, -1)
    diag_add = (torch.exp(params["log_noise_var"])
                + jitter * torch.max(torch.sum(A ** 2, dim=0)))
    out = diag_add * V
    for a, fp, kind in zip(A, params["latents"], kinds):
        xs = X / torch.exp(fp["log_lengthscale"])
        extra = kernels.extra_scalar(fp, kind)
        scal = torch.stack([torch.ones_like(extra), torch.zeros_like(extra),
                            extra])
        u = cm.cov_matvec_plain(xs, torch.einsum("a,anr->nr", a, V), scal,
                                kind, n)
        out = out + a[:, None, None] * u
    return out.reshape(p * n, -1)


def phase10_kernel_shapes(torch, dev, gate, X, params, n_batch=(4, 8000)):
    """The kernels at the shapes phase 10 is the first to reach, each
    against its plain version (or the library) and timed beside its
    bound: the matvec at (c)'s n and d on the rbf and matern32 latents at
    r = 1 (mean solve), 8 (SLQ probes) and 256 (a variance chunk: p = 2
    outputs x 128 columns), and the (4, 8000, 8000) batched Cholesky of
    (a)'s rotated factors. (The 65,536-row joint Cholesky is timed in
    (c) on (c)'s own joint covariance.)"""
    from cugp_tpu_torch.ops import chol_cuda
    from cugp_tpu_torch.ops import cholesky as chol_ops
    from cugp_tpu_torch.ops import cov_matvec_cuda as cm

    n, d = X.shape
    rng = np.random.default_rng(10)
    for fp, kind in zip(params["latents"], LMCQ_KINDS):
        xs = (X / torch.exp(fp["log_lengthscale"])).contiguous()
        scal = torch.tensor([1.0, float(np.exp(np.float32(-60.0))), 1.0],
                            dtype=torch.float32, device=dev)
        for r in (1, 8, 256):
            v = torch.as_tensor(rng.standard_normal((n, r)),
                                dtype=torch.float32, device=dev)
            got = cm.cov_matvec(xs, v, scal, kind, n)
            want = cm.cov_matvec_plain(xs, v, scal, kind, n)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            gate(err <= 1e-4 * scale, f"cov_matvec {kind} n={n} r={r}: max "
                 f"abs err {err:.3e} over 1e-4 max|plain| {scale:.3e}")
            del got, want
            ms = cuda_ms(lambda: cm.cov_matvec(xs, v, scal, kind, n),
                         iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: cm.cov_matvec_plain(xs, v, scal, kind,
                                                           n), iters=2,
                               warmup=1)
            b_ms, b_by = _matvec_bound(n, d, r)
            say("lmc", kernel="cov_matvec", shape=f"n={n} d={d} r={r} "
                f"{kind}", route=cm.route(r), kernel_ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", library_ms="none",
                bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                rel_err=f"{err / scale:.3e}")
    B, nb = n_batch
    A = _spd_batch(torch, B, nb, dev, 11)
    Lb = chol_ops.cholesky(A)
    rec = float(((Lb @ Lb.mT - A).abs().amax((1, 2))
                 / A.abs().amax((1, 2))).max())
    err = float((Lb - torch.linalg.cholesky(A)).abs().max())
    gate(rec <= 1e-5, f"cholesky ({B}, {nb}, {nb}): recon relerr {rec:.3e} "
         "(bar 1e-5)")
    ms = cuda_ms(lambda: chol_ops.cholesky(A), iters=3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky(A), iters=3, warmup=1)
    b_ms, b_by = bound(4 * B * 2 * nb ** 2, B * nb ** 3 / 3)
    say("lmc", kernel="potrf", shape=f"cholesky B={B} n={nb} (base blocks: "
        f"route {chol_cuda.route(B, dev)})", kernel_ms=f"{ms:.4f}",
        plain_ms="none", library_ms=f"{lib_ms:.4f}", bound_ms=f"{b_ms:.4f}",
        bound_by=b_by, recon_relerr=f"{rec:.3e}",
        L_err_vs_library=f"{err:.3e}")
    del A, Lb
    torch.cuda.empty_cache()


def phase_lmc(torch, dev, profile=False, n_icm=8000, icm_steps=20,
              n_pred=2000, n_q=4096, q_steps=20, n_big=32768, m_big=256,
              gate_n=LMC_GATE_N):
    """The LMC multi-output family at the sizes users run: (a) ICM,
    MultiOutputGP(kind="rbf", rank=2) fit (Adam) and predict at config
    2's size with p = 4 correlated outputs; (b) the dense rank-Q
    MultiOutputGPQ(kinds=("periodic", "rbf")) fit on the model-zoo data
    at pn = 8192; each gated at n = 1024 against the float64 oracle (the
    port's copy, in worker processes meanwhile) at the fitted params; (c)
    the matrix-free rank-Q model at benchmarks/bench_lmcq.py's
    configuration (n = 32768, d = 2, p = 2, rbf + matern32): the
    harness's small-n agreement check, enforced on the mean and the
    variance, then log_marginal_likelihood_iterative and
    predict_iterative timed, the mean solve's residual recomputed without
    the kernel, and the dense rank-Q path at the same n (pn = 65,536)
    beside it, its joint Cholesky timed and checked; (d) the kernels at
    the shapes this phase reaches first. Each of (a)-(c) is a path of its
    own for the launch counters. Returns {path: launches}."""
    import multiprocessing

    import cugp_tpu_torch
    from cugp_tpu_torch.inference import iterative
    from cugp_tpu_torch.models import lmc
    from cugp_tpu_torch.ops import cholesky as chol_ops
    from cugp_tpu_torch.ops import trsm as trsm_ops
    from cugp_tpu_torch.utils.params import params_to_numpy

    gates = Gates(torch, "lmc")
    gate, synced, path = gates.gate, gates.synced, gates.path

    def peak_of(fn):
        torch.cuda.reset_peak_memory_stats()
        out, wall = synced(fn)
        return out, wall, torch.cuda.max_memory_allocated()

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def maxdiff(a, b):
        return float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())

    def profiled(tag, fn):
        """fn() timed, then again under the profiler: its idle share
        against the timed wall."""
        _, wall = synced(fn)
        profile_device(torch, tag, fn, timed_s=wall)

    t_phase = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        # (a) ICM at config 2's size, p = 4 outputs
        X, Y = _icm_data(n_icm, seed=0)
        Xs = np.random.default_rng(3).uniform(-2.0, 2.0,
                                              (n_pred, 4)).astype(np.float32)
        cugp_tpu_torch.MultiOutputGP(kind="rbf", rank=2, device=dev).fit(
            X, Y, steps=1)                                    # warm-up
        icm = cugp_tpu_torch.MultiOutputGP(kind="rbf", rank=2, device=dev)
        fit_s = {}

        def icm_path():
            info, fit_s["icm"] = synced(lambda: icm.fit(
                X, Y, steps=icm_steps, learning_rate=0.05))
            icm.predict(Xs)
            return info

        info, _, peak = path("lmc_icm", icm_path, ("cov", "potrf", "trsm"),
                             ("cov_matvec",))
        t_fit = fit_s["icm"]
        (mu, var), t_pred = synced(lambda: icm.predict(Xs))
        (mu_f, cov_f), t_pred_full = synced(
            lambda: icm.predict(Xs, full_output_cov=True))
        loss = info["loss"].cpu().numpy()
        corr = icm.output_correlation().cpu().numpy()
        p_np = params_to_numpy(icm.params)
        Xg, Yg, Xsg = X[:gate_n], Y[:gate_n], Xs[:200]
        icm64 = pool.apply_async(_lmc_oracle, ("icm", p_np, Xg, Yg, Xsg))
        say("lmc", part="icm", n=n_icm, d=4, p=4, rank=2, steps=icm_steps,
            s_per_step=f"{t_fit / icm_steps:.4f}",
            predict_s=f"{t_pred:.4f}", predict_full_cov_s=
            f"{t_pred_full:.4f}", predict_points=n_pred, peak_bytes=peak,
            lml_first=f"{-loss[0]:.4f}", lml_last=f"{-loss[-1]:.4f}",
            output_correlation=json.dumps(np.round(corr, 4).tolist()))
        gate(np.isfinite(loss).all() and loss[-1] < loss[0],
             "icm: a non-finite loss, or the LML did not rise over the fit")
        gate(tuple(mu.shape) == tuple(var.shape) == (n_pred, 4)
             and tuple(cov_f.shape) == (n_pred, 4, 4)
             and bool(torch.isfinite(cov_f).all())
             and bool(torch.isfinite(mu).all()),
             "icm: predict shapes or finiteness")
        gate(maxdiff(torch.diagonal(cov_f, dim1=1, dim2=2).cpu(),
                     var.cpu()) <= 1e-5,
             "icm: the full output covariance's diagonal is not the "
             "diagonal predict's variance (1e-5)")
        if profile:
            # one step from the fitted params, data already on the card
            prof = cugp_tpu_torch.MultiOutputGP(kind="rbf", rank=2,
                                                device=dev)
            profiled("profile_lmc_icm_step", lambda: prof.fit(
                icm.X, icm.Y, steps=1, init=icm.params))
            del prof
        with torch.no_grad():
            lml_g = float(lmc.log_marginal_likelihood_lmc(
                icm.params, t32(Xg), t32(Yg)))
            mu_g, cov_g = lmc.posterior_lmc(icm.params, t32(Xg), t32(Yg),
                                            t32(Xsg), full_output_cov=True)
        del icm, mu, var, mu_f, cov_f
        torch.cuda.empty_cache()

        # (b) dense rank-Q on the model-zoo data, pn = 8192
        kinds_b = ("periodic", "rbf")
        Xq, Yq = _lmcq_zoo_data(n_q, seed=0)

        def init_b():
            return lmc.init_lmcq_params(d=1, p=2, kinds=kinds_b,
                                        lengthscale=0.8, noise_var=0.05,
                                        seed=0, device=dev)

        cugp_tpu_torch.MultiOutputGPQ(kinds=kinds_b, device=dev).fit(
            Xq, Yq, steps=1, init=init_b())                   # warm-up
        mq = cugp_tpu_torch.MultiOutputGPQ(kinds=kinds_b, device=dev)
        info, t_fit, peak = path("lmc_q_dense", lambda: mq.fit(
            Xq, Yq, steps=q_steps, learning_rate=0.05, init=init_b()),
            ("cov", "potrf", "trsm"), ("cov_matvec",))
        loss = info["loss"].cpu().numpy()
        Xqg, Yqg, Xsq = _lmcq_gate_inputs(Xq, Yq, gate_n)
        pq_np = params_to_numpy(mq.params)
        q64 = pool.apply_async(_lmc_oracle, (
            "lmcq", pq_np, Xqg, Yqg, Xsq, kinds_b))
        # the fitted params in full (float32 values, exact in JSON), for
        # tools/fp32_accuracy.py --cases=lmcq_dense --lmcq_params=...
        say("lmc", part="lmcq_dense", n=n_q, p=2, kinds=",".join(kinds_b),
            joint_dim=2 * n_q, steps=q_steps,
            s_per_step=f"{t_fit / q_steps:.4f}", peak_bytes=peak,
            lml_first=f"{-loss[0]:.4f}", lml_last=f"{-loss[-1]:.4f}",
            params=json.dumps(_tree_tolist(pq_np), separators=(",", ":")))
        gate(np.isfinite(loss).all() and loss[-1] < loss[0],
             "lmcq dense: a non-finite loss, or the LML did not rise")
        if profile:
            prof = cugp_tpu_torch.MultiOutputGPQ(kinds=kinds_b, device=dev)
            profiled("profile_lmc_q_dense_step", lambda: prof.fit(
                mq.X, mq.Y, steps=1, init=mq.params))
            del prof
        with torch.no_grad():
            lml_qg = float(lmc.log_marginal_likelihood_lmcq(
                mq.params, t32(Xqg), t32(Yqg), kinds_b))
            mu_qg, var_qg = lmc.posterior_lmcq(mq.params, t32(Xqg),
                                               t32(Yqg), t32(Xsq), kinds_b)
        del mq
        torch.cuda.empty_cache()

        # (c) the matrix-free rank-Q model at bench_lmcq.py's configuration
        init_c = lmc.init_lmcq_params(d=2, p=2, kinds=LMCQ_KINDS,
                                      lengthscale=1.2, noise_var=0.05,
                                      seed=0, device=dev)
        Xc, Yc = _bench_lmcq_data(gate_n, 2, 2, seed=1)
        small = cugp_tpu_torch.MultiOutputGPQ(kinds=LMCQ_KINDS, device=dev)
        small.condition(Xc, Yc, params=init_c)
        Xsc = Xc[:128] + 0.05
        mu_d, var_d = small.predict(Xsc)
        (mu_i, var_i), t_small = synced(lambda: small.predict_iterative(
            Xsc, tol=1e-7))
        check_mu, check_var = maxdiff(mu_d.cpu(), mu_i.cpu()), maxdiff(
            var_d.cpu(), var_i.cpu())
        say("lmc", part="lmcq_iterative", case=f"check_n={gate_n} tol=1e-7 "
            "against the dense path", check_mean_maxdiff=f"{check_mu:.3e}",
            check_var_maxdiff=f"{check_var:.3e}", seconds=f"{t_small:.4f}")
        gate(check_mu < 1e-3 and check_var < 1e-3,
             "lmcq iterative: the small-n agreement check is off the dense "
             "path by 1e-3 or more (mean or variance)")
        del small

        X, Y = _bench_lmcq_data(n_big, 2, 2, seed=0)
        Xs = X[:m_big] + 0.05
        big = cugp_tpu_torch.MultiOutputGPQ(kinds=LMCQ_KINDS, device=dev)
        big.condition(X, Y, params=init_c)
        tol, stats, times = 1e-4, {}, {}

        def run_iterative():
            lml_i, times["lml"] = synced(
                lambda: float(big.log_marginal_likelihood_iterative(
                    tol=tol, max_iters=LMCQ_MAX_ITERS, num_probes=8,
                    num_steps=32)))
            out, times["predict"] = synced(lambda: big.predict_iterative(
                Xs, tol=tol, max_iters=LMCQ_MAX_ITERS, col_batch=128,
                stats=stats))
            return lml_i, out

        (lml_i, (mu_i, var_i)), _, peak_i = path(
            "lmc_q_iterative", run_iterative, ("cov_matvec", "cov"))
        Xt, Yt = t32(X), t32(Y)
        with torch.no_grad():
            res = Yt.mT.reshape(-1) - _lmcq_plain_matvec(
                torch, big.params, Xt, LMCQ_KINDS, stats["alpha"])[:, 0]
            rel_res = float(torch.linalg.vector_norm(res)
                            / torch.linalg.vector_norm(Yt))
        say("lmc", part="lmcq_iterative", n=n_big, d=2, p=2,
            kinds=",".join(LMCQ_KINDS), joint_dim=2 * n_big, m=m_big,
            tol=tol, max_iters=LMCQ_MAX_ITERS, probes=8, lanczos_steps=32,
            col_batch=128, lml=f"{lml_i:.4f}",
            lml_per_point=f"{lml_i / (2 * n_big):.4f}",
            lml_s=f"{times['lml']:.4f}",
            predict_s=f"{times['predict']:.4f}", peak_bytes=peak_i,
            mean_cg_iters=stats["mean_iters"],
            var_cg_iters=",".join(map(str, stats["var_iters"])),
            mean_rel_residual=f"{rel_res:.3e}")
        gate(tuple(mu_i.shape) == tuple(var_i.shape) == (m_big, 2)
             and bool(torch.isfinite(mu_i).all())
             and bool(torch.isfinite(var_i).all()) and np.isfinite(lml_i),
             "lmcq iterative: wrong shape or non-finite")
        gate(rel_res <= 10 * tol, f"lmcq iterative: mean-solve residual "
             f"{rel_res:.3e} over 10 tol = {10 * tol:.1e}")
        # the SLQ logdet a probe at a time, on the LML's own probes (the
        # default stream), and the CG quadratic term: what the LML's gap
        # to the dense one below is made of
        yv = Yt.mT.reshape(-1)
        mv = lmc.make_lmcq_matvec(big.params, Xt, LMCQ_KINDS)
        with torch.no_grad():
            Z = iterative.rademacher(2 * n_big, 8, dev)
            ld_probe = np.array([float(iterative.slq_logdet(
                mv, 2 * n_big, Z=Z[:, j:j + 1], num_steps=32))
                for j in range(8)])
            quad_i = float(torch.dot(yv, stats["alpha"]))
        ld_i, ld_se = ld_probe.mean(), ld_probe.std(ddof=1) / np.sqrt(8)
        say("lmc", part="lmcq_iterative", slq_logdet=f"{ld_i:.4f}",
            slq_logdet_mc_se=f"{ld_se:.4f}",
            slq_logdet_per_probe=",".join(f"{v:.2f}" for v in ld_probe),
            quad=f"{quad_i:.4f}")
        if profile:
            profiled("profile_lmc_q_mean_solve", lambda: iterative.cg_solve(
                mv, yv, tol=tol, max_iters=LMCQ_MAX_ITERS))
            C = lmc.lmcq_covariance(big.params, Xt, t32(Xs[:128]),
                                    LMCQ_KINDS)
            profiled("profile_lmc_q_var_chunk", lambda: iterative.cg_solve(
                mv, C, tol=tol, max_iters=LMCQ_MAX_ITERS))
            del C
        del mv

        # the dense rank-Q path at the same n, pn = 65,536 (ungated)
        (lml_d, t_lml_d, peak_l) = peak_of(
            lambda: float(big.log_marginal_likelihood()))
        (mu_dd, var_dd), t_post_d, peak_p = peak_of(lambda: big.predict(Xs))
        say("lmc", part="lmcq_dense_at_n", n=n_big, joint_dim=2 * n_big,
            lml=f"{lml_d:.4f}", lml_s=f"{t_lml_d:.4f}",
            lml_peak_bytes=peak_l, predict_s=f"{t_post_d:.4f}",
            predict_peak_bytes=peak_p,
            iterative_minus_dense_lml=f"{lml_i - lml_d:.4f}",
            per_point=f"{(lml_i - lml_d) / (2 * n_big):.3e}",
            mean_maxdiff=f"{maxdiff(mu_i.cpu(), mu_dd.cpu()):.3e}",
            var_maxdiff=f"{maxdiff(var_i.cpu(), var_dd.cpu()):.3e}")
        del mu_dd, var_dd
        torch.cuda.empty_cache()

        # the 65,536-row joint Cholesky on (c)'s joint covariance
        with torch.no_grad():
            S = lmc.lmcq_covariance(big.params, Xt, Xt, LMCQ_KINDS)
            S.diagonal().add_(lmc._lmcq_diag_add(big.params, 1e-6))
            ms = cuda_ms(lambda: chol_ops.cholesky(S), iters=2, warmup=1)
            L = chol_ops.cholesky(S)
            finite = bool(torch.isfinite(L).all())
            nb = 4096
            relerr = float((L[:nb] @ L[:nb].T - S[:nb, :nb]).abs().max()
                           / S[:nb, :nb].abs().max())
            ld_d = 2.0 * float(torch.sum(torch.log(torch.diagonal(L))))
            quad_d = float(torch.dot(yv, trsm_ops.cho_solve(L, yv)))
        say("lmc", part="lmcq_dense_at_n", logdet=f"{ld_d:.4f}",
            quad=f"{quad_d:.4f}",
            slq_minus_dense_logdet=f"{ld_i - ld_d:.4f}",
            in_mc_se=f"{(ld_i - ld_d) / ld_se:.2f}",
            cg_minus_dense_quad=f"{quad_i - quad_d:.4f}")
        pn = 2 * n_big
        b_ms, b_by = bound(4 * 2 * pn ** 2, pn ** 3 / 3)
        say("lmc", kernel="potrf", shape=f"joint cholesky n={pn}",
            kernel_ms=f"{ms:.4f}", plain_ms="none", library_ms="none",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, finite=finite,
            recon_relerr_first_4096_rows=f"{relerr:.3e}")
        gate(finite and relerr < 2e-4, f"joint cholesky n={pn}: finite="
             f"{finite}, recon relerr {relerr:.3e} (gate 2e-4, phase 4's)")
        del L
        torch.cuda.empty_cache()
        # the library's factor of the same matrix, once its own is freed
        # (S and one output: 2 x 17.2 GB)
        lib_ms = cuda_ms(lambda: torch.linalg.cholesky(S), iters=1,
                         warmup=1)
        say("lmc", kernel="potrf", shape=f"joint cholesky n={pn}",
            library_ms=f"{lib_ms:.4f}", library="torch.linalg.cholesky")
        del S
        torch.cuda.empty_cache()

        # (d) the matvec and batched Cholesky at this phase's shapes
        phase10_kernel_shapes(torch, dev, gate, Xt, big.params)
        del big, Xt, Yt

        # (a)'s and (b)'s float64 gates, computed meanwhile
        lml64, mu64, cov64 = icm64.get()
        errs = {"lml_rel": abs(lml_g - lml64) / abs(lml64),
                "mean": maxdiff(mu_g.cpu(), mu64),
                "output_cov": maxdiff(cov_g.cpu(), cov64)}
        say("lmc", part="icm gate", n=gate_n, lml=f"{lml_g:.4f}",
            lml64=f"{lml64:.4f}",
            **{f"err_{k}": f"{v:.3e}" for k, v in errs.items()})
        gate(errs["lml_rel"] <= 1e-4, "icm: LML off float64 by more than "
             "1e-4 relative")
        gate(errs["mean"] <= 1e-3 and errs["output_cov"] <= 1e-3,
             "icm: mean or full output covariance off float64 by more than "
             "1e-3")
        lml64, mu64, var64 = q64.get()
        errs = {"lml_rel": abs(lml_qg - lml64) / abs(lml64),
                "mean": maxdiff(mu_qg.cpu(), mu64),
                "var": maxdiff(var_qg.cpu(), var64)}
        say("lmc", part="lmcq dense gate", n=gate_n, lml=f"{lml_qg:.4f}",
            lml64=f"{lml64:.4f}",
            **{f"err_{k}": f"{v:.3e}" for k, v in errs.items()})
        gate(errs["lml_rel"] <= 1e-3 and errs["mean"] <= 1e-3
             and errs["var"] <= 1e-3, "lmcq dense: LML (1e-3 relative), "
             "mean or variance (1e-3) off float64")
    finally:
        pool.terminate()
        pool.join()
    say("lmc", phase_s=f"{time.perf_counter() - t_phase:.3f}")
    gates.finish("LMC phase")
    return gates.paths


# ---- phase 11: the CLI ----

def _json_objects(text):
    """Every JSON object printed in text, in order (a verb prints one;
    predict prints the fit's and its own)."""
    dec, out, i = json.JSONDecoder(), [], 0
    while True:
        i = text.find("{", i)
        if i < 0:
            return out
        obj, i = dec.raw_decode(text, i)
        out.append(obj)


def _metrics_series(path, name):
    from cugp_tpu_torch.utils.metrics import read_metrics

    return [r[name] for r in read_metrics(path) if name in r]


def _supervised_fit(tmp, dev, n, steps):
    """utils.supervise over a real CLI fit child in its own process,
    SIGKILLed once its heartbeat (the metrics file) appears; the child is
    found among this process's own children by its /proc cmdline, never
    by pattern. Returns (supervisor rc, killed, seconds, meta)."""
    import signal
    import threading

    from cugp_tpu_torch.utils import checkpoint, supervise

    ck = os.path.join(tmp, "sup_ck")
    hb = os.path.join(tmp, "sup_metrics.jsonl")
    child = [sys.executable, "-m", "cugp_tpu_torch.cli", "fit",
             f"--device={dev.type}", f"--data.n={n}",
             "--data.dataset=multidim", "--data.d=4", f"--fit.steps={steps}",
             f"--checkpoint_dir={ck}", f"--metrics_file={hb}"]
    killed = []

    def own_children():
        me = str(os.getpid())
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    ppid = f.read().rsplit(")", 1)[1].split()[1]
                with open(f"/proc/{pid}/cmdline") as f:
                    cmdline = f.read()
            except OSError:
                continue
            if ppid == me:
                yield int(pid), cmdline

    def killer():
        deadline = time.time() + 600
        while time.time() < deadline and not os.path.exists(hb):
            time.sleep(0.2)
        for pid, cmdline in own_children():
            if "cugp_tpu_torch.cli" in cmdline:
                try:
                    os.kill(pid, signal.SIGKILL)
                    killed.append(pid)
                except ProcessLookupError:
                    pass
                return

    # the child imports the package from beside this script
    env_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + ([env_pp] if env_pp else []))
    t = threading.Thread(target=killer)
    t.start()
    t0 = time.perf_counter()
    try:
        rc = supervise.supervise(child, hb, timeout=600, max_restarts=2,
                                 poll=0.2, _log=lambda s: say("cli", **{
                                     "supervisor": s}))
    finally:
        t.join()
        if env_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = env_pp
    return rc, killed, time.perf_counter() - t0, checkpoint.peek_meta(ck)


def phase_cli(torch, dev, n_fit=8000, fit_steps=20, n_it=32768, it_steps=6,
              n_hmc=512, hmc_chains=256, hmc_warmup=8, hmc_draws=8,
              n_it_sample=8192, it_chains=8, vi_steps=200, n_sgpr=131072,
              sgpr_steps=50, n_svgp=131072, svgp_steps=1000, n_cls=4096,
              cls_steps=10, native_n=2048, sup_steps=20):
    """The port's CLI (python -m cugp_tpu_torch.cli), each verb run in
    this process through cli.__main__.main(argv) with --device set and
    its stdout captured, at users' sizes: (a) fit at config 2 twice on
    one --checkpoint_dir (the second resumes) with --metrics_file,
    predict's mean against the float64 oracle, and the native C++
    oracle's LML against the numpy one; (b) the iterative fit at n=32768
    killed after half its steps and resumed, against an uninterrupted
    run; (c) the checkpointed HMC at config 3's width, resumed, against
    an uninterrupted run; (d) the matrix-free sampler; (e) vi; (f) sgpr;
    (g) svgp bernoulli; (h) classify, binary and 3 classes; (i) info;
    (j) --profile on a 3-step fit; (k) utils.supervise over a CLI fit
    child killed once its heartbeat appears. The launches of the verbs
    run in this process are the path "cli"."""
    import contextlib
    import io
    import shutil
    import tempfile

    import cugp_tpu_torch
    from cugp_tpu_torch.cli.__main__ import main as cli_main
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.oracle import exact_gp_np as oracle
    from cugp_tpu_torch.oracle import native
    from cugp_tpu_torch.utils import checkpoint

    gates = Gates(torch, "cli")
    gate = gates.gate
    total = dict.fromkeys(_wrappers(), 0)
    on = f"--device={dev.type}"

    def verb(part, *argv):
        """main(argv) with stdout captured: (its JSON objects, seconds)."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([argv[0], on, *argv[1:]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        for k, v in launches.items():
            total[k] += v
        say("cli", part=part, wall_s=f"{wall:.3f}",
            peak_bytes=torch.cuda.max_memory_allocated(),
            launches=json.dumps(launches, separators=(",", ":")))
        if rc != 0:
            fail(f"cli {part}: main returned {rc}")
        return _json_objects(buf.getvalue()), wall

    def finite(tree):
        if isinstance(tree, dict):
            return all(finite(v) for v in tree.values())
        if isinstance(tree, list):
            return all(finite(v) for v in tree)
        return bool(np.isfinite(tree))

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        # (a) fit at config 2, resumed from its own checkpoint
        cfg2 = ["--data.dataset=multidim", f"--data.n={n_fit}", "--data.d=4"]
        ck, mf = os.path.join(tmp, "fit"), os.path.join(tmp, "fit.jsonl")
        args = ["fit", *cfg2, f"--fit.steps={fit_steps}",
                f"--checkpoint_dir={ck}", f"--metrics_file={mf}"]
        (o1,), _ = verb("fit", *args)
        (o2,), _ = verb("fit_resumed", *args)
        neg = _metrics_series(mf, "neg_lml")
        done = _metrics_series(mf, "event")
        say("cli", part="fit", lml=f"{o1['lml']:.4f}",
            lml_resumed=f"{o2['lml']:.4f}", resumed=(o1["resumed"],
                                                     o2["resumed"]),
            neg_lml_lines=len(neg), fit_done_events=done.count("fit_done"))
        gate(o1["resumed"] is False and o2["resumed"] is True,
             "fit: the second call on one checkpoint_dir did not resume")
        gate(len(neg) == 2 * fit_steps and done.count("fit_done") == 2,
             "fit: the metrics file lacks a neg_lml line a step or a "
             "fit_done event a call")
        gate(np.isfinite(o1["lml"]) and np.isfinite(o2["lml"]),
             "fit: LML not finite")

        ckp = os.path.join(tmp, "predict")
        (fo, po), _ = verb("predict", "predict", *cfg2,
                           f"--fit.steps={fit_steps}",
                           f"--checkpoint_dir={ckp}")
        gp = cugp_tpu_torch.GP.load(ckp, device=dev)
        X32 = gp.X.cpu().numpy()
        lo, hi = X32.min(axis=0), X32.max(axis=0)
        Xs = np.linspace(lo, hi, 256).reshape(256, -1)
        with torch.no_grad():
            mu = gp.predict(Xs)[0].cpu().numpy()
        p64 = {k: v.cpu().numpy().astype(np.float64)
               for k, v in gp.params.items()}
        y64 = gp.y.cpu().numpy().astype(np.float64)
        mu64, _ = oracle.posterior(p64, X32.astype(np.float64), y64,
                                   Xs.astype(np.float64))
        err = float(np.abs(mu - mu64).max())
        head_same = np.array_equal(np.float32(po["mu_head"]), mu[:8])
        say("cli", part="predict", points=256, mean_err_vs_float64=f""
            f"{err:.3e}", head_as_printed=head_same)
        gate(err <= 1e-3, f"predict: 256-point mean off float64 by {err:.3e}"
             " (gate 1e-3)")
        gate(head_same, "predict: the printed mu_head is not the saved "
             "model's prediction")
        Xn, yn = X32[:native_n].astype(np.float64), y64[:native_n]
        t0 = time.perf_counter()
        ok_native = native.available()
        lml_c = (native.log_marginal_likelihood(p64, Xn, yn)
                 if ok_native else float("nan"))
        t_native = time.perf_counter() - t0
        lml_np = oracle.log_marginal_likelihood(p64, Xn, yn)
        rel = abs(lml_c - lml_np) / abs(lml_np)
        say("cli", part="native_oracle", n=native_n, built=ok_native,
            lml_cpp=f"{lml_c:.10f}", lml_numpy=f"{lml_np:.10f}",
            rel_err=f"{rel:.3e}", seconds=f"{t_native:.3f}")
        gate(ok_native and rel <= 1e-8, f"native oracle: LML {rel:.3e} "
             "relative off the numpy oracle (gate 1e-8) or not built")

        # (b) the iterative fit killed half way and resumed
        it = ["fit", "--fit.engine=iterative", "--data.dataset=multidim",
              f"--data.n={n_it}", "--data.d=4"]
        full, part = os.path.join(tmp, "it_full"), os.path.join(tmp, "it")
        mf_full, mf_b = (os.path.join(tmp, f"it_{k}.jsonl")
                         for k in ("full", "b"))
        (of,), t_full = verb("fit_iterative", *it, f"--fit.steps={it_steps}",
                             f"--checkpoint_dir={full}",
                             f"--metrics_file={mf_full}")
        verb("fit_iterative_part", *it,
             f"--fit.steps={it_steps // 2}", f"--checkpoint_dir={part}")
        (ob,), _ = verb("fit_iterative_resumed", *it,
                        f"--fit.steps={it_steps}", f"--checkpoint_dir={part}",
                        f"--metrics_file={mf_b}")
        meta = checkpoint.peek_meta(part + "_fit_state") or {}
        l_full, l_b = (_metrics_series(f, "neg_lml") for f in (mf_full, mf_b))
        h = it_steps // 2
        dp = max(abs(np.asarray(ob["params"][k], np.float64)
                     - np.asarray(of["params"][k], np.float64)).max()
                 for k in of["params"])
        say("cli", part="fit_iterative", n=n_it, steps=it_steps,
            fit_s_per_step=f"{of['seconds'] / it_steps:.4f}",
            call_s=f"{t_full:.3f}",
            cg_iters_last=(of.get("cg_iters_last"), ob.get("cg_iters_last")),
            precond_rebuilds=(of.get("precond_rebuilds"),
                              ob.get("precond_rebuilds")),
            fit_state_step=meta.get("step"), resumed=ob["resumed"],
            first_losses_bitwise=l_b[:h] == l_full[:h],
            params_maxdiff=f"{dp:.3e}", lml=f"{of['lml']:.4f}",
            lml_resumed=f"{ob['lml']:.4f}")
        gate(meta.get("step") == it_steps and ob["resumed"] is True,
             "fit_iterative: the fit state was not saved at the last step "
             "or the call did not resume")
        gate(len(l_b) == len(l_full) == it_steps and l_b[:h] == l_full[:h],
             "fit_iterative: the resumed run's first losses are not the "
             "uninterrupted run's bit for bit")
        gate(dp <= 1e-4, f"fit_iterative: resumed params {dp:.3e} off the "
             "uninterrupted run's (gate 1e-4)")
        gate(all(k in o for o in (of, ob)
                 for k in ("cg_iters_last", "precond_rebuilds")),
             "fit_iterative: cg_iters_last or precond_rebuilds not printed")

        # (c) the checkpointed HMC at config 3's width, resumed
        hmc = ["sample", f"--data.n={n_hmc}",
               f"--sample.num_chains={hmc_chains}", "--sample.sampler=hmc",
               f"--sample.num_warmup={hmc_warmup}",
               f"--sample.checkpoint_every={hmc_draws // 2}"]
        d3, d3f = os.path.join(tmp, "hmc"), os.path.join(tmp, "hmc_full")
        verb("sample_part", *hmc,
             f"--sample.num_samples={hmc_draws // 2}", f"--checkpoint_dir={d3}")
        (sb,), _ = verb("sample_resumed", *hmc,
                        f"--sample.num_samples={hmc_draws}",
                        f"--checkpoint_dir={d3}")
        (sf,), t_sf = verb("sample", *hmc, f"--sample.num_samples={hmc_draws}",
                           f"--checkpoint_dir={d3f}")
        same = all(sb["posterior"][k][s] == sf["posterior"][k][s]
                   for k in sf["posterior"] for s in ("mean", "std"))
        rhat = {k: v["r_hat"] for k, v in sb["posterior"].items()}
        say("cli", part="sample_hmc", n=n_hmc, chains=hmc_chains,
            draws=hmc_draws, resumed=sb["resumed"],
            draws_done=sb["draws_done"], mean_std_bitwise=same,
            r_hat=json.dumps(rhat), accept_rate=f"{sb['accept_rate']:.4f}",
            samples_per_s=f"{hmc_draws * hmc_chains / t_sf:.2f}")
        gate(sb["resumed"] is True and sb["draws_done"] == hmc_draws,
             "sample: the second call did not resume to every draw")
        gate(same, "sample: the resumed posterior's mean and std are not "
             "the uninterrupted run's bit for bit")
        gate(finite(rhat), "sample: R-hat not finite")

        # (d) the matrix-free sampler
        (si,), _ = verb("sample_iterative", "sample",
                           "--sample.engine=iterative",
                           f"--data.n={n_it_sample}",
                           f"--sample.num_chains={it_chains}",
                           "--sample.sampler=hmc", "--sample.num_warmup=2",
                           "--sample.num_samples=2")
        draws_ok = finite({k: [v["mean"], v["std"]]
                           for k, v in si["posterior"].items()})
        say("cli", part="sample_iterative", n=n_it_sample, chains=it_chains,
            draws_finite=draws_ok, accept_rate=f"{si['accept_rate']:.4f}")
        gate(draws_ok, "sample --sample.engine=iterative: draws not finite")

        # (e)-(h) vi, sgpr, svgp, classify
        (vo,), _ = verb("vi", "vi", f"--data.n={n_hmc}",
                        f"--fit.steps={vi_steps}")
        say("cli", part="vi", elbo=f"{vo['elbo']:.4f}")
        gate(np.isfinite(vo["elbo"]) and finite(vo["mean"]),
             "vi: ELBO or mean not finite")
        (go,), _ = verb("sgpr", "sgpr", "--data.dataset=multidim",
                        f"--data.n={n_sgpr}", "--data.d=4",
                        f"--fit.steps={sgpr_steps}")
        say("cli", part="sgpr", elbo=f"{go['elbo']:.4f}",
            num_inducing=go["num_inducing"],
            s_per_step=f"{go['seconds'] / sgpr_steps:.4f}",
            train_rmse_head=f"{go['train_rmse_head']:.4f}")
        gate(np.isfinite(go["elbo"]) and go["num_inducing"] == min(
            n_sgpr // 4, 512), "sgpr: ELBO not finite or wrong m")
        (vg,), _ = verb("svgp", "svgp", "--svgp.likelihood=bernoulli",
                        f"--data.n={n_svgp}", f"--fit.steps={svgp_steps}")
        say("cli", part="svgp", accuracy=vg["train_accuracy"],
            s_per_step=f"{vg['seconds'] / svgp_steps:.5f}",
            elbo_batch_final=f"{vg['elbo_batch_final']:.4f}")
        gate(vg["train_accuracy"] >= 0.95, "svgp: train accuracy "
             f"{vg['train_accuracy']} below 0.95")
        for classes in (2, 3):
            (co,), _ = verb(f"classify_{classes}", "classify",
                            f"--data.n={n_cls}", f"--fit.steps={cls_steps}",
                            f"--data.num_classes={classes}")
            say("cli", part=f"classify_{classes}",
                lml=f"{co['laplace_lml']:.4f}",
                accuracy=co["train_accuracy"])
            gate(np.isfinite(co["laplace_lml"]) and co["num_classes"]
                 == classes, f"classify ({classes} classes): LML not finite")

        # (i) info
        (io_,), _ = verb("info", "info")
        say("cli", part="info", devices=json.dumps(io_["devices"]),
            torch_version=io_["torch"], cuda=io_["cuda_available"])
        gate(io_["cuda_available"] and io_["device_count"] >= 1,
             "info: no card reported")
        # (j) --profile on a 3-step fit
        prof = os.path.join(tmp, "profile")
        verb("fit_profiled", "fit", *cfg2, "--fit.steps=3",
             f"--profile={prof}")
        trace_path = os.path.join(prof, "trace.json")
        text = (open(trace_path).read() if os.path.exists(trace_path)
                else "")
        named = {k: k in text for k in ("cov_tile_kernel", "potrf_kernel",
                                        "trsm_")}
        say("cli", part="profile", trace_bytes=len(text),
            kernels_named=json.dumps(named))
        gate(all(named.values()), f"--profile: the trace names {named}")
        gates.paths["cli"] = dict(total)
        say("cli", part="cli", launches=json.dumps(
            total, separators=(",", ":")))
        for name, v in total.items():
            gate(v > 0, f"cli: the {name} kernel was never launched")


        # (k) supervision of a CLI child killed once its heartbeat appears
        torch.cuda.empty_cache()  # room for the child on the card
        rc, killed, t_sup, meta = _supervised_fit(tmp, dev, n_fit, sup_steps)
        say("cli", part="supervise", rc=rc, killed=killed,
            seconds=f"{t_sup:.3f}", meta_step=(meta or {}).get("step"))
        gate(rc == 0 and meta is not None, "supervise: rc != 0 or no "
             "checkpoint meta")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("cli", phase_s=f"{time.perf_counter() - t_phase:.3f}")
    gates.finish("CLI phase")
    return gates.paths


DIST_N4 = 32768     # config 4 / the north star: N=32768, d=8, rbf
DIST_N_MAP = 8192   # the sharded MAP steps (cut from 32768: time)
DIST_N_LARGE = 4096  # sample_hyperparams_large_n (cut: time)
DIST_N5 = 100_000   # config 5: phase 5's data
DIST_N5_FIT = 32768  # fit_iterative_sharded
DIST_N5_SAMPLE = 4096  # the matrix-free sampler (cut: time)
DIST_M5 = 32        # posterior test points at N5 (cut from 128: time)
DIST_C3 = dict(n=512, chains=256, warmup=4, draws=2)  # config 3, cut
DIST_BLOCK = 256    # block_cyclic's block at N=32768 (128 panels)
DIST_CHUNK = 8192


def _dist_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _dist_config4(torch, dev, n=DIST_N4):
    """config 4's data: multidim_regression(n, d=8) and phase 4's params."""
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.ops import kernels

    X, y, _ = synthetic.multidim_regression(n=n, d=8, seed=0)
    return (torch.as_tensor(X, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.float32, device=dev),
            kernels.init_params(d=8, lengthscale=2.0, noise_var=1e-2,
                                device=dev))


def _dist_draws(chains, dim, transitions, seed=3):
    """Config 3's replayed draws: the (C, D) initial jitter, then per
    transition the step jitter, the momentum and the accept uniforms."""
    rng = np.random.default_rng(seed)
    init = rng.standard_normal((chains, dim)).astype(np.float32)
    mom = rng.standard_normal((transitions, chains, dim)).astype(np.float32)
    uni = rng.uniform(size=(transitions, 2, chains)).astype(np.float32)
    return init, mom, uni


def _dist_rank_draws(draws, lo, hi):
    from cugp_tpu_torch.inference import hmc

    init, mom, uni = draws
    return hmc.Draws(normals=[init] + [m[lo:hi] for m in mom],
                     uniforms=[u[k][lo:hi] for u in uni for k in range(2)])


def _dist_grad(torch, fn, params):
    """(value, flat gradient in ravel_pytree's order) of fn(params)."""
    from cugp_tpu_torch.utils.params import ravel_pytree, tree_map

    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    val = fn(p)
    val.backward()
    return float(val.detach()), ravel_pytree(
        tree_map(lambda t: t.grad, p))[0].cpu().numpy()


def _dist_lml64(torch, params, X, y, jitter=1e-6, rows=4096):
    """The rbf LML and its gradient (log-space, ravel_pytree's order) in
    float64 on the device: K built in row blocks, the library's float64
    Cholesky and inverse (a reference only), the gradient as
    1/2 sum((alpha alpha^T - K^-1) o dK)."""
    import math

    from cugp_tpu_torch.utils.params import ravel_pytree

    X = X.double()
    y = y.double()
    n = X.shape[0]
    ell = torch.exp(params["log_lengthscale"].double())
    sf2 = torch.exp(params["log_signal_var"].double())
    sn2 = torch.exp(params["log_noise_var"].double())
    xs = X / ell

    def kern(lo, hi):
        d2 = torch.cdist(xs[lo:hi], xs).square_()
        return sf2 * torch.exp(-0.5 * d2)

    K = torch.empty((n, n), dtype=torch.float64, device=X.device)
    for lo in range(0, n, rows):
        K[lo:lo + rows] = kern(lo, lo + rows)
    K.diagonal().add_(sn2 + jitter * sf2)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    lml = (-0.5 * torch.dot(y, alpha) - torch.log(L.diagonal()).sum()
           - 0.5 * n * math.log(2 * math.pi))
    W = torch.cholesky_inverse(L)
    del L
    W.neg_().addr_(alpha, alpha)  # alpha alpha^T - K^-1
    g_ell = torch.zeros_like(ell)
    g_sf2 = torch.zeros((), dtype=torch.float64, device=X.device)
    for lo in range(0, n, rows):
        M = W[lo:lo + rows] * kern(lo, lo + rows)  # W o (K - diag)
        g_sf2 += M.sum()
        rs, cs = M.sum(1), M.sum(0)
        # sum_ij M_ij (xs_ik - xs_jk)^2 for each dimension k
        g_ell += ((xs[lo:lo + rows] ** 2 * rs[:, None]).sum(0)
                  + (xs ** 2 * cs[:, None]).sum(0)
                  - 2 * (xs[lo:lo + rows] * (M @ xs)).sum(0))
    tr = W.diagonal().sum()
    grads = {"log_lengthscale": 0.5 * g_ell,
             "log_signal_var": 0.5 * (g_sf2 + jitter * sf2 * tr),
             "log_noise_var": 0.5 * sn2 * tr}
    return float(lml), ravel_pytree(
        {k: grads[k] for k in params})[0].cpu().numpy()


def _dist_references(torch, dev, work):
    """The single-device results phase 12 holds the distributed tier
    against, computed here before the ranks start (they share the card);
    the large arrays go to files in `work`."""
    import math

    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import hmc, iterative, map_opt, sampling
    from cugp_tpu_torch.models import exact_gp
    from cugp_tpu_torch.ops import cov_matvec_cuda, kernels

    refs, t0 = {}, time.perf_counter()
    X, y, p = _dist_config4(torch, dev)
    refs["lml4"] = _dist_grad(
        torch, lambda q: exact_gp.log_marginal_likelihood(q, X, y), p)
    refs["lml4_64"] = _dist_lml64(torch, p, X, y)
    m = DIST_N_MAP
    pm, info = map_opt.fit(p, X[:m], y[:m], steps=2, learning_rate=0.05)
    refs["map"] = ({k: v.cpu().numpy() for k, v in pm.items()},
                   info["loss"].cpu().numpy())
    nl = DIST_N_LARGE
    lpg, unravel, q0 = sampling.make_flat_logprob(p, X[:nl], y[:nl])
    qs = sampling.init_chains(q0, hmc.Draws(torch.Generator().manual_seed(0)),
                              2)
    logp, grad = lpg(qs)
    refs["large_n"] = (qs.cpu().numpy(), logp.cpu().numpy(),
                       grad.cpu().numpy())
    prior = hmc.default_log_prior(qs)
    refs["large_n_64"] = [
        (v + float(pr), g + (-qc / 9.0).cpu().numpy())
        for qc, pr, (v, g) in zip(qs, prior, (
            _dist_lml64(torch, unravel(qc), X[:nl], y[:nl]) for qc in qs))]
    del X, y
    c3 = DIST_C3
    Xc, yc, _ = synthetic.sinusoid_1d(n=c3["n"], noise_std=0.1, seed=0)
    draws = _dist_draws(c3["chains"], 3, c3["warmup"] + c3["draws"])
    out = sampling.sample_hyperparams(
        kernels.init_params(d=1, lengthscale=0.8, noise_var=0.05,
                            device=dev),
        torch.as_tensor(Xc, dtype=torch.float32, device=dev),
        torch.as_tensor(yc, dtype=torch.float32, device=dev), sampler="hmc",
        num_chains=c3["chains"], num_samples=c3["draws"],
        num_warmup=c3["warmup"],
        rng=_dist_rank_draws(draws, 0, c3["chains"]))
    lpg3, _, q3 = sampling.make_flat_logprob(
        kernels.init_params(d=1, lengthscale=0.8, noise_var=0.05,
                            device=dev),
        torch.as_tensor(Xc, dtype=torch.float32, device=dev),
        torch.as_tensor(yc, dtype=torch.float32, device=dev))
    lp3, g3 = lpg3(sampling.init_chains(q3, hmc.Draws(normals=[draws[0]]),
                                        c3["chains"]))
    refs["c3_density"] = (lp3.cpu().numpy(), g3.cpu().numpy())
    refs["c3"] = (float(out["eps"]), out["inv_mass"].cpu().numpy(),
                  np.concatenate([out["samples"][k].reshape(
                      c3["draws"], c3["chains"], -1).cpu().numpy()
                      for k in sorted(out["samples"])], axis=-1))
    # config 5: phase 5's data, the truth as params
    X5, y5 = rff_gp_draw(DIST_N5, 4, 1.5, 1.0, math.sqrt(0.04), seed=0,
                         device=dev)
    np.save(os.path.join(work, "X5.npy"), X5)
    np.save(os.path.join(work, "y5.npy"), y5)
    p5 = kernels.init_params(d=4, lengthscale=1.5, signal_var=1.0,
                             noise_var=0.04, device=dev)
    X5t = torch.as_tensor(X5, device=dev)
    y5t = torch.as_tensor(y5, device=dev)
    V = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (DIST_N5, 9)).astype(np.float32), device=dev)
    with torch.no_grad():
        u = cov_matvec_cuda.train_cov_matvec(p5, X5t, V, kind="rbf")
    np.save(os.path.join(work, "matvec9.npy"), u.cpu().numpy())
    Xs = np.random.default_rng(2).uniform(-3.0, 3.0, (DIST_M5, 4)).astype(
        np.float32)
    np.save(os.path.join(work, "Xs.npy"), Xs)
    mu, var = iterative.posterior_iterative(
        p5, X5t, y5t, torch.as_tensor(Xs, device=dev), tol=1e-4,
        precond_rank=128)
    refs["posterior5"] = (mu.cpu().numpy(), var.cpu().numpy())
    del X5t, y5t, V, u
    Xf, yf = X5[:DIST_N5_FIT], y5[:DIST_N5_FIT]
    pf, info = map_opt.fit_iterative(
        kernels.init_params(d=4, lengthscale=0.6, signal_var=0.3,
                            noise_var=0.3, device=dev),
        torch.as_tensor(Xf, device=dev), torch.as_tensor(yf, device=dev),
        steps=2, learning_rate=0.15, precond_rank=128, num_probes=8,
        tol=1e-4, max_iters=300, split_programs=True, warm_start=False,
        generator=torch.Generator().manual_seed(0))
    refs["fit5"] = ({k: v.cpu().numpy() for k, v in pf.items()},
                    info["loss"].numpy(), info["cg_iters"])
    _dist_sync(torch, dev)
    refs["seconds"] = time.perf_counter() - t0
    torch.save(refs, os.path.join(work, "refs.pt"))
    return refs


class _DistLaunches:
    """A rank's kernel launches on the distributed path: only the calls
    made through `counted` (references and checks are not counted)."""

    def __init__(self):
        self.counts = {name: 0 for name in _wrappers()}

    def __call__(self, fn):
        before = read_launches()
        out = fn()
        for k, v in read_launches().items():
            self.counts[k] += v - before[k]
        return out


def _dist_timed(torch, dev, res, key, fn):
    _dist_sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    _dist_sync(torch, dev)
    res.setdefault("wall_s", {})[key] = time.perf_counter() - t0
    return out


def _dist_recon(L_loc, K_loc, mesh, nb=4096):
    """Phase 4's gate on the first nb rows: on the rank that holds them
    (rows and columns 0..nb of the grid's first block), else None."""
    if any(mesh.coords[a] for a in ("dp", "r", "c")):
        return None
    r = L_loc[:nb, :nb] @ L_loc[:nb, :nb].T - K_loc[:nb, :nb]
    return float(r.abs().max() / K_loc[:nb, :nb].abs().max())


def _dist_part_a(torch, dev, res, counted):
    """One rank (NCCL, the users' layout on one card) at full size."""
    from cugp_tpu_torch.parallel import distributed_chol, mesh as mesh_lib
    from cugp_tpu_torch.ops import kernels

    m = mesh_lib.make_mesh()
    X, y, p = _dist_config4(torch, dev)
    with torch.no_grad():
        K = kernels.train_covariance(p, X)
        L = _dist_timed(torch, dev, res, "distributed_cholesky",
                        lambda: counted(lambda: distributed_chol
                                        .distributed_cholesky(
                                            K, m, chunk=DIST_CHUNK)))
        res["recon_relerr"] = _dist_recon(L, K, m)
    del K, L
    res["lml"], g = _dist_timed(
        torch, dev, res, "distributed_lml_and_grad",
        lambda: counted(lambda: _dist_grad(
            torch, lambda q: distributed_chol.distributed_lml(
                q, X, y, m, chunk=DIST_CHUNK), p)))
    res["grad"] = g.tolist()


def _dist_part_b(torch, dev, res, counted, refs, work):
    """Four ranks on gloo sharing one card: every distributed entry point
    (config 4 at N=32768, config 3 chain-sharded, the large-N sampler,
    config 5 matrix-free)."""
    import torch.distributed as dist

    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import hmc
    from cugp_tpu_torch.ops import cov_matvec_cuda, kernels
    from cugp_tpu_torch.parallel import (block_cyclic, collectives,
                                         distributed_chol, gspmd, relayout,
                                         ring, sharded_sampling, sp_iterative)
    from cugp_tpu_torch.parallel import mesh as mesh_lib
    from cugp_tpu_torch.parallel.mesh import Sharding
    from cugp_tpu_torch.utils.params import ravel_pytree

    m = mesh_lib.make_mesh(dp=1)
    collectives.reset_counts()
    X, y, p = _dist_config4(torch, dev)
    n = X.shape[0]
    rows = Sharding(m, (("r", "c"), None))
    xr = Sharding(m, (("dp", "r"), None))
    with torch.no_grad():
        K_rows = _dist_timed(torch, dev, res, "ring_train_covariance",
                             lambda: counted(
                                 lambda: ring.ring_train_covariance(
                                     p, rows.shard(X), m, axis=("r", "c"))))
        ref = kernels.train_covariance(p, X)[rows.slices((n, n))[0]]
        res["ring_max_abs_err"] = float((K_rows - ref).abs().max())
        del ref
        K2 = _dist_timed(torch, dev, res, "row_to_2d",
                         lambda: counted(lambda: relayout.row_to_2d(
                             K_rows, m)))
        back = _dist_timed(torch, dev, res, "two_d_to_row",
                           lambda: counted(lambda: relayout.two_d_to_row(
                               K2, m)))
        res["relayout_bitwise"] = bool(torch.equal(back, K_rows))
        del back, K_rows
        L = _dist_timed(torch, dev, res, "block_cyclic_cholesky",
                        lambda: counted(lambda: block_cyclic
                                        .block_cyclic_cholesky(
                                            K2, m, block=DIST_BLOCK)))
        res["bc_recon_relerr"] = _dist_recon(L, K2, m)
        del L
        L = _dist_timed(torch, dev, res, "distributed_cholesky",
                        lambda: counted(lambda: distributed_chol
                                        .distributed_cholesky(
                                            K2, m, chunk=DIST_CHUNK)))
        res["dc_recon_relerr"] = _dist_recon(L, K2, m)
        del L, K2
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["lml"], g = _dist_timed(
        torch, dev, res, "distributed_lml_and_grad",
        lambda: counted(lambda: _dist_grad(
            torch, lambda q: distributed_chol.distributed_lml(
                q, xr.shard(X), xr.shard(y), m, chunk=DIST_CHUNK), p)))
    res["grad"] = g.tolist()
    # two sharded Adam steps at DIST_N_MAP rows
    nm = DIST_N_MAP
    step, tx = gspmd.make_map_train_step(m, chunk=2048)
    state = tx.init(p)
    params, losses = state.params, []

    def two_steps():
        nonlocal params, state
        for _ in range(2):
            params, state, loss = step(params, state, xr.shard(X[:nm]),
                                       xr.shard(y[:nm]))
            losses.append(float(loss))

    _dist_timed(torch, dev, res, "map_train_step_x2",
                lambda: counted(two_steps))
    res["map_losses"] = losses
    res["map_params"] = ravel_pytree(params)[0].detach().cpu().tolist()
    # large N: the density of 2 chains, then 1 + 1 NUTS transitions
    nl = DIST_N_LARGE
    qs, _, _ = refs["large_n"]
    Xl, yl = xr.shard(X[:nl]), xr.shard(y[:nl])
    _, unravel = ravel_pytree(p)

    def density():
        q = torch.as_tensor(qs, device=dev).requires_grad_(True)
        lp = torch.stack([distributed_chol.distributed_lml(
            unravel(qc), Xl, yl, m, chunk=2048) for qc in q])
        lp = lp + hmc.default_log_prior(q)
        (gq,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach().cpu().numpy(), gq.cpu().numpy()

    lp, gq = _dist_timed(torch, dev, res, "large_n_density",
                         lambda: counted(density))
    res["large_n_logp"], res["large_n_grad"] = lp.tolist(), gq.tolist()
    out = _dist_timed(torch, dev, res, "sample_hyperparams_large_n",
                      lambda: counted(lambda: sharded_sampling
                                      .sample_hyperparams_large_n(
                                          p, Xl, yl, m, chunk=2048,
                                          num_chains=1, num_warmup=1,
                                          num_samples=1, max_tree_depth=2,
                                          key=0)))
    res["large_n_draws_finite"] = bool(torch.isfinite(
        out["samples_flat"]).all())
    del X, y, Xl, yl
    # config 3: 256 chains over dp=4 with the parent's draws replayed
    c3 = DIST_C3
    m4 = mesh_lib.make_mesh(dp=4)
    Xc, yc, _ = synthetic.sinusoid_1d(n=c3["n"], noise_std=0.1, seed=0)
    local = c3["chains"] // 4
    i = m4.group("dp").index
    draws = _dist_draws(c3["chains"], 3, c3["warmup"] + c3["draws"])
    p3 = kernels.init_params(d=1, lengthscale=0.8, noise_var=0.05,
                             device=dev)
    Xc, yc = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (Xc, yc))
    # the density of this rank's initial chains (the sampler's own)
    from cugp_tpu_torch.inference import sampling

    lpg3, _, q3 = sampling.make_flat_logprob(p3, Xc, yc)
    q_loc = sampling.init_chains(q3, hmc.Draws(normals=[draws[0]]),
                                 c3["chains"])[i * local:(i + 1) * local]
    lp3, g3 = counted(lambda: lpg3(q_loc))
    lp_ref, g_ref3 = refs["c3_density"]
    res["c3_density_rel_err"] = float(np.max(np.abs(
        lp3.cpu().numpy() - lp_ref[i * local:(i + 1) * local])
        / np.abs(lp_ref[i * local:(i + 1) * local])))
    res["c3_grad_err_of_max"] = float(np.abs(
        g3.cpu().numpy() - g_ref3[i * local:(i + 1) * local]).max()
        / np.abs(g_ref3).max())
    out = _dist_timed(torch, dev, res, "sample_hyperparams_sharded_c3",
                      lambda: counted(lambda: sharded_sampling
                                      .sample_hyperparams_sharded(
                                          p3, Xc, yc, m4, sampler="hmc",
                                          num_chains=c3["chains"],
                                          num_samples=c3["draws"],
                                          num_warmup=c3["warmup"],
                                          rng=_dist_rank_draws(
                                              draws, i * local,
                                              (i + 1) * local))))
    res["c3_eps"] = out["eps_per_chip"].cpu().tolist()
    res["c3_inv_mass"] = out["inv_mass_per_chip"].cpu().tolist()
    eps_ref, im_ref, s_ref = refs["c3"]
    res["c3_samples_max_abs_diff"] = float(np.abs(
        out["samples_flat"].cpu().numpy() - s_ref).max())
    # config 5: the ring over all four ranks on phase 5's data
    axis = ("r", "c")
    g = m.group(axis)
    X5 = torch.as_tensor(np.load(os.path.join(work, "X5.npy")), device=dev)
    y5 = torch.as_tensor(np.load(os.path.join(work, "y5.npy")), device=dev)
    n5 = X5.shape[0]
    sl = rows.slices((n5, 1))[0]
    X5l, y5l = X5[sl], y5[sl]
    p5 = kernels.init_params(d=4, lengthscale=1.5, signal_var=1.0,
                             noise_var=0.04, device=dev)
    V = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (n5, 9)).astype(np.float32), device=dev)
    u = _dist_timed(torch, dev, res, "ring_matvec_r9",
                    lambda: counted(lambda: sp_iterative.ring_matvec(
                        p5, X5l, V[sl], m, axis=axis)))
    want = torch.as_tensor(np.load(os.path.join(work, "matvec9.npy"))[
        sl], device=dev)
    res["ring_matvec_rel_err"] = float((u - want).abs().max()
                                       / want.abs().max())
    del V, u, want
    pre = _dist_timed(torch, dev, res, "precond_factors_sharded",
                      lambda: counted(lambda: sp_iterative
                                      .precond_factors_sharded(
                                          p5, X5l, m, 128, axis=axis)))
    x, it = _dist_timed(torch, dev, res, "cg_solve_sharded",
                        lambda: counted(lambda: sp_iterative.cg_solve_sharded(
                            p5, X5l, y5l, m, axis=axis, tol=1e-4,
                            max_iters=1000, precond=pre)))
    res["cg_iters"] = int(it)
    xg = collectives.all_gather(x, g)
    if g.index == 0:  # the certificate, recomputed without the kernel
        with torch.no_grad():
            xs = X5 / torch.exp(p5["log_lengthscale"])
            sf2 = torch.exp(p5["log_signal_var"])
            scal = torch.stack([sf2, torch.exp(p5["log_noise_var"])
                                + 1e-6 * sf2, torch.ones_like(sf2)])
            r = y5 - cov_matvec_cuda.cov_matvec_plain(xs, xg[:, None], scal,
                                                      "rbf", n5)[:, 0]
            res["cg_rel_residual"] = float(torch.linalg.vector_norm(r)
                                           / torch.linalg.vector_norm(y5))
        del xs, r
    del xg
    Xs = torch.as_tensor(np.load(os.path.join(work, "Xs.npy")), device=dev)
    mu, var = _dist_timed(torch, dev, res, "posterior_iterative_sharded",
                          lambda: counted(lambda: sp_iterative
                                          .posterior_iterative_sharded(
                                              p5, X5l, y5l, Xs, m,
                                              axis=axis, tol=1e-4,
                                              precond=pre)))
    mu_ref, var_ref = refs["posterior5"]
    res["posterior_err_mu"] = float(np.abs(mu.cpu().numpy() - mu_ref).max())
    res["posterior_err_var"] = float(np.abs(var.cpu().numpy()
                                            - var_ref).max())
    del X5, y5, X5l, y5l, pre
    nf = DIST_N5_FIT
    Xf = torch.as_tensor(np.load(os.path.join(work, "X5.npy"))[:nf],
                         device=dev)
    yf = torch.as_tensor(np.load(os.path.join(work, "y5.npy"))[:nf],
                         device=dev)
    sf = rows.slices((nf, 1))[0]
    ss = rows.slices((DIST_N5_SAMPLE, 1))[0]
    pf, info = _dist_timed(torch, dev, res, "fit_iterative_sharded_x2",
                           lambda: counted(lambda: sp_iterative
                                           .fit_iterative_sharded(
                                               kernels.init_params(
                                                   d=4, lengthscale=0.6,
                                                   signal_var=0.3,
                                                   noise_var=0.3,
                                                   device=dev),
                                               Xf[sf], yf[sf], m, axis=axis,
                                               steps=2, learning_rate=0.15,
                                               precond_rank=128,
                                               num_probes=8, tol=1e-4,
                                               max_iters=300,
                                               generator=torch.Generator()
                                               .manual_seed(0))))
    res["fit5_losses"] = info["loss"].tolist()
    res["fit5_cg_iters"] = info["cg_iters"].tolist()
    out = _dist_timed(torch, dev, res, "sample_hyperparams_sharded_mf",
                      lambda: counted(lambda: sp_iterative
                                      .sample_hyperparams_sharded(
                                          pf, Xf[:DIST_N5_SAMPLE][ss],
                                          yf[:DIST_N5_SAMPLE][ss], m,
                                          axis=axis, num_chains=1,
                                          num_warmup=1,
                                          num_samples=1, n_leapfrog=1,
                                          tol=1e-4, max_iters=300,
                                          num_probes=8, num_steps=16,
                                          precond_rank=128,
                                          rng=hmc.Draws(torch.Generator()
                                                        .manual_seed(1)))))
    res["mf_draws_finite"] = bool(torch.isfinite(out["samples_flat"]).all())
    res["mf_accept"] = float(out["accept_rate"])
    res["staged_bytes"] = dict(collectives.STAGED)
    res["collective_calls"] = dict(collectives.CALLS)
    dist.barrier()


def _dist_probes(torch, dev, res, save):
    """Two ranks on the one card: what NCCL says to a collective, then
    what gloo does with CUDA tensors, collective by collective, without
    the port's host staging (send/recv last: gloo may crash the process
    there). `save` writes res after each answer."""
    import torch.distributed as dist

    t = torch.ones(1, device=dev)
    try:
        dist.all_reduce(t)
        torch.cuda.synchronize()
        res["nccl_two_ranks_one_card"] = f"accepted (sum {float(t)})"
    except (RuntimeError, dist.DistBackendError) as e:
        res["nccl_two_ranks_one_card"] = " ".join(str(e).split())[:300]
    save()
    pg = dist.new_group([0, 1], backend="gloo")
    me = dist.get_rank()
    x = torch.arange(4.0, device=dev) + 10 * me  # rank 0: 0..3, 1: 10..13

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=pg)
        return y, torch.arange(4.0) * 2 + 10

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0, group=pg)
        return y, torch.arange(4.0)

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(ys, x, group=pg)
        return torch.cat(ys), torch.cat([torch.arange(4.0),
                                         torch.arange(4.0) + 10])

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=pg)
        return y, torch.arange(4.0).reshape(2, 2)[me].repeat(2) + \
            torch.tensor([0.0, 0.0, 10.0, 10.0])

    def send_recv():
        y = torch.empty_like(x)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - me, group=pg),
                dist.P2POp(dist.irecv, y, 1 - me, group=pg)]):
            w.wait()
        return y, torch.arange(4.0) + 10 * (1 - me)

    res["gloo_cuda"] = {}
    for fn in (all_reduce, broadcast, all_gather, all_to_all_single,
               send_recv):
        name = fn.__name__
        res["gloo_cuda"][name] = "crashed the process"
        save()
        try:
            got, want = fn()
            torch.cuda.synchronize()
            time.sleep(0.5)  # gloo's I/O threads fail after the call
            right = torch.equal(got.cpu(), want)
            res["gloo_cuda"][name] = ("carried, values right" if right
                                      else "carried, values WRONG")
        except RuntimeError as e:
            res["gloo_cuda"][name] = (
                "refused: " + " ".join(str(e).split())[:160])
        save()


def _dist_rank(rank, world, part, url, backend, dev_type, work, go):
    """A rank of phase 12 (a spawned child process): join its group, wait
    for its turn, run its part, save what it found as JSON. An exception
    is saved too and makes the exit code 1."""
    import traceback

    import torch

    res = {"rank": rank, "part": part}
    path = os.path.join(work, f"{part}_rank{rank}.json")
    torch.set_num_threads(2)  # up to seven ranks share the host's cores
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from cugp_tpu_torch import runtime
        from cugp_tpu_torch.ops import _build

        if dev_type == "cuda":
            _build.lib()  # the parent built it: load only
        info = runtime.initialize(url, world, rank, device=dev_type,
                                  backend=backend)
        res["runtime"] = vars(info)
        # part (b) on NCCL: each rank on the card initialize chose
        dev = (torch.device("cuda", torch.cuda.current_device()
                            if part == "b" and backend == "nccl" else 0)
               if dev_type == "cuda" else torch.device("cpu"))
        go.wait()
        reset_launches()
        counted = _DistLaunches()
        if dev_type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        refs = torch.load(os.path.join(work, "refs.pt"), weights_only=False) \
            if part != "probes" else None
        t0 = time.perf_counter()
        if part == "probes":
            _dist_probes(torch, dev, res, lambda: _dist_save(path, res))
        elif part == "a":
            _dist_part_a(torch, dev, res, counted)
        else:
            _dist_part_b(torch, dev, res, counted, refs, work)
        res["part_s"] = time.perf_counter() - t0
        res["launches"] = counted.counts
        if dev_type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
        rc = 0
    except BaseException:  # saved for the parent, which fails the phase
        res["error"] = traceback.format_exc()[-3000:]
        rc = 1
    _dist_save(path, res)
    os._exit(rc)


def _dist_save(path, res):
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_spawn(ctx, part, world, backend, dev_type, work, go):
    url = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_dist_rank, args=(
        r, world, part, url, backend, dev_type, work, go)) for r in
        range(world)]
    for p in procs:
        p.start()
    return procs


def _dist_join(procs, timeout):
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    return late


def phase_distributed(torch, dev):
    """Phase 12: the distributed tier on the card.

    (a) one rank on NCCL (the users' layout, one rank a card) at config
    4's full size: distributed_cholesky (chunk 8192, phase 4's gate) and
    distributed_lml with its gradient against the single-device LML;
    beside it two ranks asking NCCL for the one card (its answer is
    recorded, and what gloo does there with CUDA tensors, collective by
    collective, unstaged). (b) four ranks, on NCCL one rank a card where
    the machine has four cards, else on gloo sharing the card (CUDA
    tensors; the collectives gloo does not carry for CUDA are staged
    through the host and counted): config 4 at N=32768 (ring covariance, the relayout
    round trip, block-cyclic and chunked Cholesky, distributed_lml and
    its gradient, two sharded MAP steps at N=8192), config 3's 256 chains
    over dp=4 with the single process's draws replayed, the large-N
    sampler at N=8192, and config 5's matrix-free ring at N=100,000 (the
    matvec, a preconditioned CG mean solve, the posterior at 128 points),
    fit_iterative_sharded and the matrix-free sampler at n=32768. The
    ranks are spawned children that only load the kernel library the
    parent built; their launches on the path are summed (the
    "distributed" path). Times from (b) on one card are four processes
    sharing it and claim no scaling.
    """
    import multiprocessing
    import shutil
    import tempfile

    from cugp_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        _build.lib()
    work = tempfile.mkdtemp(prefix="cugp_dist_")
    failures = []

    def gate(ok, what):
        if not ok:
            say("dist", FAILED=repr(what))
            failures.append(what)

    try:
        refs = _dist_references(torch, dev, work)
        say("dist", part="references", seconds=f"{refs['seconds']:.3f}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        go_probe, go_a, go_b = ctx.Event(), ctx.Event(), ctx.Event()
        backend_a = "nccl" if dev.type == "cuda" else "gloo"
        # one rank a card where there are four cards, else all on one
        backend_b = ("nccl" if dev.type == "cuda"
                     and torch.cuda.device_count() >= 4 else "gloo")
        say("dist", part_b_backend=backend_b,
            cards=torch.cuda.device_count() if dev.type == "cuda" else 0)
        t0 = time.perf_counter()
        # every rank starts now (torch's import and the card's context
        # overlap); each group waits for its turn
        groups = {"a": _dist_spawn(ctx, "a", 1, backend_a, dev.type, work,
                                   go_a),
                  "b": _dist_spawn(ctx, "b", 4, backend_b, dev.type, work,
                                   go_b)}
        if dev.type == "cuda":
            groups["probes"] = _dist_spawn(ctx, "probes", 2, "nccl",
                                           dev.type, work, go_probe)
        go_probe.set()
        late_probe = (_dist_join(groups["probes"], 120)
                      if "probes" in groups else [])
        go_a.set()
        late = _dist_join(groups["a"], 300)
        gate(not late, "part (a) timed out")
        t_a = time.perf_counter() - t0
        go_b.set()
        late = _dist_join(groups["b"], 900)
        gate(not late, "part (b) timed out")
        t_b = time.perf_counter() - t0 - t_a
        results = {}
        for part, procs in groups.items():
            for r, p in enumerate(procs):
                path = os.path.join(work, f"{part}_rank{r}.json")
                got = json.load(open(path)) if os.path.exists(path) else {}
                results[(part, r)] = got
                if part == "probes":
                    continue
                gate(p.exitcode == 0 and "error" not in got,
                     f"part ({part}) rank {r}: exit {p.exitcode} "
                     f"{got.get('error', '')}")
        say("dist", part="spawn_and_a_s", seconds=f"{t_a:.3f}")
        say("dist", part="b_s", seconds=f"{t_b:.3f}")
        if failures:
            return _dist_finish(failures, t_phase, work, {})
        a = results[("a", 0)]
        b = [results[("b", r)] for r in range(4)]
        probe = results.get(("probes", 0), {"nccl_two_ranks_one_card":
                                            "not run (CPU)"})
        say("dist", nccl_two_ranks_one_card=repr(probe.get(
            "nccl_two_ranks_one_card", "no answer")),
            probe_exit=[p.exitcode for p in groups.get("probes", [])],
            probe_hung=bool(late_probe))
        say("dist", gloo_cuda_unstaged=json.dumps(probe.get("gloo_cuda")))
        for tag, r in [("a", a)] + [(f"b{i}", x) for i, x in enumerate(b)]:
            say("dist", rank=tag, part_s=f"{r['part_s']:.3f}",
                peak_bytes=r.get("peak_bytes", "n/a"),
                staged_bytes=json.dumps(r.get("staged_bytes", {})),
                launches=json.dumps(r["launches"], separators=(",", ":")),
                wall_s=json.dumps({k: round(v, 4) for k, v in
                                   r["wall_s"].items()},
                                  separators=(",", ":")))
        lml_ref, g_ref = refs["lml4"]
        l64, g64 = refs["lml4_64"]
        err_single = abs(lml_ref - l64) / abs(l64)
        gerr_single = float(np.abs(g_ref - g64).max() / np.abs(g64).max())

        def lml_gates(tag, r):
            """Against float64 (bar: twice the single-device fp32 path's
            own error there, at least 1e-5 / 1e-4 of the largest
            gradient component), and JAX's per-point bar against the
            single-device LML; the ISSUE's 1e-5 reading printed."""
            err = abs(r["lml"] - l64) / abs(l64)
            grad = np.asarray(r["grad"])
            gerr = float(np.abs(grad - g64).max() / np.abs(g64).max())
            gerr_s = float(np.abs(grad - g_ref).max() / np.abs(g_ref).max())
            say("dist", part=tag, lml=f"{r['lml']:.4f}",
                lml_single=f"{lml_ref:.4f}", lml_float64=f"{l64:.4f}",
                lml_rel_err_vs_float64=f"{err:.3e}",
                single_rel_err_vs_float64=f"{err_single:.3e}",
                grad_err_of_max_vs_float64=f"{gerr:.3e}",
                single_grad_err_of_max_vs_float64=f"{gerr_single:.3e}",
                lml_rel_err_vs_single=(
                    f"{abs(r['lml'] - lml_ref) / abs(lml_ref):.3e}"),
                grad_err_of_max_vs_single=f"{gerr_s:.3e}",
                per_point_vs_single=(
                    f"{abs(r['lml'] - lml_ref) / DIST_N4:.3e}"))
            gate(err <= max(1e-5, 2 * err_single),
                 f"({tag}) LML vs float64")
            gate(gerr <= max(1e-4, 2 * gerr_single),
                 f"({tag}) gradient vs float64")
            gate(abs(r["lml"] - lml_ref) / DIST_N4 < 1e-3,
                 f"({tag}) LML per point vs single device")

        say("dist", part="a", n=DIST_N4, chunk=DIST_CHUNK,
            t_chol_s=f"{a['wall_s']['distributed_cholesky']:.5f}",
            recon_relerr=f"{a['recon_relerr']:.3e}",
            lml_and_grad_s=f"{a['wall_s']['distributed_lml_and_grad']:.4f}")
        gate(a["recon_relerr"] < 2e-4, "(a) reconstruction relerr")
        lml_gates("a", a)
        # (b) config 4
        b0 = b[0]
        ring_err = max(x["ring_max_abs_err"] for x in b)
        say("dist", part="b_config4", n=DIST_N4,
            ring_max_abs_err=f"{ring_err:.3e}",
            relayout_bitwise=all(x["relayout_bitwise"] for x in b),
            bc_recon_relerr=f"{b0['bc_recon_relerr']:.3e}",
            dc_recon_relerr=f"{b0['dc_recon_relerr']:.3e}",
            ranks_lml_equal=len({x["lml"] for x in b}) == 1)
        gate(ring_err <= 1e-6, "(b) ring covariance vs train_covariance")
        gate(all(x["relayout_bitwise"] for x in b), "(b) relayout bitwise")
        gate(b0["bc_recon_relerr"] < 2e-4, "(b) block-cyclic recon")
        gate(b0["dc_recon_relerr"] < 2e-4, "(b) distributed_cholesky recon")
        gate(len({x["lml"] for x in b}) == 1, "(b) ranks' LMLs differ")
        lml_gates("b", b0)
        p_ref, l_ref = refs["map"]
        from cugp_tpu_torch.utils.params import ravel_pytree

        flat_ref = ravel_pytree({k: torch.as_tensor(v) for k, v in
                                 p_ref.items()})[0].numpy()
        map_err = float(np.abs(np.asarray(b0["map_params"]) - flat_ref).max())
        map_same = all(x["map_params"] == b0["map_params"] for x in b)
        say("dist", part="b_map_step", n=DIST_N_MAP, steps=2,
            params_max_abs_err=f"{map_err:.3e}", ranks_bitwise=map_same,
            losses=",".join(f"{v:.4f}" for v in b0["map_losses"]),
            losses_ref=",".join(f"{v:.4f}" for v in l_ref))
        gate(map_err <= 1e-4, "(b) MAP steps vs map_opt.fit")
        gate(map_same, "(b) MAP params differ across ranks")
        qs, lp_ref, gq_ref = refs["large_n"]
        lp64 = np.asarray([v for v, _ in refs["large_n_64"]])
        gq64 = np.stack([g for _, g in refs["large_n_64"]])
        lp, gq = np.asarray(b0["large_n_logp"]), np.asarray(b0["large_n_grad"])
        lp_err = float(np.max(np.abs(lp - lp64) / np.abs(lp64)))
        gq_err = float(np.abs(gq - gq64).max() / np.abs(gq64).max())
        lp_err_s = float(np.max(np.abs(lp_ref - lp64) / np.abs(lp64)))
        gq_err_s = float(np.abs(gq_ref - gq64).max() / np.abs(gq64).max())
        say("dist", part="b_large_n", n=DIST_N_LARGE, chains=2,
            logp_rel_err_vs_float64=f"{lp_err:.3e}",
            single_logp_rel_err_vs_float64=f"{lp_err_s:.3e}",
            grad_err_of_max_vs_float64=f"{gq_err:.3e}",
            single_grad_err_of_max_vs_float64=f"{gq_err_s:.3e}",
            logp_rel_err_vs_single=(
                f"{float(np.max(np.abs(lp - lp_ref) / np.abs(lp_ref))):.3e}"),
            draws_finite=b0["large_n_draws_finite"])
        gate(lp_err <= max(1e-5, 2 * lp_err_s)
             and gq_err <= max(1e-4, 2 * gq_err_s), "(b) large-N density")
        gate(b0["large_n_draws_finite"], "(b) large-N draws")
        eps_ref, im_ref, _ = refs["c3"]
        eps = np.asarray(b0["c3_eps"])
        im = np.asarray(b0["c3_inv_mass"])
        eps_spread = float(np.abs(eps / eps[0] - 1).max())
        im_spread = float(np.abs(im / im[0] - 1).max())
        d3 = max(x["c3_density_rel_err"] for x in b)
        g3 = max(x["c3_grad_err_of_max"] for x in b)
        say("dist", part="b_config3", chains=DIST_C3["chains"], dp=4,
            warmup=DIST_C3["warmup"], draws=DIST_C3["draws"],
            density_rel_err_vs_one_process=f"{d3:.3e}",
            grad_err_of_max_vs_one_process=f"{g3:.3e}",
            eps=",".join(f"{v:.6f}" for v in eps), eps_ref=f"{eps_ref:.6f}",
            eps_rel_spread=f"{eps_spread:.3e}",
            inv_mass_rel_spread=f"{im_spread:.3e}",
            eps_rel_err_vs_one_process=f"{abs(eps[0] / eps_ref - 1):.3e}",
            inv_mass_rel_err_vs_one_process=(
                f"{float(np.abs(im[0] / im_ref - 1).max()):.3e}"),
            samples_max_abs_diff=f"{b0['c3_samples_max_abs_diff']:.3e}")
        gate(eps_spread <= 1e-6 and im_spread <= 1e-6,
             "(b) config 3 adaptation differs across ranks")
        gate(d3 <= 1e-5 and g3 <= 1e-4,
             "(b) config 3 density vs one process")
        say("dist", part="b_config5", n=DIST_N5,
            ring_matvec_rel_err=f"{b0['ring_matvec_rel_err']:.3e}",
            cg_iters=b0["cg_iters"],
            cg_rel_residual=f"{b0['cg_rel_residual']:.3e}",
            posterior_err_mu=f"{b0['posterior_err_mu']:.3e}",
            posterior_points=DIST_M5,
            posterior_err_var=f"{b0['posterior_err_var']:.3e}")
        gate(b0["ring_matvec_rel_err"] <= 1e-4, "(b) ring matvec")
        gate(b0["cg_rel_residual"] <= 10 * 1e-4, "(b) CG certificate")
        gate(b0["posterior_err_mu"] <= 1e-3
             and b0["posterior_err_var"] <= 1e-3, "(b) sharded posterior")
        _, fl_ref, cg_ref = refs["fit5"]
        fl = np.asarray(b0["fit5_losses"])
        fit_err = float(np.abs(fl / fl_ref - 1).max())
        say("dist", part="b_config5_fit", n=DIST_N5_FIT, steps=2,
            sampler_n=DIST_N5_SAMPLE,
            losses=",".join(f"{v:.4f}" for v in fl),
            losses_ref=",".join(f"{v:.4f}" for v in fl_ref),
            loss_rel_err=f"{fit_err:.3e}",
            cg_iters=",".join(map(str, b0["fit5_cg_iters"])),
            cg_iters_ref=",".join(map(str, cg_ref)),
            mf_draws_finite=b0["mf_draws_finite"],
            mf_accept=f"{b0['mf_accept']:.4f}")
        gate(np.isfinite(fl).all() and fit_err <= 1e-4,
             "(b) fit_iterative_sharded vs fit_iterative")
        gate(b0["mf_draws_finite"], "(b) matrix-free sampler draws")
        launches = {k: a["launches"][k] + sum(x["launches"][k] for x in b)
                    for k in a["launches"]}
        for name in ("cov", "potrf", "trsm"):
            gate(launches[name] > 0,
                 f"the {name} kernel was never launched on this path")
        return _dist_finish(failures, t_phase, work, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _dist_finish(failures, t_phase, work, launches):
    say("dist", launches=json.dumps(launches, separators=(",", ":")),
        phase_s=f"{time.perf_counter() - t_phase:.3f}")
    if failures:
        fail(f"distributed phase: {len(failures)} gate(s) failed: "
             f"{failures}")
    return launches


# ---- phase 13: the segmented schedule, the host-built preconditioner,
# blocked chains and the fetch-barrier timers ----

SEG_N = 262_144     # bench_fit_iterative.py's round-5 size (data: phase 5's)
SEG_ITERS = 16      # CG iterations a segment
SEG_TEST = 4        # (a)'s test points (cut from 8: time)
SEG_STEPS = 1       # (a)'s fit steps (cut from 2: time)


def _cg_routes(torch, mv, b, pre, tol, max_iters, seg=SEG_ITERS,
               order=(0, 1, 1, 0)):
    """One system on both CG routes, each timed by the host clock around
    synchronized work: cg_solve (0: a host read an iteration) and
    run_cg_segments (1: a host read a segment of `seg`), in `order`.
    Returns say()'s fields: each route's seconds and CG iterations."""
    from cugp_tpu_torch.inference import iterative

    runs = {0: [], 1: []}
    for route in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route:
            _x, it, _rel = iterative.run_cg_segments(
                mv, b, tol=tol, iters_per_program=seg, max_iters=max_iters,
                precond_apply=pre)
        else:
            _x, it = iterative.cg_solve(mv, b, tol=tol, max_iters=max_iters,
                                        precond_apply=pre)
        torch.cuda.synchronize()
        runs[route].append((time.perf_counter() - t0, int(it)))
    out = {}
    for route, name in ((0, "loop"), (1, f"segments{seg}")):
        out[f"{name}_s"] = ",".join(f"{s:.4f}" for s, _ in runs[route])
        out[f"{name}_iters"] = ",".join(str(i) for _, i in runs[route])
    return out


def _tape(hmc, generator):
    """hmc.Draws from `generator` that keeps every draw it hands out, so
    that a transition can be replayed on the same numbers (replay())."""

    class Tape(hmc.Draws):
        def __init__(self):
            super().__init__(generator)
            self.normals, self.uniforms = [], []

        def normal(self, shape, device):
            self.normals.append(super().normal(shape, device))
            return self.normals[-1]

        def uniform(self, shape, device):
            self.uniforms.append(super().uniform(shape, device))
            return self.uniforms[-1]

        def replay(self):
            return hmc.Draws(normals=list(self.normals),
                             uniforms=list(self.uniforms))

    return Tape()


def _recording(fn, calls):
    """fn, a logprob_and_grad, with each call's (q, logp, grad) kept."""
    def run(q):
        logp, grad = fn(q)
        calls.append((q, logp, grad))
        return logp, grad

    return run


def _evaluations(torch, calls, chains):
    """The recorded calls of a (possibly blocked) log density joined into
    whole evaluations of `chains` chains: a list of (q, logp, grad)."""
    evals, part = [], []
    for call in calls:
        part.append(call)
        if sum(c[0].shape[0] for c in part) == chains:
            evals.append(tuple(torch.cat(x) for x in zip(*part)))
            part = []
    return evals


def _rbf_logprob64(torch, X, y, dev, jitter=1e-6):
    """The sampler's rbf log density (the exact LML plus the default
    N(0, 3^2) prior) and its gradient in float64, plain PyTorch on dev:
    q (B, 3) flat as the sampler's (log lengthscale, log noise variance,
    log signal variance) -> (logp (B,), grad (B, 3)); NaN for a chain
    whose covariance does not factor."""
    import math

    x = torch.as_tensor(X, dtype=torch.float64, device=dev).reshape(-1)
    yv = torch.as_tensor(y, dtype=torch.float64, device=dev).reshape(-1)
    d2 = (x[:, None] - x[None, :]) ** 2
    eye = torch.eye(x.shape[0], dtype=torch.float64, device=dev)

    def lpg(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            ell, sn2, sf2 = (torch.exp(q[:, k])[:, None, None]
                             for k in range(3))
            K = sf2 * torch.exp(-0.5 * d2 / ell ** 2) + (sn2 + jitter
                                                         * sf2) * eye
            L, info = torch.linalg.cholesky_ex(K)
            alpha = torch.cholesky_solve(yv.expand(q.shape[0], -1)[..., None],
                                         L)[..., 0]
            lp = (-0.5 * (yv * alpha).sum(-1)
                  - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
                  - 0.5 * x.shape[0] * math.log(2.0 * math.pi)
                  - 0.5 * ((q / 3.0) ** 2).sum(-1))
            (g,) = torch.autograd.grad(lp.sum(), q)
        bad = (info != 0) | ~torch.isfinite(lp) | ~torch.isfinite(g).all(-1)
        return (torch.where(bad, torch.nan, lp.detach()),
                torch.where(bad[:, None], torch.nan, g))

    return lpg


def _hmc_witness(torch, hmc, gate, state, tape, eps, inv_mass, outs, evals,
                 lpg64, calm=0.1):
    """What separates the blocked HMC transition from the unblocked one
    on the same draws (phase 13(c)). Each chain's energy error dH comes
    from its own leapfrog replayed on the transition's recorded
    gradients (bitwise the kernel's accept probability when the replay
    is exact). Two chains, the one whose proposal moved most between the
    runs and the one whose accept probability did, are run again alone
    in float64 (lpg64) from the same start, momentum and step: how far
    each fp32 proposal lies from the float64 one tells rounding amplified
    by the trajectory from a blocking fault. Gate: chains whose |dH| is
    below `calm` in both runs take the same accept decision."""
    # the kernel's draws in the order it takes them: the step jitter,
    # the momentum, the accept uniforms
    u_jit, mom, u_acc = tape.uniforms[0], tape.normals[0], tape.uniforms[1]
    eps_c = eps * (1.0 + hmc.STEP_JITTER * (2.0 * u_jit - 1.0))[:, None]
    p0 = mom / torch.sqrt(inv_mass)
    h0 = -state.logp + hmc._kinetic(p0, inv_mass)
    dH, ends, exact = [], [], []
    for (new, aprob, _), run in zip(outs, evals):
        p, grad = p0, state.grad
        for _q, _lp, g in run:
            p = p + 0.5 * eps_c * grad
            grad = g
            p = p + 0.5 * eps_c * grad
        d = h0 - (-run[-1][1] + hmc._kinetic(p, inv_mass))
        d = torch.where(torch.isfinite(d), d, -torch.inf)
        exact.append(bool(torch.equal(torch.clamp(torch.exp(d), max=1.0),
                                      aprob)))
        dH.append(d)
        ends.append(run[-1][0])
    (a0, a1) = (o[1] for o in outs)
    fin = [torch.isfinite(end).all(dim=1) for end in ends]
    both = fin[0] & fin[1]
    dq = torch.where(both, (ends[1] - ends[0]).abs().max(dim=1).values,
                     torch.zeros_like(ends[0][:, 0]))
    worst_dH = torch.maximum(dH[0].abs(), dH[1].abs())
    still = worst_dH < calm
    same = (u_acc < a0) == (u_acc < a1)
    # the two chains alone in float64, from the same start and momentum
    ws = [int(dq.argmax()), int((a1 - a0).abs().argmax())]
    q = state.q[ws].double()
    p = p0[ws].double()
    e = eps_c[ws].double()
    lp, g = lpg64(q)
    start_rel = (lp - state.logp[ws].double()).abs() / lp.abs()
    h64 = -lp + 0.5 * (p * p).sum(-1)
    for _ in range(len(evals[0])):
        p = p + 0.5 * e * g
        q = q + e * p
        lp, g = lpg64(q)
        p = p + 0.5 * e * g
    dH64 = h64 - (-lp + 0.5 * (p * p).sum(-1))
    for k, w in enumerate(ws):
        off = [float((end[w].double() - q[k]).abs().max()) for end in ends]
        say("segmented", part="c_hmc_chain", eps=eps,
            which=("most_moved", "accept_prob_moved")[k], chain=w,
            step=f"{float(eps_c[w, 0]):.5f}", dq=f"{float(dq[w]):.3e}",
            dH=f"{float(dH[0][w]):.4f},{float(dH[1][w]):.4f}",
            dH_float64=f"{float(dH64[k]):.4f}",
            accept_prob=f"{float(a0[w]):.4f},{float(a1[w]):.4f}",
            unblocked_off_float64=f"{off[0]:.3e}",
            blocked_off_float64=f"{off[1]:.3e}",
            float64_start_rel=f"{float(start_rel[k]):.2e}")

    def top(x):
        return float(x.max()) if x.numel() else 0.0

    say("segmented", part="c_hmc_witness", eps=eps, replay_exact=exact,
        calm_chains=int(still.sum()), calm_max_abs_dq=f"{top(dq[still]):.3e}",
        restless_max_abs_dq=f"{top(dq[~still]):.3e}",
        restless_min_abs_dH=f"{-top(-worst_dH[~still]):.4f}",
        chains_dq_over_1e_3=int((dq > 1e-3).sum()),
        proposals_nonfinite_both=int((~fin[0] & ~fin[1]).sum()),
        proposals_nonfinite_one_run=int((fin[0] != fin[1]).sum()),
        decisions_equal=int(same.sum()))
    gate(bool(same[still].all()), f"blocked HMC at eps {eps}: a chain with "
         f"|dH| < {calm} took another accept decision than unblocked")


def _posterior64(torch, params, X, y, Xs, jitter=1e-6):
    """The rbf posterior mean and variance in float64 on X's device
    (torch.linalg.cholesky as the reference)."""
    f64 = {k: v.double() for k, v in params.items()}
    ell, sf2 = torch.exp(f64["log_lengthscale"]), torch.exp(
        f64["log_signal_var"])
    sn2 = torch.exp(f64["log_noise_var"])
    a, b = X.double() / ell, Xs.double() / ell

    def k(u, v):
        d2 = ((u * u).sum(1)[:, None] + (v * v).sum(1)[None, :]
              - 2.0 * u @ v.T).clamp(min=0.0)
        return sf2 * torch.exp(-0.5 * d2)

    K = k(a, a)
    K.diagonal().add_(sn2 + jitter * sf2)
    L = torch.linalg.cholesky(K)
    del K
    Ks = k(a, b)
    mu = Ks.T @ torch.cholesky_solve(y.double()[:, None], L)[:, 0]
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    return mu, sf2 - (V * V).sum(0)


def phase_segmented(torch, dev, n=SEG_N, n_test=SEG_TEST,
                    fit_steps=SEG_STEPS, n_acc=16384, n_chain=2048,
                    chains=256, chain_block=64, nuts_chains=128,
                    n_lmc=2048, n_cli=16384, cli_chains=64, results=None):
    """Item 12 on the card: (a) the segmented matrix-free fit, LML and
    predict at N=262,144 (d=4, rbf; phase 5's data) with the host-built
    preconditioner; (b) the segmented schedule's bitwise claims and the
    host against the device preconditioner on 16,384 rows; (c) blocked
    chains (256 at n=2048); (d) the rank-Q LMC posterior on segments;
    (e) the CLI's --fit.segment_iters and --sample.chain_block; (f) the
    fetch-barrier timers. Each part's launches are counted; their sum is
    the path "segmented_and_blocked". Cut for time (PERF.md §4): (e) at
    n=16384 and 64 chains (from 32768 and 256), (a) at 4 test points
    (from 8) and 1 fit step (from 2), (c)'s NUTS pair at nuts_chains
    chains (from 256)."""
    import contextlib
    import io
    import math

    import cugp_tpu_torch
    from cugp_tpu_torch.cli.__main__ import main as cli_main
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import hmc, iterative, nuts, sampling
    from cugp_tpu_torch.models import lmc
    from cugp_tpu_torch.ops import cov_cuda, cov_matvec_cuda, kernels
    from cugp_tpu_torch.utils import profiling

    gates = Gates(torch, "segmented")
    gate, synced = gates.gate, gates.synced
    t_phase = time.perf_counter()
    d, seg, tol = 4, SEG_ITERS, 1e-4
    truth = {"ell": 1.5, "sf2": 1.0, "sn2": 0.04}
    t0 = time.perf_counter()
    X, y = rff_gp_draw(n, d, truth["ell"], truth["sf2"],
                       math.sqrt(truth["sn2"]), seed=0, device=dev)
    Xs = np.random.default_rng(2).uniform(-3.0, 3.0, (512, d)).astype(
        np.float32)
    Xt, yt = (torch.as_tensor(a, device=dev) for a in (X, y))
    say("segmented", n=n, d=d, data_s=f"{time.perf_counter() - t0:.3f}")
    init = kernels.init_params(d=d, lengthscale=0.6, signal_var=0.3,
                               noise_var=0.3, device=dev)

    def part_a():
        """fit (host preconditioner), LML and predict, all segmented."""
        host = []  # the host builds the fit makes: (seconds, factors)
        real = iterative.precond_factors_host

        def timed_host(*args, **kw):
            t0 = time.perf_counter()
            fac = real(*args, **kw)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0, fac))
            return fac

        walls, last = [], [time.perf_counter()]

        def step_wall(step, params, value, grads):
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - last[0])
            last[0] = now

        gp = cugp_tpu_torch.GP(kind="rbf", device=dev)
        iterative.precond_factors_host = timed_host
        try:
            info = gp.fit_iterative(
                X, y, steps=fit_steps, init=init, callback=step_wall,
                learning_rate=0.15, precond_rank=128, num_probes=8, tol=tol,
                max_iters=300, probe_mode="frozen", warm_start=True,
                segment_iters=seg, precond_where="host")
        finally:
            iterative.precond_factors_host = real
        cg = info["cg_iters"].tolist()
        fac_d, dev_s = synced(lambda: iterative.precond_factors(
            init, Xt, 128))
        mv0 = iterative.make_matvec(init, Xt)
        # the mean solve at the init: the host factors on both CG routes,
        # the device factors on the tolerance loop
        routes = _cg_routes(
            torch, mv0, yt,
            iterative.precond_apply_from_factors(*host[0][1]), tol=tol,
            max_iters=1000, order=(0, 1))
        dev_route = _cg_routes(
            torch, mv0, yt, iterative.precond_apply_from_factors(*fac_d),
            tol=tol, max_iters=1000, order=(0,))
        its = {"host": int(routes["loop_iters"]),
               "device": int(dev_route["loop_iters"])}
        say("segmented", part="a_cg_routes", n=n, rhs=1, tol=tol,
            **{f"host_{k}": v for k, v in routes.items()},
            device_loop_s=dev_route["loop_s"])
        say("segmented", part="a_fit", steps=fit_steps,
            s_per_step=",".join(f"{w:.4f}" for w in walls),
            first_step_less_host_build_s=f"{walls[0] - host[0][0]:.4f}",
            cg_iters=",".join(map(str, cg)),
            segments_per_solve=",".join(str(c // seg) for c in cg),
            precond_host_s=",".join(f"{s:.3f}" for s, _ in host),
            precond_device_s=f"{dev_s:.4f}",
            mean_cg_iters_host=its["host"], mean_cg_iters_device=its["device"],
            loss=",".join(f"{v:.4f}" for v in info["loss"].tolist()))
        gate(all(c % seg == 0 and c > 0 for c in cg) and len(cg) == fit_steps,
             f"segmented fit: CG counts {cg} not positive multiples of {seg}")
        gate(bool(torch.isfinite(info["loss"]).all()),
             "segmented fit: non-finite loss")
        gate(len(host) >= 1, "segmented fit: the host preconditioner "
             "was never built")
        lml, t_lml = synced(lambda: gp.log_marginal_likelihood_iterative(
            segment_iters=seg))
        stats = {}
        (mu, var), t_pred = synced(lambda: gp.predict_iterative(
            Xs[:n_test], segment_iters=seg, col_batch=n_test, tol=tol,
            stats=stats))
        p = gp.params
        xs = Xt / torch.exp(p["log_lengthscale"])
        sf2 = torch.exp(p["log_signal_var"])
        scal = torch.stack([sf2, torch.exp(p["log_noise_var"])
                            + gp.jitter * sf2, torch.ones_like(sf2)])
        res = yt - cov_matvec_cuda.cov_matvec_plain(
            xs, stats["alpha"][:, None], scal, "rbf", n)[:, 0]
        rel_res = float(torch.linalg.vector_norm(res)
                        / torch.linalg.vector_norm(yt))
        kss = float(sf2)
        say("segmented", part="a_lml_predict", lml=f"{lml:.4f}",
            lml_s=f"{t_lml:.4f}", predict_points=n_test,
            predict_s=f"{t_pred:.4f}", mean_cg_iters=stats["mean_iters"],
            var_cg_iters=",".join(map(str, stats["var_iters"])),
            mean_rel_residual=f"{rel_res:.3e}",
            var_range=f"{float(var.min()):.4e}..{float(var.max()):.4e}",
            kss=f"{kss:.4f}")
        gate(math.isfinite(lml), "segmented LML is not finite")
        gate(bool(torch.isfinite(mu).all()) and mu.shape == (n_test,),
             "segmented predict: mean not finite or of the wrong shape")
        gate(rel_res <= 10 * tol, f"segmented predict: mean-solve residual "
             f"{rel_res:.3e} over 10 tol")
        gate(bool(((var >= 0) & (var <= kss * (1 + 1e-6))).all()),
             "segmented predict: a variance outside [0, k**]")
        return {k: v.detach().clone() for k, v in p.items()}

    fitted, _, _ = gates.path("a_segmented_262144", part_a,
                              launched=("cov", "trsm", "cov_matvec"))
    del Xt, yt
    torch.cuda.empty_cache()

    def part_b():
        """the bitwise claims, the segmented posterior and the two
        preconditioners on the first n_acc rows, at the fitted params."""
        Xa = torch.as_tensor(X[:n_acc], device=dev)
        ya = torch.as_tensor(y[:n_acc], device=dev)
        Xb = torch.as_tensor(Xs[:64], device=dev)
        p = fitted
        mv = iterative.make_matvec(p, Xa)
        pre_d, t_d = synced(lambda: iterative.precond_factors(p, Xa, 128))
        pre_h, t_h = synced(lambda: iterative.precond_factors_host(
            p, Xa, 128))
        apply = iterative.precond_apply_from_factors(*pre_d)
        b = torch.stack([ya, 0.5 * ya], dim=1)
        s0 = iterative.cg_init(b, apply)
        two = iterative.cg_segment(mv, iterative.cg_segment(
            mv, s0, seg, apply), 2 * seg, apply)
        one = iterative.cg_segment(mv, s0, 3 * seg, apply)
        compose = all(torch.equal(u, v) for u, v in zip(two[:4], one[:4]))
        x, it, rel = iterative.cg_solve_segmented(
            p, Xa, b, tol=1e-6, iters_per_program=seg, max_iters=1000,
            precond=pre_d)
        x_fix, _ = iterative.cg_solve(mv, b, fixed_iters=True, max_iters=it,
                                      precond_apply=apply)
        fixed = torch.equal(x, x_fix)
        Z = iterative.rademacher(n_acc, 16, dev)
        ld = iterative.slq_logdet(mv, n_acc, Z=Z)
        ld_s = iterative.slq_logdet_segmented(p, Xa, n_acc, Z,
                                              iters_per_program=seg // 2)
        slq = torch.equal(ld, ld_s)
        gate(compose, "cg_segment(16) then cg_segment(32) is not bitwise "
             "cg_segment(48)")
        gate(fixed, "cg_solve_segmented is not bitwise the fixed-iteration "
             "cg_solve")
        gate(slq, "slq_logdet_segmented(Z) is not bitwise slq_logdet(Z)")
        stats = {}
        mu_s, var_s = iterative.posterior_iterative_segmented(
            p, Xa, ya, Xb, tol=1e-6, iters_per_program=seg, precond=pre_d,
            col_batch=32, stats=stats)
        mu_1, var_1 = iterative.posterior_iterative(
            p, Xa, ya, Xb, tol=1e-6, precond=pre_d)
        mu_64, var_64 = _posterior64(torch, p, Xa, ya, Xb)
        errs = {"seg_vs_one_mu": float((mu_s - mu_1).abs().max()),
                "seg_vs_one_var": float((var_s - var_1).abs().max()),
                "seg_vs_f64_mu": float((mu_s.double() - mu_64).abs().max()),
                "seg_vs_f64_var": float((var_s.double() - var_64).abs()
                                        .max())}
        piv_d, piv_h = pre_d[0].argmax(0), pre_h[0].argmax(0)
        diff = (piv_d != piv_h).nonzero()
        first = int(diff[0, 0]) if len(diff) else 128
        lk_err = (float((pre_d[0][:, :first] - pre_h[0][:, :first]).abs()
                        .max()) if first else 0.0)
        its = {w: int(iterative.cg_solve_program(
            p, Xa, ya, precond=f, tol=tol, max_iters=1000)[1])
            for w, f in (("host", pre_h), ("device", pre_d))}
        say("segmented", part="b_bitwise", n=n_acc, compose=compose,
            fixed_iteration=fixed, slq=slq, cg_iters=it,
            logdet=f"{float(ld):.4f}")
        say("segmented", part="b_posterior", test_points=len(Xb),
            mean_iters=stats["mean_iters"],
            var_iters=",".join(map(str, stats["var_iters"])),
            **{k: f"{v:.3e}" for k, v in errs.items()})
        say("segmented", part="b_precond", host_s=f"{t_h:.4f}",
            device_s=f"{t_d:.4f}", first_pivot_differing=first,
            lk_err_before_it=f"{lk_err:.3e}", mean_cg_iters_host=its["host"],
            mean_cg_iters_device=its["device"])
        gate(max(errs.values()) <= 1e-3, f"segmented posterior off the "
             f"one-call or the float64 posterior by more than 1e-3: {errs}")
        gate(lk_err <= 1e-4, "host and device Lk differ by more than 1e-4 "
             "where their pivots agree")
        gate(abs(its["host"] - its["device"])
             <= 0.1 * max(its["host"], its["device"]),
             f"host and device preconditioners' CG counts {its} differ by "
             "more than 10%")

    gates.path("b_segments_16384", part_b, launched=("cov_matvec",))
    torch.cuda.empty_cache()

    def part_c():
        """blocked chains: the batched density, one HMC and one NUTS
        transition, chain_block against one batch."""
        Xc, yc, _ = synthetic.sinusoid_1d(n=n_chain, noise_std=0.1, seed=0)
        gpc = cugp_tpu_torch.GP(kind="rbf", device=dev).condition(
            Xc, yc, params=kernels.init_params(d=1, lengthscale=0.8,
                                               noise_var=0.05))
        lp, _unravel, q0 = sampling.make_flat_logprob(gpc.params, gpc.X,
                                                      gpc.y)
        qs = sampling.init_chains(q0, torch.Generator().manual_seed(3),
                                  chains)
        evals, peaks = {}, {}
        for cb in (0, chain_block):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            evals[cb], t_eval = synced(lambda: hmc.blocked_chains(lp, cb)(qs))
            peaks[cb] = torch.cuda.max_memory_allocated() - base
            say("segmented", part="c_density", chains=chains, n=n_chain,
                chain_block=cb, eval_s=f"{t_eval:.4f}",
                peak_bytes=peaks[cb])
        (lp0, g0), (lp1, g1) = evals[0], evals[chain_block]
        rel_lp = float(((lp1 - lp0).abs() / lp0.abs()).max())
        rel_g = float((g1 - g0).abs().max() / g0.abs().max())
        say("segmented", part="c_density", logp_rel=f"{rel_lp:.3e}",
            grad_rel_to_max=f"{rel_g:.3e}")
        gate(rel_lp <= 1e-5 and rel_g <= 1e-4, "blocked density off one "
             "batch by more than 1e-5 (logp) / 1e-4 (gradient)")
        gate(peaks[chain_block] < peaks[0], "blocked evaluation's peak "
             "memory is not below one batch's")
        state = hmc.HMCState(qs, lp0, g0)
        inv_mass = torch.ones(qs.shape[1], device=dev)
        lpg64 = _rbf_logprob64(torch, Xc, yc, dev)

        def pair(name, start, kern_of, eps, rng_of):
            outs = []
            for cb in (0, chain_block):
                kern = kern_of(cb)
                out, t_tr = synced(lambda: kern(
                    start, rng_of(cb), torch.tensor(eps, device=dev),
                    inv_mass))
                outs.append(out)
                say("segmented", part=f"c_{name}", eps=eps,
                    chains=start.q.shape[0], chain_block=cb,
                    transition_s=f"{t_tr:.4f}")
            (s0_, a0, _), (s1_, a1, _) = outs
            moved0, moved1 = ((s.q != start.q).any(dim=1)
                              for s in (s0_, s1_))
            say("segmented", part=f"c_{name}", eps=eps,
                moved_equal=bool(torch.equal(moved0, moved1)),
                accept_prob_maxdiff=f"{float((a1 - a0).abs().max()):.3e}",
                max_abs_dq=f"{float((s1_.q - s0_.q).abs().max()):.3e}",
                moved=int(moved1.sum()))
            gate(bool(torch.isfinite(s1_.q).all() & torch.isfinite(a1).all()),
                 f"blocked {name} transition not finite")
            return outs

        # HMC from one tape of draws, each evaluation kept for the
        # witness, at eps 0.005: at 0.05 every chain's |dH| was 0.86 or
        # more from these overdispersed starts (PERF.md section 6)
        eps = 0.005
        tape, calls = _tape(hmc, torch.Generator().manual_seed(5)), {}

        def kern_of(cb):
            calls[cb] = []
            return hmc.make_hmc_kernel(_recording(lp, calls[cb]), 8,
                                       chain_block=cb)

        outs = pair("hmc", state, kern_of, eps,
                    lambda cb: tape if cb == 0 else tape.replay())
        _hmc_witness(torch, hmc, gate, state, tape, eps, inv_mass, outs,
                     [_evaluations(torch, calls[cb], chains)
                      for cb in (0, chain_block)], lpg64)
        # NUTS on the first nuts_chains chains (cut from 256: time)
        k = nuts_chains
        pair("nuts", hmc.HMCState(qs[:k], lp0[:k], g0[:k]),
             lambda cb: nuts.make_nuts_kernel(lp, 4, cb), 0.05,
             lambda cb: hmc.Draws(torch.Generator().manual_seed(5)))

    gates.path("c_blocked_chains", part_c, launched=("cov", "potrf", "trsm"))
    torch.cuda.empty_cache()

    def part_d():
        """the rank-Q LMC posterior with segment_iters 16 against 0."""
        init_c = lmc.init_lmcq_params(d=2, p=2, kinds=LMCQ_KINDS,
                                      lengthscale=1.2, noise_var=0.05,
                                      seed=0, device=dev)
        Xl, Yl = _bench_lmcq_data(n_lmc, 2, 2, seed=0)
        model = cugp_tpu_torch.MultiOutputGPQ(kinds=LMCQ_KINDS, device=dev)
        model.condition(Xl, Yl, params=init_c)
        Xsl = Xl[:32] + 0.05
        out, st = {}, {}
        for k in (0, seg):
            st[k] = {}
            out[k], t_k = synced(lambda: model.predict_iterative(
                Xsl, tol=1e-6, max_iters=LMCQ_MAX_ITERS, segment_iters=k,
                stats=st[k]))
            say("segmented", part="d_lmcq", n=n_lmc, segment_iters=k,
                seconds=f"{t_k:.4f}", mean_iters=st[k]["mean_iters"],
                var_iters=",".join(map(str, st[k]["var_iters"])))
        err_mu = float((out[seg][0] - out[0][0]).abs().max())
        err_var = float((out[seg][1] - out[0][1]).abs().max())
        say("segmented", part="d_lmcq", err_mu=f"{err_mu:.3e}",
            err_var=f"{err_var:.3e}")
        gate(err_mu <= 1e-3 and err_var <= 1e-3, "segmented rank-Q LMC "
             "posterior off the unsegmented one by more than 1e-3")

    gates.path("d_lmcq_segmented", part_d, launched=("cov", "cov_matvec"))

    def part_e():
        """the CLI's --fit.segment_iters and --sample.chain_block."""
        def verb(*argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main([argv[0], f"--device={dev.type}", *argv[1:]])
            objs = _json_objects(buf.getvalue())
            return rc, objs

        def finite(tree):
            if isinstance(tree, dict):
                return all(finite(v) for v in tree.values())
            if isinstance(tree, list):
                return all(finite(v) for v in tree)
            return bool(np.isfinite(tree))

        for part, argv in (
                ("e_cli_fit", ["fit", "--fit.engine=iterative",
                               "--data.dataset=multidim", f"--data.n={n_cli}",
                               "--data.d=4", "--fit.steps=2",
                               f"--fit.segment_iters={seg}"]),
                ("e_cli_sample", ["sample", "--data.n=512",
                                  f"--sample.num_chains={cli_chains}",
                                  "--sample.num_warmup=2",
                                  "--sample.num_samples=2",
                                  "--sample.sampler=hmc",
                                  f"--sample.chain_block={chain_block}"])):
            (rc, objs), wall = synced(lambda: verb(*argv))
            o = objs[0] if objs else {}
            if "posterior" in o:  # 2 draws: R-hat has no spread to read
                shown = {"accept_rate": o["accept_rate"],
                         "r_hat": {k: v["r_hat"]
                                   for k, v in o["posterior"].items()}}
                checked = {k: [v["mean"], v["std"]]
                           for k, v in o["posterior"].items()}
            else:
                shown = {k: o.get(k) for k in ("cg_iters_last", "lml")}
                checked = o
            say("segmented", part=part, rc=rc, wall_s=f"{wall:.3f}",
                **{k: json.dumps(v) for k, v in shown.items()})
            gate(rc == 0 and bool(objs) and finite(checked),
                 f"{part}: rc {rc} or a non-finite number")
            if "cg_iters_last" in o:
                gate(o["cg_iters_last"] % seg == 0,
                     f"{part}: cg_iters_last not a multiple of {seg}")

    gates.path("e_cli", part_e, launched=("cov", "potrf", "trsm",
                                          "cov_matvec"))

    def part_f():
        """rtt_overhead and timed_loop of the 8000^2 covariance build."""
        rng = np.random.default_rng(5)
        X1 = torch.as_tensor(rng.uniform(-2, 2, (8000, 4)),
                             dtype=torch.float32, device=dev)
        s = torch.tensor([1.3, 0.1, 1.0], dtype=torch.float32, device=dev)

        def step(c):
            return c[0], cov_cuda.cov_tile(c[0], c[0], s, "rbf", True, 8000,
                                           8000)

        rtt = profiling.rtt_overhead()
        loop_s = profiling.timed_loop(step, step((X1, None)), iters=10)
        ev_ms = cuda_ms(lambda: step((X1, None)), iters=10, reps=5)
        p2 = ((results or {}).get("cov", {}).get("by_shape", {})
              .get("8000x8000 d=4", {}).get("ms"))
        say("segmented", part="f_timers", rtt_overhead_ms=f"{rtt * 1e3:.4f}",
            timed_loop_ms=f"{loop_s * 1e3:.4f}", cuda_event_ms=f"{ev_ms:.4f}",
            phase2_ms="not run" if p2 is None else f"{p2:.4f}")
        gate(rtt > 0 and loop_s > 0, "the timers returned no time")

    gates.path("f_timers", part_f, launched=("cov",))
    launches = {k: sum(p[k] for p in gates.paths.values())
                for k in _wrappers()}
    say("segmented", phase_s=f"{time.perf_counter() - t_phase:.3f}",
        launches=json.dumps(launches, separators=(",", ":")))
    gates.finish("segmented phase")
    return launches


def profile_device(torch, tag, fn, timed_s=None):
    """fn() under torch.profiler: device time by kernel, and the host
    wall around it (its idle share is 1 - busy / wall). timed_s: the wall
    of the same work timed without the profiler (whose tracing slows the
    host), printed with the idle share against it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    timed = {} if timed_s is None else dict(
        timed_s=f"{timed_s:.4f}",
        idle_share_vs_timed=f"{1.0 - busy / timed_s:.4f}")
    say(tag, wall_s=f"{wall:.4f}", device_busy_s=f"{busy:.4f}",
        idle_share=f"{1.0 - busy / wall:.4f}", kernels=len(rows), **timed)
    ours = ("cov_matvec", "cov_tile", "cov_prep", "potrf_kernel",
            "trsm_trtri", "trsm_narrow", "trsm_wide")
    for i, e in enumerate(rows):
        if i < 12 or any(k in e.key for k in ours):
            say(tag, kernel=repr(e.key[:60]), calls=e.count,
                device_ms=f"{e.self_device_time_total / 1e3:.3f}")


KERNELS = {
    "cov": ("cugp_tpu_torch/csrc/cov.cu", "cugp_tpu/ops/cov_pallas.py:48"),
    "potrf": ("cugp_tpu_torch/csrc/potrf.cu",
              "cugp_tpu/ops/chol_pallas.py:91"),
    "trsm": ("cugp_tpu_torch/csrc/trsm.cu",
             "cugp_tpu/ops/trsm_pallas.py:35"),
    "cov_matvec": ("cugp_tpu_torch/csrc/cov_matvec.cu",
                   "cugp_tpu/ops/cov_pallas.py:277"),
}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    try:
        import cugp_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import cugp_tpu_torch beside this script: {e}")
    opts = dict(a.split("=", 1) if "=" in a else (a, "1") for a in argv)
    phases = {int(v) for v in
              opts.get("--phases", ",".join(map(str, range(14)))).split(",")}
    dev = torch.device("cuda", 0)
    prof = "--profile" in opts
    walls = {}

    def run(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[phase] = round(time.perf_counter() - t0, 3)
        say("timing", of_phase=phase, wall_s=f"{walls[phase]:.3f}")
        return out

    run(0, phase_device, torch)
    run(1, phase_build)
    results, paths = {}, {}

    def kernels_alone():
        phase_cov(torch, dev, results)
        phase_potrf(torch, dev, results)
        phase_trsm(torch, dev, results, profile=prof)
        phase_cov_matvec(torch, dev, results)
        phase_batched(torch, dev, results)
        phase_batched_matvec(torch, dev, results)

    if 2 in phases:
        run(2, kernels_alone)
    if 3 in phases:
        paths["dense"] = run(3, phase_main, torch, dev, profile=prof)
    if 4 in phases:
        run(4, phase_north_star, torch, dev, profile=prof)
    if 5 in phases:
        paths["matrix_free"] = run(5, phase_matrix_free, torch, dev,
                                   profile=prof)
    if 6 in phases:
        paths["dense_api"] = run(6, phase_dense_api, torch, dev,
                                 profile=prof)
    if 7 in phases:
        paths["samplers"] = run(7, phase_samplers, torch, dev, profile=prof)
    if 8 in phases:
        paths["iterative_samplers"] = run(8, phase_iterative_sampling, torch,
                                          dev, profile=prof)
    if 9 in phases:
        paths.update(run(9, phase_sparse_classification, torch, dev,
                         profile=prof))
    if 10 in phases:
        paths.update(run(10, phase_lmc, torch, dev, profile=prof))
        torch.cuda.empty_cache()
    if 11 in phases:
        paths.update(run(11, phase_cli, torch, dev))
    if 12 in phases:
        torch.cuda.empty_cache()
        paths["distributed"] = run(12, phase_distributed, torch, dev)
    if 13 in phases:
        torch.cuda.empty_cache()
        paths["segmented_and_blocked"] = run(13, phase_segmented, torch, dev,
                                             results=results)
    say("timing", walls=json.dumps(walls, separators=(",", ":")),
        total_s=f"{sum(walls.values()):.3f}")
    if phases != set(range(14)):
        say("done", phases=sorted(phases), note="partial run, no result")
        return 0
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {k: p[name] for k, p in paths.items()},
         **results[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
