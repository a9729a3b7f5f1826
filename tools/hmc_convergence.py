"""Split R-hat of the JAX package's HMC and of the port's, at BASELINE
config 3's shape (n may be cut).

Config 3 is benchmarks/bench_hmc.py's: sinusoid_1d(n, noise_std=0.1,
seed=0), rbf, init lengthscale 0.8 and noise 0.05, 256 chains, 32
leapfrog steps, 64 warm-up transitions and 64 draws. The samplers:

  jax         cugp_tpu's warmup_adapt and sample_segment (one step size
              for every chain), keyed and started as bench_hmc.py's
              first batch (CPU);
  port_fixed  the port's drivers with the JAX package's kernel
              (make_hmc_kernel with step_jitter 0);
  port        the port's sampler as it ships: each chain's step size
              drawn per transition (hmc.STEP_JITTER).

With --draws=jax (the default) the port's samplers start where JAX's do
and port_fixed replays JAX's own draws (so far as fp32 lets two
implementations follow one another: the GP gradient's rounding parts
them after a few transitions, and then only the statistics compare).
With --draws=torch nothing imports JAX: the chains start from the
port's init_chains and every draw comes from a torch.Generator, so it
runs where JAX is not installed, on the card with --device=cuda.

Prints a JSON line for each sampler: split R-hat and ESS per
hyperparameter (the port's potential_scale_reduction and
effective_sample_size, in float64), the accept rate, the step size, the
chains that never moved in the draws, the mean lag-1 autocorrelation of
the chains that moved, and the wall time (on the card, after the card's
name and power limit).

    python tools/hmc_convergence.py --n=128
    python3 tools/hmc_convergence.py --n=512 --draws=torch --device=cuda \
        --samplers=port_fixed,port
Options: --chains=256 --warmup=64 --samples=64 --leapfrog=32
--samplers=jax,port_fixed,port --threads=4 --seed=0 (the torch draws
come from a generator seeded seed, the torch start from seed + 1).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cugp_tpu_torch.data import synthetic  # noqa: E402
from cugp_tpu_torch.inference import hmc, sampling  # noqa: E402
from cugp_tpu_torch.ops import kernels  # noqa: E402

NAMES = ("lengthscale", "noise", "signal")  # jax's sorted flat order


def jax_start(X, y, chains):
    """bench_hmc.py's first batch: the JAX log density, its chain start
    and its keys (k1, k2, k3 for the warm-up windows, k_draw)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cugp_tpu.inference import sampling as jsampling
    from cugp_tpu.ops import kernels as jkops

    init = jkops.init_params(d=1, lengthscale=0.8, noise_var=0.05)
    lp_j, _, q0 = jsampling.make_flat_logprob(init, jnp.asarray(X),
                                              jnp.asarray(y), kind="rbf")
    kb = jax.random.fold_in(jax.random.key(1000), 0)
    k_init, k1, k2, k3, k_draw = jax.random.split(kb, 5)
    qs0 = np.array(jsampling.init_chains(q0, k_init, chains))
    return lp_j, qs0, (k1, k2, k3), k_draw


def run_jax(lp_j, qs0, keys3, k_draw, warmup, samples, n_lf):
    import jax

    from cugp_tpu.inference import hmc as jhmc

    kernel = jhmc.make_hmc_kernel(lp_j, n_lf)
    warm = jax.jit(jhmc.warmup_adapt, static_argnames=(
        "kernel", "num_warmup", "target_accept"))
    seg = jax.jit(jhmc.sample_segment,
                  static_argnames=("kernel", "num_draws"))
    state = jhmc.HMCState(qs0, *jax.vmap(lp_j)(qs0))
    state, eps, inv_mass = warm(state, keys3, kernel, warmup, 0.1, 0.8)
    _, qs, aprobs, _ = seg(state, k_draw, kernel, eps, inv_mass, samples)
    return np.array(qs), np.array(aprobs), float(eps)


def replayed_draws(windows, n_chains, dim):
    """JAX's driver draws in the port's order: each (key, transitions)
    window split into a key a transition, each into a key a chain, each
    into the momentum and accept keys."""
    import jax

    def chain(k):
        k_mom, k_acc = jax.random.split(k)
        return jax.random.normal(k_mom, (dim,)), jax.random.uniform(k_acc)

    normals, uniforms = [], []
    for k, steps in windows:
        for ks in jax.random.split(k, steps):
            mom, uni = jax.vmap(chain)(jax.random.split(ks, n_chains))
            normals.append(np.array(mom))
            uniforms.append(np.array(uni))
    return hmc.Draws(normals=normals, uniforms=uniforms)


def summary(name, qs, aprobs, eps, wall):
    qs = torch.as_tensor(qs, dtype=torch.float64).cpu()  # (S, C, D)
    moved = (qs != qs[:1]).any(dim=0).any(dim=-1)
    xc = qs - qs.mean(dim=0, keepdim=True)
    lag1 = (xc[1:] * xc[:-1]).mean(dim=0) / (xc * xc).mean(dim=0).clamp(
        min=1e-300)
    out = {"sampler": name, "accept_rate": float(np.mean(aprobs)),
           "eps": eps, "chains_never_moved": int((~moved).sum()),
           "wall_s": wall}
    for j, nm in enumerate(NAMES):
        out[f"rhat_{nm}"] = float(sampling.potential_scale_reduction(
            qs[..., j]))
        out[f"ess_{nm}"] = float(sampling.effective_sample_size(qs[..., j]))
        out[f"lag1_{nm}"] = float(lag1[moved, j].mean())
    print(json.dumps(out), flush=True)


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    n = int(args.get("--n", 128))
    chains = int(args.get("--chains", 256))
    warmup = int(args.get("--warmup", 64))
    samples = int(args.get("--samples", 64))
    n_lf = int(args.get("--leapfrog", 32))
    samplers = args.get("--samplers", "jax,port_fixed,port").split(",")
    use_jax = args.get("--draws", "jax") == "jax"
    dev = torch.device(args.get("--device", "cpu"))
    seed = int(args.get("--seed", 0))
    torch.set_num_threads(int(args.get("--threads", 4)))
    if "jax" in samplers and not use_jax:
        raise SystemExit("the jax sampler needs --draws=jax")

    if dev.type == "cuda":  # the card and its power limit
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    X, y, _ = synthetic.sinusoid_1d(n=n, noise_std=0.1, seed=0)
    X, y = X.astype(np.float32), y.astype(np.float32)
    print(json.dumps({"n": n, "chains": chains, "warmup": warmup,
                      "samples": samples, "leapfrog": n_lf,
                      "draws": "jax" if use_jax else "torch",
                      "device": str(dev),
                      "step_jitter": hmc.STEP_JITTER}), flush=True)
    init = kernels.init_params(d=1, lengthscale=0.8, noise_var=0.05,
                               device=dev)
    lp_t, _, q0 = sampling.make_flat_logprob(
        init, torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev),
        kind="rbf")
    if use_jax:
        lp_j, qs0, keys3, k_draw = jax_start(X, y, chains)
        qs0 = torch.from_numpy(qs0).to(dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        qs0 = sampling.init_chains(q0, gen, chains)

    if "jax" in samplers:
        t0 = time.perf_counter()
        qs, aprobs, eps = run_jax(lp_j, qs0.cpu().numpy(), keys3, k_draw,
                                  warmup, samples, n_lf)
        summary("jax", qs, aprobs, eps, time.perf_counter() - t0)

    w1 = w3 = max(warmup // 4, 1)
    w2 = max(warmup - w1 - w3, 1)
    for name in ("port_fixed", "port"):
        if name not in samplers:
            continue
        if use_jax and name == "port_fixed":
            draws = replayed_draws([(keys3[0], w1), (keys3[1], w2),
                                    (keys3[2], w3), (k_draw, samples)],
                                   chains, qs0.shape[1])
        else:
            draws = torch.Generator(device=dev).manual_seed(seed)
        kernel = hmc.make_hmc_kernel(
            lp_t, n_lf, step_jitter=0.0 if name == "port_fixed"
            else hmc.STEP_JITTER)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hmc.adaptive_run(hmc.init_state(qs0, lp_t), draws, kernel,
                               warmup, samples, 0.1, 0.8)
        qs = out["samples_flat"].cpu()
        summary(name, qs, out["aux"].cpu().numpy(), float(out["eps"]),
                time.perf_counter() - t0)


if __name__ == "__main__":
    main()
