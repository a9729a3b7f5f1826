"""Typed config and dotted-flag overrides, as ``cugp_tpu/utils/config.py``.

A copy of the JAX package's module (it imports no jax, but the JAX
package's ``__init__`` does, so the port keeps its own): dataclass
configs with dotted-path CLI overrides (``--model.kind=matern32``)
covering the config ladder of BASELINE.json:7-11. The fields and
defaults are the JAX package's, so one argv gives the same config in
both CLIs; ``MeshConfig`` waits for the distributed tier.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    kind: str = "rbf"   # rbf | matern12 | matern32 | matern52 | rq | periodic | linear
    jitter: float = 1e-6
    method: str = "auto"         # auto | xla | blocked | pallas (the
                                 # port runs xla/blocked as auto)
    basis: str = ""              # "" (zero mean) | constant | linear
    normalize_y: bool = False    # standardize targets inside the GP facade
    inference: str = "laplace"   # classify: laplace | ep (binary only)
    lengthscale: float = 1.0
    signal_var: float = 1.0
    noise_var: float = 0.1


@dataclasses.dataclass
class DataConfig:
    dataset: str = "sinusoid"    # sinusoid | multidim | gp_draw | npz file
    n: int = 1024
    d: int = 1
    noise_std: float = 0.1
    seed: int = 0
    path: Optional[str] = None   # for dataset="npz": file with X, y arrays
    num_classes: int = 2         # classify: >=3 routes to softmax Laplace


@dataclasses.dataclass
class FitConfig:
    steps: int = 200
    optimizer: str = "adam"      # adam | lbfgs
    learning_rate: float = 0.05
    objective: str = "lml"       # lml | loo (GPML 5.4.2 pseudo-likelihood)
    restarts: int = 1            # >1: vmapped multi-start sweep, best wins
    engine: str = "dense"        # dense | iterative (matrix-free BBMM
                                 # training loop for n beyond the dense
                                 # Cholesky ceiling; map_opt.fit_iterative)
    # iterative-engine knobs (ignored for engine=dense)
    precond_rank: int = 128      # pivoted-Cholesky preconditioner rank
    precond_refresh: int = 0     # steps between preconditioner rebuilds;
                                 # 0 = adaptive (rebuild when CG
                                 # iterations grow 1.5x past the best
                                 # since the last build)
    num_probes: int = 16         # Hutchinson probes per gradient step
    cg_tol: float = 1e-4
    cg_max_iters: int = 400
    block: int = 4096            # matvec row-block size
    segment_iters: int = -1      # CG iterations a segment (one host
                                 # read each); 0 = one tolerance loop a
                                 # solve, -1 = auto (0 off a TPU)
    probe_mode: str = "fresh"    # fresh | frozen (frozen enables full
                                 # warm-starting across steps)


@dataclasses.dataclass
class SampleConfig:
    sampler: str = "nuts"        # nuts | hmc
    num_samples: int = 512
    num_warmup: int = 256
    num_chains: int = 8
    max_tree_depth: int = 8
    chain_block: int = 0         # >0: the log density evaluated that
                                 # many chains at a time (bounds the
                                 # batch's memory); adaptation pools all
    seed: int = 0
    checkpoint_every: int = 64   # draws per checkpoint segment (with
                                 # --checkpoint_dir on the sample command)
    engine: str = "dense"        # dense | iterative (matrix-free LML per
                                 # transition — hyperparameter posteriors
                                 # beyond the dense ceiling)
    num_probes: int = 16         # iterative engine: SLQ/Hutchinson probes
    precond_rank: int = 0        # iterative engine: CG preconditioner rank


@dataclasses.dataclass
class SvgpConfig:
    num_inducing: int = 256
    likelihood: str = "gaussian"  # gaussian | bernoulli | poisson | student_t
    batch: int = 256
    optimize_inducing: bool = True


@dataclasses.dataclass
class MeshConfig:
    n_devices: int = 0           # 0 = all visible devices
    dp: int = 1                  # data-parallel (chains) axis size
    block: int = 512             # block-cyclic Cholesky block size


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    fit: FitConfig = dataclasses.field(default_factory=FitConfig)
    sample: SampleConfig = dataclasses.field(default_factory=SampleConfig)
    svgp: SvgpConfig = dataclasses.field(default_factory=SvgpConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0    # 0 = disabled
    metrics_file: Optional[str] = None  # JSON-lines per-step metrics


def _set_dotted(cfg, path, value):
    parts = path.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not dataclasses.is_dataclass(obj) or not hasattr(obj, p):
            raise KeyError(f"unknown config field: {path}")
        obj = getattr(obj, p)
    field = parts[-1]
    if not dataclasses.is_dataclass(obj) or not hasattr(obj, field):
        raise KeyError(f"unknown config field: {path}")
    cur = getattr(obj, field)
    if cur is None:
        setattr(obj, field, value)
    elif isinstance(cur, bool):
        setattr(obj, field, value.lower() in ("1", "true", "yes"))
    else:
        setattr(obj, field, type(cur)(value))


def parse_overrides(argv, cfg=None):
    """Apply ``--a.b=c`` style overrides to a Config. Returns (cfg, rest)."""
    cfg = cfg or Config()
    rest = []
    for arg in argv:
        if arg.startswith("--") and "=" in arg:
            path, value = arg[2:].split("=", 1)
            _set_dotted(cfg, path, value)
        else:
            rest.append(arg)
    return cfg, rest


def to_json(cfg):
    return json.dumps(dataclasses.asdict(cfg), indent=2)
