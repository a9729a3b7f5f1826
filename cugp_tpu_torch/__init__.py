"""cugp_tpu_torch — the exact-GP engine on PyTorch and CUDA (NVIDIA H100).

A port of ``cugp_tpu`` (the JAX/Pallas reference, which stays beside it):
the dense exact-GP path — covariance build, recursive blocked Cholesky,
triangular solves, LML and its gradient, MAP fit (Adam or L-BFGS, with
restarts, priors, the LOO or basis objectives) and posterior predict,
LOO, posterior draws, save/load — the matrix-free CG/SLQ tier for N
beyond the dense ceiling, hyperparameter HMC/NUTS/VI, the sparse (SGPR,
SVGP) and classification (Laplace, EP, multiclass) families, and the
LMC multi-output family (ICM, dense and matrix-free rank-Q). The
four Pallas kernels are CUDA C++ kernels for ``sm_90a`` under
``csrc/``, built with ``nvcc`` on first use (``ops/_build.py``). CPU
tensors take each kernel's plain PyTorch version.

This package imports ``torch``, numpy and scipy, never ``jax``.
"""

import torch as _torch

# The JAX kernels pin Precision.HIGHEST: covariance Cholesky fails (NaN)
# once fp32 operands are rounded to TF32's 10-bit mantissa, so every
# matmul here runs in true fp32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from cugp_tpu_torch.api import (GP, SVGP, GPClassifier,  # noqa: E402
                                MultiOutputGP, MultiOutputGPQ)
from cugp_tpu_torch.ops.kernels import (SUPPORTED_KERNELS,  # noqa: E402
                                        init_params)

__version__ = "0.1.0"

__all__ = ["GP", "GPClassifier", "SVGP", "MultiOutputGP", "MultiOutputGPQ",
           "init_params", "SUPPORTED_KERNELS", "__version__"]
