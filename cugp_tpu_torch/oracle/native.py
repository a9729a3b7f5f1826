"""ctypes bindings for the repository's C++ float64 GP baselines, as
``cugp_tpu/oracle/native.py``.

``native/gp_serial.cpp`` (serial) and ``native/gp_parallel.cpp``
(OpenMP) are compiled with ``g++`` and the flags of ``native/Makefile``
at first use, into ``cugp_tpu_torch/_build/`` (the sources stay as they
are). A library's name carries a hash of its source and flags, so an
edit rebuilds; each build writes a temporary file and renames it into
place, so processes building at once do not collide. ``available()``
and ``parallel_available()`` are the feature gates.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = _REPO / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

KIND_IDS = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3}

_libs = {}


def _build(source, extra_flags):
    """The shared library of native/<source>, compiled if missing."""
    src = NATIVE_DIR / source
    flags = CXXFLAGS + extra_flags
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    so = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *flags, "-shared", "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _load():
    if "serial" in _libs:
        return _libs["serial"]
    lib = ctypes.CDLL(str(_build("gp_serial.cpp", [])))
    dptr = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    dbl = ctypes.c_double

    lib.gp_covariance.argtypes = [dptr, i64, i64, dptr, dbl, dbl, dbl, i32,
                                  dptr]
    lib.gp_covariance.restype = None
    lib.gp_cross_covariance.argtypes = [dptr, i64, dptr, i64, i64, dptr, dbl,
                                        i32, dptr]
    lib.gp_cross_covariance.restype = None
    lib.gp_cholesky.argtypes = [dptr, i64]
    lib.gp_cholesky.restype = i64
    lib.gp_lml.argtypes = [dptr, dptr, i64, i64, dptr, dbl, dbl, dbl, i32,
                           dptr, dptr, ctypes.POINTER(i64)]
    lib.gp_lml.restype = dbl
    lib.gp_posterior.argtypes = [dptr, dptr, i64, i64, dptr, i64, dptr, dbl,
                                 dbl, dbl, i32, dptr, dptr]
    lib.gp_posterior.restype = None
    _libs["serial"] = lib
    return lib


def available():
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _prep(params, d):
    """(the d lengthscales, a scalar one broadcast; log sf2; log sn2):
    the C code reads d lengthscales."""
    ell = np.atleast_1d(np.asarray(params["log_lengthscale"], np.float64))
    if ell.shape[0] not in (1, d):
        raise ValueError(f"log_lengthscale has {ell.shape[0]} entries for "
                         f"d={d}")
    ell = np.ascontiguousarray(np.broadcast_to(ell, (d,)))
    sf2 = float(np.asarray(params["log_signal_var"]))
    sn2 = float(np.asarray(params["log_noise_var"]))
    return ell, sf2, sn2


def _xy(X, y=None):
    X = np.ascontiguousarray(X, np.float64)
    if X.ndim != 2:
        raise ValueError(f"X must be (n, d), got shape {X.shape}")
    if y is None:
        return X, None
    y = np.ascontiguousarray(y, np.float64)
    if y.shape != (X.shape[0],):
        raise ValueError(f"y must be ({X.shape[0]},), got {y.shape}")
    return X, y


def train_covariance(params, X, kind="rbf", jitter=1e-6):
    lib = _load()
    X, _ = _xy(X)
    n, d = X.shape
    ell, sf2, sn2 = _prep(params, d)
    out = np.empty((n, n), np.float64)
    lib.gp_covariance(_ptr(X), n, d, _ptr(ell), sf2, sn2, jitter,
                      KIND_IDS[kind], _ptr(out))
    return out


def cholesky(a):
    lib = _load()
    a = np.ascontiguousarray(a, np.float64).copy()
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"need a square matrix, got shape {a.shape}")
    status = lib.gp_cholesky(_ptr(a), a.shape[0])
    if status != 0:
        raise np.linalg.LinAlgError(f"not PD at column {status - 1}")
    return a


def log_marginal_likelihood(params, X, y, kind="rbf", jitter=1e-6):
    lib = _load()
    X, y = _xy(X, y)
    n, d = X.shape
    ell, sf2, sn2 = _prep(params, d)
    alpha = np.empty(n, np.float64)
    status = ctypes.c_int64(0)
    val = lib.gp_lml(_ptr(X), _ptr(y), n, d, _ptr(ell), sf2, sn2, jitter,
                     KIND_IDS[kind], _ptr(alpha), None,
                     ctypes.byref(status))
    if status.value != 0:
        raise np.linalg.LinAlgError(f"not PD at column {status.value - 1}")
    return float(val)


# ---- OpenMP-threaded baseline (native/gp_parallel.cpp): the same
# pipeline behind the gpp_* C ABI.

def _load_parallel():
    if "parallel" in _libs:
        return _libs["parallel"]
    lib = ctypes.CDLL(str(_build("gp_parallel.cpp", ["-fopenmp"])))
    dptr = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    dbl = ctypes.c_double
    lib.gpp_num_threads.argtypes = []
    lib.gpp_num_threads.restype = i32
    lib.gpp_covariance.argtypes = [dptr, i64, i64, dptr, dbl, dbl, dbl, i32,
                                   dptr]
    lib.gpp_covariance.restype = None
    lib.gpp_cholesky.argtypes = [dptr, i64]
    lib.gpp_cholesky.restype = i64
    lib.gpp_lml.argtypes = [dptr, dptr, i64, i64, dptr, dbl, dbl, dbl, i32,
                            dptr, dptr, ctypes.POINTER(i64)]
    lib.gpp_lml.restype = dbl
    _libs["parallel"] = lib
    return lib


def parallel_available():
    try:
        _load_parallel()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def num_threads():
    return int(_load_parallel().gpp_num_threads())


def log_marginal_likelihood_parallel(params, X, y, kind="rbf", jitter=1e-6):
    """Threaded-CPU LML (OpenMP over covariance rows + Cholesky panels)."""
    lib = _load_parallel()
    X, y = _xy(X, y)
    n, d = X.shape
    ell, sf2, sn2 = _prep(params, d)
    alpha = np.empty(n, np.float64)
    status = ctypes.c_int64(0)
    val = lib.gpp_lml(_ptr(X), _ptr(y), n, d, _ptr(ell), sf2, sn2, jitter,
                      KIND_IDS[kind], _ptr(alpha), None,
                      ctypes.byref(status))
    if status.value != 0:
        raise np.linalg.LinAlgError(f"not PD at column {status.value - 1}")
    return float(val)


def posterior(params, X, y, Xs, kind="rbf", jitter=1e-6):
    lib = _load()
    X, y = _xy(X, y)
    Xs, _ = _xy(Xs)
    n, d = X.shape
    if Xs.shape[1] != d:
        raise ValueError(f"Xs has {Xs.shape[1]} features, X has {d}")
    ns = Xs.shape[0]
    ell, sf2, sn2 = _prep(params, d)
    mu = np.empty(ns, np.float64)
    var = np.empty(ns, np.float64)
    lib.gp_posterior(_ptr(X), _ptr(y), n, d, _ptr(Xs), ns, _ptr(ell), sf2,
                     sn2, jitter, KIND_IDS[kind], _ptr(mu), _ptr(var))
    return mu, var
