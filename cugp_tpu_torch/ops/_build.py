"""Build and load the hand-written CUDA kernels under ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (one process a source, all started
together) and links them into one shared library with a plain C
interface, at first use, into ``cugp_tpu_torch/_build/``. The file name
carries a hash of the sources and flags, so an edit rebuilds.
ptxas's resource report (registers, shared memory, spills) is kept
beside the library. The library is loaded with ``ctypes``; pointers and
the stream travel as ``c_void_p``. Nothing here runs at import, so
machines without ``nvcc`` import every module; a failed build raises
with nvcc's stderr.

Each kernel's Python wrapper keeps a plain int ``LAUNCHES`` that it bumps
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of csrc/*.cu (every launcher returns its cudaError_t)
_SIGNATURES = {
    # x1, x2, scal, out, scratch, m, n, d, ldo, kind, square, n1_true,
    # n2_true, batch, x1_stride, x2_stride, out_stride, stream
    "cugp_cov": [_p, _p, _p, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _i,
                 _ll, _ll, _ll, _p],
    # m, n, d: floats of the scratch cugp_cov takes an element (-1: too
    # many)
    "cugp_cov_scratch": [_i, _i, _i],
    # a, lda, batch_stride, n, batch, route (0 auto, 1 cooperative,
    # 2 batch), stream
    "cugp_potrf": [_p, _ll, _ll, _i, _i, _i, _p],
    # n, out: the grid the cooperative route launches for an (n, n) block
    "cugp_potrf_grid": [_i, ctypes.POINTER(_i)],
    # batch, out: the route cugp_potrf takes when asked for auto
    "cugp_potrf_route": [_i, ctypes.POINTER(_i)],
    # l, ldl, b, row_stride, col_stride, n, k, transpose, scratch, batch,
    # l_batch_stride, b_batch_stride, stream
    "cugp_trsm": [_p, _ll, _p, _ll, _ll, _i, _i, _i, _p, _i, _ll, _ll, _p],
    # n: floats of the scratch cugp_trsm takes for one (n, n) L
    "cugp_trsm_scratch": [_i],
    # x, v, scal, out, scratch, n, d, r, batch, x_batch_stride,
    # v_batch_stride, v_row_stride, v_col_stride, out_batch_stride, ldo,
    # kind, stream
    "cugp_cov_matvec": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll,
                        _ll, _ll, _ll, _i, _p],
    # n, d, r: floats of the scratch cugp_cov_matvec takes an element (-1:
    # too many)
    "cugp_cov_matvec_scratch": [_i, _i, _i],
    # r: V columns a CTA holds (<= 32: the narrow route; 128: the wide one)
    "cugp_cov_matvec_width": [_i],
}

_lib = None


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path():
    """Where the library for the current sources lives (built or not)."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libcugp_{h.hexdigest()[:16]}.so"


def ptxas_report():
    """ptxas's per-kernel report of the built library, by source name."""
    path = library_path().with_suffix(".ptxas.txt")
    if not path.exists():
        return {}
    text = path.read_text()
    return {name: body.strip() for name, body in
            (part.split("\n", 1) for part in text.split("### ")[1:])}


def build():
    """Compile csrc/*.cu if this source hash has no library yet."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    cmds = [[nvcc_path(), *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            for cu, obj in zip(cus, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    try:
        for cmd, p, (_, err) in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    so.with_suffix(".ptxas.txt").write_text("".join(
        f"### {cu.name}\n{err}" for cu, (_, err) in zip(cus, outs)))
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.cugp_error_string.argtypes = [ctypes.c_int]
        handle.cugp_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err, name):
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib().cugp_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def stream_of(t):
    """PyTorch's current CUDA stream on t's device, as a pointer."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
