"""Run one cell of the benchmark of ``cugp_tpu_torch`` once.

    python3 portbench/run.py --workload kin40k.fit --seed 7 --seconds 10 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up makes the inputs from the seed and warms up every shape the
cell uses; the window then runs the cell's operations for --seconds;
the last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with --trace 1 also
``breakdown``, and ``checks``: each number compared with its limit),
and the last lines of standard error are the same numbers. Without a
CUDA card, or without the program beside this folder, it exits 2 and
prints no result; if the process has loaded JAX or the JAX package, it
exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

_T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402  (standard library only)

_AGE0 = harness.process_age()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    manifest = harness.load_manifest()
    cell, _, _ = harness.find_cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; no result",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"torch sees {torch.cuda.device_count()}; no result",
              file=sys.stderr)
        return 2
    try:
        import cugp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: cannot import the program beside this folder "
              f"({e}); no result", file=sys.stderr)
        return 2
    t_start = _T0 - (_AGE0 or 0.0)
    code, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), device="cuda",
                               t_start=t_start)
    return code


if __name__ == "__main__":
    sys.exit(main())
