"""Readings for the limits of ``limits/<workload>.json``: the check's
numbers over many seeds in one process, for the program as it is, for
the control, and for planted faults. Not part of a benchmark run.

    python3 portbench/calibrate.py --workload kin40k.fit \
        --plan program:12,tf32:3,half_batch:3 --seed 1000

Each seed runs the cell's set-up (whose first steps the check follows)
and, for a serving cell, one cycle of its request sizes, then the
check. ``tf32`` is the control: the program with its GEMMs in TF32
(torch's ``allow_tf32``, the switch the program's own precision
policies turn on), the precision below the configuration's fp32 with
TF32 off. A fault name plants that fault (``faults.py``). One JSON line
is printed a seed: the mode, the seed and the numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def tf32():
    import torch

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def mode_context(mode, driver_name):
    from portbench import faults

    if mode == "program":
        return contextlib.nullcontext()
    if mode == "tf32":
        return tf32()
    return faults.planted(mode, driver_name)


def reading(workload, seed, mode, device="cuda", overrides=None,
            requests=None):
    """The check's numbers for one seed under `mode`; a serving cell
    serves `requests` requests (one cycle of its sizes by default)."""
    from portbench import driving, harness

    manifest = harness.load_manifest()
    _, cfg, traffic = harness.find_cell(manifest, workload)
    cfg = {**cfg, **(overrides or {})}
    driver = harness.load_driver(traffic)(cfg, traffic, seed, device)
    t0 = time.perf_counter()
    with mode_context(mode, traffic["driver"]):
        driver.setup()
        if "sizes_per_cycle" in traffic:
            for _ in range(requests or traffic["sizes_per_cycle"]):
                driver.operation()
        driving.sync(device)
    t1 = time.perf_counter()
    driver.release()
    numbers = driver.check()
    return {"workload": workload, "mode": mode, "seed": seed,
            "numbers": numbers, "program_s": t1 - t0,
            "check_s": time.perf_counter() - t1,
            "diag": getattr(driver, "diag", None)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plan", default="program:12,tf32:3")
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--requests", type=int, default=None,
                    help="requests a seed of a serving cell (as many as "
                         "a run serves)")
    args = ap.parse_args(argv)
    import torch

    import cugp_tpu_torch  # noqa: F401  (sets TF32 off)

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seed = args.seed
    for part in args.plan.split(","):
        mode, count = part.split(":")
        for _ in range(int(count)):
            row = reading(args.workload, seed, mode,
                          requests=args.requests)
            print(json.dumps(row), flush=True)
            seed += 1
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
