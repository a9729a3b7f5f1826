"""One run of one cell: set-up, the measured window, the metrics, the
check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``BENCHMARK.json`` names the cell's
configuration and traffic; ``configs/<config>.json`` holds the sizes,
``traffic/<mix>.json`` the mix and the ``driver`` that runs it
(``drivers/<driver>.py``), ``metrics/<metric>.py`` one reader each (or
one for a family of metrics, ``metrics/<family>.py``), and
``limits/<workload>.json`` the limit of each number the check compares.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run: JAX and the
# JAX package (compared whole: the port's name begins with the latter's)
BANNED = ("jax", "jaxlib", "flax", "cugp_tpu")


def banned_modules(modules=None):
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(tops.intersection(BANNED))


def load_manifest(root=ROOT):
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(manifest, workload):
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = _json(ROOT / configs[cell["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def load_driver(traffic):
    name = traffic["driver"]
    mod = _load(HERE / "drivers" / f"{name}.py", f"portbench_driver_{name}")
    return mod.Driver


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def metric_reader(name):
    """``metrics/<name>.py``, or else the reader of the metric's family,
    ``metrics/<name up to its first dot>.py`` (``mfu.py`` reads ``mfu.fit``
    and ``mfu.predict``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    return _load(path, "portbench_metric_" + path.stem.replace(".", "_"))


def read_metric(name, run):
    return metric_reader(name).read(run)


class Run:
    """What the per-layer readers read: the window's length, the
    driver's tally and counters, the trace summary and the launches'
    shapes."""

    def __init__(self, tally, window_s, counters, summary, shapes):
        self.tally, self.window_s, self.counters = tally, window_s, counters
        self.trace, self.shapes = summary, shapes


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def process_age():
    """Seconds since this process started (from /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def run_cell(workload, seed, seconds, trace, *, device="cuda",
             overrides=None, t_start=None, out=None, err=None):
    """Run one cell once. Returns (exit code, the result dict or None).
    overrides: configuration keys replaced (the CPU tests' small sizes)."""
    import torch

    from portbench import compare, hooks
    from portbench.trace import summarize, traced_window

    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest()
    cell, cfg, traffic = find_cell(manifest, workload)
    cfg = {**cfg, **(overrides or {})}
    limits = compare.load_limits(workload)
    on_card = torch.device(device).type == "cuda"
    driver = load_driver(traffic)(cfg, traffic, seed, device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    driver.setup()
    sync()
    launches0 = hooks.launch_counts()
    shapes = hooks.LaunchShapes() if trace else None
    tally = {"ops": 0, "failed": 0, "flops": 0.0, "points": 0}
    with (shapes.active() if trace else contextlib.nullcontext()), \
            traced_window(trace, sync, on_card) as traced:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            r = driver.operation()
            for k in tally:
                tally[k] += r.get(k, 0)
            window_s = time.perf_counter() - t0
            # the window closes after --seconds, where the driver's mix is
            # whole (a serving cell: a whole cycle of its request sizes)
            if window_s >= seconds and getattr(driver, "mix_whole",
                                               lambda: True)():
                break
    launches = {k: v - launches0[k] for k, v in hooks.launch_counts().items()}
    summary = summarize(traced.prof) if traced.prof is not None else None
    run = Run(tally, window_s, driver.counters, summary, shapes)

    metrics = {}
    if not trace:
        values = {**driver.end_to_end(tally, window_s), "setup_s": setup_s}
        for m in manifest["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in manifest["per_layer"]:
            if applies(m, workload):
                v = read_metric(m["name"], run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": cell["chips"],
                "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                      if on_card else 0)}
    if trace:
        dev_info["busy_s"] = summary["busy_s"] if summary else 0.0
        dev_info["window_s"] = summary["window_s"] if summary else window_s
    ops = max(tally["ops"], 1)
    print(f"[portbench] workload={workload} seed={seed} ops={tally['ops']} "
          f"window_s={window_s!r} setup_s={setup_s!r} "
          f"memory_peak_bytes={dev_info['memory_peak_bytes']}", file=out)
    if on_card:
        print(f"[portbench] nvidia-smi: {nvidia_smi()}", file=out)
    if trace:
        print("[portbench] launches_per_op " + " ".join(
            f"{k}={v / ops!r}" for k, v in launches.items()), file=out)
        for k, v in driver.counters.items():
            print(f"[portbench] counter {k}={v}", file=out)
        if summary:
            print(f"[portbench] trace device_events="
                  f"{summary['device_events']}", file=out)
            for name, s in sorted(summary["by_op"].items(),
                                  key=lambda kv: -kv[1])[:40]:
                print(f"[portbench] device_op s={s!r} name={name[:160]}",
                      file=out)
    out.flush()

    driver.release()
    numbers = driver.check()
    if getattr(driver, "diag", None):
        print(f"[portbench] check diag {json.dumps(driver.diag)}", file=out)
    correct, rows = compare.verdict(numbers, limits)
    correct = correct and tally["failed"] == 0 and tally["ops"] > 0
    result = {"correct": correct, "attempted": tally["ops"],
              "failed": tally["failed"], "metrics": metrics,
              "device": dev_info}
    if trace and summary:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    # JSON has no infinity: a number that is not finite goes as null
    result["checks"] = {name: {"value": v if math.isfinite(v) else None,
                               "limit": lim}
                        for name, v, lim in rows}
    bad = banned_modules()
    if bad:
        print(f"portbench: the process loaded {bad} (JAX or the JAX "
              "package); no result", file=err, flush=True)
        return 3, None
    for name, v, lim in rows:
        flag = "ok" if math.isfinite(v) and v <= lim else "FAIL"
        print(f"check {name}={v!r} limit={lim!r} {flag}", file=err)
    err.flush()
    print(json.dumps(result, allow_nan=False), file=out, flush=True)
    return 0, result
