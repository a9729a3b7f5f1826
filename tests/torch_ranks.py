"""Run a test module's ``_worker`` as a group of gloo ranks on the CPU.

The distributed tier's tests start their ranks once per file: each rank
is a process of its own (``python -c``, so it imports torch and the test
module only, never jax), joins a gloo group through a FileStore under
the test's temporary directory, runs every case of its module and saves
what it found with ``torch.save``; the tests then read those results.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import torch

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)


class Ranks:
    """A running group of `world` rank processes of `module`."""

    def __init__(self, module, tmp, world=4, timeout=300):
        self.tmp = pathlib.Path(tmp)
        self.timeout = timeout
        self.started = time.monotonic()
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        code = ("import sys; sys.path.insert(0, {root!r}); "
                "import {module} as m; m._worker({rank}, {world}, {tmp!r})")
        self.procs = []
        for rank in range(world):
            log = open(self.tmp / f"rank{rank}.log", "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, "-c", code.format(
                    root=ROOT, module=module, rank=rank, world=world,
                    tmp=str(self.tmp))],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT),
                log))
        self._results = None

    def results(self):
        """Each rank's saved dict (waits for the ranks; raises with the
        logs if one failed or the group outlived its timeout)."""
        if self._results is None:
            try:
                for p, _ in self.procs:
                    left = self.timeout - (time.monotonic() - self.started)
                    p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                pass
            finally:
                for p, log in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    log.close()
            bad = [r for r, (p, _) in enumerate(self.procs) if p.returncode]
            if bad:
                logs = "\n".join(
                    f"--- rank {r} (rc {self.procs[r][0].returncode}) ---\n"
                    + (self.tmp / f"rank{r}.log").read_text()[-4000:]
                    for r in bad)
                raise RuntimeError(f"ranks {bad} failed:\n{logs}")
            self._results = [torch.load(self.tmp / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(len(self.procs))]
        return self._results


def init_worker(rank, world, tmp):
    """In a rank: one thread, the gloo group on the FileStore under tmp.
    Returns runtime.initialize's RuntimeInfo."""
    torch.set_num_threads(1)
    from cugp_tpu_torch import runtime

    return runtime.initialize(f"file://{tmp}/store", world, rank,
                              device="cpu")


def run_cases(cases, *args):
    """{name: case(*args)} for every case, each case's seconds printed to
    the rank's log."""
    out = {}
    for name, fn in cases.items():
        t0 = time.perf_counter()
        out[name] = fn(*args)
        print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def finish_worker(rank, tmp, out):
    import torch.distributed as dist

    torch.save(out, pathlib.Path(tmp) / f"rank{rank}.pt")
    dist.destroy_process_group()
