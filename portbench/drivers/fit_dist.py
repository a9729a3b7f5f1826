"""Exact-GP hyperparameter learning over several cards through the
distributed tier's sharded step: ``runtime.initialize`` (one rank a card,
NCCL; gloo on the CPU), ``parallel.mesh.make_mesh`` and
``parallel.gspmd.make_map_train_step(..., lml_backend="chunked")``, Adam
on -LML, in chunks of steps, each chunk from the params the previous one
left.

The harness's process is rank 0 on the first card. Set-up builds the
kernels, then starts ranks 1 ... world-1 as child processes (this file
run as a script), one a card, which import torch, the benchmark and the
program only. Every rank makes the same data from the configuration and
the seed and keeps its own rows. Each ``operation()`` sends every child
the number of steps on its standard input, all ranks run them, and the
host's read of rank 0's loss ends the chunk. A child dies with its
parent (the kernel's parent-death signal), rank 0 stops the run when a
child ends before it is told to stop (a watchdog thread), and every
rank's collectives time out: a failure ends the run, it does not hang
it. ``release()`` tells the children to stop, waits for them to leave
the group and end (the watchdog ends the run if they take longer than
``STOP_S``) and frees their cards; a child may end before rank 0 has
left the group, and that is no failure. Only rank 0 is traced; the ranks do the
same work on blocks of the same size.

Set-up runs the first ``check_steps`` steps; the float64 reference
(``reference/matern32_dist4``, over the cards the program used) follows
them after the release, as in ``fit.py``: the loss of each, the first
gradient as Adam got it, the params' change after the last.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent

# seconds a rank waits on a collective (or to join the group) before
# failing: longer than anything rank 0 does between two chunks
TIMEOUT_S = 300
# seconds the ranks have, once told to stop, to leave the group and end
STOP_S = 120


class _Rank:
    """What every rank holds: its mesh, its rows and the sharded step."""

    def __init__(self, cfg, traffic, seed, device, url, world, rank):
        import inspect

        from cugp_tpu_torch import runtime
        from cugp_tpu_torch.parallel import gspmd, mesh as mesh_lib
        from cugp_tpu_torch.parallel.mesh import Sharding

        from portbench import data, driving

        kw = {}
        if "timeout" in inspect.signature(runtime.initialize).parameters:
            kw["timeout"] = TIMEOUT_S
        self.info = runtime.initialize(url, world, rank,
                                       device=device.type, **kw)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        dep = cfg["deployment"]
        self.mesh = mesh_lib.make_mesh(world, dp=dep["dp"])
        X, y, _, _ = data.dataset(cfg, seed, device)
        rows = Sharding(self.mesh, (("dp", "r"), None))
        self.X_loc, self.y_loc = rows.shard(X), rows.shard(y)
        self.X, self.y = (X, y) if rank == 0 else (None, None)
        init = cfg["init"]
        self.p0 = driving.log_params(cfg["d"], init["lengthscale"],
                                     init["signal_var"], init["noise_var"],
                                     device)
        self.step, tx = gspmd.make_map_train_step(
            self.mesh, kind=cfg["kernel"], jitter=cfg["jitter"],
            learning_rate=traffic["learning_rate"], lml_backend="chunked",
            chunk=dep["block"])
        self.state = tx.init(self.p0)
        self.params = self.state.params

    def run(self, steps):
        losses = []
        for _ in range(steps):
            self.params, self.state, loss = self.step(
                self.params, self.state, self.X_loc, self.y_loc)
            losses.append(loss)
        return torch.stack(losses)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent(parent):
    """In a child: SIGKILL when the parent dies (PR_SET_PDEATHSIG), and
    exit now if it already has."""
    import ctypes

    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.counters = {}
        self.world = cfg["deployment"]["ranks"]
        self.children, self.rank = [], None
        self._stop_sent = None  # monotonic time the children were told to stop
        self._released = threading.Event()

    def _abort(self, why):
        """End the run: the children killed, the reason on stderr, this
        process gone at once (a collective may be waiting on a dead
        peer)."""
        print(f"portbench: {why}", file=sys.stderr, flush=True)
        for p in self.children:
            if p.poll() is None:
                p.kill()
        os._exit(1)

    def _watch(self):
        """Until the children are told to stop, end the run when one of
        them ends; after, end it if they have not all ended in STOP_S."""
        while not self._released.wait(0.5):
            for r, p in enumerate(self.children, 1):
                # read after the poll: a child ends only after its stop
                # was sent, unless it failed during the run
                if p.poll() is not None and self._stop_sent is None:
                    self._abort(f"rank {r} ended (exit {p.returncode}) "
                                "during the run")
            if (self._stop_sent is not None
                    and time.monotonic() - self._stop_sent > STOP_S):
                self._abort(f"the ranks did not stop in {STOP_S} s")

    def _send(self, line):
        for p in self.children:
            p.stdin.write(line + "\n")
            p.stdin.flush()

    def _steps(self, steps):
        try:
            self._send(f"steps {steps}")
            return self.rank.run(steps)
        except Exception:
            self._abort("rank 0 failed:\n" + traceback.format_exc())

    def setup(self):
        from portbench import driving, frozen, hooks

        cfg, dev = self.cfg, self.device
        try:
            if dev.type == "cuda":
                from cugp_tpu_torch.ops import _build

                _build.lib()  # built once, before the children load it
            url = f"tcp://localhost:{_free_port()}"
            spec = json.dumps({
                "cfg": cfg, "traffic": self.traffic, "seed": self.seed,
                "device": dev.type, "url": url, "world": self.world,
                "tf32": torch.backends.cuda.matmul.allow_tf32})
            env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}
            env["PYTHONPATH"] = str(ROOT)
            for r in range(1, self.world):
                self.children.append(subprocess.Popen(
                    [sys.executable, __file__, str(r), str(os.getpid())],
                    stdin=subprocess.PIPE, text=True, env=env,
                    cwd=str(ROOT)))
                self.children[-1].stdin.write(spec + "\n")
                self.children[-1].stdin.flush()
            threading.Thread(target=self._watch, daemon=True).start()
            self.rank = _Rank(cfg, self.traffic, self.seed, dev, url,
                              self.world, 0)
        except Exception:
            self._abort("set-up failed:\n" + traceback.format_exc())
        probe = hooks.AdamProbe()
        with probe.active():
            losses = self._steps(self.traffic["check_steps"])
        driving.sync(self.rank.device)
        # no Adam step at all (every checked gradient not finite, so the
        # finite guard skipped them): a first gradient of NaNs
        first = (probe.first_grads[0] if probe.first_grads else
                 [torch.full_like(v, math.nan)
                  for v in self.rank.params.values()])
        self.checked = {
            "losses": [float(v) for v in losses],
            "first_grad": driving.named(first),
            "params": {k: v.detach().clone()
                       for k, v in self.rank.params.items()}}
        # the model FLOPs of a step, counted per card
        self.step_flops = frozen.dense_fit_step_flops(
            cfg["n_train"], cfg["d"], cfg["d"] + 2) / self.world

    def operation(self):
        steps = self.traffic["chunk_steps"]
        losses = self._steps(steps).tolist()  # the host read ends the chunk
        failed = sum(not math.isfinite(v) for v in losses)
        return {"ops": steps, "failed": failed,
                "flops": steps * self.step_flops}

    def end_to_end(self, tally, window_s):
        return {"fit_step_s": window_s / tally["ops"]}

    def release(self):
        import torch.distributed as dist

        from portbench import driving

        # from here a child may end (it may leave the group and end
        # before rank 0 has); the watchdog ends the run if the ranks do
        # not all stop in STOP_S, a teardown that hangs included
        self._stop_sent = time.monotonic()
        self._send("stop")
        if dist.is_initialized():
            dist.destroy_process_group()
        for r, p in enumerate(self.children, 1):
            if p.wait():
                # every step was done and read by then: the run stands
                print(f"portbench: rank {r} ended with exit {p.returncode} "
                      "after it was told to stop", file=sys.stderr,
                      flush=True)
        self._released.set()
        self.X, self.y = self.rank.X, self.rank.y
        dev = self.rank.device
        self.rank = None
        driving.release(dev)

    def check(self):
        from portbench import compare, driving
        from portbench.reference import adam, matern32_dist4

        cfg, t = self.cfg, self.traffic
        X, y, jitter = self.X, self.y, cfg["jitter"]
        devices = ([f"cuda:{i}" for i in range(self.world)]
                   if self.device.type == "cuda" else ["cpu"] * self.world)

        def loss_and_grad(p):
            lml, g = matern32_dist4.lml_and_grad(
                X, y, p, jitter, devices, tile=cfg["deployment"][
                    "reference_tile"])
            return -lml, {k: -v.to(X.device) for k, v in g.items()}

        p0 = driving.to64(driving.log_params(
            cfg["d"], cfg["init"]["lengthscale"], cfg["init"]["signal_var"],
            cfg["init"]["noise_var"], X.device))
        losses, g1, p_end = adam.follow(
            p0, loss_and_grad, t["check_steps"], t["learning_rate"],
            driving.bounds(cfg))
        got = self.checked
        moved = compare.moved_leaves(g1)
        self.diag = {
            "left_out": [k for k in compare.components(g1)
                         if k not in moved],
            "loss_gaps": [compare.rel_gap(a, b)
                          for a, b in zip(got["losses"], losses)],
            "losses": got["losses"], "ref_losses": losses,
            "first_grad": {k: v.tolist() for k, v in compare.components(
                driving.to64(got["first_grad"])).items()},
            "ref_first_grad": {k: v.tolist() for k, v in
                               compare.components(g1).items()}}
        prog_change = {k: driving.to64(got["params"])[k] - p0[k] for k in p0}
        ref_change = {k: p_end[k] - p0[k] for k in p0}
        return {
            "loss_gap": max(compare.rel_gap(a, b)
                            for a, b in zip(got["losses"], losses)),
            "grad_gap": compare.leaf_norm_gap(got["first_grad"], g1),
            "change_gap": compare.leaf_norm_gap(prog_change, ref_change,
                                                moved)}


def _child(rank, parent):
    """Rank `rank` > 0 of the harness process `parent`: its spec on the
    first line of standard input, then one command a line ("steps <k>",
    "stop")."""
    _die_with_parent(parent)
    sys.path.insert(0, str(ROOT))
    spec = json.loads(sys.stdin.readline())
    torch.set_num_threads(2)
    import cugp_tpu_torch  # noqa: F401  (sets TF32 off)

    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]
    me = _Rank(spec["cfg"], spec["traffic"], spec["seed"],
               torch.device(spec["device"]), spec["url"], spec["world"],
               rank)
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "stop":
            break
        me.run(int(cmd[1]))
    if me.device.type == "cuda":
        torch.cuda.synchronize(me.device)
        sys.stdout.write(f"[portbench] rank {rank} memory_peak_bytes="
                         f"{torch.cuda.max_memory_allocated(me.device)}\n")
        sys.stdout.flush()
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _child(int(sys.argv[1]), int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)
