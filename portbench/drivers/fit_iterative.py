"""Matrix-free hyperparameter learning through ``GP.fit_iterative``
(preconditioned CG for [y | probes], the Hutchinson gradient sweep,
Adam), in chunks of steps, each chunk starting from the params the
previous one returned. The probes are the benchmark's, frozen for the
whole run (part of the configuration's data set), and every chunk
warm-starts CG from step to step.

Set-up makes the data, builds the GP and runs its first chunk of
``check_steps`` steps through the same call. The reference cannot solve
at this size within a run (float64 CG without the program's
preconditioner would take minutes a step), so it takes each step's
solves from the program (read where the gradient sweep receives them)
and judges them by their float64 residuals against the benchmark's own
right-hand sides [y | its probes]; the probes the program swept with
must be those probes, bit for bit. Adam then runs in float64 on the
reference's estimate from those solves and the benchmark's probes,
evaluated at its own iterates, and the params at which the program took
each later step must be those iterates. Each step's loss, 1/2 y^T a,
follows from a solve the residual already judges, so it is not
compared on its own.
"""

from __future__ import annotations

import math

import torch

from portbench import compare, data, driving, frozen, hooks
from portbench.reference import adam, matern32


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.counters = {"cg_iters": [], "precond_rebuilds": 0}

    def _fit(self, steps, init):
        t = self.traffic
        return self.gp.fit_iterative(
            self.X, self.y, steps=steps, init=init,
            learning_rate=t["learning_rate"], precond_rank=t["precond_rank"],
            num_probes=t["num_probes"], tol=t["tol"],
            max_iters=t["max_iters"], probe_mode="frozen", probes=self.Z,
            warm_start=t["warm_start"])

    def setup(self):
        import cugp_tpu_torch

        cfg, dev, t = self.cfg, self.device, self.traffic
        self.X, self.y, self.Z, _ = data.dataset(cfg, self.seed, dev,
                                                 t["num_probes"])
        self.gp = cugp_tpu_torch.GP(kind=cfg["kernel"], jitter=cfg["jitter"],
                                    device=dev)
        init = cfg["init"]
        self.p0 = driving.log_params(cfg["d"], init["lengthscale"],
                                     init["signal_var"], init["noise_var"],
                                     dev)
        probe, capture = hooks.AdamProbe(), hooks.SolveCapture()
        with probe.active(), capture.active():
            info = self._fit(t["check_steps"], self.p0)
        driving.sync(dev)
        self.checked = {
            "losses": [float(v) for v in info["loss"]],
            # Adam stepped on the negated estimate (it minimizes)
            "first_grad": {k: -v for k, v in
                           driving.named(probe.first_grads[0]).items()},
            "params": {k: v.clone() for k, v in self.gp.params.items()},
            "solves": capture.steps,
            "cg_iters": [int(v) for v in info["cg_iters"]]}
        self.r = 1 + t["num_probes"]

    def operation(self):
        steps = self.traffic["chunk_steps"]
        info = self._fit(steps, self.gp.params)
        losses = info["loss"].tolist()
        driving.sync(self.device)
        iters = [int(v) for v in info["cg_iters"]]
        self.counters["cg_iters"] += iters
        self.counters["precond_rebuilds"] += int(info["precond_rebuilds"])
        cfg = self.cfg
        flops = sum(frozen.matrix_free_step_flops(cfg["n_train"], cfg["d"],
                                                  self.r, it) for it in iters)
        return {"ops": steps,
                "failed": sum(not math.isfinite(v) for v in losses),
                "flops": flops}

    def end_to_end(self, tally, window_s):
        return {"iterative_step_s": window_s / tally["ops"]}

    def release(self):
        del self.gp
        driving.release(self.device)

    def check(self):
        cfg, t = self.cfg, self.traffic
        X, y, Z, jitter = self.X, self.y, self.Z, cfg["jitter"]
        got = self.checked
        solves = got["solves"]
        numbers = dict.fromkeys(("probes_differ", "solve_resid",
                                 "solve_resid_y", "grad_gap", "path_gap",
                                 "change_gap"), math.inf)
        self.diag = {"cg_iters": got["cg_iters"], "resid_by_column": []}
        if len(solves) != t["check_steps"]:
            return numbers
        # the probes each step swept with against the benchmark's
        numbers["probes_differ"] = float(sum(
            not (s["z"].shape == Z.shape and torch.equal(s["z"], Z))
            for s in solves))
        if any(s["w"].shape != Z.shape for s in solves):
            return numbers
        rhs = torch.cat([y[:, None], Z], dim=1)
        resid = resid_y = 0.0
        for s in solves:
            sol = torch.cat([s["alpha"][:, None], s["w"]], dim=1)
            r = matern32.relative_residuals(X, s["params"], jitter, sol, rhs)
            self.diag["resid_by_column"].append(r.tolist())
            resid = max(resid, float(r.max()))
            resid_y = max(resid_y, float(r[0]))
        ref_grads, path = [], []
        steps = iter(solves)

        def follow_program(p):
            s = next(steps)
            path.append((s["params"], dict(p)))  # follow rebinds its leaves
            g = matern32.estimator_grad(X, p, jitter, s["alpha"], s["w"], Z)
            ref_grads.append(g)
            return 0.0, {k: -v for k, v in g.items()}

        p0 = driving.to64(self.p0)
        _, _, p_end = adam.follow(p0, follow_program, t["check_steps"],
                                  t["learning_rate"], driving.bounds(cfg))
        moved = compare.moved_leaves(ref_grads[0])
        self.diag["left_out"] = [k for k in compare.components(ref_grads[0])
                                 if k not in moved]

        def change_gap(prog, ref):
            prog = driving.to64(prog)
            return compare.leaf_norm_gap({k: prog[k] - p0[k] for k in p0},
                                         {k: ref[k] - p0[k] for k in p0},
                                         moved)

        numbers.update(
            solve_resid=resid, solve_resid_y=resid_y,
            grad_gap=compare.leaf_norm_gap(got["first_grad"], ref_grads[0]),
            # the params the program took steps 2.. at, against the
            # reference's own iterates
            path_gap=max((change_gap(prog, ref) for prog, ref in path[1:]),
                         default=0.0),
            change_gap=change_gap(got["params"], p_end))
        return numbers
