"""Dense exact-GP hyperparameter learning through ``GP.fit`` (Adam on
the LML), in chunks of steps, each chunk starting from the params the
previous one returned.

Set-up makes the data, builds the GP and runs its first chunk of
``check_steps`` steps through the same call; those steps are the ones
the reference follows (the loss of each, the first gradient as Adam
got it, the params' change after the last), each lengthscale as a
hyperparameter of its own.
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
        self.counters = {}

    def _fit(self, steps, init):
        t = self.traffic
        return self.gp.fit(self.X, self.y, steps=steps, init=init,
                           optimizer="adam",
                           learning_rate=t["learning_rate"],
                           objective=t["objective"])

    def setup(self):
        import cugp_tpu_torch

        cfg, dev = self.cfg, self.device
        self.X, self.y, _, _ = data.dataset(cfg, self.seed, dev)
        self.gp = cugp_tpu_torch.GP(kind=cfg["kernel"], jitter=cfg["jitter"],
                                    device=dev)
        init = cfg["init"]
        self.p0 = driving.log_params(cfg["d"], init["lengthscale"],
                                     init["signal_var"], init["noise_var"],
                                     dev)
        probe = hooks.AdamProbe()
        with probe.active():
            info = self._fit(self.traffic["check_steps"], self.p0)
        driving.sync(dev)
        self.checked = {
            "losses": [float(v) for v in info["loss"]],
            "first_grad": driving.named(probe.first_grads[0]),
            "params": {k: v.clone() for k, v in self.gp.params.items()}}
        self.step_flops = frozen.dense_fit_step_flops(
            cfg["n_train"], cfg["d"], cfg["d"] + 2)

    def operation(self):
        steps = self.traffic["chunk_steps"]
        info = self._fit(steps, self.gp.params)
        losses = info["loss"].tolist()  # the host read ends the chunk
        driving.sync(self.device)
        failed = sum(not math.isfinite(v) for v in losses)
        return {"ops": steps, "failed": failed,
                "flops": steps * self.step_flops}

    def end_to_end(self, tally, window_s):
        return {"fit_step_s": window_s / tally["ops"]}

    def release(self):
        del self.gp
        driving.release(self.device)

    def check(self):
        cfg, t = self.cfg, self.traffic
        X, y = self.X, self.y
        jitter = cfg["jitter"]

        def loss_and_grad(p):
            lml, g = matern32.lml_and_grad(X, y, p, jitter)
            return -lml, {k: -v for k, v in g.items()}

        p0 = driving.to64(self.p0)
        losses, g1, p_end = adam.follow(
            p0, loss_and_grad, t["check_steps"], t["learning_rate"],
            driving.bounds(cfg))
        got = self.checked
        moved = compare.moved_leaves(g1)
        self.diag = {"left_out": [k for k in compare.components(g1)
                                  if k not in moved]}
        prog_change = {k: driving.to64(got["params"])[k] - p0[k] for k in p0}
        ref_change = {k: p_end[k] - p0[k] for k in p0}
        return {
            "loss_gap": max(compare.rel_gap(a, b)
                            for a, b in zip(got["losses"], losses)),
            "grad_gap": compare.leaf_norm_gap(got["first_grad"], g1),
            "change_gap": compare.leaf_norm_gap(prog_change, ref_change,
                                                moved)}
