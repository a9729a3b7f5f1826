"""Posterior serving through ``GP.predict``: one client in a closed
loop against a GP conditioned in set-up at the draw's hyperparameters.
Each request asks for b test points, fresh from the seed, and reads the
mean and variance back to the host. The sizes cycle through a fixed set
spread log-uniformly between ``b_min`` and ``b_max``, in an order drawn
from the seed, so every seed serves the same mix; the window closes on a
whole cycle, so every run serves the same sizes.

Every answer served in the window is judged once the window has closed,
against the reference's posterior from its own float64 factor.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import data, driving, frozen
from portbench.reference import matern32


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.counters = {}
        self.served = []  # (Xs on the device, mean, var on the host)
        self.latencies = []

    def _request(self, b):
        Xs = data.uniform_inputs(b, self.cfg["d"], self.gen,
                                 self.device).to(torch.float32)
        t0 = time.perf_counter()
        mu, var = self.gp.predict(Xs)
        mu, var = mu.cpu(), var.cpu()
        return Xs, mu, var, time.perf_counter() - t0

    def setup(self):
        import cugp_tpu_torch

        cfg, dev, t = self.cfg, self.device, self.traffic
        draw = cfg["draw"]
        self.X, self.y, _, self.gen = data.dataset(cfg, self.seed, dev)
        self.params = driving.log_params(
            cfg["d"], draw["lengthscale"], draw["signal_var"],
            draw["noise_var"], dev)
        self.gp = cugp_tpu_torch.GP(kind=cfg["kernel"], jitter=cfg["jitter"],
                                    device=dev).condition(self.X, self.y,
                                                          self.params)
        self.sizes = data.size_cycle(t["b_min"], t["b_max"],
                                     t["sizes_per_cycle"], self.gen)
        for b in (t["b_max"], t["b_min"]):  # the cell's widest and narrowest
            self._request(b)
        self.next = 0

    def operation(self):
        b = self.sizes[self.next % len(self.sizes)]
        self.next += 1
        Xs, mu, var, lat = self._request(b)
        self.served.append((Xs, mu, var))
        self.latencies.append(lat)
        bad = not (torch.isfinite(mu).all() and torch.isfinite(var).all())
        return {"ops": 1, "failed": int(bad), "points": b,
                "flops": frozen.predict_request_flops(
                    self.cfg["n_train"], self.cfg["d"], b)}

    def mix_whole(self):
        return self.next % len(self.sizes) == 0

    def end_to_end(self, tally, window_s):
        return {"predict_points_per_s": tally["points"] / window_s,
                "predict_p90_ms": 1e3 * float(
                    np.percentile(self.latencies, 90))}

    def release(self):
        del self.gp
        driving.release(self.device)

    def check(self):
        L, a, _ = matern32.factor(self.X, self.y, self.params,
                                  self.cfg["jitter"])
        Xt = torch.cat([s[0] for s in self.served])
        mu_ref, var_ref = matern32.posterior(L, a, self.X, self.params, Xt)
        mu = torch.cat([s[1] for s in self.served]).to(torch.float64)
        var = torch.cat([s[2] for s in self.served]).to(torch.float64)
        return {"mean_max_abs": float((mu - mu_ref.cpu()).abs().max()),
                "var_max_abs": float((var - var_ref.cpu()).abs().max())}
