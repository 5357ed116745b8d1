"""Entry ``kriging``: one month's ordinary kriging of a stationary
configuration through the port's ``kriging_from_kernel`` (field,
uncertainty, constraint mask)."""

import numpy as np
import torch

from glomargridding_tpu_torch import kriging_from_kernel

from .. import accounting
from ..families.stationary import build, k1_least_ms, max_rel, observations

REFERENCE = "stationary"
__all__ = ["REFERENCE", "Entry", "build"]


class Entry:
    """One month's ordinary kriging: field, uncertainty, constraint
    mask."""

    def __init__(self, state, cfg, mix, items, seed, spans):
        self.state, self.cfg, self.items = state, cfg, items
        gen = torch.Generator(device=state.device)
        gen.manual_seed(seed)
        self.pool = [self.inputs(item, gen) for item in items]

    def inputs(self, item, gen):
        return observations(self.state, item["m"], gen)

    def longest(self):
        return int(np.argmax([it["m"] for it in self.items]))

    def warm_up(self):
        ms = [it["m"] for it in self.items]
        return [int(np.argmax(ms)), int(np.argmin(ms))]

    def work(self, m):
        n = self.state.n
        return {"f32_flops": accounting.kriging_flops(m, n)
                + accounting.K1_FLOPS * (m * m + m * n),
                "k1_least_ms": k1_least_ms(m, n)}

    def __call__(self, k):
        s = self.state
        idx, y, E = self.pool[k]
        out = kriging_from_kernel(
            s.kernel, s.lat, s.lon, idx, y, error_cov=E, variance=s.variance,
            method=self.cfg["method"], n_blocks=self.cfg["n_blocks"])
        return out, self.work(idx.shape[0])

    def info(self, works):
        return {}

    def release(self, kept):
        self.pool = {k: self.pool[k] for k in kept}

    def reference_inputs(self, k):
        idx, y, E = self.pool[k]
        f64 = torch.float64
        return (self.state.lat.to(f64), self.state.lon.to(f64), idx,
                y.to(f64), torch.diagonal(E).to(f64))

    def compare(self, kept, reference):
        out = {"field_err": 0.0, "uncertainty_err": 0.0, "mask_err": 0.0}
        sd = self.state.variance ** 0.5
        for k, res in kept.items():
            field, unc, mask = reference.kriging_fields(
                self.cfg, *self.reference_inputs(k), method=self.cfg["method"])
            out["field_err"] = max(out["field_err"], max_rel(res.field, field))
            out["uncertainty_err"] = max(out["uncertainty_err"],
                                         max_rel(res.uncertainty, unc, sd))
            out["mask_err"] = max(out["mask_err"],
                                  max_rel(res.constraint_mask, mask, 1.0))
        return out
