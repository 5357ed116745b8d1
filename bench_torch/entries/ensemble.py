"""Entry ``ensemble``: one month's ordinary field and its
observation-perturbation members through the port's
``ensemble_from_kernel``."""

import torch

from glomargridding_tpu_torch import ensemble_from_kernel

from .. import accounting
from ..families.stationary import build, k1_least_ms, max_rel, observations
from . import kriging

REFERENCE = "stationary"
__all__ = ["REFERENCE", "Entry", "build"]


class Entry(kriging.Entry):
    """One month's ordinary field and its observation-perturbation
    members."""

    def inputs(self, item, gen):
        idx, y, E = observations(self.state, item["m"], gen)
        z = torch.randn((int(self.cfg["members"]), item["m"]), generator=gen,
                        device=self.state.device)
        return idx, y, E, z

    def work(self, m):
        n, M = self.state.n, int(self.cfg["members"])
        return {"f32_flops": accounting.ensemble_flops(m, n, M)
                + accounting.K1_FLOPS * (m * m + m * n),
                "k1_least_ms": k1_least_ms(m, n)}

    def __call__(self, k):
        s = self.state
        idx, y, E, z = self.pool[k]
        out = ensemble_from_kernel(
            s.kernel, s.lat, s.lon, idx, y, E, n_members=z.shape[0],
            n_blocks=self.cfg["n_blocks"], noise=z)
        return out, self.work(idx.shape[0])

    def reference_inputs(self, k):
        idx, y, E, z = self.pool[k]
        f64 = torch.float64
        return (self.state.lat.to(f64), self.state.lon.to(f64), idx,
                y.to(f64), torch.diagonal(E).to(f64), z.to(f64))

    def compare(self, kept, reference):
        out = {"field_err": 0.0, "members_err": 0.0}
        for k, (field, members) in kept.items():
            f_ref, m_ref = reference.ensemble(self.cfg,
                                              *self.reference_inputs(k))
            out["field_err"] = max(out["field_err"], max_rel(field, f_ref))
            out["members_err"] = max(out["members_err"],
                                     max_rel(members, m_ref))
        return out
