"""Entry ``month``: one month's factored kriging and 100 members
(``lowrank_ensemble_step``) on the covariance of an ellipse
configuration, built and clipped once in set-up."""

import numpy as np
import torch

from glomargridding_tpu_torch import (
    explained_variance_clip_lowrank,
    lowrank_ensemble_step,
)

from ..families.ellipse import (
    build,
    compare_step,
    eigen_numbers,
    observations,
    operator,
    reference_fields,
    step_work,
    worst,
)

REFERENCE = "ellipse"
__all__ = ["REFERENCE", "Entry", "build"]


class Entry:
    """One month's factored kriging and 100 members against the
    covariance built and clipped in set-up."""

    def __init__(self, state, cfg, mix, items, seed, spans):
        self.state, self.cfg, self.items, self.spans = state, cfg, items, spans
        gen = torch.Generator(device=state.device)
        gen.manual_seed(seed)
        # the factors are this cell's data: the control changes the
        # month's step alone, so the set-up clip runs on the port's store
        mv, n, trace = operator(state, state.Lx, state.Ly, state.theta, None)
        self.psd = explained_variance_clip_lowrank(
            mv, n=n, trace=trace, generator=gen, **cfg["clip"]).pad_rank(
                int(cfg["pad_rank"]))
        del mv
        self.members = int(cfg["members"])
        self.pool = [observations(state, it["m"], self.members,
                                  self.psd.rank, gen) for it in items]
        # the factors stay, so each month's counted work is known here
        self.works = [step_work(state, self.psd, it["m"], self.members)
                      for it in items]

    def longest(self):
        return int(np.argmax([it["m"] for it in self.items]))

    def warm_up(self):
        ms = [it["m"] for it in self.items]
        return [int(np.argmax(ms)), int(np.argmin(ms))]

    def __call__(self, k):
        idx, y, e, z1, z2, zo = self.pool[k]
        with self.spans("step"):
            res, members = lowrank_ensemble_step(
                self.psd, idx, y, e, n_members=self.members,
                noise=(z1, z2, zo))
        return (res, members), self.works[k]

    def info(self, works):
        return {"rank": f"{self.psd.rank} ({self.psd.effective_rank} "
                        "with gain)"}

    def release(self, kept):
        self.pool = {k: self.pool[k] for k in kept}

    def compare(self, kept, reference):
        """The set-up clip's eigenpairs under the reference's covariance,
        then each kept month on those factors."""
        s = self.state
        fields = reference_fields(s, reference, s.Lx, s.Ly, s.theta)
        out = {"eig_res": eigen_numbers(fields, self.psd,
                                        float(self.cfg["nu"]))["eig_res"]}
        for k, (res, members) in kept.items():
            worst(compare_step(self.psd, res, members, self.pool[k],
                               reference), out)
        return out
