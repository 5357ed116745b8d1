"""Entry ``variant``: one covariance variant of an ellipse configuration
(Lx and Ly times a factor, theta plus an offset) built into the
configuration's store, clipped, padded and used for one month's factored
kriging and members."""

import numpy as np
import torch

from glomargridding_tpu_torch import (
    explained_variance_clip_lowrank,
    lowrank_ensemble_step,
)

from .. import accounting
from ..families.ellipse import (
    Counted,
    build,
    compare_step,
    eigen_numbers,
    max_rel,
    observations,
    operator,
    reference_fields,
    step_work,
    worst,
)

REFERENCE = "ellipse"
__all__ = ["REFERENCE", "Entry", "build"]


class Entry:
    """One covariance variant: the store, the clip, the padding, then one
    month's factored kriging and members."""

    def __init__(self, state, cfg, mix, items, seed, spans):
        import bench_torch.reference.ellipse as reference

        self.reference = reference
        self.state, self.cfg, self.items, self.spans = state, cfg, items, spans
        gen = torch.Generator(device=state.device)
        gen.manual_seed(seed)
        self.members = int(cfg["members"])
        self.fields = [(state.Lx * it["length_factor"],
                        state.Ly * it["length_factor"],
                        state.theta + it["theta_offset"]) for it in items]
        m = int(mix["observations"])
        self.pool = [observations(state, m, self.members, None, gen)
                     for _ in items]
        self.seeds = [int(s) for s in torch.randint(
            0, 2**62, (len(items),), generator=gen, device=state.device).cpu()]

    def longest(self):
        # the shortest lengths need the highest rank, so the most sweeps
        return int(np.argmin([it["length_factor"] for it in self.items]))

    def warm_up(self):
        return [self.longest()]

    def store_work(self, n, columns):
        """The counted work of building the store and of the clip's
        `columns` applications of it: K2's pairs in f32 and the bf16
        products. A store of another kind is counted by the entry that
        runs it."""
        if self.cfg["store"] != "bf16":
            return {}
        return {"f32_flops": accounting.PAIR_FLOPS * n * (n - 1) / 2.0,
                "bf16_flops": accounting.operator_flops(n, columns),
                "k2_least_ms": accounting.k2_least_ms(n)[0]}

    def __call__(self, k):
        s, spans = self.state, self.spans
        idx, y, e, z1, _, zo = self.pool[k]
        gen = torch.Generator(device=s.device)
        gen.manual_seed(self.seeds[k])
        with spans("assembly"):
            mv, n, trace = operator(s, *self.fields[k], self.reference)
        counted = Counted(mv)
        with spans("clip"):
            psd = explained_variance_clip_lowrank(
                counted, n=n, trace=trace, generator=gen, **self.cfg["clip"])
        psd = psd.pad_rank(int(self.cfg["pad_rank"]))
        del mv
        counted.op = None  # frees the store before the month
        z2 = torch.randn((psd.rank, self.members), generator=gen,
                         device=s.device)
        with spans("step"):
            res, members = lowrank_ensemble_step(
                psd, idx, y, e, n_members=self.members, noise=(z1, z2, zo))
        work = step_work(s, psd, idx.shape[0], self.members)
        store = self.store_work(n, counted.columns)
        work["f32_flops"] += store.pop("f32_flops", 0.0)
        work.update(store, sweeps=counted.calls, columns=counted.columns,
                    clips=1)
        return dict(psd=psd, res=res, members=members, z2=z2,
                    first=counted.first), work

    def info(self, works):
        ranks = [w["rank"] for w in works]
        return {"ranks": f"{min(ranks)}-{max(ranks)} with gain",
                "sweeps_per_clip": f"{np.mean([w['sweeps'] for w in works])}",
                "columns_per_clip": f"{np.mean([w['columns'] for w in works])}"}

    def release(self, kept):
        self.pool = {k: self.pool[k] for k in kept}
        self.fields = {k: self.fields[k] for k in kept}

    def compare(self, kept, reference):
        """Each kept variant: the store's first columns, the clip's
        eigenvalues against the reference's covariance on their vectors,
        and the month on its factors; for the longest (the highest rank,
        the only one that every run keeps, and one whose clip widens past
        its first block) the clip's eigenpair residuals too. Those differ
        from variant to variant by the rank's margin within the block (a
        factor of 18 over the pool), more than an under-converged clip
        moves one variant's (4-21 times), so only the longest's is held
        to a limit."""
        s, nu = self.state, float(self.cfg["nu"])
        out = {}
        for k, o in kept.items():
            f = reference_fields(s, reference, *self.fields[k])
            X, Y = o["first"]
            numbers = {"store_err": max_rel(Y, f.apply(X, nu))}
            numbers.update(eigen_numbers(f, o["psd"], nu,
                                         residual=k == self.longest()))
            idx, y, e, z1, _, zo = self.pool[k]
            numbers.update(compare_step(o["psd"], o["res"], o["members"],
                                        (idx, y, e, z1, o["z2"], zo),
                                        reference))
            worst(numbers, out)
        return out
