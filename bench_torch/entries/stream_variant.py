"""Entry ``stream_variant``: one covariance variant of an ellipse
configuration whose store is the zero-storage stream (theta plus an
offset, the lengths times the mix's factor), built as the stream
operator, clipped, padded and used for one month's factored kriging and
members.

Each application of the operator the clip makes runs inside the
harness's ``stream`` span, and the program's stream counters are read
around it (``stream.columns``, ``stream.built_pairs``; a program without
them leaves their deltas 0 and the metrics that read them silent). Where
the program has them they must agree with this entry's own count: the
columns it handed over, and ``band_stats``' kept pairs for each wide
application.

A window holds a few variants of the pool's K, so the entry keeps, and
compares, the first ``compare`` variants of the run's cycle itself (the
harness's draw of pool indices would miss most); the last of the cycle,
which a window does not reach first, is the warm-up.
"""

import numpy as np
import torch

from glomargridding_tpu_torch import (
    explained_variance_clip_lowrank,
    lowrank_ensemble_step,
)
from glomargridding_tpu_torch.utils import profiling

from ..families import ellipse_stream as yardstick
from ..families.ellipse import (
    Counted,
    build,
    compare_step,
    eigen_numbers,
    max_rel,
    operator,
    reference_fields,
    step_work,
    worst,
)
from ..traffic import plan
from . import variant

REFERENCE = "ellipse_stream"
__all__ = ["REFERENCE", "Entry", "build"]

# the program's stream counters an analysis reads
COUNTED = ("stream.columns", "stream.built_pairs")


class Streamed(Counted):
    """``Counted``, with each application inside the harness's ``stream``
    span, the wide ones (more than K3's columns) and their columns
    counted, and the program's stream counters' deltas summed."""

    def __init__(self, op, spans):
        super().__init__(op)
        self.spans = spans
        self.wide = self.wide_columns = 0
        self.program = dict.fromkeys(COUNTED, 0)

    def __call__(self, x):
        before = [profiling.COUNTS[c] for c in COUNTED]
        with self.spans("stream"):
            y = super().__call__(x)
        columns = x.shape[1] if x.dim() == 2 else 1
        if columns > yardstick.K3_COLUMNS:
            self.wide += 1
            self.wide_columns += columns
        for c, b in zip(COUNTED, before):
            self.program[c] += profiling.COUNTS[c] - b
        return y

    def check(self, stats):
        """The program's counts against this wrapper's, where the program
        counts (``stats`` the operator's ``band_stats``)."""
        if not set(COUNTED) <= set(getattr(profiling, "COUNTERS", ())):
            return
        want = {"stream.columns": self.columns,
                "stream.built_pairs": self.wide * int(stats["kept_pairs"])}
        if self.program != want:
            raise RuntimeError(f"the stream counted {self.program}, "
                               f"its caller {want}")


class _Applied:
    """The reference's product C V, computed once, in the place of its
    fields for ``eigen_numbers``."""

    def __init__(self, CV):
        self.CV = CV

    def apply(self, V, nu):
        return self.CV


class Entry(variant.Entry):
    """One covariance variant on the stream: the operator's plan, the
    clip, the padding, then one month's factored kriging and members."""

    def __init__(self, state, cfg, mix, items, seed, spans):
        if cfg["store"] != "stream":
            raise ValueError("the stream entry runs a stream configuration")
        super().__init__(state, cfg, mix, items, seed, spans)
        _, order = plan(mix, seed)
        self.compared = order[:int(mix["compare"])]
        self.warm = order[-1]
        self.warming = 0
        self.kept = {}
        self.needed = yardstick.needed_pairs(
            cfg["grid"]["step_deg"], cfg["max_dist_km"], state.device)

    def longest(self):
        # every variant has the configuration's lengths, so about one
        # rank: the one every run keeps is the window's first
        return self.compared[0]

    def warm_up(self):
        self.warming = 1
        return [self.warm]

    def stream_work(self, counted):
        """The counted work of the clip's applications, from the pairs the
        result needs: K4's least time and f32 flops, the GEMM's flops."""
        n = self.state.n
        return {"f32_flops": counted.wide * yardstick.K4_FLOPS * self.needed
                + yardstick.gemm_flops(self.needed, counted.wide_columns),
                "k4_least_ms": counted.wide * yardstick.k4_least_ms(
                    self.needed, n)[0],
                "stream.needed_pairs": counted.wide * self.needed,
                "stream.wide": counted.wide, **counted.program}

    def __call__(self, k):
        s, spans = self.state, self.spans
        idx, y, e, z1, _, zo = self.pool[k]
        gen = torch.Generator(device=s.device)
        gen.manual_seed(self.seeds[k])
        with spans("assembly"):
            mv, n, trace = operator(s, *self.fields[k], self.reference)
        counted = Streamed(mv, spans)
        with spans("clip"):
            psd = explained_variance_clip_lowrank(
                counted, n=n, trace=trace, generator=gen, **self.cfg["clip"])
        psd = psd.pad_rank(int(self.cfg["pad_rank"]))
        counted.check(mv.band_stats)
        del mv
        counted.op = None
        z2 = torch.randn((psd.rank, self.members), generator=gen,
                         device=s.device)
        with spans("step"):
            res, members = lowrank_ensemble_step(
                psd, idx, y, e, n_members=self.members, noise=(z1, z2, zo))
        work = step_work(s, psd, idx.shape[0], self.members)
        stream = self.stream_work(counted)
        work["f32_flops"] += stream.pop("f32_flops")
        work.update(stream, sweeps=counted.calls, columns=counted.columns,
                    clips=1)
        out = dict(psd=psd, res=res, members=members, z2=z2,
                   first=counted.first)
        if self.warming:
            self.warming -= 1
        elif k in self.compared and k not in self.kept:
            self.kept[k] = out
        return out, work

    def info(self, works):
        out = super().info(works)
        built = sum(w["stream.built_pairs"] for w in works)
        needed = sum(w["stream.needed_pairs"] for w in works)
        out["stream"] = (f"{np.mean([w['stream.wide'] for w in works])} wide "
                         f"applications a clip, {self.needed} needed pairs, "
                         f"built/needed {built / needed if built else None}")
        out["compared"] = f"pool {sorted(self.kept)} of {self.compared}"
        return out

    def release(self, kept):
        self.pool = {k: self.pool[k] for k in self.kept}
        self.fields = {k: self.fields[k] for k in self.kept}

    def compare(self, kept, reference):
        """Each variant this entry kept (the harness's `kept` aside), with
        one pass over the reference's C for the stream's first columns
        and the clip's retained vectors at once:

        - ``stream_err``: the clip's first application, its first
          ``PROBE_COLUMNS`` columns, against C X;
        - ``ritz_err``, and for the window's first ``eig_res``
          (``eigen_numbers``);
        - ``field_err``, ``uncertainty_err``, ``mask_err``,
          ``members_err`` of the month on the factors (``compare_step``).
        """
        s, nu = self.state, float(self.cfg["nu"])
        out = {}
        for k, o in self.kept.items():
            f = reference_fields(s, reference, *self.fields[k])
            X, Y = o["first"]
            psd = o["psd"]
            V = psd.vectors[:, psd.gains > 0].to(torch.float64)
            CXV = reference.product(f, torch.cat(
                [X.to(torch.float64), V], dim=1), nu)
            numbers = {"stream_err": max_rel(Y, CXV[:, :X.shape[1]])}
            numbers.update(eigen_numbers(_Applied(CXV[:, X.shape[1]:]), psd,
                                         nu, residual=k == self.longest()))
            del CXV
            idx, y, e, z1, _, zo = self.pool[k]
            numbers.update(compare_step(psd, o["res"], o["members"],
                                        (idx, y, e, z1, o["z2"], zo),
                                        reference))
            worst(numbers, out)
        return out
