"""The general traffic generator: one analysis plan from a traffic mix's
data file (``bench_torch/traffic/<mix>.json``) and the seed.

A mix draws each varying quantity of an analysis (the observation count
``m``, a variant's length factor, ...) from a law named in its file.
Every seed gets the same set of values: K stratified quantiles of each
law (K = ``pool``), so that the work of a run does not depend on the
seed. The seed picks where in the cycle a run starts; the cycle visits
the strata in bit-reversed order, so that any run of consecutive
analyses spreads over the whole law. Everything else an analysis needs
(observed cells, values, noise) the configuration's family draws on the
card from the seed.
"""

import math

import numpy as np


def quantile(law, q):
    """The value of `law` at probability q in (0, 1)."""
    kind = law["law"]
    lo, hi = float(law["low"]), float(law["high"])
    if kind == "uniform":
        x = lo + q * (hi - lo)
    elif kind == "loguniform":
        x = math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown law {kind!r}")
    return int(round(x)) if law.get("integer") else x


def bit_reversed(k, bits):
    return int(f"{k:0{bits}b}"[::-1], 2) if bits else 0


def plan(mix, seed):
    """(items, order): the pool's K analyses as dicts of their drawn
    quantities (stratum k of the first law, stratum (4j + 1) k mod K of
    the j-th, a fixed pairing), and the cycle of pool indices a run
    walks, starting where the seed says."""
    K = int(mix["pool"])
    bits = K.bit_length() - 1
    if K < 1 or 1 << bits != K:
        raise ValueError("a mix's pool is a power of two")
    laws = sorted(mix.get("laws", {}).items())
    items = []
    for k in range(K):
        item = {}
        for j, (name, law) in enumerate(laws):
            stratum = (k * (4 * j + 1)) % K
            item[name] = quantile(law, (stratum + 0.5) / K)
        items.append(item)
    start = int(np.random.default_rng(seed).integers(K))
    order = [bit_reversed((start + p) % K, bits) for p in range(K)]
    return items, order
