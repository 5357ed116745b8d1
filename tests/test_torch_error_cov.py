"""The port's ``ops/error_covariance`` against the JAX package's on the
same inputs (mirrors ``tests/test_error_cov.py``): the host components
exactly, W E W' (on the device) to rtol 1e-12 in f64 and 1e-6 in f32.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from glomargridding_tpu.ops import error_covariance as jerr
from glomargridding_tpu_torch.ops import error_covariance as terr
from glomargridding_tpu_torch.utils.frames import ColumnNotFoundError


def _frame(rng, n=60, boxes=9):
    return pd.DataFrame({
        "grid_idx": rng.integers(0, boxes, n) * 7,
        "data_type": rng.choice(["ship", "buoy", "argo", "drifter"], n),
        "platform": rng.choice(["p1", "p2", "p3"], n),
        "val": rng.normal(size=n),
        "lat": rng.uniform(-5, 5, n), "lon": rng.uniform(-5, 5, n),
        "sig2": rng.uniform(0.1, 1.0, n), "bias": rng.uniform(0.0, 0.5, n),
    })


SIG = {"ship": 2.0, "buoy": 1.0, "argo": 0.5, "drifter": 0.7}


def _both(name, *args, **kw):
    with warnings.catch_warnings(record=True) as caught_t:
        warnings.simplefilter("always")
        ours = getattr(terr, name)(*args, **kw)
    with warnings.catch_warnings(record=True) as caught_j:
        warnings.simplefilter("always")
        ref = getattr(jerr, name)(*args, **kw)
    assert [str(w.message) for w in caught_t] == \
        [str(w.message) for w in caught_j]
    return ours, ref


@pytest.mark.parametrize("kw", [
    {"obs_sig_map": SIG}, {"obs_sig_map": {"ship": 2.0}}, {"obs_sig_map": {}},
    {"obs_sig_col": "sig2"}, {"group_col": "platform",
                              "obs_sig_map": {"p1": 0.3, "p2": 0.4,
                                              "p3": 0.1}},
])
def test_uncorrelated_components(rng, kw):
    ours, ref = _both("uncorrelated_components", _frame(rng), **kw)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ColumnNotFoundError, match="missing"):
        terr.uncorrelated_components(_frame(rng), obs_sig_col="missing")


@pytest.mark.parametrize("kw", [
    {"bias_sig_map": {"p1": 0.3, "p2": 0.4, "p3": 0.1}},
    {"bias_sig_map": {"p1": 0.3}}, {"bias_sig_map": None},
    {"bias_sig_col": "bias"},
])
def test_correlated_components(rng, kw):
    ours, ref = _both("correlated_components", _frame(rng), "platform", **kw)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ColumnNotFoundError):
        terr.correlated_components(_frame(rng), "deck")


def test_weights_and_dist_weight(rng):
    df = _frame(rng)
    np.testing.assert_array_equal(terr.get_weights(df), jerr.get_weights(df))

    def dist_fn(sub, scale=1.0):
        d = np.abs(sub["lat"].to_numpy()[:, None]
                   - sub["lat"].to_numpy()[None, :])
        return scale * d

    for fn in (dist_fn, None):
        ours = terr.dist_weight(df, fn, scale=2.0)
        ref = jerr.dist_weight(df, fn, scale=2.0)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)
    # a frame with a non-default index and the gridbox column renamed
    df2 = df.rename(columns={"grid_idx": "box"}).set_index(
        pd.Index(np.arange(len(df)) * 3))
    np.testing.assert_array_equal(terr.get_weights(df2, "box"),
                                  jerr.get_weights(df2, "box"))
    for o, r in zip(terr.dist_weight(df2, dist_fn, "box"),
                    jerr.dist_weight(df2, dist_fn, "box")):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_gridbox_error_covariance(rng, dtype, rtol):
    df = _frame(rng)
    E = terr.uncorrelated_components(df, obs_sig_map=SIG)
    E = E + terr.correlated_components(
        df, "platform", bias_sig_map={"p1": 0.3, "p2": 0.4, "p3": 0.1})
    W = terr.get_weights(df).astype(dtype)
    ours = terr.gridbox_error_covariance(W, E, device="cpu")
    ref = jerr.gridbox_error_covariance(W, E)
    assert isinstance(ours, torch.Tensor) and ours.dtype == \
        torch.from_numpy(W).dtype
    assert ours.shape == (9, 9)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    np.testing.assert_allclose(ours.numpy(), W @ E.astype(dtype) @ W.T,
                               rtol=rtol, atol=rtol * np.abs(ref).max())
    # tensors stay where they are
    t = terr.gridbox_error_covariance(torch.as_tensor(W), E)
    assert t.device.type == "cpu"
