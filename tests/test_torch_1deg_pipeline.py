"""The 1-degree pipeline's twin (``examples/torch_nonstationary_1deg_
pipeline.py``) against the JAX script (``examples/nonstationary_1deg_
pipeline.py``) at ``--small`` (the 4-degree grid, 2,780 ocean cells), on
the CPU.

The JAX script's ``main(small=True)`` runs with its stage outputs
captured by wrapping the names it imported (nothing of the JAX package or
the script is edited); its sampler draws in f64 (the sampler's dtype
wrapped), so that both packages' cubes and truths compare in f64; its
keyed draws are replayed into the twin (``noise=``, ``draw=``).

The whole-grid fit is the one stage cut: at the script's arguments the
JAX fit takes ~36 s here and the port's f32 fit ~12 min on four threads,
so both fit with ``max_train_cols`` cut to 128 (the script's own 4,096
is recorded), the twin's fit on the script's cube, compared by share;
the twin's stages after the fit take the script's fitted fields.

Bounds: the mask and the grid exactly; the cube and the correlation 1e-8
(f64); the assembled covariance 1e-5 of max |C| (f32, K2's plain twin
against the script's Pallas kernel in interpret mode); the f32 clips of
that matrix, densified, 1e-3 of max |C| (two f32 eigensolves, the bound
``chip_smoke.py`` holds two clips to); the truth 1e-8; the kriging and
members fed the script's factors 1e-4 (f32); the fit by share (>= 95% of
lanes within 1% on the lengths).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)

import nonstationary_1deg_pipeline as jpp  # noqa: E402
import torch_nonstationary_1deg_pipeline as tpp  # noqa: E402
from test_torch_examples import (  # noqa: E402
    _rel,
    ensemble_noise,
    lowrank_from_jax,
    sampler_noise,
    start_blocks,
)

import glomargridding_tpu.config as jconfig  # noqa: E402



@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads, whatever another test file set: the suite's
    workers share the cores, and wider pools wait on each other."""
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)

F64_TOL = 1e-8
F32_TOL = 1e-4
COV_TOL = 1e-5
CLIP_F32_TOL = 1e-3
FIT_SHARE = 0.95
FIT_COLS = 128


@pytest.fixture(scope="module")
def script():
    """The JAX script's main(small=True), its stages captured."""
    cap = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "enable_compile_cache", lambda *a, **k: None)
        sampler_cls = jpp.SphericalHarmonicSampler

        class Sampler(sampler_cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, dtype=jnp.float64, **kwargs)
                cap["sampler"] = self

            def draw(self, key, n):
                out = super().draw(key, n)
                cap.setdefault("draws", []).append(np.asarray(out))
                return out

        builder_cls = jpp.EllipseBuilder

        class Builder(builder_cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                cap["builder"] = self

            def compute_params(self, *args, **kwargs):
                cap["fit_kwargs"] = dict(kwargs)
                cap["params"] = super().compute_params(
                    *args, **{**kwargs, "max_train_cols": FIT_COLS})
                return cap["params"]

        cov_cls = jpp.EllipseCovarianceBuilder

        class CovBuilder(cov_cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                cap["cov"] = np.asarray(self.cov_ns)

        clip_fn = jpp.explained_variance_clip_lowrank
        mp.setattr(jpp, "explained_variance_clip_lowrank",
                   lambda *a, **k: cap.update(clip_kwargs=k) or cap
                   .setdefault("psd", clip_fn(*a, **k)))
        ens_fn = jpp.lowrank_ensemble_step
        mp.setattr(jpp, "lowrank_ensemble_step",
                   lambda *a, **k: cap.update(ens_args=a) or cap
                   .setdefault("ensemble", ens_fn(*a, **k)))
        for name, cls in (("SphericalHarmonicSampler", Sampler),
                          ("EllipseBuilder", Builder),
                          ("EllipseCovarianceBuilder", CovBuilder)):
            mp.setattr(jpp, name, cls)
        jpp.main(small=True)
    return cap


def test_grid_cube_and_correlation(script):
    lats, lons = tpp.axes(small=True)
    mask = tpp.ocean_mask(lats, lons)
    np.testing.assert_array_equal(mask, jpp.ocean_mask(lats, lons))
    assert int((~mask).sum()) == 2780
    cells = lats.size * lons.size
    noise = sampler_noise(jax.random.key(0), tpp.T_TRAIN, tpp.L_MAX,
                          tpp.NUGGET, cells, np.float64)
    sampler = tpp.training_sampler(lats, lons, torch.float64, "cpu")
    cube = tpp.training_cube(sampler, mask, noise=noise)
    assert _rel(cube.reshape(tpp.T_TRAIN, -1)[:, ~mask.ravel()],
                script["draws"][0][:, ~mask.ravel()]) <= F64_TOL
    assert bool(torch.isnan(cube[:, mask]).all())
    builder = tpp.correlation(cube, lats, lons)
    assert _rel(builder.cor, np.asarray(script["builder"].cor)) <= F64_TOL


def test_fit_arguments_and_the_twins_fit(script):
    """The script's fit arguments, and the twin's fit on the script's cube
    with its columns cut as the script's were, by share."""
    kw = script["fit_kwargs"]
    for name, value in kw.items():
        if name != "matern_ellipse":
            assert tpp.FIT_KW[name] == value, name
    lats, lons = tpp.axes(small=True)
    cube = torch.from_numpy(np.asarray(script["draws"][0])).reshape(
        tpp.T_TRAIN, lats.size, lons.size)
    mask = tpp.ocean_mask(lats, lons)
    cube = torch.where(torch.from_numpy(mask)[None], torch.nan, cube)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tpp.FIT_KW, "max_train_cols", FIT_COLS)
        params = tpp.fit_ellipses(tpp.correlation(cube, lats, lons))
    ref = script["params"]
    ocean = ~mask
    for name in ("Lx", "Ly"):
        ours = np.asarray(params[name].values)[ocean]
        want = np.asarray(ref[name].values)[ocean]
        share = np.mean(np.abs(ours / want - 1.0) <= 0.01)
        assert share >= FIT_SHARE, (name, share)


def test_assembly_clip_and_ensemble(script):
    """The stages after the fit, fed the script's fitted fields."""
    lats, lons = tpp.axes(small=True)
    mask = tpp.ocean_mask(lats, lons)
    left_out, good = tpp.fit_mask(script["params"], mask)
    cov = tpp.assembly(script["params"], left_out, lats, lons, "cpu")
    n = cov.shape[0]
    assert n == int(good.sum() - (good & mask).sum())
    assert _rel(cov, script["cov"]) <= COV_TOL
    kw = script["clip_kwargs"]
    assert (kw["k0"], kw["max_rank"], kw["rank_multiple"]) == (
        512, 1536, 128)
    psd, true_rank, trace_rel = tpp.psd_repair(
        cov, small=True, draw=start_blocks(jax.random.key(1), np.float32))
    jpsd = script["psd"]
    assert trace_rel <= 1e-5 and psd.rank % tpp.PAD_RANK == 0
    assert _rel(psd.to_dense(), jpsd.to_dense()) <= CLIP_F32_TOL

    sampler = tpp.training_sampler(lats, lons, torch.float64, "cpu")
    truth_noise = sampler_noise(jax.random.key(2), 1, tpp.L_MAX, tpp.NUGGET,
                                lats.size * lons.size, np.float64)
    idx, truth, y, E = tpp.observations(sampler, left_out, n,
                                        noise=truth_noise,
                                        dtype=torch.float64)
    _, jidx, jy, jE, _ = script["ens_args"]
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert _rel(truth, script["draws"][1][0][~left_out.ravel()]) <= F64_TOL
    assert _rel(y, jy) <= F32_TOL
    np.testing.assert_array_equal(E.float().numpy(), jE)

    jpad = script["ens_args"][0]
    tpsd = lowrank_from_jax(jpad)
    jres, jmembers = script["ensemble"]
    res, members = tpp.ensemble(
        tpsd, idx, torch.from_numpy(np.asarray(jy)), E.float(),
        noise=ensemble_noise(jax.random.key(3), n, tpsd.rank, idx.numel(),
                             tpp.N_MEMBERS, jnp.asarray(jpad.vectors).dtype))
    for a, b in zip(res, jres):
        assert _rel(a, b) <= F32_TOL
    assert _rel(members, jmembers) <= F32_TOL


def test_run_end_to_end_from_the_fitted_fields(script):
    """``run`` from the script's fitted fields and replayed draws: the
    stages above, in their order."""
    lats, lons = tpp.axes(small=True)
    cells = lats.size * lons.size
    jpsd = script["ens_args"][0]
    n, r = jpsd.vectors.shape
    noise = {
        "cube": sampler_noise(jax.random.key(0), tpp.T_TRAIN, tpp.L_MAX,
                              tpp.NUGGET, cells, np.float32),
        "truth": sampler_noise(jax.random.key(2), 1, tpp.L_MAX, tpp.NUGGET,
                               cells, np.float32),
        "members": ensemble_noise(jax.random.key(3), n, r,
                                  script["ens_args"][1].size,
                                  tpp.N_MEMBERS),
    }
    out = tpp.run(small=True, device="cpu", noise=noise,
                  draw=start_blocks(jax.random.key(1), np.float32),
                  params=script["params"], verbose=False)
    assert out["n_ocean"] == 2780 and out["members"].shape == (
        tpp.N_MEMBERS, n)
    assert out["trace_rel"] <= 1e-5
    assert _rel(out["psd"].to_dense(), jpsd.to_dense()) <= CLIP_F32_TOL
    for name in ("rmse", "spread", "uncertainty"):
        assert np.isfinite(out[name]) and out[name] > 0
