"""The port's twins of four JAX examples against the JAX scripts' own code
on the same inputs, at small grids, on the CPU.

Each JAX script's ``main`` runs with its module constants cut
(``M_LAT``, ``M_LON``, ``T_TRAIN``, ``N_OBS``, ``N_MEMBERS``,
``N_POINTS``), ``enable_compile_cache`` a no-op, and its stage outputs
captured by wrapping the names it imported (nothing in the JAX package
or the scripts is edited). Its ``jax.random`` draws are replayed into the
twins as ``noise=`` and ``draw=``.

- ``nonstationary_quarter_degree`` on a 10-degree grid (648 cells). The
  script's clip starts at k0 = 1,024, above n: its ``k0`` alone is cut to
  512 (wrapped, in the script and in the twin). Its cube is drawn in f64
  (the sampler's dtype wrapped) so that both packages fit in f64. The
  cube to 1e-8; the fitted lengths by share (>= 95% of lanes within 1%,
  as ``tests/test_torch_workflow.py``); the stages after the fit fed the
  script's fitted fields: the stream operator to 1e-5 and, fed the
  script's factors, truth, field, uncertainty and members to 1e-4 (f32);
  the clip in f64 on both packages' f64 operators to 1e-8, and the f32
  script's clip densified to 1e-3 of max |C| (two f32 eigensolves of the
  same operator, the bound ``chip_smoke.py`` holds two clips to).
- ``nonstationary_65k_lowrank`` on a 10-degree grid: ``k0`` cut to 256.
  The bf16 store's matvec to 1e-4 of max |y| (each package rounds its own
  f32 tile to bf16); the clip in f64 on the script's store densified to
  1e-8, and each package's f32 clip of its own store to 1e-2 of max |C|
  (``BF16_CLIP_TOL``); the ensemble fed the script's factors to 1e-4.
- ``large_ensemble_65k`` on an 11.25-degree grid (512 cells, 16 blocks):
  the field and members to 1e-4 (f32); the covariance blocks of K1's
  contract (on the CPU its plain twin) against the script's
  ``kernel_block`` to ``NUGGET_TOL`` (f64 and f32).
- ``ellipse_1deg_covariance`` at 300 points: the f32 matrix to 1e-5 of
  max |C| against the script's Pallas build (interpret mode), and in f64
  against the JAX kernel on the same inputs to 1e-8.
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

import ellipse_1deg_covariance as jec  # noqa: E402
import large_ensemble_65k as jle  # noqa: E402
import nonstationary_65k_lowrank as jlr  # noqa: E402
import nonstationary_quarter_degree as jqd  # noqa: E402
import torch_ellipse_1deg_covariance as tec  # noqa: E402
import torch_large_ensemble_65k as tle  # noqa: E402
import torch_nonstationary_65k_lowrank as tlr  # noqa: E402
import torch_nonstationary_quarter_degree as tqd  # noqa: E402

import glomargridding_tpu.config as jconfig  # noqa: E402
from glomargridding_tpu.ops import eigsh as jeig  # noqa: E402
from glomargridding_tpu.models.ellipse.covariance import (  # noqa: E402
    ellipse_covariance_operator as jax_operator,
)
from glomargridding_tpu.ops.covariance_tools import (  # noqa: E402
    explained_variance_clip_lowrank as jax_clip,
)
from glomargridding_tpu_torch import convert  # noqa: E402
from glomargridding_tpu_torch.ops.covariance_tools import (  # noqa: E402
    explained_variance_clip_lowrank,
)

torch.set_num_threads(4)
F64_TOL = 1e-8
F32_TOL = 1e-4
CLIP_F32_TOL = 1e-3
# the two packages' bf16 stores differ by ~1e-4 of max |y| (each rounds
# its own f32 tile to bf16 once), which the f32 clip's cut moves to
# 2.9e-3 of max |C| at 648 cells
BF16_CLIP_TOL = 1e-2
FIT_SHARE = 0.95
JDTYPE = {np.float32: jnp.float32, np.float64: jnp.float64}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel(ours, ref, scale=None):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    scale = np.max(np.abs(ref)) if scale is None else scale
    return float(np.max(np.abs(ours.astype(np.float64) - ref)) / scale)


def sampler_noise(key, n, l_max, nugget, cells, dtype, member_batch=64):
    """The JAX sampler's normals of ``draw(key, n)``: the coefficients at
    the count rounded up to `member_batch`, from the two halves of the key
    (after the nugget's split)."""
    k = key
    if nugget > 0:
        k, kn = jax.random.split(key)
    n_eff = member_batch * (-(-n // member_batch))
    kc, ks = jax.random.split(k)
    out = [np.array(jax.random.normal(kk, (n_eff, l_max + 1, l_max + 1),
                                      JDTYPE[dtype]))[:n] for kk in (kc, ks)]
    if nugget > 0:
        out.append(np.array(jax.random.normal(kn, (n, cells),
                                              JDTYPE[dtype])))
    return out


def start_blocks(key, dtype):
    """The eigensolver's start blocks from the JAX key: one split per
    stage of ``adaptive_topk_eigh``."""
    state = {"key": key}

    def draw(shape, torch_dtype):
        state["key"], sub = jax.random.split(state["key"])
        jd = jnp.float64 if torch_dtype == torch.float64 else jnp.float32
        return torch.from_numpy(np.array(jax.random.normal(sub, shape, jd)))

    return draw


def psd_noise(key, n, r, dtype=jnp.float32):
    """``LowRankPSD.draw(key, 1)``'s normals."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.normal(k1, (n, 1), dtype)),
            np.array(jax.random.normal(k2, (r, 1), dtype)))


def ensemble_noise(key, n, r, m, members, dtype=jnp.float32):
    """``lowrank_ensemble_step``'s three draws, in its order."""
    k_state, k_obs = jax.random.split(key)
    k1, k2 = jax.random.split(k_state)
    return tuple(np.array(jax.random.normal(k, shape, dtype)) for k, shape in (
        (k1, (n, members)), (k2, (r, members)), (k_obs, (m, members))))


def lowrank_from_jax(jpsd):
    return convert.lowrank_psd_from_arrays(
        np.asarray(jpsd.vectors), np.asarray(jpsd.gains),
        np.asarray(jpsd.floor), device="cpu")


def _set(mp, modules, **values):
    for module in modules:
        for name, value in values.items():
            mp.setattr(module, name, value)


def _captured_main(mp, module, tmp_path, clip_k0=None):
    """Run `module.main()` with its stage outputs captured: the cube, the
    fit, the operator, the clip (`clip_k0` cut), the ensemble calls and
    the saved arrays."""
    cap = {"ensembles": []}
    mp.setattr(jconfig, "enable_compile_cache", lambda *a, **k: None)
    # the locked widening the script takes at its own size (n >= 200,000);
    # the port has no other
    mp.setattr(jeig, "_LOCK_MIN_N", 0)
    mp.setenv("GLOMAR_MLE_CHECKPOINT", str(tmp_path / "mle.npz"))
    mp.setenv("GLOMAR_SAVE_OUTPUTS", str(tmp_path / "out"))
    mp.setattr(module, "save_outputs", lambda out_dir, **a: cap.update(
        saved=a))

    def operator(*args, **kwargs):
        cap["operator"] = module_op(*args, **kwargs)
        return cap["operator"]

    module_op = module.ellipse_covariance_operator
    mp.setattr(module, "ellipse_covariance_operator", operator)

    def clip(*args, **kwargs):
        # f32, as the script runs without x64 (with x64 a callable's
        # solve defaults to f64)
        kwargs = {**kwargs, "dtype": jnp.float32}
        if clip_k0 is not None:
            kwargs["k0"] = clip_k0
        cap["clip_kwargs"] = kwargs
        cap["psd"] = jax_clip(*args, **kwargs)
        return cap["psd"]

    mp.setattr(module, "explained_variance_clip_lowrank", clip)
    module_ens = module.lowrank_ensemble_step

    def ens(*args, **kwargs):
        out = module_ens(*args, **kwargs)
        cap["ensembles"].append(out)
        return out

    mp.setattr(module, "lowrank_ensemble_step", ens)
    return cap


# ---------------------------------------------------------------------------
# nonstationary_quarter_degree
# ---------------------------------------------------------------------------
QD = dict(M_LAT=18, M_LON=36, T_TRAIN=60, N_OBS=60, N_MEMBERS=8)
QD_K0 = 512


@pytest.fixture(scope="module")
def quarter(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quarter")
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (jqd, tqd), **QD)
        cap = _captured_main(mp, jqd, tmp, clip_k0=QD_K0)
        sampler_cls = jqd.SphericalHarmonicSampler

        class Sampler(sampler_cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, dtype=jnp.float64, **kwargs)

            def draw(self, key, n):
                out = super().draw(key, n)
                cap.setdefault("cube", np.asarray(out))
                return out

        builder_cls = jqd.EllipseBuilder

        class Builder(builder_cls):
            def compute_params(self, *args, **kwargs):
                cap["fit_kwargs"] = kwargs
                cap["params"] = super().compute_params(*args, **kwargs)
                return cap["params"]

        mp.setattr(jqd, "SphericalHarmonicSampler", Sampler)
        mp.setattr(jqd, "EllipseBuilder", Builder)
        jqd.main()
        yield cap


def _qd_fields(params):
    return {k: np.asarray(params[k].values) for k in (
        "Lx", "Ly", "theta", "standard_deviation", "qc_code")}


def test_quarter_degree_cube_and_fit(quarter, tmp_path):
    lat, lon, _, _ = tqd.axes()
    cells = lat.size * lon.size
    assert cells == 648
    noise = sampler_noise(jax.random.key(0), QD["T_TRAIN"], tqd.L_MAX,
                          tqd.NUGGET, cells, np.float64)
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (tqd,), **QD)
        sampler = tqd.training_sampler(lat, lon, torch.float64, "cpu")
        cube = tqd.training_cube(sampler, noise)
        assert _rel(cube.reshape(QD["T_TRAIN"], -1), quarter["cube"]) <= \
            F64_TOL
        # the script's fit arguments, apart from the chunk size
        kw = quarter["fit_kwargs"]
        for name in ("max_distance", "tol", "max_train_cols", "guesses"):
            assert tqd.FIT_KW[name] == kw[name]
        params = tqd.fit_ellipses(tqd.correlation(cube, lat, lon),
                                  checkpoint=str(tmp_path / "fit.npz"))
        resumed = tqd.fit_ellipses(tqd.correlation(cube, lat, lon),
                                   checkpoint=str(tmp_path / "fit.npz"))
    ours, ref = _qd_fields(params), _qd_fields(quarter["params"])
    for name in ("Lx", "Ly"):
        fitted = ref[name] > 0
        assert np.array_equal(ours[name] > 0, fitted)
        share = np.mean(np.abs(ours[name][fitted] / ref[name][fitted] - 1)
                        <= 0.01)
        assert share >= FIT_SHARE, (name, share)
    assert np.array_equal(ours["standard_deviation"],
                          ref["standard_deviation"]) or _rel(
        ours["standard_deviation"], ref["standard_deviation"]) <= F64_TOL
    for name, values in _qd_fields(resumed).items():
        np.testing.assert_array_equal(values, ours[name])


def test_quarter_degree_after_the_fit(quarter):
    """The stages after the fit, fed the script's fitted fields."""
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (tqd,), **QD)
        mp.setitem(tqd.CLIP_KW, "k0", QD_K0)
        _, _, glat, glon = tqd.axes()
        fields, n_fit = tqd.fitted_fields(quarter["params"])
        assert n_fit == int(np.sum(fields["Lx"] > 0))
        np.testing.assert_array_equal(fields["Lx"], quarter["saved"]["Lx"])
        max_dist = tqd.max_dist_km()
        assert max_dist == 3000.0
        mv, n, trace = tqd.stream_operator(glat, glon, fields, max_dist,
                                           "cpu")
        jmv, jn, jtrace = quarter["operator"]
        assert n == jn and trace == pytest.approx(float(jtrace), rel=1e-6)
        x = np.random.default_rng(1).normal(size=(n, 9)).astype(np.float32)
        for cols in (slice(0, 8), slice(0, 9)):
            assert _rel(mv(torch.from_numpy(x[:, cols])),
                        jmv(jnp.asarray(x[:, cols]))) <= 1e-5

        mp.setattr(jeig, "_LOCK_MIN_N", 0)
        _quarter_degree_clip_f64(glat, glon, fields, n, max_dist)

        # the f32 script's clip, densified
        psd, true_rank = tqd.psd_repair(
            mv, n, trace, draw=start_blocks(jax.random.key(1), np.float32),
            device="cpu")
        jpsd = quarter["psd"]
        assert quarter["clip_kwargs"]["k0"] == QD_K0
        assert psd.rank % tqd.PAD_RANK == 0
        assert _rel(psd.to_dense(), jpsd.to_dense()) <= CLIP_F32_TOL

        _quarter_degree_ensembles(quarter, jpsd, n)


def _quarter_degree_clip_f64(glat, glon, fields, n, max_dist):
    """The clip in f64, both packages on one f64 matrix: the JAX operator
    of the fitted fields in f64, densified (the two packages' f64
    operators differ by their f32 diagonal term, and the Ritz vectors at
    the cut move with that)."""
    inputs64 = tqd.stream_inputs(glat, glon, fields, torch.float64, "cpu")
    jmv64, _, _ = jax_operator(
        *(jnp.asarray(_np(a)) for a in inputs64), v=1.5,
        store="stream", max_dist=max_dist)
    A = np.asarray(jmv64(jnp.eye(n, dtype=jnp.float64)))
    A = 0.5 * (A + A.T)
    trace64 = float(np.trace(A))
    At = torch.from_numpy(A)
    kw = dict(tqd.CLIP_KW)
    ours64 = explained_variance_clip_lowrank(
        lambda X: At @ torch.as_tensor(X, dtype=At.dtype), n=n,
        trace=trace64, draw=start_blocks(jax.random.key(1), np.float64),
        dtype=torch.float64, device="cpu", **kw)
    ref64 = jax_clip(lambda X: jnp.asarray(A) @ X, n=n, trace=trace64,
                     key=jax.random.key(1), **kw)
    assert ours64.effective_rank == int(np.sum(np.asarray(
        ref64.gains) > 0))
    assert _rel(ours64.to_dense(), ref64.to_dense()) <= F64_TOL


def _quarter_degree_ensembles(quarter, jpsd, n):
    """Truth, kriging and members, fed the script's factors."""
    jpad = jpsd.pad_rank(tqd.PAD_RANK)
    tpsd = lowrank_from_jax(jpad)
    r = tpsd.rank
    idx, truth, y, E = tqd.observations(
        tpsd, noise=psd_noise(jax.random.key(2), n, r))
    saved = quarter["saved"]
    assert _rel(truth, saved["truth"]) <= F32_TOL
    m = QD["N_OBS"]
    for k, (jres, jmem) in zip((3, 4), quarter["ensembles"]):
        res, members = tqd.ensemble(tpsd, idx, y, E, noise=ensemble_noise(
            jax.random.key(k), n, r, m, QD["N_MEMBERS"]))
        for a, b in zip(res, jres):
            assert _rel(a, b) <= F32_TOL
        assert _rel(members, jmem) <= F32_TOL
    assert _rel(res.field, saved["field"]) <= F32_TOL
    assert _rel(members[0], saved["member0"]) <= F32_TOL


def test_quarter_degree_run_on_replayed_draws(quarter, tmp_path):
    """``run`` end to end from the script's fitted fields and draws: the
    same numbers as its stage functions, which the tests above hold."""
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (tqd,), **QD)
        mp.setitem(tqd.CLIP_KW, "k0", QD_K0)
        mp.setenv("GLOMAR_MAX_DIST_KM", "3000")
        out = tqd.run(device="cpu", ellipse_params=quarter["params"],
                      draw=start_blocks(jax.random.key(1), np.float32),
                      generator=torch.Generator().manual_seed(0),
                      verbose=False, checkpoint=str(tmp_path / "x.npz"))
    assert out["trace_rel"] <= 1e-5
    assert set(out["times"]) >= {"kriging + members (warm)"}
    assert out["members"].shape == (QD["N_MEMBERS"], 648)
    for name in ("rmse", "spread", "uncertainty"):
        assert np.isfinite(out[name]) and out[name] > 0
    assert _rel(out["psd"].to_dense(), quarter["psd"].to_dense()) <= \
        CLIP_F32_TOL


def test_quarter_degree_max_dist_env(monkeypatch):
    for value, want in (("", None), ("0", None), ("-5", None),
                        ("2500", 2500.0)):
        monkeypatch.setenv("GLOMAR_MAX_DIST_KM", value)
        assert tqd.max_dist_km() == want
    monkeypatch.delenv("GLOMAR_MAX_DIST_KM")
    assert tqd.max_dist_km() == 3000.0
    monkeypatch.delenv("GLOMAR_MLE_CHECKPOINT", raising=False)
    assert tqd.checkpoint_path().endswith("glomar_quarter_deg_mle.npz")
    monkeypatch.setenv("GLOMAR_MLE_CHECKPOINT", "elsewhere.npz")
    assert tqd.checkpoint_path() == "elsewhere.npz"


def test_fitted_fields_median_fallback():
    lx = np.array([[2000.0, -999.9], [1500.0, 1000.0]])
    params = {"Lx": lx, "Ly": lx / 2, "theta": np.zeros((2, 2)),
              "standard_deviation": np.ones((2, 2)),
              "qc_code": np.array([[0, -1], [9, 0]])}
    fields, n_fit = tqd.fitted_fields(params)
    assert n_fit == 2
    np.testing.assert_array_equal(fields["Lx"], [2000.0, 1500.0, 1500.0,
                                                 1000.0])


# ---------------------------------------------------------------------------
# nonstationary_65k_lowrank
# ---------------------------------------------------------------------------
LR = dict(M_LAT=18, M_LON=36, N_OBS=60, N_MEMBERS=8)
LR_K0 = 256


@pytest.fixture(scope="module")
def lowrank65(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lowrank65")
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (jlr, tlr), **LR)
        cap = _captured_main(mp, jlr, tmp, clip_k0=LR_K0)
        jlr.main()
        yield cap


def test_lowrank_65k_against_the_script(lowrank65):
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (tlr,), **LR)
        mp.setitem(tlr.CLIP_KW, "k0", LR_K0)
        glat, glon = tlr.grid()
        mv, n, trace = tlr.bf16_operator(glat, glon,
                                         tlr.ellipse_fields(glat), "cpu")
        jmv, jn, jtrace = lowrank65["operator"]
        assert n == jn == 648
        assert trace == pytest.approx(float(jtrace), rel=1e-6)
        x = np.random.default_rng(2).normal(size=(n, 5)).astype(np.float32)
        assert _rel(mv(torch.from_numpy(x)), jmv(jnp.asarray(x))) <= F32_TOL
        # the clip in f64, both packages on the script's store densified
        A = np.asarray(jmv(jnp.eye(n, dtype=jnp.float32)), np.float64)
        At, kw = torch.from_numpy(A), dict(tlr.CLIP_KW)
        ours64 = explained_variance_clip_lowrank(
            lambda X: At @ torch.as_tensor(X, dtype=At.dtype), n=n,
            trace=float(jtrace), draw=start_blocks(jax.random.key(1),
                                                   np.float64),
            dtype=torch.float64, device="cpu", **kw)
        ref64 = jax_clip(lambda X: jnp.asarray(A) @ X, n=n,
                         trace=float(jtrace), key=jax.random.key(1), **kw)
        assert _rel(ours64.to_dense(), ref64.to_dense()) <= F64_TOL
        # the f32 clip of each package's own store
        psd, _ = tlr.psd_repair(mv, n, trace, draw=start_blocks(
            jax.random.key(1), np.float32), device="cpu")
        jpsd = lowrank65["psd"]
        assert _rel(psd.to_dense(), jpsd.to_dense()) <= BF16_CLIP_TOL
        tpsd = lowrank_from_jax(jpsd.pad_rank(tlr.PAD_RANK))
        r = tpsd.rank
        idx, truth, y, E = tlr.observations(
            tpsd, noise=psd_noise(jax.random.key(2), n, r))
        saved = lowrank65["saved"]
        assert _rel(truth, saved["truth"]) <= F32_TOL
        for k, (jres, jmem) in zip((3, 4), lowrank65["ensembles"]):
            res, members = tlr.ensemble(tpsd, idx, y, E, noise=ensemble_noise(
                jax.random.key(k), n, r, LR["N_OBS"], LR["N_MEMBERS"]))
            for a, b in zip(res, jres):
                assert _rel(a, b) <= F32_TOL
            assert _rel(members, jmem) <= F32_TOL
        assert _rel(res.uncertainty, saved["uncertainty"]) <= F32_TOL
        out = tlr.run(device="cpu", draw=start_blocks(jax.random.key(1),
                                                      np.float32),
                      verbose=False)
    assert out["trace_rel"] <= 1e-5
    assert _rel(out["psd"].to_dense(), jpsd.to_dense()) <= BF16_CLIP_TOL
    assert out["members"].shape == (LR["N_MEMBERS"], n)


# ---------------------------------------------------------------------------
# large_ensemble_65k
# ---------------------------------------------------------------------------
LE = dict(M_LAT=16, M_LON=32, N_OBS=50, N_MEMBERS=8)


@pytest.fixture(scope="module")
def large_ensemble():
    cap = []
    ready = jax.block_until_ready

    def record(x):
        cap.append(x)
        return ready(x)

    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (jle, tle), **LE)
        mp.setattr(jconfig, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(jax, "block_until_ready", record)
        jle.main()
    # the script syncs on (field, members) after each of its two calls
    return [x for x in cap if isinstance(x, tuple) and len(x) == 2]


def test_large_ensemble_against_the_script(large_ensemble):
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (tle,), **LE)
        lat, lon = tle.grid()
        sampler = tle.state_sampler(lat, lon, torch.float32, "cpu")
        k_state, k_obs = jax.random.split(jax.random.key(0))
        noise = {
            "states": sampler_noise(k_state, LE["N_MEMBERS"], sampler.l_max,
                                    tle.NUGGET, lat.size * lon.size,
                                    np.float32),
            "obs": np.array(jax.random.normal(
                k_obs, (LE["N_OBS"], LE["N_MEMBERS"]), jnp.float32)),
        }
        noise = {k: (torch.from_numpy(v) if not isinstance(v, list) else
                     [torch.from_numpy(a) for a in v])
                 for k, v in noise.items()}
        out = tle.run(device="cpu", noise=noise, verbose=False)
    assert len(large_ensemble) == 4  # two calls, two syncs each
    for field, members in large_ensemble:
        assert _rel(out["field"], field) <= F32_TOL
        assert _rel(out["members"], members) <= F32_TOL
    assert out["draws_per_s"] > 0 and np.isfinite(out["spread_mean"])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_large_ensemble_blocks_meet_kernel_block(dtype):
    """K1's contract plus the nugget at coinciding cells against the
    script's kernel_block (full arcsin)."""
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (tle,), **LE)
        lat, lon = tle.grid()
        la, lo = tle.cells(lat, lon, dtype, "cpu")
        idx, _, _ = tle.observations(la.shape[0])
    idx_t = torch.as_tensor(idx)
    width = la.shape[0] // tle.N_BLOCKS
    for b0 in (0, 7 * width):
        cols = slice(b0, b0 + width)
        inside = (idx_t >= b0) & (idx_t < b0 + width)
        rows = torch.arange(idx_t.numel())
        got = tle.kernel_block(la[idx_t], lo[idx_t], la[cols], lo[cols],
                               (rows[inside], idx_t[inside] - b0))
        jd = jnp.float64 if dtype == torch.float64 else jnp.float32
        want = jle.kernel_block(*(jnp.asarray(_np(a), jd) for a in (
            la[idx_t], lo[idx_t], la[cols], lo[cols])))
        assert _rel(got, want, tle.PSILL) <= tle.NUGGET_TOL[dtype]
        assert int(inside.sum()) > 0
    # without the nugget the block misses the script's by NUGGET / PSILL
    plain = tle.covariance_block(la[idx_t], lo[idx_t], la[:width],
                                 lo[:width])
    want = jle.kernel_block(*(jnp.asarray(_np(a)) for a in (
        la[idx_t], lo[idx_t], la[:width], lo[:width])))
    assert _rel(plain, want, tle.PSILL) > tle.NUGGET_TOL[dtype]


# ---------------------------------------------------------------------------
# ellipse_1deg_covariance
# ---------------------------------------------------------------------------
EC_POINTS = 300


@pytest.fixture(scope="module")
def ellipse_builds():
    cap = []
    kernel = jec.ellipse_covariance_pallas

    def record(*args, **kwargs):
        cap.append(kernel(*args, **kwargs))
        return cap[-1]

    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (jec, tec), N_POINTS=EC_POINTS)
        mp.setattr(jconfig, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(jec, "ellipse_covariance_pallas", record)
        jec.main()
        yield cap


def test_ellipse_covariance_against_the_script(ellipse_builds):
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, (tec,), N_POINTS=EC_POINTS)
        out = tec.run(device="cpu", verbose=False)
        lats, lons, fields = tec.points()
        inputs64 = tec.kernel_inputs(lats, lons, fields, torch.float64,
                                     "cpu")
        ours64 = tec.build(inputs64)
    assert len(ellipse_builds) == 2
    for cov in ellipse_builds:
        assert _rel(out["cov"], cov) <= 1e-5
    ref64 = jec.ellipse_covariance_pallas(
        *(jnp.asarray(_np(a)) for a in inputs64), v=tec.NU)
    assert _rel(ours64, ref64) <= F64_TOL
    assert out["eigs"].shape == (min(tec.BLOCK, EC_POINTS),)
    assert out["eigs"].min() > 0


def test_ellipse_covariance_checks_reject_a_bad_matrix():
    stdev = np.full(1000, 0.7)
    block = np.eye(tec.BLOCK)
    tec.check(stdev**2, block, stdev)
    with pytest.raises(AssertionError):
        tec.check(stdev**2 * 1.001, block, stdev)
    block[0, 1] = 1e-5
    with pytest.raises(AssertionError, match="asymmetric"):
        tec.check(stdev**2, block, stdev)
