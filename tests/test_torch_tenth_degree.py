"""The 0.1-degree pipeline's twin (``examples/torch_nonstationary_tenth_
degree.py``) against the JAX script (``examples/nonstationary_tenth_
degree.py``) at its ``--small`` arguments, on the CPU.

The JAX script's ``main`` runs with ``--small``'s constants (the 2-degree
grid, 16,200 cells, 500 observations), its stage outputs captured by
wrapping the names it imported (nothing of the JAX package or the script
is edited). Under the tests' x64 its clip's ``dtype=None`` means f64,
but the f32 image of its f32 operator would carry the solve back to f32:
the wrapped clip casts the operator's image to f64, so that the script's
repair, factors and ensemble run in f64, and the twin's run in f64 too
(``dtype=``); the operator stays f32 in both, as the script builds it.
Its keyed draws are replayed into the twin (``draw=``, ``noise=``). The
twin's stream runs in 16 row blocks, so that a CPU tile stays near 25 MB
(one block would be 1.06 GB).

Bounds: the fields and the demonstration block bitwise; the band plan
(``col_starts``, ``bw``) equal to the reference's ``_stream_band_plan``
at the same blocks; the W = 64 application 1e-5 of max |y| in f32 and,
both packages' operators built in f64, 1e-10; the clip's rank, retained
fraction (1e-6) and trace (1e-6); the members on replayed normals fed
the script's factors 1e-8, and from the twin's own clip 1e-6.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eigsh import reference_draws

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)

import nonstationary_tenth_degree as jte  # noqa: E402
import torch_nonstationary_tenth_degree as tte  # noqa: E402
from test_torch_examples import (  # noqa: E402
    _rel,
    ensemble_noise,
    lowrank_from_jax,
    psd_noise,
)

from glomargridding_tpu.models.ellipse import covariance as jcov  # noqa: E402
from glomargridding_tpu_torch.models.ellipse.covariance import (  # noqa: E402
    _stream_band_plan,
)



@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads, whatever another test file set: the suite's
    workers share the cores, and wider pools wait on each other."""
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)

SMALL = dict(M_LAT=90, M_LON=180, N_OBS=500)
N_BLOCKS = 16
F64_TOL = 1e-10
F32_TOL = 1e-5
CLIP_TOL = 1e-6
MEMBERS_TOL = 1e-8


def _dense_sub(psd, step=7):
    """The factored covariance on every `step`-th cell, f64 numpy."""
    V = np.asarray(psd.vectors, np.float64)[::step]
    g = np.asarray(psd.gains, np.float64)
    return (V * g) @ V.T + np.diag(np.asarray(psd.floor, np.float64)[::step])


@pytest.fixture(scope="module")
def script():
    """The JAX script's main() at --small, its stages captured."""
    cap = {"ensembles": []}
    with pytest.MonkeyPatch.context() as mp:
        for module in (jte, tte):
            for name, value in SMALL.items():
                mp.setattr(module, name, value)
        mp.setattr(jte, "enable_compile_cache", lambda *a, **k: None)
        mp.delenv("GLOMAR_SAVE_OUTPUTS", raising=False)
        mp.delenv("GLOMAR_TENTH_RANK", raising=False)
        fields_fn = jte.heterogeneous_ellipse_fields
        mp.setattr(jte, "heterogeneous_ellipse_fields", lambda *a, **k: cap
                   .setdefault("fields", tuple(fields_fn(*a, **k))))
        operator_fn = jte.ellipse_covariance_operator

        def operator(*args, **kwargs):
            mv, n, trace = operator_fn(*args, **kwargs)
            cap.update(operator=(mv, n, trace), operator_kwargs=kwargs)

            def first(x):
                y = mv(x)
                cap.setdefault("demo", (np.asarray(x), np.asarray(y)))
                return y

            first.band_stats = mv.band_stats
            return first, n, trace

        mp.setattr(jte, "ellipse_covariance_operator", operator)
        clip_fn = jte.explained_variance_clip_lowrank

        def clip(operator, **kwargs):
            # the solve in f64, as dtype=None asks under x64: the
            # operator's f32 image cast back to the start block's f64
            cap.update(clip_kwargs=kwargs)
            cap["psd"] = clip_fn(
                lambda x: operator(x).astype(jnp.float64),
                dtype=jnp.float64, **kwargs)
            return cap["psd"]

        mp.setattr(jte, "explained_variance_clip_lowrank", clip)
        ens_fn = jte.lowrank_ensemble_step

        def ens(*args, **kwargs):
            out = ens_fn(*args, **kwargs)
            cap["ensembles"].append((args, out))
            return out

        mp.setattr(jte, "lowrank_ensemble_step", ens)
        jte.main()
    return cap


@pytest.fixture(scope="module")
def twin(script):
    """The twin's run() in f64 on the script's replayed draws."""
    jpsd = script["psd"]
    n, r = jpsd.vectors.shape
    noise = {
        "truth": psd_noise(jax.random.key(2), n, r, jnp.float64),
        "members": ensemble_noise(jax.random.key(3), n, r, SMALL["N_OBS"],
                                  tte.N_MEMBERS, jnp.float64),
        "members_warm": ensemble_noise(jax.random.key(4), n, r,
                                       SMALL["N_OBS"], tte.N_MEMBERS,
                                       jnp.float64),
    }
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(tte, name, value)
        mp.delenv("GLOMAR_TENTH_RANK", raising=False)
        out = tte.run(device="cpu", dtype=torch.float64, noise=noise,
                      draw=reference_draws(jax.random.key(1)),
                      n_blocks=N_BLOCKS, verbose=False)
    return out, noise


def test_fields_band_plan_and_demonstration(script, twin):
    out, _ = twin
    for ours, ref in zip(out["fields"], script["fields"]):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    X, Y = out["demo"]
    jX, jY = script["demo"]
    np.testing.assert_array_equal(X.numpy(), jX)
    assert _rel(Y, jY) <= F32_TOL
    assert script["operator_kwargs"]["max_dist"] == tte.MAX_DIST_KM

    stats = out["band_stats"]
    n = X.shape[0]
    assert n == 16_200 and stats["banded"] and stats["n_cols"] == n
    block = stats["block"]
    assert block == -(-(-(-n // N_BLOCKS)) // 64) * 64
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(tte, name, value)
        glat, _ = tte.grid()
    lat = np.radians(glat.astype(np.float32)).astype(np.float64)
    n_rb = -(-n // block)
    lat_pad = np.pad(lat, (0, n_rb * block - n), mode="edge")
    starts, bw, hi = jcov._stream_band_plan(lat_pad, lat, n, block, 3000.0,
                                            64, 64)
    np.testing.assert_array_equal(stats["col_starts"], starts)
    assert stats["bw"] == bw
    ours = _stream_band_plan(lat_pad, lat, n, block, 3000.0, 64, 64)
    np.testing.assert_array_equal(ours[2], hi)
    assert stats["wide_pairs"] == sum(
        (min(r0 + block, n) - r0) * (min(int(c) + bw, n) - int(c))
        for r0, c in zip(range(0, n, block), starts))


def test_w64_application_in_f64(script, twin):
    """The twin's operator built in f64 on the script's fields, against
    the reference's jnp tile in f64 over every column plus the f64
    diagonal term (the stream's diagonal is in its own dtype), on three
    slabs of 512 rows. (The reference's stream operator keeps its tiles
    and its diagonal in f32: 2.9e-8 of max |y| from that tile in f64.)"""
    out, _ = twin
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(tte, name, value)
        glat, glon = tte.grid()
        mv, n, trace = tte.stream_operator(
            glat, glon, out["fields"], N_BLOCKS, torch.float64, device="cpu")
    inputs = [jnp.asarray(a.numpy()) for a in tte.operator_inputs(
        glat, glon, out["fields"], torch.float64, "cpu")]
    _, jn, jtrace = script["operator"]
    X = out["demo"][0].double().numpy()
    diag = np.asarray(inputs[4], np.float64) ** 2
    got = mv(torch.from_numpy(X)).numpy()
    # rows at the south pole, the equator (a row block starting at
    # -179 degrees) and the north pole, over every column
    for r0 in (0, n // 2 - 90, n - 512):
        rows = [a[r0:r0 + 512] for a in inputs]
        want = diag[r0:r0 + 512, None] * X[r0:r0 + 512] + np.asarray(
            jcov.ellipse_covariance_block(
                *rows, *inputs, v=1.5, max_dist=tte.MAX_DIST_KM,
                use_max_dist=True)) @ X
        assert _rel(got[r0:r0 + 512], want) <= F64_TOL
    # the trace is the sum of the diagonal: f64 here, f32 in the reference
    assert n == jn and trace == pytest.approx(float(jtrace), rel=1e-6)


def test_clip_rank_retained_and_trace(script, twin):
    out, _ = twin
    jpsd = script["psd"]
    _, _, trace = script["operator"]
    kw = script["clip_kwargs"]
    assert (kw["k0"], kw["max_rank"], kw["oversample"], kw["n_iter"],
            kw["rank_multiple"]) == (88, 88, 8, 2, 8)
    assert kw["target_variance_fraction"] == tte.TARGET
    psd = out["psd"]
    assert psd.vectors.dtype == torch.float64
    assert psd.rank == jpsd.rank == 24
    retained = float(np.asarray(jpsd.gains).sum()) / trace
    assert out["retained"] == pytest.approx(retained, abs=CLIP_TOL)
    assert out["trace"] == pytest.approx(trace, rel=1e-6)
    assert out["trace_rel"] <= CLIP_TOL
    assert abs(float(jpsd.trace()) - trace) / trace <= CLIP_TOL
    # densified on every 7th cell (the whole matrix is 2.1 GB in f64)
    assert _rel(_dense_sub(psd), _dense_sub(jpsd)) <= CLIP_TOL


def test_members_on_replayed_normals(script, twin):
    out, noise = twin
    (jargs, (jres, jmembers)), (_, (jres_w, jmembers_w)) = script[
        "ensembles"]
    _, idx, y, E, _ = jargs
    np.testing.assert_array_equal(out["idx"].numpy(), idx)
    # fed the script's factors and observations: the ensemble stage alone
    psd = lowrank_from_jax(script["psd"])
    for key, ref_res, ref_members in (("members", jres, jmembers),
                                      ("members_warm", jres_w, jmembers_w)):
        res, members = tte.ensemble(psd, torch.from_numpy(idx),
                                    torch.from_numpy(np.asarray(y)),
                                    torch.from_numpy(np.asarray(E)),
                                    noise=noise[key])
        assert _rel(members, ref_members) <= MEMBERS_TOL
        assert _rel(res.field, ref_res.field) <= MEMBERS_TOL
        assert _rel(res.uncertainty, ref_res.uncertainty) <= MEMBERS_TOL
    # the twin's own run, off its own clip
    assert _rel(out["y"], y) <= CLIP_TOL
    assert _rel(out["members"], jmembers_w) <= CLIP_TOL
    assert _rel(out["result"].field, jres_w.field) <= CLIP_TOL


@pytest.mark.parametrize("centre", [0.0, 70.0])
def test_longitude_certificate(centre):
    """Every row block of a banded stream builds its tile against the
    active column chunks of its window alone (``_active_chunks``): on a
    row of the 0.1-degree grid (3,600 cells) a 64-cell block spans 6.4
    degrees of longitude and keeps under a third of its window at the
    equator, and less than all of it at 70 degrees. Its application in
    f64 meets the reference's jnp tile in f64 over every column (the
    chunks it skips hold only pairs beyond the cutoff), and equals the
    same blocks against their whole windows (``_apply_wide`` without
    `chunks`) to roundoff in f64 and f32. The first block starts at
    -179.95 degrees, and its chunks across the antimeridian are kept."""
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov
    from glomargridding_tpu_torch.ops.cuda.ellipse import pack_points

    lat = np.array([centre], np.float32)
    lon = np.linspace(-179.95, 179.95, 3600).astype(np.float32)
    glat, glon = np.repeat(lat, lon.size), np.tile(lon, lat.size)
    n = glat.size
    fields = tte.heterogeneous_ellipse_fields(glat, glon)
    X = np.random.default_rng(3).normal(size=(n, 9))
    out = {}
    for dtype in (torch.float64, torch.float32):
        mv = tte.stream_operator(glat, glon, fields, -(-n // 64), dtype,
                                 device="cpu")[0]
        inputs = tte.operator_inputs(glat, glon, fields, dtype, "cpu")
        P = pack_points(*inputs)
        x = torch.from_numpy(X).to(dtype)
        lat_rad = P[:, 0].double().numpy()
        windows = tcov.stream_plan(lat_rad, lat_rad, 64,
                                   tte.MAX_DIST_KM)[0]
        whole = tcov._apply_wide(P, x, windows, 1.5, "Modified_Met_Office",
                                 tte.MAX_DIST_KM)
        # the stream's diagonal is the variance in its own dtype
        out[dtype] = (mv.band_stats, mv(x),
                      whole + (P[:, 6] ** 2)[:, None] * x, inputs)
    stats, y64, whole64, inputs = out[torch.float64]
    assert stats["block"] == 64
    assert stats["kept_pairs"] < stats["wide_pairs"] / (
        3 if centre == 0.0 else 1)
    # the reference's tile in f64 over every column, plus the f64
    # diagonal term
    jin = [jnp.asarray(a.numpy()) for a in inputs]
    want = np.asarray(inputs[4], np.float64)[:, None] ** 2 * X + np.asarray(
        jcov.ellipse_covariance_block(*jin, *jin, v=1.5,
                                      max_dist=tte.MAX_DIST_KM,
                                      use_max_dist=True)) @ X
    assert _rel(y64, want) <= F64_TOL
    assert _rel(y64, whole64) <= 1e-13
    assert _rel(out[torch.float32][1], out[torch.float32][2]) <= F32_TOL
    # the block at -179.95 keeps the chunks at the far end of its row
    ptr, ids = tcov._active_chunks(
        pack_points(*inputs), tcov.stream_plan(
            inputs[0].numpy(), inputs[0].numpy(), 64, tte.MAX_DIST_KM)[0],
        stats["bw"], tte.MAX_DIST_KM)
    first = set(ids[ptr[0]:ptr[1]].tolist())
    assert float(glon[0]) == pytest.approx(-179.95)
    assert 0 in first and (n - 1) // 64 in first
    assert len(first) < -(-n // 64)
