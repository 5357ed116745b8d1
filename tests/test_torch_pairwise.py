"""The covariance tile (K1): its plain PyTorch twin against the JAX tile,
and the host side of its CUDA wrapper and build.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py);
here every tensor lies on the CPU, so the wrapper takes the plain twin.
Tolerance: f64 rtol 1e-10 with an absolute floor of 1e-14 (tile values
are O(1) differences ``variance - gamma``); f32 is stated per test.
"""

import dataclasses
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomargridding_tpu.models import kernel_kriging as jkk
from glomargridding_tpu.ops import variogram as jvario
from glomargridding_tpu.ops.pallas import matern_covariance_pallas
from glomargridding_tpu_torch.convert import kernel_from_params
from glomargridding_tpu_torch.ops.cuda import build
from glomargridding_tpu_torch.ops.cuda import pairwise as tpair
from glomargridding_tpu_torch.utils.profiling import COUNTS

torch.set_num_threads(2)

RTOL, ATOL = 1e-10, 1e-14


def _coords(rng, n, dtype=np.float64):
    la = np.radians(rng.uniform(-89, 89, n)).astype(dtype)
    lo = np.radians(rng.uniform(-180, 180, n)).astype(dtype)
    return la, lo


def _models():
    return [
        jvario.MaternVariogram(psill=1.2, nugget=0.1, range=1500.0, nu=nu,
                               method=m)
        for nu, m in ((0.5, "sklearn"), (1.5, "gstat"), (2.5, "karspeck"),
                      (3.5, "sklearn"))
    ] + [
        jvario.ExponentialVariogram(psill=1.0, nugget=0.05, range=800.0),
        jvario.GaussianVariogram(psill=1.0, nugget=0.05, range=800.0),
        jvario.SphericalVariogram(psill=1.0, nugget=0.05, range=3000.0),
    ]


def _pair(jmodel, distance):
    jkern = jkk.variogram_kernel(jmodel, distance=distance)
    tkern = kernel_from_params(
        dataclasses.asdict(jmodel), jkern.distance, jkern.var, jkern.radius
    )
    return jkern, tkern


@pytest.mark.parametrize("distance", ["haversine", "chordal", "cartesian"])
@pytest.mark.parametrize(
    "jmodel", _models(), ids=lambda v: f"{v._kind}-{getattr(v, 'nu', '')}"
)
def test_tile_matches_reference(rng, jmodel, distance):
    """Cross tile and self tile (the K diagonal) in f64."""
    jkern, tkern = _pair(jmodel, distance)
    la1, lo1 = _coords(rng, 37)
    la2, lo2 = _coords(rng, 29)
    for rows, cols in (((la1, lo1), (la2, lo2)), ((la1, lo1), (la1, lo1))):
        ref = np.asarray(jkern(*map(jnp.asarray, rows + cols)))
        ours = tkern(*map(torch.as_tensor, rows + cols)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_self_pairs_keep_the_asin_poly_offset(rng, dtype):
    """A haversine self-pair has d = 2R asin_poly(0) > 0, so the Matern
    d == 0 branch does not fire on diag(K) in the reference; the port
    must agree exactly there. Cartesian self-pairs have d == 0."""
    jmodel = jvario.MaternVariogram(psill=1.2, nugget=0.1, range=1500.0,
                                    nu=0.5)
    la, lo = _coords(rng, 16, dtype)
    for distance, branch_fires in (("haversine", False), ("cartesian", True)):
        jkern, tkern = _pair(jmodel, distance)
        ref = np.diag(np.asarray(jkern(*map(jnp.asarray, (la, lo, la, lo)))))
        ours = np.diag(tkern(*map(torch.as_tensor, (la, lo, la, lo))).numpy())
        np.testing.assert_array_equal(ours, ref)
        at_zero = dtype(jkern.var) - dtype(0.1)  # variance - nugget
        assert np.all(ours == at_zero) == branch_fires


@pytest.mark.parametrize("distance", ["haversine", "chordal", "cartesian"])
def test_tile_f32(rng, distance):
    """The main path's dtype: f32 against the reference's f32, atol 2e-6
    (~16 ulp of the tile's scale, 1.3)."""
    jmodel = jvario.MaternVariogram(psill=1.2, nugget=0.1, range=1200.0,
                                    nu=0.5)
    jkern, tkern = _pair(jmodel, distance)
    la1, lo1 = _coords(rng, 40, np.float32)
    la2, lo2 = _coords(rng, 33, np.float32)
    args = (la1, lo1, la2, lo2)
    ref = np.asarray(jkern(*map(jnp.asarray, args)))
    ours = tkern(*map(torch.as_tensor, args)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
def test_matern_covariance_cuda_matches_pallas(rng, nu):
    """matern_covariance_cuda (plain twin on CPU) against the Pallas K1 in
    interpret mode, f64: the two contracts (psill*corr vs
    variance - psill*(1 - corr)) differ by rounding only, atol 1e-14."""
    lats1, lons1 = rng.uniform(-80, 80, 40), rng.uniform(-180, 180, 40)
    lats2, lons2 = rng.uniform(-80, 80, 30), rng.uniform(-180, 180, 30)
    ref = np.asarray(
        matern_covariance_pallas(
            jnp.asarray(lats1), jnp.asarray(lons1), jnp.asarray(lats2),
            jnp.asarray(lons2), nu=nu, psill=1.2, range_km=1500.0,
        )
    )
    ours = tpair.matern_covariance_cuda(
        torch.as_tensor(lats1), torch.as_tensor(lons1),
        torch.as_tensor(lats2), torch.as_tensor(lons2),
        nu=nu, psill=1.2, range_km=1500.0,
    ).numpy()
    assert ours.shape == (40, 30)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def _vario():
    from glomargridding_tpu_torch import MaternVariogram

    return MaternVariogram(psill=1.0, range=1000.0, nu=0.5)


def test_wrapper_rejects_bad_arguments():
    ok = torch.zeros(5, dtype=torch.float64)
    v = _vario()
    cases = [
        ((ok, ok, ok, ok), {"distance": "manhattan"}, ValueError),
        ((ok, ok[:4], ok, ok), {}, ValueError),
        ((ok[None], ok[None], ok, ok), {}, ValueError),
        ((ok.long(), ok.long(), ok.long(), ok.long()), {}, TypeError),
        ((ok, ok, ok.float(), ok.float()), {}, TypeError),
        ((ok.numpy(), ok, ok, ok), {}, TypeError),
        ((torch.zeros(10, dtype=torch.float64)[::2], ok, ok, ok), {},
         ValueError),
        ((ok, ok, ok.to("meta"), ok.to("meta")), {}, ValueError),
    ]
    for args, kwargs, exc in cases:
        with pytest.raises(exc):
            tpair.pairwise_covariance(*args, v, **kwargs)


def test_cpu_tensors_never_build_or_launch(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must not trigger a build")

    monkeypatch.setattr(build, "load_library", no_build)
    monkeypatch.setattr(build, "compile_library", no_build)
    before = COUNTS["k1.launches"]
    x = torch.linspace(-1, 1, 7, dtype=torch.float64)
    out = tpair.pairwise_covariance(x, x, x, x, _vario())
    assert out.shape == (7, 7)
    assert COUNTS["k1.launches"] == before


def test_launch_args():
    from glomargridding_tpu_torch import (
        ExponentialVariogram,
        MaternVariogram,
        SphericalVariogram,
    )

    dist, fam, scalars = tpair.launch_args(
        MaternVariogram(psill=1.2, nugget=0.1, range=900.0, nu=2.5,
                        method="karspeck"),
        "chordal", 1.3, 6371.0,
    )
    assert (dist, fam) == (1, 2)
    assert scalars[:5] == (1.2, 0.1, 900.0, 1.3, 6371.0)
    assert scalars[5] == 2.0 * np.sqrt(2.5)  # karspeck scale
    assert scalars[6] == pytest.approx(1.0 / (1.329340388179137 * 2**1.5))
    assert tpair.launch_args(
        ExponentialVariogram(range=1.0), "cartesian", 1.0, 1.0
    )[:2] == (2, 4)
    assert tpair.launch_args(
        SphericalVariogram(range=1.0), "haversine", 1.0, 1.0
    )[:2] == (0, 6)
    with pytest.raises(NotImplementedError, match="nu"):
        tpair.launch_args(
            MaternVariogram(range=1.0, nu=4.5), "haversine", 1.0, 1.0
        )


def test_build_flags_and_cache_key(tmp_path):
    flags = build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    key = build.cache_key(src)
    assert build.cache_key(src, flags + ("-lineinfo",)) != key
    src.write_text("// b\n")
    assert build.cache_key(src) != key
    assert build.library_path("pairwise_tile").parent == build.BUILD_DIR


def test_build_failure_raises_with_stderr(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    src = tmp_path / "k.cu"
    src.write_text("// k\n")
    target = tmp_path / "out" / "libk.so"
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        build.compile_library(src, target, nvcc=str(fake))
    assert not target.exists()
    assert not [p for p in os.listdir(target.parent) if ".tmp" in p]


def test_build_compiles_once(tmp_path):
    """A fake nvcc that writes its -o target: the second call finds the
    library and does not compile again."""
    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    fake.write_text(
        "#!/bin/sh\necho x >> " + str(calls) + "\n"
        'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n'
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    src = tmp_path / "k.cu"
    src.write_text("// k\n")
    target = tmp_path / "out" / "libk.so"
    build.compile_library(src, target, nvcc=str(fake))
    assert target.exists()
    build.compile_library(src, target, nvcc=str(fake))
    assert calls.read_text().count("x") == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_half_angle_haversine_a(rng, dtype):
    """The haversine-a of the CUDA tile, in numpy with its roundings: s =
    sh_i ch_j - ch_i sh_j from each point's sin/cos of its half angles,
    each product rounded on its own. A self-pair gives exactly 0 (so the
    asin_poly(0) > 0 trap still keeps d > 0 on diag(K)); otherwise a is
    within a few ulp of 1 (absolute) of the plain twin's per-pair sin."""
    la, lo = _coords(rng, 400, dtype)
    la = np.concatenate([la, [0.0, 1.5, -1.5]]).astype(dtype)
    lo = np.concatenate([lo, [np.pi - 1e-3, -np.pi + 1e-3, 0.0]]).astype(dtype)
    half = dtype(0.5)
    shla, chla = np.sin(la * half), np.cos(la * half)
    shlo, chlo = np.sin(lo * half), np.cos(lo * half)
    cl = np.cos(la)
    s1 = shla[:, None] * chla[None, :] - chla[:, None] * shla[None, :]
    s2 = shlo[:, None] * chlo[None, :] - chlo[:, None] * shlo[None, :]
    a = np.clip(s1 * s1 + cl[:, None] * cl[None, :] * (s2 * s2), 0, 1)
    assert a.dtype == dtype
    assert not np.diagonal(a).any()
    t_la, t_lo = torch.as_tensor(la), torch.as_tensor(lo)
    twin = torch.clamp(
        torch.sin((t_la[:, None] - t_la[None, :]) / 2.0) ** 2
        + torch.cos(t_la)[:, None] * torch.cos(t_la)[None, :]
        * torch.sin((t_lo[:, None] - t_lo[None, :]) / 2.0) ** 2, 0.0, 1.0,
    ).numpy()
    # s errs by ~1 ulp of 0.5 absolute, so a by ~2 |s| of that
    bound = 8 * np.finfo(dtype).eps
    assert np.max(np.abs(a - twin)) <= bound
