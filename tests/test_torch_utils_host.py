"""The port's host utilities against the JAX package's on the same
inputs: ``config``, ``utils/{frames,calendar,logging,profiling,roofline}``
(mirrors ``tests/test_utils.py``, ``tests/test_roofline.py`` and the
profiling test of ``tests/test_workflow_integration.py``). Exact, except
the roofline's rates (1e-12 relative); the peaks differ by design (the
port's are the H100's) and are passed explicitly where the two are
compared.
"""

import logging
from datetime import date

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from glomargridding_tpu import config as jconfig
from glomargridding_tpu.utils import calendar as jcal
from glomargridding_tpu.utils import frames as jframes
from glomargridding_tpu.utils import logging as jlog
from glomargridding_tpu.utils import profiling as jprof
from glomargridding_tpu.utils import roofline as jroof
from glomargridding_tpu_torch import config as tconfig
from glomargridding_tpu_torch import utils as tutils
from glomargridding_tpu_torch.utils import calendar as tcal
from glomargridding_tpu_torch.utils import frames as tframes
from glomargridding_tpu_torch.utils import logging as tlog
from glomargridding_tpu_torch.utils import profiling as tprof
from glomargridding_tpu_torch.utils import roofline as troof


def test_default_dtype_and_its_context():
    assert tconfig.default_dtype() == torch.float32
    assert np.dtype(jconfig.default_dtype()) == np.float32
    with tconfig.default_dtype_ctx(np.float64):
        assert tconfig.default_dtype() == torch.float64
        with tconfig.default_dtype_ctx(torch.float32):
            assert tconfig.default_dtype() == torch.float32
        assert tconfig.default_dtype() == torch.float64
    assert tconfig.default_dtype() == torch.float32
    try:
        tconfig.set_default_dtype("float64")
        assert tconfig.default_dtype() == torch.float64
    finally:
        tconfig.set_default_dtype(torch.float32)
    with pytest.raises(RuntimeError):
        with tconfig.default_dtype_ctx(torch.float64):
            raise RuntimeError("restored on the way out")
    assert tconfig.default_dtype() == torch.float32


@pytest.mark.parametrize("closed", ["both", "left", "right", "none",
                                    ["both", "none"]])
def test_filter_bounds(rng, closed):
    df = pd.DataFrame({"lat": rng.integers(-3, 4, 200).astype(float),
                       "lon": rng.integers(-3, 4, 200).astype(float),
                       "v": rng.normal(size=200)})
    args = (df, [(-2, 2), (-1, 3)], ["lat", "lon"], closed)
    pd.testing.assert_frame_equal(tframes.filter_bounds(*args),
                                  jframes.filter_bounds(*args))


def test_filter_bounds_errors():
    df = pd.DataFrame({"lat": [0.0], "lon": [0.0]})
    for module in (tframes, jframes):
        with pytest.raises(ValueError, match="Length of 'bounds'"):
            module.filter_bounds(df, [(0, 1)], ["lat", "lon"])
        with pytest.raises(ValueError, match="Length of 'closed'"):
            module.filter_bounds(df, [(0, 1)], ["lat"], ["both", "left"])
        with pytest.raises(ValueError, match="Unknown closed"):
            module.filter_bounds(df, [(0, 1)], ["lat"], "open")
    with pytest.raises(tframes.ColumnNotFoundError, match="depth"):
        tframes.filter_bounds(df, [(0, 1)], ["depth"])


@pytest.mark.parametrize("n", [1, 3, 7, 8])
def test_batched(n):
    items = "ABCDEFG"
    assert list(tframes.batched(items, n)) == list(jframes.batched(items, n))
    if 7 % n:
        with pytest.raises(ValueError, match="incomplete"):
            list(tframes.batched(items, n, strict=True))
    with pytest.raises(ValueError):
        list(tframes.batched(items, 0))


@pytest.mark.parametrize("keys", [("a", "b", "c"), ("a", "x", "c"), ("a",),
                                  ("z",), ("a", "b"), ("a", "b", "c", "d")])
def test_get_recurse(keys):
    cfg = {"a": {"b": {"c": 1}}, "z": 5}
    assert tframes.get_recurse(cfg, *keys, default=-1) == \
        jframes.get_recurse(cfg, *keys, default=-1)
    from glomargridding_tpu_torch.io import get_recurse

    assert get_recurse is tframes.get_recurse


@pytest.mark.parametrize("year", [1850, 1988, 2000, 2008, 2023])
def test_calendar_helpers(year):
    for day in (1, 14, 28):
        np.testing.assert_array_equal(tcal.days_since_by_month(year, day),
                                      jcal.days_since_by_month(year, day))
    for month in (1, 2, 12):
        assert tcal.get_date_index(year, month, 1850) == \
            jcal.get_date_index(year, month, 1850)
        assert tcal.days_in_month(year, month) == \
            jcal.days_in_month(year, month)
    centres = [date(year, 2, 27), date(year, 3, 1), date(year, 12, 31),
               date(year, 1, 1)] + ([date(year, 2, 29)] if year % 4 == 0
                                    and year % 100 != 0 or year % 400 == 0
                                    else [])
    for centre in centres:
        assert tcal.get_pentad_range(centre) == jcal.get_pentad_range(centre)
    dates = pd.Series(pd.to_datetime([f"{year}-01-01", f"{year}-02-10",
                                      f"{year}-12-31T23:00"], format="ISO8601"))
    pd.testing.assert_series_equal(tcal.get_month_midpoint(dates),
                                   jcal.get_month_midpoint(dates))
    assert tcal.MonthName.MARCH == jcal.MonthName.MARCH == 3
    assert [m.name for m in tcal.MonthName] == \
        [m.name for m in jcal.MonthName]


def test_month_midpoint_refuses_non_dates():
    with pytest.raises(TypeError, match="not a datetime"):
        tcal.get_month_midpoint(pd.Series([1, 2]))


@pytest.mark.parametrize("level,value", [("debug", 10), ("INFO", 20),
                                         ("warn", 30), ("error", 40),
                                         ("Critical", 50)])
def test_logging_levels(level, value):
    assert tlog._get_logging_level(level) == \
        jlog._get_logging_level(level) == value


def test_init_logging_writes_to_a_file(tmp_path):
    path = tmp_path / "run.log"
    with pytest.raises(ValueError, match="Unknown logging level"):
        tlog.init_logging(str(path), "loud")
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    # init_logging reloads the logging module: a new root and a new logger
    # tree, which the loggers made before it (the package's modules') no
    # longer reach, nor do later tests' caplog handlers. Its namespace is
    # put back after the test.
    namespace = dict(vars(logging))
    try:
        for h in root.handlers[:]:
            root.removeHandler(h)
        tlog.init_logging(str(path), "info")
        logging.getLogger("glomar").info("ingest done")
        logging.getLogger("glomar").debug("hidden")
        for h in logging.getLogger().handlers:
            h.flush()
    finally:
        for h in logging.getLogger().handlers[:]:
            logging.getLogger().removeHandler(h)
            h.close()
        logging.captureWarnings(False)
        vars(logging).clear()
        vars(logging).update(namespace)
        for h in saved[0]:
            logging.getLogger().addHandler(h)
        logging.getLogger().setLevel(saved[1])
    text = path.read_text()
    assert "INFO at" in text and "ingest done" in text
    assert "hidden" not in text


@pytest.mark.parametrize("shapes", [
    (((100, 100), "float32"),),
    (((65000, 65000), "float64"), ((7,), "int32")),
    (((3, 5, 2), "float16"), ((4,), "int64"), ((), "float32")),
])
def test_hbm_estimate(shapes):
    ref = jprof.hbm_estimate(*((s, jnp.dtype(d)) for s, d in shapes))
    assert tprof.hbm_estimate(*((s, getattr(torch, d)) for s, d in shapes)) \
        == ref
    assert tprof.hbm_estimate(*((s, np.dtype(d)) for s, d in shapes)) == ref


def test_hbm_budget_check(monkeypatch):
    small = (((10, 10), torch.float32),)
    big = (((65000, 65000), torch.float64),)
    assert tprof.hbm_budget_check(*small, limit_bytes=1 << 20)
    assert not tprof.hbm_budget_check(*big, limit_bytes=16 * 1024**3)
    assert jprof.hbm_budget_check(((10, 10), jnp.float32),
                                  limit_bytes=1 << 20)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="limit_bytes"):
        tprof.hbm_budget_check(*small)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda: (1 << 30, 80 << 30))
    assert tprof.hbm_budget_check(*small)
    assert not tprof.hbm_budget_check(((1 << 28,), torch.float64))


def test_stage_timer_records_and_syncs_only_the_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    timings: dict = {}
    with tprof.stage_timer("noop", timings) as h:
        h["out"] = {"field": torch.ones(4) * 2, "parts": [torch.zeros(2)]}
    assert timings["noop"] >= 0 and synced == []
    ref: dict = {}
    with jprof.stage_timer("noop", ref) as h:
        h["out"] = jnp.ones(4) * 2
    assert set(ref) == set(timings)
    fake = torch.empty(0, device="meta")
    monkeypatch.setattr(tprof, "_cuda_devices",
                        lambda out, found: {torch.device("cuda", 0)})
    with tprof.stage_timer("card") as h:
        h["out"] = fake
    assert synced == [torch.device("cuda", 0)]


def test_cuda_devices_walks_nested_results():
    assert tprof._cuda_devices(
        {"a": [torch.ones(1), (torch.zeros(2),)], "b": 3}, set()) == set()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "traceEvents" in text


def test_flop_formulas_match_the_reference():
    for args in ((3, 5, 7), (5000, 64800, 5000)):
        assert troof.matmul_flops(*args) == jroof.matmul_flops(*args)
    for n in (6, 5000):
        assert troof.cholesky_flops(n) == jroof.cholesky_flops(n)
        assert troof.trsm_flops(n, 9) == jroof.trsm_flops(n, 9)
        assert troof.cho_solve_flops(n, 9) == jroof.cho_solve_flops(n, 9)


@pytest.mark.parametrize("peak", [67.0, 197.0])
def test_achieved_rates_match_the_reference_at_one_peak(peak):
    ours = troof.achieved_matmul(3.2e12, 0.081, peak_tflops=peak)
    ref = jroof.achieved_matmul(3.2e12, 0.081, peak_tflops=peak)
    assert ours.as_dict() == ref.as_dict()
    np.testing.assert_allclose(ours.pct_roofline, ref.pct_roofline,
                               rtol=1e-12)
    ours = troof.achieved_pairs(2.0e10, 0.5, peak_gpairs=peak)
    ref = jroof.achieved_pairs(2.0e10, 0.5, peak_gpairs=peak)
    assert ours.as_dict() == ref.as_dict()


def test_achieved_rates_use_the_cards_peaks():
    a = troof.achieved_matmul(troof.F32_FLOPS_S, 1.0)
    assert a.pct_roofline == pytest.approx(100.0)
    b = troof.achieved_bandwidth(troof.HBM_BYTES_S, 2.0)
    assert b.pct_roofline == pytest.approx(50.0)
    assert b.as_dict()["hbm_gbs"] == round(troof.HBM_BYTES_S / 2e9, 1)
    assert troof.pairs_peak() == (None, "not measured")
    p = troof.achieved_pairs(4e10, 1.0)
    assert p.pct_roofline is None and p.as_dict() == {"gpairs_per_s": 40.0}
    try:
        troof.set_pairs_peak(80.0, "a measured sweep")
        assert troof.achieved_pairs(4e10, 1.0).pct_roofline == \
            pytest.approx(50.0)
        troof.set_pairs_peak(0.0, "ignored")
        assert troof.pairs_peak() == (80.0, "a measured sweep")
    finally:
        troof._PAIRS_PEAK_GS, troof._PAIRS_PEAK_SRC = None, "not measured"


def test_kernel_bounds():
    ms, by = troof.bound(3.35e9, 0.0, 0.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = troof.bound(0.0, 67e9, 4.18e9 / 2)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = troof.bound(1.0, 0.0, 4.18e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    pairs, kept = 10**9, 4 * 10**8
    ms, by = troof.ellipse_bound(8.0, pairs, kept, troof.K3_CONTRACT_FLOPS)
    flops = pairs * troof.CUT_FLOPS + kept * (troof.PAIR_FLOPS
                                              + troof.K3_CONTRACT_FLOPS)
    assert by == "operations"
    assert ms == pytest.approx(max(flops / troof.F32_FLOPS_S,
                                   kept * troof.PAIR_TRANSCENDENTALS
                                   / troof.TRANSCENDENTALS_S) * 1e3)


def test_utils_exports_match_the_reference():
    import glomargridding_tpu.utils as jutils

    assert set(jutils.__all__) <= set(tutils.__all__)
    for name in jutils.__all__:
        assert hasattr(tutils, name), name
