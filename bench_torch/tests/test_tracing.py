"""The traced-run arithmetic on a recorded event list: the union of the
device's intervals, device time by kernel, the port's kernels against
the libraries', and idle gaps labelled by the host's spans."""

import pytest

from bench_torch import tracing
from bench_torch.tracing import Event, Trace


def recorded():
    # times in seconds; the window is [1, 11]
    device = [
        Event("void pairwise_tile_kernel<float>(...)", 0.5, 1.5),  # cut at 1
        Event("sm90_xmma_gemm_f32f32_tn", 1.2, 3.0),  # overlaps the tile
        Event("potrf_kernel", 2.0, 2.5),  # inside the GEMM
        Event("void ellipse_sym_kernel<1, __nv_bfloat16>(...)", 4.0, 5.0),
        Event("Memcpy DtoD", 5.0, 5.5),  # touches the kernel before it
        Event("sm90_xmma_gemm_f32f32_tn", 9.0, 12.0),  # cut at 11
    ]
    spans = [
        Event(tracing.WINDOW, 1.0, 11.0),
        Event("analysis", 1.0, 6.0),
        Event("clip", 3.2, 5.8),
        Event("analysis", 6.0, 11.0),
        Event("step", 6.5, 8.5),
    ]
    return Trace(device, spans)


def test_union_merges_overlapping_and_touching_intervals():
    assert tracing.union([(3, 4), (1, 2), (1.5, 2.5), (2.5, 3)]) == [(1, 4)]
    assert tracing.union([(0, 1), (2, 3)]) == [(0, 1), (2, 3)]
    assert tracing.union([]) == []


def test_busy_is_the_union_inside_the_window():
    # [1, 3] + [4, 5.5] + [9, 11] = 2 + 1.5 + 2
    assert tracing.busy_seconds(recorded()) == pytest.approx(5.5)


def test_device_time_by_name_and_owner():
    t = recorded()
    by = tracing.device_seconds_by_name(t)
    assert by["sm90_xmma_gemm_f32f32_tn"] == pytest.approx(1.8 + 2.0)
    assert tracing.own_seconds(t, "pairwise_tile_kernel") == pytest.approx(0.5)
    assert tracing.own_seconds(t, "ellipse_sym_kernel") == pytest.approx(1.0)
    # the GEMMs, the factor and the copy: 3.8 + 0.5 + 0.5
    assert tracing.library_seconds(t) == pytest.approx(4.8)
    assert tracing.own_kernel("potrf_kernel") is None


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    gaps = dict(tracing.idle_gaps(recorded()))
    # [3, 4] opens inside the first analysis before its clip began,
    # [5.5, 9] inside the clip (which ends at 5.8)
    assert gaps == pytest.approx({"analysis": 1.0, "clip": 3.5})
    assert sum(gaps.values()) == pytest.approx(10.0 - 5.5)


def test_breakdown_lists_the_largest_first():
    b = tracing.breakdown(recorded(), top=2)
    assert [n for n, _ in b["device_ops"]] == [
        "sm90_xmma_gemm_f32f32_tn",
        "void ellipse_sym_kernel<1, __nv_bfloat16>(...)"]
    assert b["idle_gaps"][0][0] == "clip"


def test_spans_cost_nothing_untraced():
    calls = []
    spans = tracing.Spans(False, lambda: calls.append(1))
    with spans("clip"):
        pass
    assert calls == [] and spans.seconds == {}
    assert tracing.span_mean_ms(spans.seconds, "clip") is None
