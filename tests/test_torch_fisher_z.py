"""K5's wrapper (``ops/cuda/ellipse_nll.fisher_z_nll``) and the rule that
sends a fit's objective to it (``estimate._k5_takes``), on the CPU.

Every refusal is raised before the library is built or loaded: the
library is replaced by one that fails the test if it is asked for. A
valid call on CPU tensors is refused too (K5 runs on the card; on the CPU
the objective is the vmapped ``_nll_fit_z``). The kernel itself is held
against its twin on the card (``tests/test_torch_cuda_k5.py``).
"""

import math

import pytest
import torch

from glomargridding_tpu_torch.models.ellipse import estimate, model
from glomargridding_tpu_torch.models.ellipse.model import EllipseModel
from glomargridding_tpu_torch.ops.cuda import ellipse_nll
from glomargridding_tpu_torch.ops.special import (
    HALF_INTEGER_ORDERS,
    half_integer_coeffs,
)

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


def _model(anisotropic=True, rotated=True, v=1.5, unit_sigma=True):
    return EllipseModel(anisotropic=anisotropic, rotated=rotated,
                        physical_distance=True, v=v, unit_sigma=unit_sigma)


@pytest.mark.parametrize("form, lane, device, dtype, takes", [
    (dict(), "nm", CUDA, torch.float32, True),
    (dict(), "nm", CUDA, torch.float64, True),
    (dict(rotated=False, unit_sigma=False, v=0.5), "nm", CUDA,
     torch.float32, True),
    (dict(unit_sigma=False, v=3.5), "nm", CUDA, torch.float64, True),
    (dict(v=2.5), "nm", CUDA, torch.float32, True),
    (dict(), "nm", CPU, torch.float32, False),
    (dict(), "lm", CUDA, torch.float32, False),
    (dict(), "lbfgs", CUDA, torch.float32, False),
    (dict(anisotropic=False, rotated=False), "nm", CUDA, torch.float32,
     False),
    (dict(v=1.0), "nm", CUDA, torch.float32, False),
    (dict(v=4.5), "nm", CUDA, torch.float32, False),
    (dict(), "nm", CUDA, torch.bfloat16, False),
])
def test_which_fits_take_k5(form, lane, device, dtype, takes):
    """The Nelder-Mead lane on a CUDA device, for the anisotropic forms at
    nu in HALF_INTEGER_ORDERS in f32 or f64; the gradient lanes, the CPU, the
    isotropic form and other orders keep the vmapped objective."""
    assert estimate._k5_takes(_model(**form), lane, device, dtype) is takes


def _inputs(K=4, B=3, N=8, d=3, dtype=torch.float32):
    g = torch.Generator().manual_seed(K * 100 + B)
    return dict(
        points=torch.rand((K, B, d), generator=g, dtype=dtype) + 1.0,
        X=torch.rand((B, N, 2), generator=g, dtype=dtype),
        z_y=torch.rand((B, N), generator=g, dtype=dtype),
        w=torch.ones((B, N), dtype=dtype),
        mask=torch.ones((B,), dtype=torch.bool))


def _refuse(**change):
    kw = dict(_inputs(), v=1.5, fit_sigma=False)
    for k, v in change.items():
        kw[k] = v(kw) if callable(v) else v
    return kw


@pytest.fixture
def no_library(monkeypatch):
    def fail():
        raise AssertionError("the library was asked for")
    monkeypatch.setattr(ellipse_nll, "_library", fail)


@pytest.mark.parametrize("kw, error, match", [
    (_refuse(X=lambda kw: kw["X"].numpy()), TypeError, "torch tensors"),
    (_refuse(v=1.0), ValueError, "nu in"),
    (_refuse(v=4.5), ValueError, "nu in"),
    (_refuse(points=lambda kw: kw["points"][0]), ValueError, r"\(K, B, d\)"),
    (_refuse(points=lambda kw: kw["points"][..., :1]), ValueError,
     "2 or 3 shape"),
    (_refuse(fit_sigma=True, points=lambda kw: kw["points"][..., :2]),
     ValueError, "2 or 3 shape"),
    (_refuse(points=lambda kw: torch.cat([kw["points"]] * 2)), ValueError,
     "points a call"),
    (_refuse(X=lambda kw: kw["X"][..., :1]), ValueError, "X must be"),
    (_refuse(X=lambda kw: kw["X"][:2]), ValueError, "X must be"),
    (_refuse(z_y=lambda kw: kw["z_y"][:, :5]), ValueError, "z_y must be"),
    (_refuse(w=lambda kw: kw["w"][:2]), ValueError, "w must be"),
    (_refuse(mask=lambda kw: kw["mask"].float()), ValueError, "bool"),
    (_refuse(mask=lambda kw: kw["mask"][:2]), ValueError, "bool"),
    (_refuse(**{k: (lambda kw, k=k: kw[k].half())
                for k in ("points", "X", "z_y", "w")}), TypeError,
     "float32 or float64"),
    (_refuse(w=lambda kw: kw["w"].double()), TypeError, "one dtype"),
    (_refuse(w=lambda kw: torch.empty(kw["w"].shape, device="meta")),
     ValueError, "one device"),
    (_refuse(X=lambda kw: kw["X"].transpose(0, 1).contiguous()
             .transpose(0, 1)), ValueError, "contiguous"),
    (_refuse(), ValueError, "CUDA tensors"),
    (_refuse(**{k: (lambda kw, k=k: kw[k].double())
                for k in ("points", "X", "z_y", "w")}), ValueError,
     "CUDA tensors"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_refusals_come_before_any_launch(no_library, kw, error, match):
    kw = dict(kw)
    args = [kw.pop(k) for k in ("points", "X", "z_y", "w", "mask")]
    with pytest.raises(error, match=match):
        ellipse_nll.fisher_z_nll(*args, **kw)


@pytest.mark.parametrize("v", HALF_INTEGER_ORDERS)
def test_the_constants_are_the_models(v):
    """The kernel's constants are those of ``_nll_fit_z``'s formula:
    ``cov_ij_anisotropic``'s factor, ``xv_kv_half_integer``'s, the
    clip and ``_weighted_nll``'s log sqrt(2 pi), and the Horner
    coefficients; the widest form's d + 1 points fit one call."""
    n, consts = ellipse_nll._consts(v)
    assert list(consts) == [
        1.0 / (math.gamma(v) * 2.0 ** (v - 1.0)), math.sqrt(math.pi / 2.0),
        math.sqrt(v), model.ARCTANH_THRESHOLD, model._LOG_SQRT_2PI,
        *half_integer_coeffs(v)]
    assert n == len(half_integer_coeffs(v)) == HALF_INTEGER_ORDERS.index(v) + 1
    widest = _model(unit_sigma=False)
    assert ellipse_nll.MAX_POINTS == widest.n_params + 2
