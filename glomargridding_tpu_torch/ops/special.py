r"""``x**v K_v(x)`` for the Matern models, on tensors.

Port of ``glomargridding_tpu/ops/special.py:246-298``: the half-integer
closed form, which covers the production orders (HadSST4 0.5, HadCRUT5
1.5). The general-order Temme/Steed ``kv`` (``special.py:51-240``) is not
ported yet (ROADMAP.md, Queue 1 item 2); until it is, a non-half-integer
order raises ``NotImplementedError`` so that no other code path silently
stands in for it.
"""

import math

import torch


def _is_half_integer(v: float) -> bool:
    return abs(2.0 * v - round(2.0 * v)) < 1e-12 and (round(2.0 * v) % 2 == 1)


def xv_kv_half_integer(v: float, x: torch.Tensor) -> torch.Tensor:
    r"""``x**v * K_v(x)`` for half-integer ``v`` as one exp times a
    Horner polynomial:

    .. math::
        x^\nu K_\nu(x) = \sqrt{\pi/2}\; e^{-x}
            \sum_{k=0}^{n} \frac{(n+k)!}{k!\,(n-k)!\,2^k}\, x^{n-k}.

    NaN at ``x <= 0``, matching the generic product's ``0 * inf``.
    """
    if not _is_half_integer(v):
        raise ValueError(f"v={v} is not half-integer")
    x = torch.as_tensor(x)
    positive = x > 0.0
    x_safe = torch.where(positive, x, torch.ones_like(x))
    # c_k = (n+k)! / (k! (n-k)! 2^k), built iteratively; Horner from x^n
    n = int(round(v - 0.5))
    coeffs = [1.0]
    for k in range(1, n + 1):
        coeffs.append(coeffs[-1] * (n + k) * (n - k + 1) / (2.0 * k))
    total = torch.full_like(x_safe, coeffs[0])
    for c in coeffs[1:]:
        total = total * x_safe + c
    out = math.sqrt(math.pi / 2.0) * torch.exp(-x_safe) * total
    return torch.where(positive, out, torch.full_like(out, math.nan))


def xv_kv(v: float, x: torch.Tensor) -> torch.Tensor:
    """``x**v * K_v(x)``; half-integer orders only (see module doc)."""
    if _is_half_integer(v):
        return xv_kv_half_integer(v, x)
    raise NotImplementedError(
        f"Matern order nu={v} needs the general-order K_nu (Temme/Steed), "
        "which the PyTorch port does not have yet (ROADMAP.md, Queue 1 "
        "item 2); half-integer orders are supported"
    )


def gamma_fn(v: float) -> float:
    """Gamma(v) for a Python float order."""
    return math.gamma(v)
