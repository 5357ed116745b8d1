r"""Modified Bessel function of the second kind K_nu, on tensors.

Port of ``glomargridding_tpu/ops/special.py``. The stationary Matern
variogram and the Paciorek-Schervish ellipse kernel both need
:math:`x^\nu K_\nu(x)`:

1. **Half-integer orders** (0.5, 1.5, 2.5, ...): the closed form, one exp
   times a polynomial (``xv_kv_half_integer``); these cover HadSST4 (0.5)
   and HadCRUT5 (1.5).
2. **General order, small x** (x <= 2): Temme's series for
   :math:`(K_\mu, K_{\mu+1})`, :math:`|\mu| \le 1/2`.
3. **General order, large x** (x > 2): Steed's continued fraction (CF2).

Paths 2 and 3 run a fixed number of steps (50 series terms, 60 fraction
steps) and are blended with a ``where`` on x, then raised to the order by
upward recurrence, so ``kv`` is one graph of tensor operations:
differentiable in x under autograd and the ``torch.func`` transforms, and
free of data-dependent control flow. Both branches are computed for every
element, as in the reference. The order ``v`` is a Python float.

Three details guard a value or a gradient and follow the reference
exactly: the branch switch clamps x with ``where``, not ``min``/``max``
(which would split the gradient at the tie x == 2); ``sinh(e)/e`` divides
by a safe denominator (the untaken branch of a ``where`` still takes part
in backward); and Steed's loop freezes each element once converged and
rescales (c, q1, q2) jointly by an exact power of two, so the fixed trip
count cannot overflow in f32.

Accuracy against ``scipy.special.kv``: ``tests/test_torch_special.py``.
"""

import math

import torch

_EULER_GAMMA = 0.5772156649015328606

# the half-integer orders whose closed forms (``half_integer_coeffs``) the
# hand-written kernels are templated on; the one list of them
HALF_INTEGER_ORDERS = (0.5, 1.5, 2.5, 3.5)

# largest binary exponent of each float type (``numpy.finfo(...).maxexp``)
_MAXEXP = {torch.float32: 128, torch.float64: 1024}


def _is_half_integer(v: float) -> bool:
    return abs(2.0 * v - round(2.0 * v)) < 1e-12 and (round(2.0 * v) % 2 == 1)


def _kv_half_integer(n: int, x: torch.Tensor) -> torch.Tensor:
    """K_{n+1/2}(x) in closed form; n >= 0 an integer."""
    pref = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x)
    inv2x = 1.0 / (2.0 * x)
    total = torch.ones_like(x)
    coeff = 1.0
    term = torch.ones_like(x)
    for k in range(1, n + 1):
        # (n+k)! / (k! (n-k)!) built up iteratively
        coeff = coeff * (n + k) * (n - k + 1) / k
        term = term * inv2x
        total = total + coeff * term
    return pref * total


def _kv_temme_small(mu: float, x: torch.Tensor, max_iter: int = 50):
    """Temme's series for (K_mu, K_{mu+1}), |mu| <= 1/2, for x <= 2."""
    mu2 = mu * mu
    gampl = 1.0 / math.gamma(1.0 + mu)  # 1/Gamma(1+mu)
    gammi = 1.0 / math.gamma(1.0 - mu)  # 1/Gamma(1-mu)
    if abs(mu) < 1e-12:
        gam1 = -_EULER_GAMMA
    else:
        gam1 = (gammi - gampl) / (2.0 * mu)
    gam2 = (gammi + gampl) / 2.0
    pimu = math.pi * mu
    fact = 1.0 if abs(pimu) < 1e-12 else pimu / math.sin(pimu)

    x2 = x * x / 4.0
    d_log = -torch.log(x / 2.0)
    e = mu * d_log
    # safe denominator: the untaken branch of a where still takes part in
    # backward, so sinh(e)/e at e == 0 would leak NaN into the gradient
    small = torch.abs(e) < 1e-12
    e_safe = torch.where(small, torch.ones_like(e), e)
    fact2 = torch.where(small, torch.ones_like(e), torch.sinh(e_safe) / e_safe)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d_log)
    ee = torch.exp(e)
    p = 0.5 * ee / gampl
    q = 0.5 / (ee * gammi)
    c = torch.ones_like(x)
    s0, s1 = ff, p
    for i in range(1, max_iter + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu2)
        c = c * x2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        s0 = s0 + c * ff
        s1 = s1 + c * (p - fi * ff)
    return s0, s1 * (2.0 / x)


def _kv_steed_large(mu: float, x: torch.Tensor, max_iter: int = 60):
    """Steed's CF2 for (K_mu, K_{mu+1}), |mu| <= 1/2, for x > 2."""
    a1 = 0.25 - mu * mu
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    c = torch.full_like(x, a1)
    q = c
    a = torch.full_like(x, -a1)
    s = 1.0 + q * delh
    done = torch.zeros_like(x, dtype=torch.bool)

    eps = torch.finfo(x.dtype).eps
    maxexp = _MAXEXP[x.dtype]
    # c grows ~factorially and q1, q2 decay reciprocally (only c * qnew
    # matters): a joint rescale by an exact power of two keeps both in
    # range without changing a bit of the result
    big = 2.0 ** (0.5 * maxexp)
    rescale = 2.0 ** (-maxexp // 4)

    def keep(new, old):
        return torch.where(done, old, new)

    for i in range(2, max_iter + 2):
        # the auxiliaries grow without bound once the fraction has
        # converged (the textbook loop breaks early): each element latches
        # `done` and keeps its state from then on
        fi = float(i)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        done_n = done | (torch.abs(dels / s_n) <= eps)
        r = torch.where(torch.abs(c_n) > big, torch.full_like(c_n, rescale),
                        torch.ones_like(c_n))
        c_n = c_n * r
        q1_n = q2 / r
        q2_n = qnew / r
        a, b, c, d = keep(a_n, a), keep(b_n, b), keep(c_n, c), keep(d_n, d)
        h, delh = keep(h_n, h), keep(delh_n, delh)
        q1, q2 = keep(q1_n, q1), keep(q2_n, q2)
        q, s = keep(q_n, q), keep(s_n, s)
        done = done_n
    h = a1 * h
    k_mu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    return k_mu, k_mu * (mu + x + 0.5 - h) / x


def _kv_general(v: float, x: torch.Tensor, series_iters: int = 50,
                cf_iters: int = 60) -> torch.Tensor:
    """K_v(x) for a general order v > 0, elementwise in x > 0."""
    n = int(v + 0.5)
    mu = v - n  # |mu| <= 1/2
    # where, not min/max: torch.minimum splits the gradient at the tie
    use_small = x <= 2.0
    x_small = torch.where(use_small, x, 2.0)
    x_large = torch.where(use_small, 2.0, x)
    ks_mu, ks_mu1 = _kv_temme_small(mu, x_small, series_iters)
    kl_mu, kl_mu1 = _kv_steed_large(mu, x_large, cf_iters)
    k_prev = torch.where(use_small, ks_mu, kl_mu)
    k_cur = torch.where(use_small, ks_mu1, kl_mu1)
    # upward recurrence K_{mu+i+1} = 2 (mu+i) / x K_{mu+i} + K_{mu+i-1}
    for i in range(1, n + 1):
        k_prev, k_cur = k_cur, 2.0 * (mu + i) / x * k_cur + k_prev
    return k_prev  # K_{mu+n} = K_v


def _float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def kv(v: float, x) -> torch.Tensor:
    """Modified Bessel function of the second kind of order `v`, with
    ``scipy.special.kv``'s semantics on the real line: +inf at x == 0,
    NaN for x < 0, and K_{-v} = K_v."""
    v = abs(float(v))
    x = _float(x)
    x_safe = torch.maximum(x, torch.tensor(torch.finfo(x.dtype).tiny,
                                           dtype=x.dtype, device=x.device))
    if _is_half_integer(v):
        out = _kv_half_integer(int(round(v - 0.5)), x_safe)
    else:
        out = _kv_general(v, x_safe)
    out = torch.where(x == 0.0, math.inf, out)
    return torch.where(x < 0.0, math.nan, out)


def kv_nan_guard(v: float, x) -> torch.Tensor:
    """``kv`` with inf mapped to NaN (the reference variogram's
    convention)."""
    out = kv(v, x)
    return torch.where(torch.isinf(out), math.nan, out)


def half_integer_coeffs(v: float) -> list[float]:
    """The Horner coefficients of ``xv_kv_half_integer`` for half-integer
    `v` = n + 1/2, from x^n down: c_k = (n+k)! / (k! (n-k)! 2^k)."""
    if not _is_half_integer(v):
        raise ValueError(f"v={v} is not half-integer")
    n = int(round(v - 0.5))
    coeffs = [1.0]
    for k in range(1, n + 1):
        coeffs.append(coeffs[-1] * (n + k) * (n - k + 1) / (2.0 * k))
    return coeffs


def xv_kv_half_integer(v: float, x: torch.Tensor) -> torch.Tensor:
    r"""``x**v * K_v(x)`` for half-integer ``v`` as one exp times a
    Horner polynomial:

    .. math::
        x^\nu K_\nu(x) = \sqrt{\pi/2}\; e^{-x}
            \sum_{k=0}^{n} \frac{(n+k)!}{k!\,(n-k)!\,2^k}\, x^{n-k}.

    NaN at ``x <= 0``, matching the generic product's ``0 * inf``.
    """
    coeffs = half_integer_coeffs(v)
    x = torch.as_tensor(x)
    positive = x > 0.0
    x_safe = torch.where(positive, x, torch.ones_like(x))
    total = torch.full_like(x_safe, coeffs[0])
    for c in coeffs[1:]:
        total = total * x_safe + c
    out = math.sqrt(math.pi / 2.0) * torch.exp(-x_safe) * total
    return torch.where(positive, out, torch.full_like(out, math.nan))


def xv_kv(v: float, x) -> torch.Tensor:
    """``x**v * K_v(x)``, NaN at x <= 0.

    The fused closed form for half-integer orders; otherwise
    ``pow(x, v) * kv_nan_guard(v, x)`` as in the reference, evaluated at a
    safe x = 1 where x <= 0 so that the gradient of the elements the
    callers mask (the Matern ``d == 0`` entries) is 0 and not NaN. The
    values are the reference's everywhere.
    """
    if _is_half_integer(v):
        return xv_kv_half_integer(v, x)
    x = _float(x)
    positive = x > 0.0
    x_safe = torch.where(positive, x, torch.ones_like(x))
    out = torch.pow(x_safe, v) * kv_nan_guard(v, x_safe)
    return torch.where(positive, out, math.nan)


def gamma_fn(v: float) -> float:
    """Gamma(v) for a Python float order."""
    return math.gamma(v)
