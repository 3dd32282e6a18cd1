"""Group collapse of secondary-energy spectra (fission chi; config 4).

chi_g'(E) = integral over group g' of p(E'|E) (SURVEY.md section 3.4).

Paths:
  - tabular pdfs (law 4-style, piecewise linear / histogram-by-duplication):
    sorted-edges + midpoint rule, which is EXACT for piecewise-linear
    integrands — no quadrature error at all;
  - analytic spectra (law 7 Maxwell, 9 evaporation, 11 Watt): closed-form
    group integrals via erf/exp, with the ACE restriction E' <= E - U
    truncating the support and renormalizing.

All kernels are jit-compiled, vectorized over incident-energy rows, and
share the edge-group clamping convention of ops.twobody.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import erf, erfc

from ndpp_tpu.ops import select
from ndpp_tpu.ops.legendre import gl_nodes_weights


def _effective_bounds(bounds, clamp: bool):
    """Clamped bounds; shared (G+1,) or per-row (T, B+1) band windows."""
    if not clamp:
        return bounds
    shp = bounds.shape[:-1] + (1,)
    lo = jnp.full(shp, -jnp.inf, dtype=bounds.dtype)
    hi = jnp.full(shp, jnp.inf, dtype=bounds.dtype)
    return jnp.concatenate([lo, bounds[..., 1:-1], hi], axis=-1)


@partial(jax.jit, static_argnames=("clamp",))
def tabular_group_fractions(e_knots, pdf, bounds, clamp: bool = True):
    """Exact group integrals of piecewise-linear pdfs.

    e_knots/pdf: (T, K) — outgoing-energy knots (duplicated knots encode
    histogram steps) and pdf values (1/eV). bounds: (G+1,).
    Returns (T, G) with row sums equal to the pdf norm (1 for normalized).

    Realized as boundary CUMULANTS (round 4): the per-knot-panel integral
    prefix is a cumsum, each boundary's partial panel is closed-form, and
    group values are differences of boundary cumulants — exact for
    piecewise-linear pdfs, like the sorted-edges + midpoint-rule form it
    replaces (equal to ~1e-16), but with no (T, K+G+1)-wide sort, no
    per-segment interpolation, and no scatter-add: the only lookup is ONE
    take_along_axis of a 4-wide panel payload at the G+1 boundaries.
    """
    ng = bounds.shape[-1] - 1
    k = e_knots.shape[1]
    eff = _effective_bounds(bounds, clamp)
    if eff.ndim == 1:
        eff = eff[None, :]
    dx = e_knots[:, 1:] - e_knots[:, :-1]
    ok = dx > 0
    dxs = jnp.where(ok, dx, 1.0)
    slope = jnp.where(ok, (pdf[:, 1:] - pdf[:, :-1]) / dxs, 0.0)
    pint = jnp.where(ok, 0.5 * (pdf[:, 1:] + pdf[:, :-1]) * dx, 0.0)  # exact panel integrals
    prefix = jnp.cumsum(pint, axis=1) - pint  # exclusive: integral up to knot j
    b = jnp.clip(eff, e_knots[:, :1], e_knots[:, -1:])  # (T, G+1)
    # containing panel by count (side='right'), then one payload gather
    idx = jnp.clip(
        jnp.sum((e_knots[:, None, :] <= b[:, :, None]).astype(jnp.int32), axis=2) - 1,
        0,
        k - 2,
    )  # (T, G+1)
    payload = jnp.stack([e_knots[:, :-1], pdf[:, :-1], slope, prefix], axis=-1)  # (T, K-1, 4)
    # exact one-hot f32 selection (ops/select) in place of an f64
    # take_along_axis
    pb = select.select_rows(payload, idx)  # (T, G+1, 4)
    h = jnp.maximum(b - pb[..., 0], 0.0)
    cum = pb[..., 3] + h * (pb[..., 1] + 0.5 * pb[..., 2] * h)  # (T, G+1)
    return cum[:, 1:] - cum[:, :-1]


def _maxwell_integral(x, theta):
    """I(x) = int_0^x sqrt(t) exp(-t/theta) dt (unnormalized)."""
    x = jnp.maximum(x, 0.0)
    z = jnp.sqrt(x / theta)
    return theta ** 1.5 * (jnp.sqrt(jnp.pi) / 2.0) * erf(z) - theta * jnp.sqrt(x) * jnp.exp(-x / theta)


def _maxwell_comp(x, theta):
    """Ic(x) = int_x^inf sqrt(t) exp(-t/theta) dt (tail-accurate complement)."""
    x = jnp.maximum(x, 0.0)
    z = jnp.sqrt(x / theta)
    return theta ** 1.5 * (jnp.sqrt(jnp.pi) / 2.0) * erfc(z) + theta * jnp.sqrt(x) * jnp.exp(-x / theta)


def _evap_integral(x, theta):
    """I(x) = int_0^x t exp(-t/theta) dt."""
    x = jnp.maximum(x, 0.0)
    r = x / theta
    # -expm1(-r) - r*exp(-r) is accurate for small r too
    return theta**2 * (-jnp.expm1(-r) - r * jnp.exp(-r))


def _evap_comp(x, theta):
    """Ic(x) = int_x^inf t exp(-t/theta) dt = theta^2 e^{-x/theta} (1 + x/theta)."""
    x = jnp.maximum(x, 0.0)
    r = x / theta
    return theta**2 * jnp.exp(-r) * (1.0 + r)


def _watt_half(s, h, a):
    """int_0^s u exp(-(u-h)^2/a) du  (building block of the Watt integral)."""
    sq = jnp.sqrt(a)
    term_exp = 0.5 * a * (jnp.exp(-(h**2) / a) - jnp.exp(-((s - h) ** 2) / a))
    term_erf = h * (jnp.sqrt(jnp.pi) * sq / 2.0) * (erf((s - h) / sq) + erf(h / sq))
    return term_exp + term_erf


def _watt_half_comp(s, h, a):
    """int_s^inf u exp(-(u-h)^2/a) du."""
    sq = jnp.sqrt(a)
    return 0.5 * a * jnp.exp(-((s - h) ** 2) / a) + h * (jnp.sqrt(jnp.pi) * sq / 2.0) * erfc((s - h) / sq)


def _watt_integral(x, a, b):
    """I(x) = int_0^x exp(-t/a) sinh(sqrt(b t)) dt (unnormalized, exact).

    Derivation: t = u^2, sinh = (e^{+cu} - e^{-cu})/2 with c = sqrt(b);
    complete the square. The common factor exp(ab/4) is kept explicit.
    """
    x = jnp.maximum(x, 0.0)
    s = jnp.sqrt(x)
    c = jnp.sqrt(b)
    h = a * c / 2.0
    return jnp.exp(a * b / 4.0) * (_watt_half(s, h, a) - _watt_half(s, -h, a))


def _watt_comp(x, a, b):
    """Ic(x) = int_x^inf exp(-t/a) sinh(sqrt(b t)) dt."""
    x = jnp.maximum(x, 0.0)
    s = jnp.sqrt(x)
    c = jnp.sqrt(b)
    h = a * c / 2.0
    return jnp.exp(a * b / 4.0) * (_watt_half_comp(s, h, a) - _watt_half_comp(s, -h, a))


_ANALYTIC = {7: (_maxwell_integral, _maxwell_comp), 9: (_evap_integral, _evap_comp)}


def _raw_spectrum(law: int, x, theta, b_param):
    """Unnormalized spectrum value (smooth; no cancellation anywhere)."""
    if law == 7:
        return jnp.sqrt(jnp.maximum(x, 0.0)) * jnp.exp(-x / theta)
    if law == 9:
        return jnp.maximum(x, 0.0) * jnp.exp(-x / theta)
    if law == 11:
        return jnp.exp(-x / theta) * jnp.sinh(jnp.sqrt(jnp.maximum(b_param * x, 0.0)))
    raise ValueError(law)


@partial(jax.jit, static_argnames=("law", "clamp", "nq"))
def analytic_group_fractions(e, theta, b_param, u, bounds, law: int, clamp: bool = True, nq: int = 24):
    """Group fractions for laws 7/9/11 with restriction E' <= E - U.

    e/theta/b_param: (T,) rows (b_param used only for law 11, where theta
    plays the role of 'a'). Returns (T, G) rows summing to 1 (0 below U).

    Implementation: per-group Gauss-Legendre of the raw spectrum. The
    spectrum is entire, so per-panel GL converges to machine precision and
    (unlike differencing the closed-form cumulative, kept in this module
    as _maxwell/_evap/_watt_integral for cross-checks) suffers no
    tail cancellation. Normalization divides by the sum over the full
    [0, E-U] partition, so rows sum to exactly 1.
    """
    ng = bounds.shape[0] - 1
    emax = jnp.maximum(e - u, 0.0)  # (T,)
    th = theta[:, None, None]
    bp = b_param[:, None, None]

    eff = _effective_bounds(bounds, clamp)
    cut = jnp.clip(eff[None, :], 0.0, emax[:, None])  # (T, G+1)
    # full partition of [0, emax]: leading [0, cut_0] and trailing [cut_G, emax]
    zeros = jnp.zeros_like(emax)[:, None]
    part = jnp.concatenate([zeros, cut, emax[:, None]], axis=1)  # (T, G+3)

    xq, wq = gl_nodes_weights(nq)
    xq = jnp.asarray(xq, dtype=e.dtype)
    wq = jnp.asarray(wq, dtype=e.dtype)
    lo, hi = part[:, :-1], part[:, 1:]
    half = 0.5 * (hi - lo)  # (T, G+2)
    mid = 0.5 * (hi + lo)
    x = mid[:, :, None] + half[:, :, None] * xq[None, None, :]  # (T, G+2, Q)
    vals = _raw_spectrum(law, x, th, bp)
    seg = jnp.sum(vals * wq[None, None, :], axis=-1) * half  # (T, G+2)

    total = jnp.sum(seg, axis=1)  # integral over [0, emax]
    ok = total > 0.0
    total = jnp.where(ok, total, 1.0)
    frac = seg[:, 1 : ng + 1] / total[:, None]
    return jnp.where(ok[:, None], frac, 0.0)
