"""Free-gas (target-in-motion) thermal scattering moments with up-scatter.

Config 3 (BASELINE.json:9; SURVEY.md sections 3.3, 8.5). Model: Maxwellian
target of mass ratio A at temperature T (kT in eV), constant free-atom
cross section, isotropic CM scattering — the standard free-gas model; the
conditional-on-scatter kernel is independent of the cross-section value.

Coordinates (speed units y = sqrt(E), so E = y^2):

  v = sqrt(E) incident; gamma = A/(A+1); u' = gamma * v_r (CM outgoing speed)
  V_cm in [|v - gamma v_r|, v + gamma v_r]   for given relative speed v_r
  weight  w = v_r^2 * V_cm * exp(-beta^2 V^2),  beta^2 = A/kT,
          V^2 = -v^2/A + v_r^2/(A+1) + V_cm^2 (A+1)/A
  cos(v, V_cm) = c_a = (v^2 + V_cm^2 - gamma^2 v_r^2) / (2 v V_cm)
  E' uniform over [(V_cm-u')^2, (V_cm+u')^2] with density 1/(4 V_cm u');
  azimuthal average: <P_l(mu_lab)> = P_l(c_a) P_l(c_b),
  c_b = (v'^2 + V_cm^2 - u'^2) / (2 v' V_cm).

The innermost integral over v' = sqrt(E') of P_l(c_b) * 2v'/(4 V_cm u') is
a Laurent polynomial — evaluated in CLOSED FORM per outgoing group
(including the log term), so group boundaries cost nothing. The (v_r, V_cm)
quadrature uses per-row graded panels; normalization divides by the same
quadrature of the bare weight, which also yields sigma_eff/sigma_free for
free validation against the analytic Doppler-broadened formula.

f_{l,g'}(E,T) = [sum w P_l(c_a) J_{l,g'}] / [sum w], rows sum to 1 exactly.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ndpp_tpu.ops.legendre import gl_nodes_weights, legendre_all
from ndpp_tpu.ops.panelsplit import lagrange_cumulants

# per-row outer v_r panel offsets in units of 1/beta, graded around v_r = v
_VR_OFFSETS = np.array([-8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0, 8.0])
# middle V_cm panel offsets in units of the Gaussian width, graded around the
# weight peak V_cm* (the e^{-beta^2 V^2} band can be much narrower than the
# kinematic [|v - u|, v + u] range at high x = beta v)
_VCM_OFFSETS = np.array([-8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0, 8.0])


def _vcm_panel_nodes(v, vr, u, awr, beta, xc, wc, sb=None):
    """Graded V_cm quadrature nodes/weights for given (row, v_r) values.

    v/vr/u: (...,) tensors. When ``sb`` ((G+1,) sqrt-boundaries) is given,
    the exact kink lines V_cm = sb_g -+ u (where the inner group-clipped
    integral changes branch) are inserted as panel edges, keeping every GL
    panel smooth. Returns cc, w_c with a flattened trailing node axis.
    """
    dtype = v.dtype
    a_ratio = (awr + 1.0) / awr
    clo = jnp.abs(v - u)
    chi_ = v + u
    # weight peak: V^2 = 0 at V_cm*^2 = v^2/(A+1) - A vr^2/(A+1)^2
    vstar2 = v**2 / (awr + 1.0) - awr * vr**2 / (awr + 1.0) ** 2
    vstar = jnp.sqrt(jnp.maximum(vstar2, 0.0))
    anchor = jnp.clip(vstar, clo, chi_)
    # two ladder scales: quadratic regime (peak interior) and linear regime
    # (peak clipped at the domain edge, where dV^2/dV_cm ~ 2 V_cm a_ratio
    # makes the Gaussian band much narrower — the A ~ 1 high-x case)
    w_quad = 1.0 / (beta * jnp.sqrt(a_ratio))
    w_lin = 1.0 / (beta**2 * 2.0 * jnp.maximum(anchor, 1e-30) * a_ratio)
    offs = jnp.asarray(_VCM_OFFSETS, dtype=dtype)
    graded_q = jnp.clip(anchor[..., None] + w_quad[..., None] * offs, clo[..., None], chi_[..., None])
    graded_l = jnp.clip(anchor[..., None] + w_lin[..., None] * offs, clo[..., None], chi_[..., None])
    parts = [clo[..., None], graded_q, graded_l, chi_[..., None]]
    # |V_cm - u| branch switch: the inner-range lower end kinks at V_cm = u
    parts.append(jnp.clip(u[..., None], clo[..., None], chi_[..., None]))
    if sb is not None:
        finite = jnp.where(jnp.isfinite(sb), sb, 0.0)
        # kink families |V_cm - u| = sb_g and V_cm + u = sb_g reduce to the
        # two value sets u + sb_g and |u - sb_g|
        parts.append(jnp.clip(u[..., None] + finite, clo[..., None], chi_[..., None]))
        parts.append(jnp.clip(jnp.abs(u[..., None] - finite), clo[..., None], chi_[..., None]))
    edges = jnp.sort(jnp.concatenate(parts, axis=-1), axis=-1)
    mid = 0.5 * (edges[..., 1:] + edges[..., :-1])  # (..., PC)
    half = 0.5 * (edges[..., 1:] - edges[..., :-1])
    cc = (mid[..., None] + half[..., None] * xc).reshape(*mid.shape[:-1], -1)
    w_c = (half[..., None] * wc).reshape(*mid.shape[:-1], -1)
    return cc, w_c


def _leg_monomial_coeffs(order: int) -> list[np.ndarray]:
    """Monomial coefficients of P_l, l = 0..order (exact in f64 for l <= ~12)."""
    out = []
    for l in range(order + 1):
        c = np.zeros(l + 1)
        c[l] = 1.0
        out.append(np.polynomial.legendre.leg2poly(c))
    return out


def _inner_closed_form(lo, hi, cc, u, order: int):
    """J_l = (1/(2 C u)) * int_lo^hi P_l((y^2 + D)/(2 C y)) y dy, D = C^2 - u^2.

    lo/hi/cc/u broadcastable tensors (pre-clipped, lo <= hi); returns a list
    of L+1 tensors. Exact (power rule + log term), vectorized.
    """
    d = cc * cc - u * u
    inv2c = 1.0 / (2.0 * cc)
    coeffs = _leg_monomial_coeffs(order)
    lmax = order
    # powers y^p for p in [2 - lmax, lmax + 2]
    p_min = min(2 - lmax, 1)
    p_max = lmax + 2
    # Floor the lower limit so the Laurent terms (1/lo)^(order-2) stay
    # inside f32 range (~3.4e38), which an earlier backend's emulated f64
    # shared. Physically this drops outgoing energies below ~(floor)^2 eV —
    # utterly negligible.
    if lmax > 2:
        lo_floor = 10.0 ** (-min(30.0 / (lmax - 2), 12.0))
    else:
        lo_floor = 1e-12
    lo = jnp.maximum(lo, lo_floor)
    hi = jnp.maximum(hi, lo)
    pow_lo = {0: jnp.ones_like(lo), 1: lo}
    pow_hi = {0: jnp.ones_like(hi), 1: hi}
    for p in range(2, p_max + 1):
        pow_lo[p] = pow_lo[p - 1] * lo
        pow_hi[p] = pow_hi[p - 1] * hi
    inv_lo = 1.0 / lo
    inv_hi = 1.0 / hi
    for p in range(-1, p_min - 1, -1):
        pow_lo[p] = pow_lo[p + 1] * inv_lo
        pow_hi[p] = pow_hi[p + 1] * inv_hi
    log_diff = jnp.log(jnp.maximum(hi, 1e-30)) - jnp.log(jnp.maximum(lo, 1e-30))

    out = []
    from math import comb

    for l in range(order + 1):
        acc = jnp.zeros_like(lo)
        a = coeffs[l]
        for k in range(l + 1):
            if a[k] == 0.0:
                continue
            base = a[k]
            for m in range(k + 1):
                coef = base * comb(k, m)
                p_exp = 2 * m + 2 - k  # antiderivative exponent of the y^{2m+1-k} term
                dpow = d ** (k - m) if k - m > 0 else 1.0
                scale = coef * inv2c**k * dpow
                if p_exp == 0:
                    acc = acc + scale * log_diff
                else:
                    acc = acc + (scale / p_exp) * (pow_hi[p_exp] - pow_lo[p_exp])
        out.append(acc * inv2c / u)  # the 1/(2 C u) prefactor: inv2c/u
    return out


def _effective_sqrt_bounds(bounds, clamp: bool):
    """sqrt of group boundaries, with edge groups extended under clamping."""
    sb = jnp.sqrt(jnp.maximum(bounds, 0.0))
    if not clamp:
        return sb
    lo = jnp.zeros((1,), dtype=bounds.dtype)
    hi = jnp.full((1,), jnp.inf, dtype=bounds.dtype)
    return jnp.concatenate([lo, sb[1:-1], hi])


@partial(jax.jit, static_argnames=("order", "nq_r", "nq_c", "clamp"))
def freegas_moments(e, awr, kt, bounds, order: int, nq_r: int = 8, nq_c: int = 12, clamp: bool = True):
    """Free-gas transfer moments: (T, L+1, G), rows normalized per scatter.

    e: (T,) incident energies (eV); awr: A; kt: temperature (eV);
    bounds: (G+1,) group boundaries (eV).
    """
    dtype = e.dtype
    ng = bounds.shape[0] - 1
    v = jnp.sqrt(e)  # (T,)
    # awr/kt may be scalars or per-row (T,) arrays (multi-nuclide batches)
    awr = jnp.broadcast_to(jnp.asarray(awr, dtype=dtype), e.shape)
    kt = jnp.broadcast_to(jnp.asarray(kt, dtype=dtype), e.shape)
    gamma = awr / (awr + 1.0)  # (T,)
    beta = jnp.sqrt(awr / kt)
    inv_beta = 1.0 / beta

    sb = _effective_sqrt_bounds(bounds, clamp)  # (G+1,)

    # per-row outer panels over v_r: Maxwellian-graded offsets plus the
    # closed-form kink locations where a middle-dimension split line
    # (V_cm = sb_g -+ u) crosses the V_cm domain ends |v - gamma v_r| and
    # v + gamma v_r:  v_r in {(v + sb_g)/2gamma, (v - sb_g)/2gamma,
    # (sb_g - v)/2gamma}
    offsets = jnp.asarray(_VR_OFFSETS, dtype=dtype)
    graded_r = v[:, None] + inv_beta[:, None] * offsets[None, :]  # (T, P0+1)
    lo_r = jnp.maximum(v - 8.0 * inv_beta, 0.0)[:, None]
    hi_r = (v + 8.0 * inv_beta)[:, None]
    sbf = jnp.where(jnp.isfinite(sb), sb, 0.0)[None, :]
    g2 = (2.0 * gamma)[:, None]
    # families (v + sb)/2gamma and |v - sb|/2gamma (the latter merges the
    # (v - sb) and (sb - v) sets)
    kinks = jnp.concatenate(
        [
            (v[:, None] + sbf) / g2,
            jnp.abs(v[:, None] - sbf) / g2,
        ],
        axis=1,
    )
    kinks = jnp.clip(kinks, lo_r, hi_r)
    edges = jnp.sort(jnp.concatenate([jnp.maximum(graded_r, 0.0), kinks], axis=1), axis=1)
    pm = edges.shape[1] - 1
    mid_p = 0.5 * (edges[:, 1:] + edges[:, :-1])
    half_p = 0.5 * (edges[:, 1:] - edges[:, :-1])

    xr, wr = gl_nodes_weights(nq_r)
    xr = jnp.asarray(xr, dtype=dtype)
    wr = jnp.asarray(wr, dtype=dtype)
    xc, wc = gl_nodes_weights(nq_c)
    xc = jnp.asarray(xc, dtype=dtype)
    wc = jnp.asarray(wc, dtype=dtype)

    p_arr = jnp.asarray(np.repeat(np.arange(pm), nq_r), dtype=jnp.int32)
    q_arr = jnp.asarray(np.tile(np.arange(nq_r), pm), dtype=jnp.int32)

    a_ratio = (awr + 1.0) / awr

    def body(carry, inp):
        acc_num, acc_den = carry
        p_idx, q_idx = inp
        mid_c = jax.lax.dynamic_index_in_dim(mid_p, p_idx, axis=1, keepdims=False)  # (T,)
        half_c = jax.lax.dynamic_index_in_dim(half_p, p_idx, axis=1, keepdims=False)
        vr = mid_c + half_c * jnp.take(xr, q_idx)  # (T,)
        w_r = half_c * jnp.take(wr, q_idx)  # (T,)

        u = gamma * vr  # (T,)
        cc, w_c = _vcm_panel_nodes(v, vr, u, awr, beta, xc, wc, sb)  # (T, C)

        v2 = (v**2)[:, None]
        vsq = -v2 / awr[:, None] + (vr**2)[:, None] / (awr + 1.0)[:, None] + cc**2 * a_ratio[:, None]
        weight = (
            (vr**2)[:, None] * cc * jnp.exp(jnp.minimum(-(beta**2)[:, None] * vsq, 0.0)) * w_c * w_r[:, None]
        )  # (T, C); exponent clamped: see pointwise kernel note

        c_a = jnp.clip((v2 + cc**2 - (u**2)[:, None]) / (2.0 * v[:, None] * cc), -1.0, 1.0)
        pl_a = legendre_all(c_a, order)  # (T, C, L+1)

        # inner: closed form per group over [max(|C-u|, sb_g), min(C+u, sb_{g+1})]
        u2 = u[:, None, None]
        cc3 = cc[:, :, None]
        rng_lo = jnp.abs(cc3 - u2)  # (T, C, 1)
        rng_hi = cc3 + u2
        lo_g = jnp.maximum(rng_lo, sb[None, None, :-1])  # (T, C, G)
        hi_g = jnp.minimum(rng_hi, sb[None, None, 1:])
        valid = hi_g > lo_g
        lo_s = jnp.where(valid, lo_g, 1.0)
        hi_s = jnp.where(valid, hi_g, 1.0)
        j_list = _inner_closed_form(lo_s, hi_s, cc3, u2, order)  # L+1 x (T, C, G)

        num_terms = []
        for l in range(order + 1):
            jl = jnp.where(valid, j_list[l], 0.0)
            num_terms.append(jnp.einsum("tc,tc,tcg->tg", weight, pl_a[:, :, l], jl))
        num = jnp.stack(num_terms, axis=1)  # (T, L+1, G)
        den = jnp.sum(weight, axis=1)  # (T,)
        return (acc_num + num, acc_den + den), None

    tt = e.shape[0]
    # derive the init carry from input data so its mesh-varying type matches
    # the body output under shard_map
    zrow = 0.0 * e
    init = (jnp.zeros((tt, order + 1, ng), dtype=dtype) + zrow[:, None, None], zrow)
    (num, den), _ = jax.lax.scan(body, init, (p_arr, q_arr))
    den = jnp.where(den > 0, den, 1.0)
    return num / den[:, None, None]


@partial(jax.jit, static_argnames=("nq_r", "nq_c"))
def freegas_sigma_eff_ratio(e, awr, kt, nq_r: int = 8, nq_c: int = 8):
    """sigma_eff/sigma_free = vbar_r / v computed with the SAME quadrature.

    Validation hook: the analytic result is
      (1 + 1/(2x^2)) erf(x) + exp(-x^2)/(sqrt(pi) x),  x = sqrt(A E / kT).
    Agreement checks the (v_r, V_cm) quadrature independently of any moments.
    """
    dtype = e.dtype
    v = jnp.sqrt(e)
    gamma = awr / (awr + 1.0)
    beta = jnp.sqrt(awr / kt)
    inv_beta = 1.0 / beta
    offsets = jnp.asarray(_VR_OFFSETS, dtype=dtype)
    edges = jnp.maximum(v[:, None] + inv_beta * offsets[None, :], 0.0)
    edges = jnp.sort(edges, axis=1)
    mid_p = 0.5 * (edges[:, 1:] + edges[:, :-1])
    half_p = 0.5 * (edges[:, 1:] - edges[:, :-1])
    xr, wr = gl_nodes_weights(nq_r)
    xc, wc = gl_nodes_weights(nq_c)
    xr = jnp.asarray(xr, dtype=dtype)
    wr = jnp.asarray(wr, dtype=dtype)
    xc = jnp.asarray(xc, dtype=dtype)
    wc = jnp.asarray(wc, dtype=dtype)
    a_ratio = (awr + 1.0) / awr

    vr = mid_p[:, :, None] + half_p[:, :, None] * xr[None, None, :]  # (T, P, R)
    w_r = half_p[:, :, None] * wr[None, None, :]
    u = gamma * vr
    cc, w_c = _vcm_panel_nodes(jnp.broadcast_to(v[:, None, None], vr.shape), vr, u, awr, beta, xc, wc)
    v2 = (v**2)[:, None, None, None]
    vsq = -v2 / awr + (vr**2)[..., None] / (awr + 1.0) + cc**2 * a_ratio
    wgt = (vr**2)[..., None] * cc * jnp.exp(jnp.minimum(-(beta**2) * vsq, 0.0)) * w_c * w_r[..., None]
    # vbar_r = int f(V) v_r d3V = (2 beta^3 / (sqrt(pi) gamma v)) * N_full
    # (the weight already carries the v_r rate factor via the v_r^2 Jacobian
    # times rate); sigma_eff/sigma_free = vbar_r / v.
    n_full = jnp.sum(wgt, axis=(1, 2, 3))
    return 2.0 * beta**3 * n_full / (jnp.sqrt(jnp.pi) * gamma * v**2)


# ---------------------------------------------------------------------------
# Pointwise-E' formulation (v2): cost per outgoing point independent of the
# group count. The kink-panel ("grouped") kernel above inserts O(G) exact
# breakpoints in BOTH quadrature dimensions, which is unbeatable for coarse
# structures but scales O(G^2) in nodes, too large at G=361. Here the differential kernel dF_l/dE'(y') is evaluated at per-group
# Gauss-Legendre points in y' = sqrt(E') (the only non-smooth E' feature,
# the cusp at y' = v, becomes a panel edge), with a smooth (v_r, V_cm)
# quadrature per point whose THREE closed-form v_r kinks
# {y/gamma, (v -+ y)/(2 gamma)} do not depend on the group structure.


@partial(
    jax.jit,
    static_argnames=("order", "nq_g", "nq_r", "nq_c", "chunk", "nfill_r", "nfill_c", "ngeo_c"),
)
def freegas_moments_pointwise(
    e,
    awr,
    kt,
    bounds,
    order: int,
    nq_g: int = 8,
    nq_r: int = 8,
    nq_c: int = 8,
    chunk: int = 8,
    nfill_r: int = 7,
    nfill_c: int = 7,
    ngeo_c: int = 8,
):
    """Free-gas transfer moments via the pointwise-E' path: (T, L+1, G).

    bounds must be FINITE and COVER the kinematically reachable outgoing
    range (the driver windows them to it): rows are normalized by their own
    l=0 total, which makes sum_g f0 = 1 exactly and cancels the common-mode
    quadrature error between groups (same convention as the reference-style
    grouped kernel). A non-covering window silently renormalizes the
    retained mass to 1 — don't do that.
    """
    dtype = e.dtype
    ng = bounds.shape[0] - 1
    v = jnp.sqrt(e)  # (T,)
    awr = jnp.broadcast_to(jnp.asarray(awr, dtype=dtype), e.shape)
    kt = jnp.broadcast_to(jnp.asarray(kt, dtype=dtype), e.shape)
    gamma = awr / (awr + 1.0)
    beta = jnp.sqrt(awr / kt)
    inv_beta = 1.0 / beta
    a_ratio = (awr + 1.0) / awr
    tt = e.shape[0]

    sb = jnp.sqrt(jnp.maximum(bounds, 0.0))  # (G+1,) finite

    # --- outgoing panels in y: group boundaries + the cusp at y = v, plus
    # graded ladders resolving the thermal spike around y = v and the
    # smeared 0K down-scatter edge at y = sqrt(alpha) v (coarse group panels
    # would otherwise straddle the entire kernel support)
    delta = 2.0 * gamma * inv_beta  # thermal smearing width in y
    lad = jnp.asarray(np.array([-32.0, -16.0, -8.0, -4.0, -2.0, -1.0, -0.5, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0]), dtype=dtype)
    y_alpha = v * jnp.abs(awr - 1.0) / (awr + 1.0)
    extra = jnp.concatenate(
        [
            v[:, None] + delta[:, None] * lad[None, :],
            y_alpha[:, None] + delta[:, None] * lad[None, :],
            jnp.stack([v, y_alpha], axis=1),
        ],
        axis=1,
    )
    extra = jnp.clip(extra, sb[0], sb[-1])
    y_edges = jnp.sort(
        jnp.concatenate([jnp.broadcast_to(sb, (tt, ng + 1)), extra], axis=1), axis=1
    )  # (T, G+1+30)
    npan = y_edges.shape[1] - 1
    xg, wg = gl_nodes_weights(nq_g)
    xg = jnp.asarray(xg, dtype=dtype)
    wg = jnp.asarray(wg, dtype=dtype)
    pmid = 0.5 * (y_edges[:, 1:] + y_edges[:, :-1])  # (T, P)
    phalf = 0.5 * (y_edges[:, 1:] - y_edges[:, :-1])
    # panel -> group classification by midpoint
    pg = jnp.clip(jnp.searchsorted(bounds, pmid**2, side="right") - 1, 0, ng - 1)  # (T, P)

    xr, wr = gl_nodes_weights(nq_r)
    xr = jnp.asarray(xr, dtype=dtype)
    wr = jnp.asarray(wr, dtype=dtype)
    xc, wc = gl_nodes_weights(nq_c)
    xc = jnp.asarray(xc, dtype=dtype)
    wc = jnp.asarray(wc, dtype=dtype)

    lo_r_dom = jnp.maximum(v - 8.0 * inv_beta, 0.0)
    hi_r_dom = v + 8.0 * inv_beta
    ladder = jnp.asarray(_VR_OFFSETS, dtype=dtype)  # 11 offsets

    n_chunks = -(-npan // chunk)
    pad_p = n_chunks * chunk
    pmid_p = jnp.pad(pmid, ((0, 0), (0, pad_p - npan)))
    phalf_p = jnp.pad(phalf, ((0, 0), (0, pad_p - npan)))  # padded panels: half=0 -> zero weight
    chunk_ids = jnp.arange(n_chunks) * chunk

    offs_c = jnp.asarray(_VCM_OFFSETS, dtype=dtype)

    def body(carry, c0):
        acc = carry  # (T, P_pad, L+1) accumulated panel integrals
        pm = jax.lax.dynamic_slice_in_dim(pmid_p, c0, chunk, axis=1)  # (T, PC)
        ph = jax.lax.dynamic_slice_in_dim(phalf_p, c0, chunk, axis=1)
        y = (pm[:, :, None] + ph[:, :, None] * xg[None, None, :]).reshape(tt, chunk * nq_g)  # (T, NY)
        wy = (ph[:, :, None] * wg[None, None, :]).reshape(tt, chunk * nq_g) * 2.0 * y  # dE' = 2y dy

        dsig = _pointwise_dens(
            y, v, awr, gamma, beta, inv_beta, a_ratio, lo_r_dom, hi_r_dom,
            ladder, offs_c, xr, wr, xc, wc, order, nfill_r, nfill_c, ngeo_c,
        )

        # panel integrals for this chunk: sum GL points per panel
        vals = jnp.stack(dsig, axis=-1) * wy[..., None]  # (T, NY, L+1)
        vals = vals.reshape(tt, chunk, nq_g, order + 1).sum(axis=2)  # (T, PC, L+1)
        acc = jax.lax.dynamic_update_slice_in_dim(
            acc, jax.lax.dynamic_slice_in_dim(acc, c0, chunk, axis=1) + vals, c0, axis=1
        )
        return acc, None

    init = jnp.zeros((tt, pad_p, order + 1), dtype=dtype) + (0.0 * e)[:, None, None]
    panel_vals, _ = jax.lax.scan(body, init, chunk_ids)

    # normalization: the numerator's own l=0 total over the (covering)
    # window — exact row sums by construction, and the common-mode
    # quadrature error cancels between groups (see docstring)
    n_full = jnp.sum(panel_vals[:, :, 0], axis=1)
    n_full = jnp.where(n_full > 0, n_full, 1.0)

    # scatter panels -> groups
    pgp = jnp.pad(pg, ((0, 0), (0, pad_p - npan)))
    def row_scatter(vals_row, g_row):
        return jnp.zeros((ng, order + 1), dtype=vals_row.dtype).at[g_row].add(vals_row)

    out = jax.vmap(row_scatter)(panel_vals, pgp)  # (T, G, L+1)
    return jnp.swapaxes(out, 1, 2) / n_full[:, None, None]


@partial(
    jax.jit,
    static_argnames=("order", "nq_g", "nq_r", "nq_c", "chunk", "nfill_r", "nfill_c", "ngeo_c", "nfill_y"),
)
def freegas_moments_panelsplit(
    e,
    awr,
    kt,
    bounds,
    order: int,
    nq_g: int = 10,
    nq_r: int = 8,
    nq_c: int = 8,
    chunk: int = 8,
    nfill_r: int = 7,
    nfill_c: int = 7,
    ngeo_c: int = 8,
    nfill_y: int = 8,
):
    """Pointwise free-gas moments with G-INDEPENDENT evaluation cost: (T, L+1, G).

    Same physics and inner (v_r, V_cm) quadrature as
    freegas_moments_pointwise, but the outgoing-y axis is panelized ONLY at
    the integrand's own structure — the cusps y = v and y = sqrt(alpha) v,
    graded kT-width ladders around them, uniform fill, and the window ends
    — NOT at group boundaries, across which dF_l/dE' is smooth. Panel GL
    sums give totals; each group boundary's partial integral inside its
    panel comes from the GL-node Lagrange interpolant, whose full-panel
    integral IS the GL sum (GL weights are the integrals of the Lagrange
    basis), so cumulative sums telescope exactly and the row
    self-normalization stays exact. Cost per row ~ (31 + nfill_y) panels x
    nq_g inner evaluations regardless of G; the round-1 scheme paid
    (G + 31) x nq_g — ~6x more at the production 361-group windows.

    bounds: FINITE covering window, ascending (same contract as
    freegas_moments_pointwise).
    """
    dtype = e.dtype
    v = jnp.sqrt(e)  # (T,)
    awr = jnp.broadcast_to(jnp.asarray(awr, dtype=dtype), e.shape)
    kt = jnp.broadcast_to(jnp.asarray(kt, dtype=dtype), e.shape)
    gamma = awr / (awr + 1.0)
    beta = jnp.sqrt(awr / kt)
    inv_beta = 1.0 / beta
    a_ratio = (awr + 1.0) / awr

    xr, wr = gl_nodes_weights(nq_r)
    xr = jnp.asarray(xr, dtype=dtype)
    wr = jnp.asarray(wr, dtype=dtype)
    xc, wc = gl_nodes_weights(nq_c)
    xc = jnp.asarray(xc, dtype=dtype)
    wc = jnp.asarray(wc, dtype=dtype)
    lo_r_dom = jnp.maximum(v - 8.0 * inv_beta, 0.0)
    hi_r_dom = v + 8.0 * inv_beta
    ladder = jnp.asarray(_VR_OFFSETS, dtype=dtype)
    offs_c = jnp.asarray(_VCM_OFFSETS, dtype=dtype)

    def dens_fn(y):
        return _pointwise_dens(
            y, v, awr, gamma, beta, inv_beta, a_ratio, lo_r_dom, hi_r_dom,
            ladder, offs_c, xr, wr, xc, wc, order, nfill_r, nfill_c, ngeo_c,
        )

    return _outgoing_panelsplit(e, v, awr, kt, bounds, order, nq_g, nfill_y, chunk, dens_fn)


@partial(
    jax.jit,
    static_argnames=("order", "nq_u", "nq_g", "chunk", "nfill_y"),
)
def freegas_moments_sab(
    e,
    awr,
    kt,
    bounds,
    order: int,
    nq_u: int = 24,
    nq_g: int = 20,
    chunk: int = 8,
    nfill_y: int = 8,
):
    """Free-gas moments via the EXACT scattering-law density: (T, L+1, G).

    The (v_r, V_cm) double quadrature of the pointwise kernels collapses to
    a SINGLE smooth Gaussian integral (scripts/freegas_sab_closed.py holds
    the full derivation and its validation — worst 2.6e-11 relative against
    the independent dense (v_r, V_cm) reference across an (A, E, E') matrix):

      alpha = (E + E' - 2 mu sqrt(EE'))/(A kT)  in  [a-, a+],
      S_freegas(alpha, beta) = (4 pi alpha)^(-1/2) e^{-(alpha+beta)^2/(4 alpha)},
      mu(alpha) linear  =>  with t = sqrt(alpha), u = (t - |beta|/t)/2:

        dF_l/dE' ~ e^{-max(beta,0)} int du (dt/du) e^{-u^2} P_l(m0 - m1 t(u)^2),
        t(u) = u + sqrt(u^2 + |beta|)  (monotone, both scatter directions
        via the identity ((t+c/t)/2)^2 = u^2 + c).

    ~10^2 nodes per outgoing point replace the ~6.6e4 (v_r, V_cm) nodes of
    the quadrature kernels; the outgoing-y axis reuses the panel-split
    machinery (group splits from the GL-node Lagrange interpolant), so the
    total per-row cost is both G-independent and ~100x lighter.

    Defaults nq_u=24, nq_g=20 (round 3, measured at the production
    257-group window against a 32/24-node refined self): round-2's
    (16, 10) sat at 3.7e-7 worst absolute (A~1, E=10 eV: high-l Legendre
    structure across wide y panels is nq_g-limited; deep-thermal heavy-A
    rows are nq_u-limited). The shipped pair holds the whole (A, E) test
    matrix at <= ~5e-10 absolute on row-normalized moments AND <= 1e-8
    per-element relative on every element >= 10% of the row's dominant
    moment (tests/test_freegas_production.py).

    bounds: FINITE covering window, ascending.
    """
    dtype = e.dtype
    v = jnp.sqrt(e)
    awr = jnp.broadcast_to(jnp.asarray(awr, dtype=dtype), e.shape)
    kt = jnp.broadcast_to(jnp.asarray(kt, dtype=dtype), e.shape)

    def dens_fn(y):
        return _sab_dens(y, v, awr, kt, order, nq_u)

    return _outgoing_panelsplit(e, v, awr, kt, bounds, order, nq_g, nfill_y, chunk, dens_fn)


_SAB_ULAD = np.array([-6.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0, 6.0])
_SAB_CLAD = np.array([-8.0, -4.0, -2.0, -1.0, 1.0, 2.0, 4.0, 8.0])
_UCLIP = 8.5


def _sab_dens(y, v, awr, kt, order: int, nq_u: int):
    """Exact dF_l/dE' at outgoing points y via the free-gas scattering law.

    y: (T, NY); returns a list of L+1 (T, NY) arrays (up to an E-row-only
    constant factor, which the caller's row normalization cancels).
    Endpoint u-values use the exact identities c/t- = (y+v) sqrt(A/kT) and
    c/t+ = |y-v| sqrt(A/kT) (no 0/0 at the elastic point; for u < 0 at
    beta -> 0 the Jacobian t/sqrt(u^2+c) -> 0 kills the spurious segment
    continuously). Panels: a fixed u-ladder for the Gaussian plus a
    sqrt(|beta|)-scaled ladder resolving the sqrt(u^2+c) curvature at
    u ~ 0 (the elastic cusp).
    """
    dtype = y.dtype
    tt, ny = y.shape
    vv = v[:, None]
    akt = (awr * kt)[:, None]
    sq_akt = jnp.sqrt(akt)
    sq_a_kt = jnp.sqrt(awr / kt)[:, None]
    dy = jnp.abs(y - vv)
    sy = y + vv
    beta_s = (y * y - vv * vv) / kt[:, None]  # signed energy transfer / kT
    c = jnp.abs(beta_s)
    u_lo = jnp.maximum(0.5 * (dy / sq_akt - sy * sq_a_kt), -_UCLIP)
    u_hi = jnp.minimum(0.5 * (sy / sq_akt - dy * sq_a_kt), _UCLIP)
    u_hi = jnp.maximum(u_hi, u_lo)
    denom = jnp.maximum(2.0 * vv * y, 1e-30)
    m0 = (vv * vv + y * y) / denom
    m1 = akt / denom

    sc = jnp.sqrt(c)
    ulad = jnp.asarray(_SAB_ULAD, dtype=dtype)
    clad = jnp.asarray(_SAB_CLAD, dtype=dtype)
    edges = jnp.concatenate(
        [
            u_lo[..., None],
            jnp.clip(jnp.broadcast_to(ulad, (tt, ny, ulad.shape[0])), u_lo[..., None], u_hi[..., None]),
            jnp.clip(sc[..., None] * clad, u_lo[..., None], u_hi[..., None]),
            u_hi[..., None],
        ],
        axis=-1,
    )
    edges = jnp.sort(edges, axis=-1)  # (T, NY, P+1)
    xq, wq = gl_nodes_weights(nq_u)
    xq = jnp.asarray(xq, dtype=dtype)
    wq = jnp.asarray(wq, dtype=dtype)
    pm = 0.5 * (edges[..., 1:] + edges[..., :-1])
    ph = 0.5 * (edges[..., 1:] - edges[..., :-1])
    u = pm[..., None] + ph[..., None] * xq  # (T, NY, P, Q)
    w = ph[..., None] * wq
    root = jnp.sqrt(u * u + c[..., None, None])
    t = u + root
    jac = t / jnp.maximum(root, 1e-30)
    expo = -(u * u) - jnp.maximum(beta_s, 0.0)[..., None, None]
    base = w * jac * jnp.exp(expo)
    mu = jnp.clip(m0[..., None, None] - m1[..., None, None] * t * t, -1.0, 1.0)

    dsig = [jnp.sum(base, axis=(2, 3))]
    if order >= 1:
        p_prev = jnp.ones_like(mu)
        p_cur = mu
        dsig.append(jnp.sum(base * p_cur, axis=(2, 3)))
        for l in range(1, order):
            p_next = ((2 * l + 1) * mu * p_cur - l * p_prev) / (l + 1)
            p_prev, p_cur = p_cur, p_next
            dsig.append(jnp.sum(base * p_cur, axis=(2, 3)))
    return dsig


def _outgoing_panelsplit(e, v, awr, kt, bounds, order: int, nq_g: int, nfill_y: int, chunk: int, dens_fn):
    """Shared outgoing-axis machinery of the panel-split kernels.

    Panels at the integrand's own structure only; group-boundary splits via
    the GL-node Lagrange interpolant (see freegas_moments_panelsplit).
    dens_fn maps y (T, NY) -> list of L+1 (T, NY) density values.
    """
    dtype = e.dtype
    ng = bounds.shape[0] - 1
    gamma = awr / (awr + 1.0)
    beta = jnp.sqrt(awr / kt)
    inv_beta = 1.0 / beta
    tt = e.shape[0]

    sb = jnp.sqrt(jnp.maximum(bounds, 0.0))  # (G+1,) finite ascending

    # --- y panel edges: cusps + graded ladders + uniform fill + window ends
    delta = 2.0 * gamma * inv_beta
    lad = jnp.asarray(
        np.array([-32.0, -16.0, -8.0, -4.0, -2.0, -1.0, -0.5, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0]),
        dtype=dtype,
    )
    y_alpha = v * jnp.abs(awr - 1.0) / (awr + 1.0)
    fill_y = jnp.asarray(np.linspace(0.0, 1.0, nfill_y + 2), dtype=dtype)
    fills = sb[0] + (sb[-1] - sb[0]) * fill_y  # includes both window ends
    extra = jnp.concatenate(
        [
            v[:, None] + delta[:, None] * lad[None, :],
            y_alpha[:, None] + delta[:, None] * lad[None, :],
            jnp.stack([v, y_alpha], axis=1),
        ],
        axis=1,
    )
    extra = jnp.clip(extra, sb[0], sb[-1])
    y_edges = jnp.sort(
        jnp.concatenate([jnp.broadcast_to(fills, (tt, fills.shape[0])), extra], axis=1), axis=1
    )  # (T, NP+1)
    npan = y_edges.shape[1] - 1
    xg, wg = gl_nodes_weights(nq_g)
    xg = jnp.asarray(xg, dtype=dtype)
    wg = jnp.asarray(wg, dtype=dtype)
    pmid = 0.5 * (y_edges[:, 1:] + y_edges[:, :-1])  # (T, NP)
    phalf = 0.5 * (y_edges[:, 1:] - y_edges[:, :-1])

    # --- evaluate g(y) = dF_l/dE' * 2y at every panel GL node, chunked
    n_chunks = -(-npan // chunk)
    pad_p = n_chunks * chunk
    pmid_p = jnp.pad(pmid, ((0, 0), (0, pad_p - npan)))
    phalf_p = jnp.pad(phalf, ((0, 0), (0, pad_p - npan)))
    chunk_ids = jnp.arange(n_chunks) * chunk

    def body(carry, c0):
        gvals = carry  # (T, P_pad, NQG, L+1) node values of g
        pm = jax.lax.dynamic_slice_in_dim(pmid_p, c0, chunk, axis=1)
        ph = jax.lax.dynamic_slice_in_dim(phalf_p, c0, chunk, axis=1)
        y = (pm[:, :, None] + ph[:, :, None] * xg[None, None, :]).reshape(tt, chunk * nq_g)
        dsig = dens_fn(y)
        vals = jnp.stack(dsig, axis=-1) * (2.0 * y)[..., None]  # g(y) = dens * dE'/dy
        vals = vals.reshape(tt, chunk, nq_g, order + 1)
        gvals = jax.lax.dynamic_update_slice(gvals, vals, (0, c0, 0, 0))
        return gvals, None

    init = jnp.zeros((tt, pad_p, nq_g, order + 1), dtype=dtype) + (0.0 * e)[:, None, None, None]
    gvals, _ = jax.lax.scan(body, init, chunk_ids)

    # --- cumulative integrals C_l(sb_g) at every group boundary (shared
    # Lagrange machinery: ops/panelsplit.lagrange_cumulants)
    cumul = lagrange_cumulants(y_edges, pmid_p, phalf_p, gvals, wg, sb, npan, nq_g)

    out = cumul[:, 1:, :] - cumul[:, :-1, :]  # (T, G, L+1)
    n_full = cumul[:, -1, 0]
    n_full = jnp.where(n_full > 0, n_full, 1.0)
    return jnp.swapaxes(out, 1, 2) / n_full[:, None, None]


def _pointwise_dens(
    y, v, awr, gamma, beta, inv_beta, a_ratio, lo_r_dom, hi_r_dom,
    ladder, offs_c, xr, wr, xc, wc, order: int,
    nfill_r: int, nfill_c: int, ngeo_c: int,
):
    """dF_l/dE'(y) integrand values at outgoing points: list of L+1 (T, NY).

    The shared inner (v_r, V_cm) quadrature of the pointwise formulation
    (see freegas_moments_pointwise); y is (T, NY)."""
    dtype = y.dtype
    tt, ny = y.shape
    nq_r = xr.shape[0]

    # per-(row, y) outer v_r edges: Maxwellian ladder + 3 closed-form kinks.
    # |v - y| covers BOTH directions: for upscatter rows (y > v) the
    # reachable-v_r edge sits at (y - v)/(2 gamma) — without the abs the
    # kink clipped to the domain floor and GL panels straddled the hard
    # onset (the A~1, E <~ kT accuracy loss of round 1).
    base_e = (v[:, None] + inv_beta[:, None] * ladder[None, :])[:, None, :]  # (T,1,11)
    base_e = jnp.broadcast_to(base_e, (tt, ny, ladder.shape[0]))
    g2 = (2.0 * gamma)[:, None]
    kinks = jnp.stack(
        [y / gamma[:, None], jnp.abs(v[:, None] - y) / g2, (v[:, None] + y) / g2], axis=-1
    )  # (T, NY, 3)

    # C-ladder layout transitions: vstar(vr) crossing the C-domain ends
    # |y - u|, y + u, |v - u|, v + u — quadratic roots
    #   (A/(A+1)) vr^2 -+ 2 z gamma vr + z^2 - v^2/(A+1) = 0, z in {y, v}
    a2 = (awr / (awr + 1.0))[:, None]  # (T,1)
    vsc = (v**2 / (awr + 1.0))[:, None]
    root_parts = []
    for z in (y, jnp.broadcast_to(v[:, None], y.shape)):
        for sgn in (-1.0, 1.0):
            bq = sgn * 2.0 * z * gamma[:, None]
            disc = bq**2 - 4.0 * a2 * (z**2 - vsc)
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            root_parts.append((-bq + sq) / (2.0 * a2))
            root_parts.append((-bq - sq) / (2.0 * a2))
    vkinks = jnp.stack(root_parts, axis=-1)  # (T, NY, 8)

    # uniform fill edges: the Maxwellian ladder grades for the Gaussian
    # only; P_l(c_a)P_l(c_b) oscillates across the whole domain and
    # needs panels bounded everywhere (l >= 1 convergence)
    fill_fr = jnp.asarray(np.linspace(0.0, 1.0, nfill_r + 2)[1:-1], dtype=dtype)
    span_r = (hi_r_dom - lo_r_dom)[:, None, None]
    fill_r = lo_r_dom[:, None, None] + span_r * fill_fr[None, None, :]
    fill_r = jnp.broadcast_to(fill_r, (tt, ny, fill_fr.shape[0]))
    edges_r = jnp.sort(
        jnp.clip(
            jnp.concatenate([base_e, kinks, vkinks, fill_r], axis=-1),
            lo_r_dom[:, None, None],
            hi_r_dom[:, None, None],
        ),
        axis=-1,
    )  # (T, NY, 29)
    nrp = edges_r.shape[-1] - 1

    # scan (not a python loop) over v_r panels: the unrolled form kept every
    # panel's (T, NY, QR, C) temporaries live simultaneously in the HLO
    # schedule — measured 19.9 GB HBM for a 64-row/33-group tile (~30x the
    # arithmetic working set) — and the row-tile caps it forced were the
    # free-gas family's real throughput limiter. The scan body reuses one
    # panel's buffers; only the (L+1) x (T, NY) accumulators persist.
    def _rp_body(carry, rp):
        e_lo = jnp.take(edges_r, rp, axis=-1)
        e_hi = jnp.take(edges_r, rp + 1, axis=-1)
        rmid = 0.5 * (e_hi + e_lo)  # (T, NY)
        rhalf = 0.5 * (e_hi - e_lo)
        vr = rmid[..., None] + rhalf[..., None] * xr  # (T, NY, QR)
        w_r = rhalf[..., None] * wr
        u = gamma[:, None, None] * vr
        lo_c = jnp.maximum(jnp.abs(y[..., None] - u), jnp.abs(v[:, None, None] - u))
        hi_c = jnp.minimum(y[..., None] + u, v[:, None, None] + u)
        ok_rc = hi_c > lo_c
        # graded C nodes inside [lo_c, hi_c]
        vstar2 = (v**2 / (awr + 1.0))[:, None, None] - (awr / (awr + 1.0) ** 2)[
            :, None, None
        ] * vr**2
        vstar = jnp.sqrt(jnp.maximum(vstar2, 0.0))
        anchor = jnp.clip(vstar, lo_c, hi_c)
        w_quad = (1.0 / (beta * jnp.sqrt(a_ratio)))[:, None, None]
        w_lin = 1.0 / ((beta**2 * 2.0 * a_ratio)[:, None, None] * jnp.maximum(anchor, 1e-30))
        g_q = jnp.clip(anchor[..., None] + w_quad[..., None] * offs_c, lo_c[..., None], hi_c[..., None])
        g_l = jnp.clip(anchor[..., None] + w_lin[..., None] * offs_c, lo_c[..., None], hi_c[..., None])
        # fill for the oscillatory P_l factors (same reason as the v_r
        # fill above) + geometric grading at the lo end, where c_a/c_b
        # vary like 1/c when u ~ y ~ v (lo_c << hi_c)
        fill_cf = jnp.asarray(
            np.unique(
                np.concatenate(
                    [
                        np.linspace(0.0, 1.0, nfill_c + 2)[1:-1],
                        4.0 ** -np.arange(ngeo_c, 0, -1.0),
                    ]
                )
            ),
            dtype=dtype,
        )
        g_f = lo_c[..., None] + (hi_c - lo_c)[..., None] * fill_cf
        edges_c = jnp.sort(
            jnp.concatenate([lo_c[..., None], g_q, g_l, g_f, hi_c[..., None]], axis=-1), axis=-1
        )  # (T, NY, QR, EC)
        cmid = 0.5 * (edges_c[..., 1:] + edges_c[..., :-1])
        chalf = 0.5 * (edges_c[..., 1:] - edges_c[..., :-1])
        cc = (cmid[..., None] + chalf[..., None] * xc).reshape(tt, ny, nq_r, -1)  # (T,NY,QR,C)
        w_c = (chalf[..., None] * wc).reshape(tt, ny, nq_r, -1)

        v2_ = (v**2)[:, None, None, None]
        u4 = u[..., None]
        vsq = (
            -v2_ / awr[:, None, None, None]
            + (vr**2)[..., None] / (awr + 1.0)[:, None, None, None]
            + cc**2 * a_ratio[:, None, None, None]
        )
        # clamp the exponent at 0: vsq >= 0 for every VALID cell, but
        # masked/padded cells can see vsq ~ -v^2/A, and exp may overflow
        # (inf * 0-mask = NaN)
        wgt = (
            (vr**2)[..., None]
            * cc
            * jnp.exp(jnp.minimum(-(beta**2)[:, None, None, None] * vsq, 0.0))
            * w_c
            * w_r[..., None]
            * ok_rc[..., None]
        )
        # guard the PRODUCTS (individual factors can underflow to 0
        # jointly on masked/padded cells, giving 0/0 NaN that would
        # poison the 0-weight multiply)
        dens = wgt / jnp.maximum(4.0 * cc * u4, 1e-30)  # x E'-density 1/(4 C u)
        c_a = jnp.clip(
            (v2_ + cc**2 - u4**2) / jnp.maximum(2.0 * v[:, None, None, None] * cc, 1e-30),
            -1.0,
            1.0,
        )
        c_b = jnp.clip(
            ((y**2)[..., None, None] + cc**2 - u4**2)
            / jnp.maximum(2.0 * y[..., None, None] * cc, 1e-30),
            -1.0,
            1.0,
        )
        pa_prev = jnp.ones_like(c_a)
        pb_prev = jnp.ones_like(c_b)
        parts = [jnp.sum(dens, axis=(2, 3))]
        if order >= 1:
            pa_cur, pb_cur = c_a, c_b
            parts.append(jnp.sum(dens * pa_cur * pb_cur, axis=(2, 3)))
            for l in range(1, order):
                pa_next = ((2 * l + 1) * c_a * pa_cur - l * pa_prev) / (l + 1)
                pb_next = ((2 * l + 1) * c_b * pb_cur - l * pb_prev) / (l + 1)
                pa_prev, pa_cur = pa_cur, pa_next
                pb_prev, pb_cur = pb_cur, pb_next
                parts.append(jnp.sum(dens * pa_cur * pb_cur, axis=(2, 3)))
        return tuple(c + p for c, p in zip(carry, parts)), None

    # derive the init carry from input data so its mesh-varying type matches
    # the body output under shard_map (same trick as the old chunk scan)
    zero = 0.0 * y
    init = tuple(zero for _ in range(order + 1))
    dsig_t, _ = jax.lax.scan(_rp_body, init, jnp.arange(nrp, dtype=jnp.int32))
    return list(dsig_t)
