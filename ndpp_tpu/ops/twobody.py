"""Two-body (elastic + discrete-level inelastic) group-transfer moments.

The heart of configuration 1/2 (BASELINE.json:7-8). For each incident
energy E, two-body kinematics with reaction constants (C1, C2):

    E_cm' = C2 * (E - C1)                 (C1 = |Q|(A+1)/A, C2 = (A/(A+1))^2;
                                           elastic: C1 = 0)
    E'_lab(mu_cm) = E_cm' + [E + 2 mu_cm (A+1) sqrt(E E_cm')] / (A+1)^2
    mu_lab = mu_cm sqrt(E_cm'/E'_lab) + sqrt(E/E'_lab) / (A+1)

E'_lab is affine and monotone-increasing in mu_cm, so outgoing-group
boundaries map to closed-form mu_cm breakpoints (SURVEY.md sections 3.2,
8.2). The kernel preserves the reference's exact-breakpoint-then-GL
structure — no quadrature panel ever crosses a p(mu) knot or a group
boundary, which is what makes 1e-8 attainable:

  edges   = sort( knots(E) ++ breakpoints(E) )         (static width K+G+1)
  each subinterval integrates p(mu) P_l(mu_lab) with GL and scatters into
  its single outgoing group.

Inputs are host-prepared, padded, piecewise-LINEAR angular pdfs on per-E
knot rows (ndpp_tpu.host.prep normalizes histogram/equiprobable encodings
by knot doubling). Everything is statically shaped; jit-compiled once per
(shape, order, nq).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ndpp_tpu.ops.legendre import gl_nodes_weights, legendre_all
from ndpp_tpu.ops.segment import segment_group_sum


def _affine_coeffs_rows(knots, pdf, mid):
    """Per-point affine pdf coefficients (a, b) of the knot panel containing
    each query in `mid` (T, S). Masked sum over the static knot axis — no
    gathers. Queries must not sit exactly on interior knots (subinterval
    midpoints never do)."""
    k = knots.shape[1]
    a = jnp.zeros_like(mid)
    b = jnp.zeros_like(mid)
    covered = jnp.zeros_like(mid, dtype=bool)
    for j in range(k - 1):
        x0 = knots[:, j : j + 1]
        x1 = knots[:, j + 1 : j + 2]
        y0 = pdf[:, j : j + 1]
        y1 = pdf[:, j + 1 : j + 2]
        dx = x1 - x0
        slope = jnp.where(dx > 0, (y1 - y0) / jnp.where(dx > 0, dx, 1.0), 0.0)
        inter = y0 - slope * x0
        inside = (mid >= x0) & (mid < x1)
        if j == 0:
            inside = inside | (mid < x0)
        if j == k - 2:
            inside = inside | (mid >= x1)
        take = inside & ~covered
        a = jnp.where(take, inter, a)
        b = jnp.where(take, slope, b)
        covered = covered | take
    return a, b


def _interp_rows(knots, pdf, mu):
    """Piecewise-linear pdf evaluation per row, safe on duplicated knots.

    knots/pdf: (T, K) — non-decreasing knots (duplicates encode steps).
    mu: (T, S) query points. Returns (T, S).

    Instead of searchsorted + a per-row gather, accumulate the piecewise
    value as a masked sum over the static knot axis: for each panel j,
    add its affine extension where the query falls inside. Dense
    elementwise work, exactly equivalent (left panel clamps below, right
    panel above). Whether a gather is faster on the H100 is not measured
    (ROADMAP S4).
    """
    k = knots.shape[1]
    out = jnp.zeros_like(mu)
    covered = jnp.zeros_like(mu, dtype=bool)
    for j in range(k - 1):
        x0 = knots[:, j : j + 1]
        x1 = knots[:, j + 1 : j + 2]
        y0 = pdf[:, j : j + 1]
        y1 = pdf[:, j + 1 : j + 2]
        dx = x1 - x0
        t = jnp.clip((mu - x0) / jnp.where(dx > 0, dx, 1.0), 0.0, 1.0)
        val = y0 + jnp.where(dx > 0, t, 0.0) * (y1 - y0)
        inside = (mu >= x0) & (mu < x1)
        if j == 0:
            inside = inside | (mu < x0)  # clamp below
        if j == k - 2:
            inside = inside | (mu >= x1)  # clamp above
        take = inside & ~covered
        out = jnp.where(take, val, out)
        covered = covered | take
    return out


def twobody_panels(e, knots, pdf, bounds, c1, c2, awr, clamp: bool):
    """Shared prologue: exact subinterval panels for the two-body engines.

    Builds the sorted edge set (pdf knots ++ group-boundary mu breakpoints ++
    graded -1 ladder) and per-subinterval affine pdf coefficients.

    Returns (mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e).
    """
    # kinematic constants may be scalars or per-row (T,) arrays (multi-nuclide batches)
    c1 = jnp.broadcast_to(jnp.asarray(c1, dtype=e.dtype), e.shape)
    c2 = jnp.broadcast_to(jnp.asarray(c2, dtype=e.dtype), e.shape)
    awr = jnp.broadcast_to(jnp.asarray(awr, dtype=e.dtype), e.shape)
    ap1 = awr + 1.0  # (T,)

    ecm = c2 * (e - c1)  # (T,) outgoing CM energy
    valid_e = ecm > 0.0
    ecm = jnp.where(valid_e, ecm, 1.0)  # keep math finite on masked rows
    e_safe = jnp.where(valid_e, e, 1.0)

    base = ecm + e_safe / ap1**2  # E'_lab = base + slope * mu_cm
    slope = 2.0 * jnp.sqrt(e_safe * ecm) / ap1

    # Group-boundary breakpoints in mu_cm, clipped into [-1, 1]. Under
    # clamping the outermost boundaries are pushed to +-inf so the edge
    # groups swallow out-of-range outgoing energies. `bounds` may be the
    # shared (G+1,) table or PER-ROW (T, B+1) windows (the banded path:
    # each row carries only the boundaries its kinematic reach can hit).
    if bounds.ndim == 1:
        bounds2 = jnp.broadcast_to(bounds[None, :], (e.shape[0], bounds.shape[0]))
    else:
        bounds2 = bounds
    if clamp:
        ninf = jnp.full((bounds2.shape[0], 1), -jnp.inf, dtype=bounds2.dtype)
        pinf = jnp.full((bounds2.shape[0], 1), jnp.inf, dtype=bounds2.dtype)
        eff_bounds = jnp.concatenate([ninf, bounds2[:, 1:-1], pinf], axis=1)
    else:
        eff_bounds = bounds2
    brk = (eff_bounds - base[:, None]) / slope[:, None]  # (T, G+1 | B+1)
    brk = jnp.clip(brk, -1.0, 1.0)

    # Graded refinement near mu_cm = -1: when E'_lab(-1) ~ 0 (elastic on
    # A ~ 1, or near-threshold levels), mu_lab(mu_cm) has a sqrt-type
    # endpoint singularity that defeats fixed-order GL on a wide panel.
    # A geometric ladder of static split points restores fast convergence
    # everywhere at the cost of a few extra (harmless) subintervals.
    graded = jnp.asarray(-1.0 + 2.0 * 0.25 ** np.arange(1, 11), dtype=e.dtype)  # (10,)
    graded = jnp.broadcast_to(graded, (e.shape[0], graded.shape[0]))

    edges = jnp.sort(jnp.concatenate([knots, brk, graded], axis=1), axis=1)  # (T, M)
    lo = edges[:, :-1]
    hi = edges[:, 1:]
    half = 0.5 * (hi - lo)  # (T, S)
    mid = 0.5 * (hi + lo)
    # Every subinterval lies inside exactly ONE pdf panel (the edges include
    # all knots), so the pdf is a single affine a + b*mu per subinterval:
    # select coefficients by midpoint (S masked terms instead of S*Q interps)
    a_s, b_s = _affine_coeffs_rows(knots, pdf, mid)
    return mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e


def twobody_scatter_ref(m, mid, half, base, slope, valid_e, bounds, clamp: bool):
    """Reference epilogue: per-row scatter-add of (T, L+1, S) subinterval
    moments into outgoing groups -> (T, L+1, G). Semantically exact, and
    independent of the segment reduction; kept as the oracle for
    twobody_scatter (tests, selfcheck). On the GPU the adds are atomics,
    so their order, and the last bits, vary from run to run. Its speed
    against twobody_scatter on the H100 is not measured (ROADMAP S4)."""
    ng = bounds.shape[0] - 1
    elab_mid = base[:, None] + slope[:, None] * mid  # (T, S)
    gidx = jnp.searchsorted(bounds, elab_mid, side="right") - 1  # (T, S)
    if clamp:
        gidx = jnp.clip(gidx, 0, ng - 1)
        valid = (half[:, :] > 0.0) & valid_e[:, None]
    else:
        valid = (half[:, :] > 0.0) & (gidx >= 0) & (gidx < ng) & valid_e[:, None]
    gidx = jnp.clip(gidx, 0, ng - 1)
    m = m * valid[:, None, :]

    def scatter_row(m_row, g_row):
        return jnp.zeros((m_row.shape[0], ng), dtype=m_row.dtype).at[:, g_row].add(m_row)

    return jax.vmap(scatter_row)(m, gidx)  # (T, L+1, G)


def twobody_scatter(m, mid, half, base, slope, valid_e, bounds, clamp: bool):
    """Shared epilogue: (T, L+1, S) subinterval moments -> (T, L+1, G).

    Segment reduction: E'_lab(mid) is ascending along the sorted
    subinterval axis (slope > 0), so group indices are NON-DECREASING per
    row and the group sums are contiguous segments — delegated to
    ops.segment.segment_group_sum (no scatter HLO; see
    twobody_scatter_ref for the scatter-add reference).
    """
    elab_mid = base[:, None] + slope[:, None] * mid  # (T, S)
    valid = (half[:, :] > 0.0) & valid_e[:, None]
    m = m * valid[:, None, :]
    return segment_group_sum(m, elab_mid, bounds, clamp)


def _subinterval_moments(e, knots, pdf, bounds, c1, c2, awr, order: int, nq: int, clamp: bool):
    """Prologue + quadrature: (T, L+1, S) subinterval moments and the panel
    geometry the epilogue needs (m, mid, half, base, slope, valid_e)."""
    xq, wq = gl_nodes_weights(nq)
    xq = jnp.asarray(xq, dtype=e.dtype)
    wq = jnp.asarray(wq, dtype=e.dtype)
    mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e = twobody_panels(
        e, knots, pdf, bounds, c1, c2, awr, clamp
    )

    # Layout: (T, Q, S) keeps the wide subinterval axis minor for every
    # elementwise op, and the q-reduction is Q static adds — never
    # materializing a (T, S, Q, L+1) tensor with a 6-wide minor axis.
    mu_q = mid[:, None, :] + half[:, None, :] * xq[None, :, None]  # (T, Q, S)
    pdf_q = a_s[:, None, :] + b_s[:, None, :] * mu_q

    elab_q = base[:, None, None] + slope[:, None, None] * mu_q
    inv_sqrt_elab = jax.lax.rsqrt(elab_q)
    mu_lab = jnp.clip(
        (mu_q * jnp.sqrt(ecm)[:, None, None] + (jnp.sqrt(e_safe) / ap1)[:, None, None])
        * inv_sqrt_elab,
        -1.0,
        1.0,
    )

    weight = pdf_q * wq[None, :, None] * half[:, None, :]  # (T, Q, S)
    # Bonnet recurrence in place; per-l reduction over the Q axis
    p_prev = jnp.ones_like(mu_lab)
    m_list = [jnp.sum(weight, axis=1)]  # l = 0
    if order >= 1:
        p_cur = mu_lab
        m_list.append(jnp.sum(weight * p_cur, axis=1))
        for l in range(1, order):
            p_next = ((2 * l + 1) * mu_lab * p_cur - l * p_prev) / (l + 1)
            p_prev, p_cur = p_cur, p_next
            m_list.append(jnp.sum(weight * p_cur, axis=1))
    m = jnp.stack(m_list, axis=1)  # (T, L+1, S)
    return m, mid, half, base, slope, valid_e


@partial(jax.jit, static_argnames=("order", "nq", "clamp"))
def twobody_moments(e, knots, pdf, bounds, c1, c2, awr, order: int, nq: int = 16, clamp: bool = True):
    """Group-transfer Legendre moments for one two-body reaction.

    Args:
      e:      (T,) incident energies (eV).
      knots:  (T, K) mu_cm knots of the piecewise-linear p(mu|E) (padded by
              repeating the last knot).
      pdf:    (T, K) pdf values at the knots.
      bounds: (G+1,) ascending group boundaries (eV), or per-row (T, B+1)
              boundary WINDOWS covering each row's kinematic reach (the
              banded path — the result's group axis is then window-local
              and the caller owns the per-row offsets).
      c1, c2: reaction kinematic constants (eV, -); scalars.
      awr:    atomic weight ratio A; scalar.
      order:  max Legendre order L (static).
      nq:     GL points per subinterval (static).
      clamp:  if True (static), outgoing energies outside the group range
              collapse into the edge groups (standard multigroup practice:
              the bottom/top group catch everything past their outer
              boundary); if False such transfer is dropped.

    Returns:
      (T, L+1, G) moments f_{l,g'}(E): the expected value, per scattering
      event, of P_l(mu_lab) joint with outgoing energy in group g'.
      Rows with E below threshold are all zero.
    """
    m, mid, half, base, slope, valid_e = _subinterval_moments(
        e, knots, pdf, bounds, c1, c2, awr, order, nq, clamp
    )
    return twobody_scatter(m, mid, half, base, slope, valid_e, bounds, clamp)


@partial(jax.jit, static_argnames=("order", "nq", "clamp"))
def twobody_moments_scatter_ref(
    e, knots, pdf, bounds, c1, c2, awr, order: int, nq: int = 16, clamp: bool = True
):
    """twobody_moments with the scatter-add reference epilogue in place of
    the segment reduction (shared (G+1,) bounds only) — the accuracy
    gate's independent check of the production epilogue (selfcheck)."""
    m, mid, half, base, slope, valid_e = _subinterval_moments(
        e, knots, pdf, bounds, c1, c2, awr, order, nq, clamp
    )
    return twobody_scatter_ref(m, mid, half, base, slope, valid_e, bounds, clamp)


def twobody_constants(awr: float, q_ev: float) -> tuple[float, float]:
    """(C1, C2) for a two-body reaction with Q-value q_ev (Q=0 -> elastic)."""
    c1 = abs(q_ev) * (awr + 1.0) / awr
    c2 = (awr / (awr + 1.0)) ** 2
    return c1, c2
