"""Shared Lagrange panel-split machinery (free-gas + continuum kernels).

A kernel integrates a SMOOTH density over panels chosen at the integrand's
own structure (cusps, data-knot images, graded ladders) — NOT at group
boundaries, across which the density is analytic. Panel GL sums give the
totals; each group boundary's partial integral inside its panel comes from
the GL-node Lagrange interpolant, whose full-panel integral IS the GL sum
(GL weights are the integrals of the Lagrange basis), so cumulative sums
telescope exactly: C(first edge) = 0, C(last edge) = total, and group
values are differences of boundary cumulants. Per-row cost is then
independent of the group count (round-2; first applied to the free-gas
kernels, then the continuum family).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ndpp_tpu.ops import select


def lagrange_antiderivative_coeffs(nq: int) -> np.ndarray:
    """(NQ, NQ+1) monomial coefficients of A_q(t) = int_{-1}^t L_q on GL nodes.

    L_q is the Lagrange basis on the nq-point Gauss-Legendre nodes; by the
    definition of GL weights, A_q(1) == w_q exactly, so partial-panel
    integrals built from these telescope consistently with GL panel sums.
    """
    x, w = np.polynomial.legendre.leggauss(nq)
    out = np.zeros((nq, nq + 1))
    for q in range(nq):
        roots = np.delete(x, q)
        poly = np.polynomial.polynomial.Polynomial.fromroots(roots)
        poly = poly / poly(x[q])
        integ = poly.integ(lbnd=-1.0)
        out[q, : integ.coef.size] = integ.coef
    assert np.allclose(out @ np.power(1.0, np.arange(nq + 1)), w, atol=1e-13)
    return out


def lagrange_cumulants(edges, pmid_p, phalf_p, gvals, wg, boundaries, npan: int, nq: int):
    """Cumulative panel integrals C_l evaluated at arbitrary boundaries.

    edges: (T, NP+1) ascending panel edges; pmid_p/phalf_p: (T, P_pad)
    padded panel mids/halves (pad halves = 0); gvals: (T, P_pad, NQ, L+1)
    density node values; wg: (NQ,) GL weights; boundaries: (NB,) shared or
    (T, NB) per-row. Returns (T, NB, L+1). Boundaries below the first edge
    give 0, above the last give the total (clip semantics of the panel
    lookup + t in [-1, 1]).

    Lookup realization (round 4, re-measured): each boundary needs the
    payload of exactly ONE panel — mid, half, the NQ x (L+1) node block,
    and the exclusive prefix — so the lookup is done with a single
    take_along_axis of a concatenated (T, P_pad, NQ*(L+1) + L+1) payload.
    The previous one-hot einsum realized the same lookup as
    T*NB*P*NQ*(L+1) f64-emulated MACs (~9e9 at the production continuum
    shape) and was ~20% of the whole continuum dispatch; the gather is
    information-proportional (T*NB*66 loads) and matched it to 4e-14.
    (Round 1's "gathers are ~10x the surrounding compute" finding was
    about replacing ~10 flops/element interpolation — here the alternative
    was ~1000x more flops, and the gather wins.)
    """
    dtype = gvals.dtype
    tt = edges.shape[0]
    pad_p = gvals.shape[1]
    nq_ = gvals.shape[2]
    l1 = gvals.shape[3]
    # Contractions here are written as broadcast-multiply + sum, NOT
    # einsum/dot: at these tiny contraction depths (q = 10, k = 11) a fused
    # elementwise multiply+reduce avoids a dot_general launch; its cost
    # against a dot on the H100 is not measured (ROADMAP S3).
    totals = phalf_p[..., None] * jnp.sum(gvals * wg[None, None, :, None], axis=2)  # (T, P_pad, L+1)
    prefix = jnp.cumsum(totals, axis=1) - totals  # exclusive

    b = boundaries if boundaries.ndim == 2 else jnp.broadcast_to(
        boundaries[None, :], (tt, boundaries.shape[0])
    )
    nb = b.shape[1]
    le = edges[:, None, :-1]  # (T, 1, P)
    pidx = jnp.clip(
        jnp.sum((le <= b[:, :, None]).astype(jnp.int32), axis=2) - 1, 0, npan - 1
    )  # (T, NB) int32
    # ONE exact one-hot f32 selection (ops/select) of the combined panel
    # payload [mid, half, node block, prefix]
    payload = jnp.concatenate(
        [pmid_p[:, :, None], phalf_p[:, :, None], gvals.reshape(tt, pad_p, nq_ * l1), prefix],
        axis=2,
    )
    pay_b = select.select_rows(payload, pidx)  # (T, NB, 2 + NQ*L1 + L1)
    mid_b = pay_b[:, :, 0]
    half_b = pay_b[:, :, 1]
    nodes_b = pay_b[:, :, 2 : 2 + nq_ * l1].reshape(tt, nb, nq_, l1)
    prefix_b = pay_b[:, :, 2 + nq_ * l1 :]  # (T, NB, L+1)
    # floor 1e-30 keeps the divisor normal in any float range
    t_b = jnp.clip((b - mid_b) / jnp.maximum(half_b, 1e-30), -1.0, 1.0)
    acoef = jnp.asarray(lagrange_antiderivative_coeffs(nq), dtype=dtype)  # (NQ, NQ+1)
    # powers by ITERATED MULTIPLICATION, not float `**`: a pow that routes
    # negative bases through exp/log returns NaN for t_b < 0 at boundaries
    # that sit in the lower half of their panel (an earlier backend did)
    pows = [jnp.ones_like(t_b)]
    for _ in range(nq):
        pows.append(pows[-1] * t_b)
    tpow = jnp.stack(pows, axis=-1)  # (T, NB, NQ+1)
    aq = jnp.sum(tpow[:, :, None, :] * acoef[None, None, :, :], axis=3)  # A_q(t_b)
    partial = half_b[..., None] * jnp.sum(aq[..., None] * nodes_b, axis=2)
    return prefix_b + partial
