"""Sorted-segment group reduction — a scatter-free group collapse.

Every group-collapse epilogue in this package has the same shape: per-row
quantities attached to a SORTED ladder of panel/subinterval midpoints must
be summed into the outgoing group containing each midpoint. The obvious
`zeros.at[gidx].add(m)` emits a scatter HLO, which adds in no fixed order
(atomics on the GPU); what either costs on the H100 is not measured
(ROADMAP S4).

Because the classification values are non-decreasing along the segment
axis, group sums are CONTIGUOUS runs: with C the running (cumulative) sum
of m and p_j the count of values below boundary j,

    out[g] = C[p_{g+1} - 1] - C[p_g - 1]        (C[-1] := 0)

— dense compares, one cumsum, and an exact one-hot selection (no
scatter/gather HLO). Selecting exactly one
lane per (row, boundary) keeps the selection EXACT in any float dtype
(adding zeros is exact), so this is bit-for-bit a reordering of the same
additions the scatter would do per group.

Counterpart of the reference's per-group accumulation loops (SURVEY.md
section 3.2 step 4); semantics match `jnp.searchsorted(side="right")`
classification: a midpoint exactly ON boundary j belongs to group j.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_group_sum(m, values, bounds, clamp: bool):
    """Sum sorted segments into groups: (T, C, S) -> (T, C, G).

    m:      (T, C, S) per-segment quantities (C = channels, e.g. L+1).
    values: (T, S) per-segment classification values, NON-DECREASING along
            S in every row. Padded/dead segments must carry m == 0 and a
            value that preserves the ordering (+inf tail pads are fine).
    bounds: (G+1,) ascending group boundaries, or PER-ROW (T, B+1) windows
            (the banded two-body path).
    clamp:  True  — outermost boundaries catch everything (standard
                    multigroup edge semantics: below-range mass lands in
                    group 0, above-range in group G-1);
            False — segments outside [bounds[0], bounds[-1]) are dropped
                    (the prefix-difference structure excludes them with no
                    explicit mask).
    """
    if bounds.ndim == 1:
        bounds = jnp.broadcast_to(bounds[None, :], (m.shape[0], bounds.shape[0]))
    ng = bounds.shape[1] - 1
    if clamp:
        ninf = jnp.full((bounds.shape[0], 1), -jnp.inf, dtype=bounds.dtype)
        pinf = jnp.full((bounds.shape[0], 1), jnp.inf, dtype=bounds.dtype)
        eff = jnp.concatenate([ninf, bounds[:, 1:-1], pinf], axis=1)
    else:
        eff = bounds
    c = jnp.cumsum(m, axis=2)  # (T, C, S)
    # p[t, j] = #segments with value < boundary j (ties -> upper group,
    # matching searchsorted side="right" classification)
    pj = jnp.sum(
        (values[:, None, :] < eff[:, :, None]).astype(jnp.int32), axis=2
    )  # (T, G+1)
    sel = _select_at(c, pj)  # (T, C, G+1): C[p_j - 1], 0 where p_j == 0
    out = sel[:, :, 1:] - sel[:, :, :-1]
    assert out.shape == (m.shape[0], m.shape[1], ng)
    return out


def _select_at(c, pj):
    """Exact lane selection sel[t, k, j] = c[t, k, pj[t, j] - 1] (0 where
    pj == 0) without gather/scatter HLOs: a one-hot masked reduction that
    XLA fuses into dense elementwise work (NOT an einsum/matmul — a matmul
    could run in reduced precision on f32 inputs; the masked sum is exact
    in any dtype because each (t, j) selects exactly ONE lane and adding
    zeros is exact)."""
    t, _, s = c.shape
    oh = (
        jax.lax.broadcasted_iota(jnp.int32, (t, pj.shape[1], s), 2)
        == (pj[:, :, None] - 1)
    )
    # (T, 1, J, S) mask against (T, C, 1, S) cumsums -> (T, C, J)
    return jnp.sum(jnp.where(oh[:, None, :, :], c[:, :, None, :], 0), axis=3)
