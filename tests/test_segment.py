"""ops.segment.segment_group_sum vs a numpy scatter-add reference.

The segment reduction is the shared scatter-free epilogue of every
group-collapse kernel (twobody/continuum/freegas/chi); this pins its
semantics — searchsorted(side='right') classification, clamp edge
handling, +inf tail pads — against the obvious scatter implementation.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ndpp_tpu.ops.segment import segment_group_sum


def _ref(m, values, bounds, clamp):
    t, c, s = m.shape
    ng = bounds.size - 1
    out = np.zeros((t, c, ng))
    for ti in range(t):
        for si in range(s):
            if not np.isfinite(values[ti, si]):
                assert np.all(m[ti, :, si] == 0.0)
                continue
            g = np.searchsorted(bounds, values[ti, si], side="right") - 1
            if clamp:
                g = min(max(g, 0), ng - 1)
            elif g < 0 or g >= ng:
                continue
            out[ti, :, g] += m[ti, :, si]
    return out


@pytest.mark.parametrize("clamp", [True, False])
def test_matches_scatter_reference(clamp):
    rng = np.random.default_rng(5)
    t, c, s, ng = 7, 4, 40, 9
    bounds = np.sort(rng.uniform(0.0, 10.0, ng + 1))
    # sorted values straddling both out-of-range sides, with exact
    # boundary ties mixed in
    vals = np.sort(rng.uniform(-2.0, 12.0, (t, s)), axis=1)
    vals[:, 5] = bounds[3]  # tie exactly ON a boundary -> upper group
    vals = np.sort(vals, axis=1)
    m = rng.standard_normal((t, c, s))
    got = np.asarray(segment_group_sum(jnp.asarray(m), jnp.asarray(vals), jnp.asarray(bounds), clamp))
    np.testing.assert_allclose(got, _ref(m, vals, bounds, clamp), rtol=1e-13, atol=1e-14)


def test_inf_tail_pads_contribute_zero():
    rng = np.random.default_rng(11)
    t, c, s, ng = 3, 2, 16, 5
    bounds = np.linspace(0.0, 1.0, ng + 1)
    vals = np.sort(rng.uniform(0.0, 1.0, (t, s)), axis=1)
    m = rng.standard_normal((t, c, s))
    # pad 6 dead segments: value +inf, m == 0
    vals_p = np.concatenate([vals, np.full((t, 6), np.inf)], axis=1)
    m_p = np.concatenate([m, np.zeros((t, c, 6))], axis=2)
    a = np.asarray(segment_group_sum(jnp.asarray(m), jnp.asarray(vals), jnp.asarray(bounds), True))
    b = np.asarray(segment_group_sum(jnp.asarray(m_p), jnp.asarray(vals_p), jnp.asarray(bounds), True))
    np.testing.assert_array_equal(a, b)


def test_exact_reordering():
    """Per-group sums are the same additions the scatter would do — with
    all-equal segment magnitudes the result is exact, not approximate."""
    t, c, s, ng = 2, 1, 12, 4
    bounds = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    vals = np.sort(np.tile(np.linspace(0.1, 3.9, s), (t, 1)), axis=1)
    m = np.full((t, c, s), 0.125)
    got = np.asarray(segment_group_sum(jnp.asarray(m), jnp.asarray(vals), jnp.asarray(bounds), True))
    np.testing.assert_array_equal(got.sum(), 0.125 * t * s)
