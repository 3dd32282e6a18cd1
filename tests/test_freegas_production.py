"""Free-gas 1e-8 evidence AT THE PRODUCTION WINDOW (round-2 verdict
Missing #4 / Next #5).

Two links in the chain, both in-suite:

1. The closed-form scattering-law density (oracle.freegas_sab.dfl_de) vs
   the structurally independent dense (v_r, V_cm) reference — the
   validation formerly living only in scripts/freegas_sab_closed.py —
   at a spot matrix of (A, E, E') points, <= 1e-9.
2. The DEVICE kernel (freegas_moments_sab) at the production 257-group
   window vs the refinement-verified host group collapse
   (oracle.freegas_sab.group_moments), <= 1e-8 on every moment
   (f0-scale), for light and heavy targets across the thermal range.

This retires the 3e-8 / 3e-7 toy-window bars as the binding evidence.
"""

import numpy as np
import pytest

from ndpp_tpu.oracle.freegas_sab import dfl_de, group_moments

KT = 0.0253
ORDER = 5


def production_window() -> np.ndarray:
    """The production free-gas covering window: leading catch group +
    257-bound geometric window (same shape bench.py measures)."""
    return np.concatenate([[0.0], np.geomspace(1e-3, 200.0, 257)])


def test_sab_density_vs_dense_reference():
    """Closed-form scattering-law density == dense (v_r, V_cm) reference.

    Spot matrix trimmed for suite runtime (~1.3 s per dense call); the full
    matrix lives in scripts/freegas_sab_closed.py (worst 2.6e-11)."""
    from ndpp_tpu.oracle.freegas_exact import _dmoments_dy_dense

    worst = 0.0
    for awr, e in ((0.999167, KT), (0.999167, 1.0), (15.858, KT), (238.0, 9.9)):
        v = np.sqrt(e)
        fracs = (0.8, 1.0, 1.2)
        eps = np.array([(v * f) ** 2 for f in fracs])
        ref = np.stack(
            [
                _dmoments_dy_dense(np.sqrt(epi), v, awr, KT, ORDER, 12, 24) / (2.0 * np.sqrt(epi))
                for epi in eps
            ]
        )
        got = dfl_de(e, eps, awr, KT, ORDER)
        i0 = np.argmax(np.abs(ref[:, 0]))
        scale = ref[i0, 0] / got[i0, 0]
        rel = np.abs(got * scale - ref) / np.abs(ref).max()
        worst = max(worst, rel.max())
    assert worst < 1e-9, worst


def test_reference_refinement_stability():
    """The group-collapse reference is verified <= 1e-9 against its own
    refinement before it anchors the 1e-8 device bar."""
    bw = production_window()
    for awr, e in ((0.999167, 0.1), (0.999167, 10.0), (238.0, 1e-2), (238.0, 1.0)):
        a = group_moments(e, awr, KT, bw, ORDER)  # defaults: nq_ep=32, nq_u=48
        b = group_moments(e, awr, KT, bw, ORDER, nq_ep=40, nq_u=64)
        assert np.abs(a - b).max() < 1e-9, np.abs(a - b).max()


@pytest.mark.parametrize("awr", [0.999167, 238.0])
def test_device_kernel_production_window(awr):
    """freegas_moments_sab at the production 257-group window == host
    reference, on the binding 1e-8 metric:

      (a) <= 1e-8 ABSOLUTE on row-normalized moments (each row's f0 sums
          to 1, so this bounds the error of every derived group constant
          at 1e-8 of the scatter rate), and
      (b) allclose with rtol = 1e-8, atol = 2e-9 per element.

    The atol is the two sides' combined certification budget: the
    reference's refinement test above verifies it to 1e-9 absolute (not
    further), and the device kernel's own quadrature error is bounded
    independently at <= 1.4e-9 absolute by its self-refinement (worst at
    the A~1 deep-thermal corner) — elements
    whose magnitude is below ~0.1 of the row norm cannot be
    cross-certified tighter than the anchors themselves. Tiny
    transfer elements are differences of panel cumulants, so per-element
    relative accuracy on arbitrarily small elements is not achievable by
    any fixed-quadrature processor (reference Fortran included) and is
    not what BASELINE.json:5's bar means."""
    import jax.numpy as jnp

    from ndpp_tpu.ops.freegas import freegas_moments_sab

    bw = production_window()
    rows = np.array([1e-4, 1e-2, 0.1, 1.0, 10.0])
    got = np.asarray(freegas_moments_sab(jnp.asarray(rows), awr, KT, jnp.asarray(bw), ORDER))
    ref = np.stack([group_moments(float(e), awr, KT, bw, ORDER) for e in rows])
    assert np.abs(got - ref).max() < 1e-8, np.abs(got - ref).max()  # row-normalized abs
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=2e-9)
