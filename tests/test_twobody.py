"""Two-body moment kernel vs oracle + property tests (SURVEY.md section 4.2-4.4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ndpp_tpu import groups
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.prep import prepare_twobody
from ndpp_tpu.ops.twobody import twobody_moments
from ndpp_tpu.oracle.twobody import twobody_moments_oracle

G47 = groups.get("uniform-lethargy-47")
RTOL = 1e-8


def _device_moments(nuc, rxn, e_sel, bounds, order, nq=16):
    prep = prepare_twobody(nuc, rxn, e_sel)
    out = twobody_moments(
        jnp.asarray(prep.e),
        jnp.asarray(prep.knots),
        jnp.asarray(prep.pdf),
        jnp.asarray(bounds),
        prep.c1,
        prep.c2,
        prep.awr,
        order,
        nq,
    )
    return np.asarray(out)


def _compare_vs_oracle(nuc, rxn, e_sel, order, nq=16):
    dev = _device_moments(nuc, rxn, e_sel, G47.bounds, order, nq)
    for i, e in enumerate(e_sel):
        ora = twobody_moments_oracle(nuc, rxn, float(e), G47.bounds, order)
        scale = np.abs(ora).max() or 1.0
        np.testing.assert_allclose(dev[i], ora, rtol=RTOL, atol=RTOL * scale, err_msg=f"E={e:.3e} eV")


def test_h1_elastic_vs_oracle():
    nuc = synth.build("h1")
    e_sel = np.array([1e-3, 1.0, 1e2, 1e4, 1e6, 5e6, 1.9e7])
    _compare_vs_oracle(nuc, nuc.elastic, e_sel, order=3)


def test_h1_isotropic_analytic_f0():
    """Isotropic CM elastic: f_{0,g'} is the fractional overlap of [alpha*E, E] with g'."""
    nuc = synth.build("h1_iso")
    a = nuc.awr
    alpha = ((a - 1.0) / (a + 1.0)) ** 2
    e_sel = np.array([1e-2, 1e3, 1e5, 1e7])
    dev = _device_moments(nuc, nuc.elastic, e_sel, G47.bounds, order=0)
    eff = G47.bounds.copy()
    eff[0], eff[-1] = -np.inf, np.inf  # kernel default clamps into edge groups
    for i, e in enumerate(e_sel):
        lo_all, hi_all = alpha * e, e
        expected = np.array(
            [
                max(0.0, min(hi_all, eff[g + 1]) - max(lo_all, eff[g])) / (hi_all - lo_all)
                for g in range(G47.ng)
            ]
        )
        np.testing.assert_allclose(dev[i, 0], expected, rtol=1e-9, atol=1e-12, err_msg=f"E={e}")


def test_fe56_elastic_vs_oracle():
    nuc = synth.build("fe56")
    e_sel = np.array([1e-2, 1.15e3, 2.74e4, 1e6, 1.5e7])  # on/near resonances too
    _compare_vs_oracle(nuc, nuc.elastic, e_sel, order=5)


def test_fe56_level_inelastic_vs_oracle():
    nuc = synth.build("fe56")
    rxn = nuc.reactions[51]
    thresh = rxn.q * -(nuc.awr + 1.0) / nuc.awr
    e_sel = np.array([thresh * 1.001, thresh * 1.5, 5e6, 1.9e7])
    _compare_vs_oracle(nuc, rxn, e_sel, order=5)


def test_below_threshold_is_zero():
    nuc = synth.build("fe56")
    rxn = nuc.reactions[51]
    dev = _device_moments(nuc, rxn, np.array([1e2, 1e5]), G47.bounds, order=3)
    assert np.all(dev == 0.0)


def test_equiprobable_encoding_vs_oracle():
    """MT=52 carries the legacy 32-equiprobable-bin encoding end to end."""
    nuc = synth.build("fe56")
    rxn = nuc.reactions[52]
    e_sel = np.array([4e6, 1e7, 1.9e7])
    _compare_vs_oracle(nuc, rxn, e_sel, order=3)


def test_normalization_and_bounded_moments():
    """sum_g f0 = 1 and |f_l| <= f0 summed (SURVEY.md section 4.4)."""
    nuc = synth.build("o16")
    e_sel = np.exp(np.linspace(np.log(1e-3), np.log(1.9e7), 40))
    dev = _device_moments(nuc, nuc.elastic, e_sel, G47.bounds, order=5)
    f0_sum = dev[:, 0, :].sum(axis=1)
    np.testing.assert_allclose(f0_sum, 1.0, rtol=1e-10)
    fl_sum = np.abs(dev[:, 1:, :].sum(axis=2))
    assert np.all(fl_sum <= f0_sum[:, None] + 1e-12)


def test_downscatter_limited_to_alpha_window():
    """0K elastic can only reach groups overlapping [alpha*E, E]."""
    nuc = synth.build("fe56")
    e = 1e5
    dev = _device_moments(nuc, nuc.elastic, np.array([e]), G47.bounds, order=0)[0, 0]
    alpha = ((nuc.awr - 1.0) / (nuc.awr + 1.0)) ** 2
    for g in range(G47.ng):
        overlaps = (G47.bounds[g + 1] > alpha * e) and (G47.bounds[g] < e)
        if not overlaps:
            assert dev[g] == 0.0


def test_f32_path_runs():
    """Kernel must also trace/execute in f32 (fast path; accuracy relaxed)."""
    nuc = synth.build("h1")
    prep = prepare_twobody(nuc, nuc.elastic, np.array([1e4, 1e6]))
    out = twobody_moments(
        jnp.asarray(prep.e, dtype=jnp.float32),
        jnp.asarray(prep.knots, dtype=jnp.float32),
        jnp.asarray(prep.pdf, dtype=jnp.float32),
        jnp.asarray(G47.bounds, dtype=jnp.float32),
        prep.c1,
        prep.c2,
        prep.awr,
        3,
    )
    assert np.asarray(out).dtype == np.float32
    np.testing.assert_allclose(np.asarray(out)[:, 0, :].sum(axis=1), 1.0, rtol=1e-4)


def test_segment_scatter_matches_reference_scatter():
    """The segment-reduction epilogue (cumsum + exact one-hot selection; no
    scatter HLO) vs the scatter-add reference, both clamp modes, on real
    panel geometry. They must agree to f64 roundoff."""
    import jax

    from ndpp_tpu.ops.legendre import gl_nodes_weights, legendre_all
    from ndpp_tpu.ops import twobody as tb

    nuc = synth.build("fe56")
    prep = prepare_twobody(nuc, nuc.elastic, np.array([1e2, 1e4, 1e6, 2e6]))
    args = (
        jnp.asarray(prep.e),
        jnp.asarray(prep.knots),
        jnp.asarray(prep.pdf),
        jnp.asarray(G47.bounds),
        prep.c1,
        prep.c2,
        prep.awr,
    )
    for clamp in (True, False):
        pan = jax.jit(lambda *a: tb.twobody_panels(*a, clamp))(*args)
        mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e = pan
        xq, wq = gl_nodes_weights(8)
        mu_q = mid[:, None, :] + half[:, None, :] * jnp.asarray(xq)[None, :, None]
        pdf_q = a_s[:, None, :] + b_s[:, None, :] * mu_q
        elab_q = base[:, None, None] + slope[:, None, None] * mu_q
        mu_lab = jnp.clip(
            (mu_q * jnp.sqrt(ecm)[:, None, None] + (jnp.sqrt(e_safe) / ap1)[:, None, None])
            * jax.lax.rsqrt(elab_q),
            -1.0,
            1.0,
        )
        w = pdf_q * jnp.asarray(wq)[None, :, None] * half[:, None, :]
        pl_ = legendre_all(mu_lab, 5)
        m = jnp.einsum("tqs,tqsl->tls", w, pl_)
        ref = np.asarray(
            tb.twobody_scatter_ref(m, mid, half, base, slope, valid_e, jnp.asarray(G47.bounds), clamp)
        )
        new = np.asarray(
            tb.twobody_scatter(m, mid, half, base, slope, valid_e, jnp.asarray(G47.bounds), clamp)
        )
        np.testing.assert_allclose(new, ref, rtol=1e-12, atol=1e-14, err_msg=f"clamp={clamp}")


def test_banded_windows_match_dense_driver():
    """Per-row group-band windows (round 4): a heavy-ish nuclide's two-body
    moments through the banded dispatch must match the dense path at
    roundoff. The banded kernel sees the identical live panel structure
    (out-of-reach breakpoints clip to +-1 as dead panels in the dense
    edge set), so this is a reordering of the same arithmetic."""
    import ndpp_tpu.driver as driver_mod
    from ndpp_tpu import config as config_mod
    from ndpp_tpu import groups
    from ndpp_tpu.host.ace import synth

    nuc = synth.o16_like(n_energy=48)
    gs = groups.get("uniform-lethargy-172")
    cfg = config_mod.RunConfig(legendre_order=3, temperatures=[293.6], thermal_cutoff_kt=1e-9)
    cfg.device.e_tile = 64
    e_grid = nuc.energy

    banded, _, _ = driver_mod.scattering_moments(nuc, gs, cfg, e_grid)

    real_bw = driver_mod._band_windows
    # confirm banding actually engaged for this nuclide, then force dense
    engaged = []

    def spy(preps, idxs, bounds):
        r = real_bw(preps, idxs, bounds)
        engaged.append(r is not None)
        return r

    driver_mod._band_windows = spy
    try:
        driver_mod.scattering_moments(nuc, gs, cfg, e_grid)
        assert any(engaged), "banding never engaged on the heavy-A fixture"
        driver_mod._band_windows = lambda preps, idxs, bounds: None
        dense, _, _ = driver_mod.scattering_moments(nuc, gs, cfg, e_grid)
    finally:
        driver_mod._band_windows = real_bw
    np.testing.assert_allclose(banded, dense, rtol=1e-13, atol=1e-15)
