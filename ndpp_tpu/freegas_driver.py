"""Free-gas thermal replacement driver (config 3, BASELINE.json:9).

Below the thermal cutoff (cfg.thermal_cutoff_kt * kT, conventionally 400 kT;
SURVEY.md section 3.3), the 0K elastic transfer moments are replaced by
target-in-motion free-gas moments with up-scatter, per temperature:

    scatter[T, rows] += w_el(rows) * (f_freegas(rows, T) - f_elastic_0K(rows))

with w_el the elastic share of the scattering weight. Cross-section WEIGHTS
keep the ACE table values (the table is already at its base temperature);
full sigma Doppler broadening across temperatures is out of scope for the
kernel-shape replacement and documented in docs/design.md.
"""

from __future__ import annotations

import numpy as np

from ndpp_tpu.config import BOLTZMANN_EV_PER_K
from ndpp_tpu.ops.freegas import freegas_moments_sab
from ndpp_tpu.utils import log as log_mod
from ndpp_tpu.utils.metrics import RunMetrics


def doppler_sigma_ratio(e: np.ndarray, awr: float, kt: float) -> np.ndarray:
    """Analytic sigma_eff/sigma_free for a Maxwellian free gas, constant
    free-atom cross section:

        (1 + 1/(2 x^2)) erf(x) + exp(-x^2) / (sqrt(pi) x),  x = sqrt(A E / kT)

    The device quadrature reproduces this at ~1e-10 (test_freegas); the
    driver uses the closed form directly for cross-section weighting.
    """
    from scipy.special import erf

    x = np.sqrt(np.maximum(awr * np.asarray(e, dtype=np.float64) / kt, 1e-30))
    return (1.0 + 0.5 / x**2) * erf(x) + np.exp(-(x**2)) / (np.sqrt(np.pi) * x)


def apply_freegas(
    scatter: np.ndarray,
    nuc,
    gs,
    cfg,
    e_grid: np.ndarray,
    metrics=None,
    e_min_by_temp=None,
    elastic0k=None,
) -> np.ndarray:
    """scatter: (NT, NE, L+1, G) 0K combined moments; returns the corrected array.

    e_min_by_temp: optional per-temperature lower limits (eV) below which the
    free-gas replacement is SKIPPED — rows there are owned by an S(alpha,beta)
    table (thermal_driver.apply_sab supersedes free-gas where tabulated).

    elastic0k: optional (mom, g0, i0) from scattering_moments — the
    UNWEIGHTED 0K elastic moments already computed on e_grid[i0:] (possibly
    banded). When present and the exact per-row path is active, the thermal
    rows are SLICED from it instead of re-dispatched (round 4: the
    recompute cost 1-2 dispatch round-trips per nuclide on the warm
    profile for values the main pool already fetched).
    """
    import jax.numpy as jnp

    from ndpp_tpu import driver as driver_mod

    log = log_mod.get()
    if cfg.freegas_for and nuc.name not in cfg.freegas_for:
        return scatter
    order = scatter.shape[2] - 1

    # elastic weight on the grid (same weighting convention as the 0K combine)
    with RunMetrics.span_or_null(metrics, "prep.freegas"):
        rxns = nuc.scattering_reactions(include_fission=False)
        sigma_el = nuc.sigma_el
        if not np.array_equal(e_grid, nuc.energy):
            sigma_el = np.interp(e_grid, nuc.energy, sigma_el)
        sigma_s = np.zeros_like(e_grid)
        for rxn in rxns:
            sig = nuc.sigma_on_grid(rxn)
            if not np.array_equal(e_grid, nuc.energy):
                sig = np.interp(e_grid, nuc.energy, sig)
            sigma_s += sig
        w_el = np.where(sigma_s > 0, sigma_el / np.where(sigma_s > 0, sigma_s, 1.0), 0.0)

    from ndpp_tpu.host import unionize

    # Pass 1 (round 3): dispatch EVERY temperature's scattering-law tiles
    # and prepare every 0K-elastic row set up front; pass 2 waits and
    # combines. Cross-temperature batching keeps the device queue full and
    # lets the 0K elastic rows of all temperatures ride ONE batched
    # two-body dispatch (driver._tiled_twobody_multi) — per-dispatch
    # latency, not FLOPs, dominated the warm free-gas cost.
    plans = []  # (k, rows, sub_idx, e_sub, w, ffg, pending)
    zero_k_preps = []
    for k, temp_k in enumerate(cfg.temperatures):
        kt = BOLTZMANN_EV_PER_K * temp_k
        cutoff = cfg.thermal_cutoff_kt * kt
        n_rows = int(np.searchsorted(e_grid, cutoff))
        e_min = 0.0 if e_min_by_temp is None else float(e_min_by_temp[k])
        n_lo = int(np.searchsorted(e_grid, e_min, side="right")) if e_min > 0 else 0
        if n_rows <= n_lo:
            continue
        rows = slice(n_lo, n_rows)
        n_rows = n_rows - n_lo

        # Default (freegas_max_rows=0): evaluate EVERY thermal union row
        # exactly. The opt-in subgrid (a positive max_rows) evaluates a
        # bounded log-subgrid and lin-log-interpolates the correction back —
        # a speed knob with a measured ~1e-2 error envelope at 256 rows
        # (test_freegas): per-group moment curves have group-boundary-
        # crossing structure on the scale of a group width (a kink from the
        # 0K term at every E = E_b, a kT-smeared ramp from the thermal
        # term), which a coarse subgrid cannot interpolate to the 1e-8 bar.
        max_rows = cfg.device.freegas_max_rows or n_rows
        if n_rows > max_rows:
            sub_idx = np.unique(
                np.round(np.linspace(0, n_rows - 1, max_rows)).astype(int)
            )
            e_sub = e_grid[rows][sub_idx]
        else:
            sub_idx = None
            e_sub = e_grid[rows]
        # Group WINDOW: the free-gas kernel's cost scales with the number of
        # boundaries it inserts exact breakpoints for; only groups reachable
        # from thermal energies matter. E'_max ~ (v + 2 gamma (v + 8/beta))^2.
        gamma = nuc.awr / (nuc.awr + 1.0)
        beta = np.sqrt(nuc.awr / kt)
        vmax = np.sqrt(cutoff)
        e_reach = 1.5 * (vmax + 2.0 * gamma * (vmax + 8.0 / beta)) ** 2
        w = int(np.clip(np.searchsorted(gs.bounds, e_reach), 1, gs.ng))
        w = min(unionize.bucket_pow2(w), gs.ng)  # pow2 window buckets: minimize distinct kernel shapes
        from ndpp_tpu.parallel import rows as rows_mod

        ns = e_sub.size
        # Row cap: the scattering-law kernel's working set is tiny
        # (~(rows x chunk*nq_g x ~20 u-panels x nq_u)); the best cap on the
        # H100 is not measured (ROADMAP S2). e_tile halving (OOM retry)
        # still shrinks the tile via tile_for.
        cap = 256
        tile = rows_mod.tile_for(ns, cap, cfg.device.e_tile)
        ffg = np.zeros((ns, order + 1, gs.ng))
        pending = []
        # Single production path: freegas_moments_sab — the EXACT
        # scattering-law density (the (v_r, V_cm) double quadrature
        # collapses to one smooth Gaussian integral in u; derivation and
        # oracle validation at 2.6e-11 in scripts/freegas_sab_closed.py)
        # under the panel-split outgoing machinery (group splits from the
        # GL-node Lagrange interpolant; per-row cost independent of the
        # window's group count). Agreement with the retired quadrature
        # kernels' 12/16/16 reference: 2.4e-9 worst (nq_u=16). History: the
        # grouped kernel's Laurent closed form cancelled catastrophically
        # on thermal-fine windows; the pointwise quadrature kernels (freegas_moments_
        # pointwise / _panelsplit) remain in ops/freegas as the
        # independent cross-validation path (test_freegas).
        #
        # The kernel normalizes over ITS OWN window, so it always gets a
        # COVERING one: an extra leading [0, bounds_0) catch group holds
        # the below-range mass, which is folded into the edge group under
        # clamping and DROPPED otherwise (sum_g f0 < 1, matching the 0K
        # clamp=False convention; the covering window keeps the
        # self-normalization exact either way).
        bw = np.concatenate([[0.0], gs.bounds[: w + 1]])
        bounds_pw = rows_mod.put_replicated(bw)

        with RunMetrics.span_or_null(metrics, "dispatch.freegas"):
            for start, length in unionize.tile_indices(ns, tile):
                e_t = unionize.pad_to(e_sub[start : start + length], tile)
                part = freegas_moments_sab(
                    rows_mod.put_rows(e_t), nuc.awr, kt, bounds_pw, order
                )
                pending.append((start, length, part))
        if elastic0k is not None and sub_idx is None and n_lo >= elastic0k[2]:
            # exact rows: slice the main pool's elastic output directly
            zero_k_preps.append(None)
        else:
            from ndpp_tpu.host.prep import prepare_twobody

            with RunMetrics.span_or_null(metrics, "prep.twobody"):
                zero_k_preps.append(prepare_twobody(nuc, nuc.elastic, e_sub))
        plans.append((k, kt, rows, sub_idx, e_sub, w, ffg, pending))

    if not plans:
        return scatter

    # 0K elastic for ALL temperatures: sliced from the main pool's elastic
    # output where possible, else one batched dispatch set; banded results
    # (heavy-A narrow reach) densify on host for the combine
    todo_preps = [p for p in zero_k_preps if p is not None]
    computed = iter(
        driver_mod._tiled_twobody_multi(
            todo_preps, gs.bounds, order, cfg.device.quad_points, 256, metrics, cfg.clamp_outside
        )
        if todo_preps
        else []
    )
    f0k_all = []
    for (k, kt, rows, sub_idx, e_sub, w, ffg, pending), prep in zip(plans, zero_k_preps):
        if prep is None:
            mom, g0, i0 = elastic0k
            sl = slice(rows.start - i0, rows.stop - i0)
            f0k_all.append(
                driver_mod.densify_banded(
                    mom[sl], None if g0 is None else g0[sl], gs.ng
                )
            )
        else:
            mom, g0 = next(computed)
            f0k_all.append(driver_mod.densify_banded(mom, g0, gs.ng))

    # Pass 2: wait on the scattering-law tiles and combine per temperature
    for (k, kt, rows, sub_idx, e_sub, w, ffg, pending), f0k in zip(plans, f0k_all):
        def store(st, ln, pt):
            arr = np.asarray(pt)[:ln]  # (ln, L+1, w+1): [catch, g0..g_{w-1}]
            ffg[st : st + ln, :, :w] = arr[:, :, 1:]
            if cfg.clamp_outside:
                ffg[st : st + ln, :, 0] += arr[:, :, 0]

        with RunMetrics.span_or_null(metrics, "wait.freegas"):
            for start, length, part in pending:
                store(start, length, part)

        def to_rows(arr):
            """Subgrid -> full rows (both free-gas and 0K elastic kernel
            SHAPES are smooth in E; unionize.interp_rows_loglin)."""
            if sub_idx is None:
                return arr
            return unionize.interp_rows_loglin(e_grid[rows], e_sub, arr)

        if cfg.freegas_xs_weighting:
            # Doppler sigma_eff weighting: the elastic channel's cross
            # section at the REQUESTED temperature is the table's scaled by
            # the ratio of analytic free-gas sigma_eff factors (the free
            # cross section cancels). Exactly 1 when T matches the table.
            r = doppler_sigma_ratio(e_grid[rows], nuc.awr, kt) / doppler_sigma_ratio(
                e_grid[rows], nuc.awr, max(nuc.kT, 1e-12)
            )
            ffg_full = to_rows(ffg)
            f0k_full = to_rows(f0k)
            sig_el_r = sigma_el[rows]
            denom = sigma_s[rows] + sig_el_r * (r - 1.0)
            ok = denom > 0
            num = (
                scatter[k, rows] * sigma_s[rows, None, None]
                - sig_el_r[:, None, None] * f0k_full
                + (sig_el_r * r)[:, None, None] * ffg_full
            )
            scatter[k, rows] = np.where(
                ok[:, None, None], num / np.where(ok, denom, 1.0)[:, None, None], scatter[k, rows]
            )
        else:
            corr = to_rows(ffg - f0k)  # (rows, L+1, G) smooth in E
            scatter[k, rows] = scatter[k, rows] + w_el[rows, None, None] * corr
        if metrics is not None:
            metrics.moments_computed += ffg.size
        log.debug(
            "free-gas: %s kT=%.3g eV replaced %d rows (window %d/%d groups)",
            nuc.name, kt, e_sub.size, w, gs.ng,
        )
    return scatter
