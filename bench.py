#!/usr/bin/env python
"""Benchmark: nuclide-group-moments/sec, per kernel family + composite.

Runs on whatever backend JAX selects. Prints ONE JSON line:
  {"metric": "nuclide-group-moments/sec", "value": N, "unit": "moments/s",
   "detail": {...}}

The PRIMARY value is the two-body XLA f64 kernel at the production shape
(P5, 361 groups, 2048-point E-tiles, 16-pt GL), matching BASELINE.json:2.

detail additionally carries:
  - per-family f64 rates at production-like shapes: free-gas
    scattering-law, continuum (Kalbach pointwise), chi collapse;
  - "composite_moments_per_sec": one number for a nominal per-nuclide
    library workload (two-body 2048 rows + continuum 2048 rows + free-gas
    256 rows x 257-group window + chi 512 rows, P5/361g), combined as
    total-moments / total-time with each family's time taken from its
    measured rate;
  - "selfcheck": the on-device accuracy gate — every kernel family vs an
    independent path at production shapes; any family above 1e-8 sets
    ok=false and exits 1;
  - the device as JAX reports it, and the card's name and power limit.

These are kernel-family rates at one shape, not end-to-end cells; the
H100 benchmark that replaces them is ROADMAP S1.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

ORDER = 5
NQ = 16
TILE = 2048
K = 48
NG = 361
ITERS = 20

# nominal per-nuclide workload for the composite metric (rows per family)
COMPOSITE_ROWS = {"twobody": 2048, "continuum": 2048, "freegas": 256, "chi": 512}


def _rate(fn, e0, eps_scale, moments_per_iter, iters=ITERS):
    """(moments/s, wall_s) of fn over `iters` chained iterations in one
    dispatch: the carry feeds a perturbation of each output into the next
    input, so no iteration can be hoisted or skipped."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def run(e_arr):
        def body(i, e_arr):
            out = fn(e_arr)
            return e_arr * (1.0 + eps_scale * out.ravel()[0].astype(e_arr.dtype))

        return lax.fori_loop(0, iters, body, e_arr)

    out = run(e0)
    jax.block_until_ready(out)  # compile + warm
    t0 = time.perf_counter()
    out = run(e0 * jnp.asarray(1.0 + 1e-9, e0.dtype))
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return moments_per_iter * iters / dt, dt


def _rate_pipelined(fn, e0, moments_per_call, calls=6):
    """(moments/s, wall_s) over `calls` DISTINCT async dispatches — the
    driver's issue pattern (a pending queue of per-tile calls, blocked at
    store time)."""
    import jax
    import jax.numpy as jnp

    es = [e0 * jnp.asarray(1.0 + 1e-9 * i, e0.dtype) for i in range(calls + 1)]
    jax.block_until_ready(fn(es[0]))  # compile + warm
    t0 = time.perf_counter()
    outs = [fn(e) for e in es[1:]]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    return moments_per_call * calls / dt, dt


def _card() -> str:
    """nvidia-smi's name and power limit of the card, or why there is none."""
    import subprocess

    from chip_smoke import PhaseError, card_info

    try:
        return card_info()
    except (OSError, subprocess.SubprocessError, PhaseError) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"


def _twobody_setup():
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from ndpp_tpu import groups

    e, knots, pdf, _, c1, c2, awr = ge._example_batch(1, TILE, k=K, ng=NG)
    bounds = groups.get("uniform-lethargy-361").bounds
    args = (
        jnp.asarray(knots[0]),
        jnp.asarray(pdf[0]),
        jnp.asarray(bounds),
        jnp.asarray(np.repeat(c1, TILE)),
        jnp.asarray(np.repeat(c2, TILE)),
        jnp.asarray(np.repeat(awr, TILE)),
    )
    return jnp.asarray(e[0]), args


def _freegas_rate():
    """Free-gas scattering-law kernel at the production window shape:
    64 rows x (1 catch + 256)-group window, P5 (freegas_driver)."""
    import jax.numpy as jnp

    from ndpp_tpu.ops.freegas import freegas_moments_sab

    rows = 64
    bw = jnp.asarray(np.concatenate([[0.0], np.geomspace(1e-3, 200.0, 257)]))
    e0 = jnp.asarray(np.geomspace(1e-4, 10.0, rows))
    moments = rows * (ORDER + 1) * (bw.shape[0] - 1)
    rate, dt = _rate_pipelined(
        lambda e: freegas_moments_sab(e, 237.98, 0.0253, bw, ORDER), e0, moments
    )
    return rate, moments


def _continuum_rate():
    """Kalbach pointwise kernel at a production-like shape: 256 rows x 64
    outgoing knots, P5, 361 groups, windowed knot gather, Lagrange group
    split (continuum_driver)."""
    import jax.numpy as jnp

    from ndpp_tpu import groups
    from ndpp_tpu.ops.continuum import cm_moments_pointwise

    rows, k = 256, 64
    awr = 89.132
    e = np.geomspace(4e6, 2e7, rows)
    emax_r = (e - 2e6) * awr / (awr + 1.0)
    kn = np.linspace(1e3, emax_r, k, axis=-1)  # (rows, k), ascending
    pd = kn * np.exp(-kn / (emax_r[:, None] / 4.0))
    pd /= np.trapezoid(pd, kn, axis=1)[:, None]
    rr = np.full((rows, k), 0.3)
    aa = 0.2 + 1.5 * kn / np.maximum(emax_r[:, None], 1.0)
    bounds = groups.get("uniform-lethargy-361").bounds
    muk = jnp.asarray(np.array([-1.0, 1.0]))
    mup = jnp.zeros((rows, k, 2))
    moments = rows * (ORDER + 1) * (bounds.size - 1)
    args = (
        jnp.asarray(kn), jnp.asarray(pd), jnp.asarray(rr), jnp.asarray(aa),
        muk, mup, jnp.zeros(rows), 0.0, jnp.asarray(bounds),
    )
    # ksel exactly as continuum_driver quantizes it for this shape
    from ndpp_tpu.continuum_driver import _window_knot_bound, quantize_ksel

    ksel = quantize_ksel(_window_knot_bound(e, awr, kn), k)
    # (10, 7): the driver's production Kalbach quadrature since round 5
    # (nq_w=8 measured over the 1e-8 bar at production shapes; nq_y=7
    # holds 9.5e-11 abs vs the independent reference, 6 does not)
    rate, dt = _rate_pipelined(
        lambda e_arr: cm_moments_pointwise(
            e_arr, *args, awr, ORDER, 10, 7, "kalbach", "tabular", True, 8, ksel, "lagrange"
        ),
        jnp.asarray(e),
        moments,
    )
    return rate, moments


def _chi_rate():
    """Tabular chi collapse: 512 rows x 64 spectrum knots -> 361 groups."""
    import jax.numpy as jnp

    from ndpp_tpu import groups
    from ndpp_tpu.ops.chi import tabular_group_fractions

    rows, k = 512, 64
    rng = np.random.default_rng(11)
    kn = np.sort(rng.uniform(1e2, 2e6, size=(rows, k)), axis=1)
    pd = rng.uniform(0.2, 1.0, size=(rows, k))
    pd /= np.sum(0.5 * (pd[:, 1:] + pd[:, :-1]) * np.diff(kn, axis=1), axis=1)[:, None]
    bounds = groups.get("uniform-lethargy-361").bounds
    moments = rows * (bounds.size - 1)
    kn_j, pd_j, b_j = jnp.asarray(kn), jnp.asarray(pd), jnp.asarray(bounds)

    # distinct pdf scalings per dispatch (perturbs normalization only)
    rate, dt = _rate_pipelined(
        lambda p: tabular_group_fractions(kn_j, p, b_j), pd_j, moments
    )
    return rate, moments


def main() -> None:
    import jax

    from ndpp_tpu import selfcheck
    from ndpp_tpu.ops.twobody import twobody_moments

    e0, args = _twobody_setup()
    tb_moments = TILE * (ORDER + 1) * NG
    f64_rate, _ = _rate(
        lambda e_arr: twobody_moments(e_arr, *args, ORDER, NQ), e0, 1e-13, tb_moments
    )

    detail: dict = {}
    family_rates: dict = {}
    for name, fn in (("freegas", _freegas_rate), ("continuum", _continuum_rate), ("chi", _chi_rate)):
        try:
            rate, _m = fn()
            family_rates[name] = rate
        except Exception as e:
            family_rates[name] = None
            detail[f"{name}_error"] = f"{type(e).__name__}: {e}"
    detail.update({f"{k}_f64_moments_per_sec": round(v, 1) for k, v in family_rates.items() if v})

    try:
        detail["selfcheck"] = selfcheck.run(tile=TILE, order=ORDER, ng=NG, nq=NQ)
    except Exception as e:  # never lose the JSON line to the gate itself
        detail["selfcheck"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}

    if all(family_rates.get(k) for k in ("freegas", "continuum", "chi")):
        # nominal per-nuclide workload: time per family = nominal moments / rate
        per_row = {"twobody": (ORDER + 1) * NG, "continuum": (ORDER + 1) * NG,
                   "freegas": (ORDER + 1) * 257, "chi": NG}
        rates = {"twobody": f64_rate, **family_rates}
        total_m = sum(COMPOSITE_ROWS[f] * per_row[f] for f in COMPOSITE_ROWS)
        total_t = sum(COMPOSITE_ROWS[f] * per_row[f] / rates[f] for f in COMPOSITE_ROWS)
        detail["composite_moments_per_sec"] = round(total_m / total_t, 1)
        detail["composite_workload_rows"] = COMPOSITE_ROWS

    dev = jax.devices()[0]
    detail.update(
        {
            "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
            "card": _card(),
            "tile": TILE,
            "order": ORDER,
            "groups": NG,
            "iters": ITERS,
        }
    )
    print(
        json.dumps(
            {
                "metric": "nuclide-group-moments/sec",
                "value": round(f64_rate, 1),
                "unit": "moments/s",
                "detail": detail,
            }
        )
    )
    if not detail["selfcheck"].get("ok"):
        sys.exit(1)  # the accuracy gate fails loudly (after printing the line)


if __name__ == "__main__":
    main()
