"""Per-nuclide processing pipeline and run driver.

The new-framework equivalent of the reference main program stack
(SURVEY.md section 3.1):

    cli.run -> config.load -> host parse (ACE) -> host prep/padding
      -> device kernels (two-body / continuum / free-gas / chi)
      -> host write (HDF5/ASCII)

Per-nuclide failures are quarantined rather than fatal (SURVEY.md section
5 'failure detection'): the sweep is a bag of independent tasks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ndpp_tpu.config import BOLTZMANN_EV_PER_K, RunConfig
from ndpp_tpu.groups import GroupStructure
from ndpp_tpu.host import library_index, unionize
from ndpp_tpu.host.ace.parse import read_ace
from ndpp_tpu.host.ace.records import Nuclide, Reaction
from ndpp_tpu.host.prep import prepare_twobody
from ndpp_tpu.io.library import NuclideResult, open_writers
from ndpp_tpu.ops.twobody import twobody_moments
from ndpp_tpu.utils import log as log_mod
from ndpp_tpu.utils.errors import NdppError
from ndpp_tpu.utils.metrics import RunMetrics
from ndpp_tpu.utils.timer import PhaseTimers


def is_twobody(rxn: Reaction) -> bool:
    """Elastic, or a reaction whose only energy law is 3 (discrete level)."""
    if rxn.mt == 2:
        return True
    return len(rxn.energy_dists) == 1 and rxn.energy_dists[0].law == 3


def reaction_yield(rxn: Reaction, e_grid: np.ndarray, include_yield: bool) -> np.ndarray:
    """Neutron multiplicity on the grid (1.0 everywhere if yields disabled)."""
    if not include_yield:
        return np.ones_like(e_grid)
    if rxn.yield_tab is not None:
        return rxn.yield_tab(e_grid)
    mult = rxn.multiplicity if rxn.multiplicity not in (0, 19) else 1
    return np.full_like(e_grid, float(mult))


@dataclass
class ScatterInputs:
    """A single reaction's contribution, ready for tiled device execution."""

    rxn: Reaction
    sigma: np.ndarray  # (NE,) on the union grid
    yld: np.ndarray  # (NE,)


def _tiled_twobody(nuc, rxn, e_grid, bounds, order, nq, tile, metrics: RunMetrics | None, clamp: bool = True):
    """Run the two-body kernel over fixed-size E-tiles; returns (NE, L+1, G).

    With >1 visible device each dispatch carries one kernel-tile of rows per
    device, sharded over the flat 'e' mesh (parallel.rows): the jitted kernel
    partitions along rows with no collectives.
    """
    from ndpp_tpu.parallel import rows as rows_mod

    with RunMetrics.span_or_null(metrics, "prep.twobody"):
        prep = prepare_twobody(nuc, rxn, e_grid)
    if metrics is not None:
        metrics.record_padding(prep.real_elements, prep.padded_elements)
    ne = e_grid.size
    tile = rows_mod.tile_for(ne, tile)  # callers pass cfg.device.e_tile as the cap
    # pow2-bucket the knot axis so reactions with similar table sizes share
    # one compiled kernel (compile >> padded compute; unionize.bucket_pow2)
    k16 = unionize.bucket_pow2(prep.knots.shape[1])
    knots = unionize.pad_to(prep.knots, k16, axis=1)
    pdf = unionize.pad_to(prep.pdf, k16, axis=1)
    out = np.empty((ne, order + 1, bounds.size - 1))
    b = rows_mod.put_replicated(bounds)
    # dispatch every tile asynchronously, then gather: the host blocks once
    # instead of once per tile. Constants go as per-row arrays so these
    # dispatches share compiled shapes with the batched path
    # (_tiled_twobody_multi).
    pending = []
    with RunMetrics.span_or_null(metrics, "dispatch.twobody"):
        for start, length in unionize.tile_indices(ne, tile):
            e_t = unionize.pad_to(prep.e[start : start + length], tile)
            k_t = unionize.pad_to(knots[start : start + length], tile)
            p_t = unionize.pad_to(pdf[start : start + length], tile)
            res = twobody_moments(
                rows_mod.put_rows(e_t), rows_mod.put_rows(k_t), rows_mod.put_rows(p_t),
                b,
                rows_mod.put_rows(np.full(tile, prep.c1)),
                rows_mod.put_rows(np.full(tile, prep.c2)),
                rows_mod.put_rows(np.full(tile, prep.awr)),
                order, nq, clamp,
            )
            pending.append((start, length, res))
    with RunMetrics.span_or_null(metrics, "wait.twobody"):
        for start, length, res in pending:
            out[start : start + length] = np.asarray(res)[:length]
    return out


def _band_windows(preps, idxs, bounds):
    """Per-row boundary-window plan for one pooled knot bucket, or None.

    Each two-body row's outgoing reach is closed-form:
    E'_lab(mu = -+1) = (sqrt(E'_cm) -+ sqrt(E)/(A+1))^2 — so the set of
    group boundaries a row can hit is a contiguous window. Banding pays on
    heavy nuclides (band width ~ ln(1/alpha) in lethargy: a handful of the
    361 groups), where it cuts BOTH the kernel's panel lanes (S = K + B
    + 11 instead of K + G + 11) and the fetched bytes (B/G of the dense
    row). What each cut is worth on the H100 is not measured (ROADMAP S5).
    Light nuclides (wide reach) return None and keep the dense path.

    Returns (B, g0_all (NE,)) with B a pow2 bucket; the window is clipped
    into [0, ng - B] so it always covers each row's [g_lo, g_hi].
    """
    ng = bounds.size - 1
    g_lo_parts = []
    g_hi_parts = []
    for i in idxs:
        p = preps[i]
        ecm = p.c2 * (p.e - p.c1)
        valid = ecm > 0
        ecm = np.where(valid, ecm, 1.0)
        root = np.sqrt(p.e * ecm)
        lo = np.where(valid, ecm + p.e / (p.awr + 1.0) ** 2 - 2.0 * root / (p.awr + 1.0), 0.0)
        hi = np.where(valid, ecm + p.e / (p.awr + 1.0) ** 2 + 2.0 * root / (p.awr + 1.0), 1.0)
        g_lo_parts.append(np.searchsorted(bounds, np.maximum(lo, 0.0), side="right") - 1)
        g_hi_parts.append(np.searchsorted(bounds, hi, side="left"))
    # one safety group each side absorbs breakpoint roundoff
    g_lo = np.clip(np.concatenate(g_lo_parts) - 1, 0, ng - 1)
    g_hi = np.clip(np.concatenate(g_hi_parts) + 1, 1, ng)
    width = int((g_hi - g_lo).max())
    b_w = unionize.bucket_pow2(width, lo=16)
    if b_w >= ng // 2:
        return None  # wide reach: the dense path is as good and simpler
    g0 = np.clip(g_lo, 0, ng - b_w)
    return b_w, g0


def _tiled_twobody_multi(preps, bounds, order, nq, tile_cap, metrics, clamp=True):
    """Batched two-body dispatch: ALL reactions sharing a knot bucket ride
    ONE row pool (round 3), with per-row group-band windows where the
    kinematic reach is narrow (round 4; see _band_windows).

    The kernel takes per-row (c1, c2, awr), so rows from different
    reactions (and different incident sub-grids) concatenate freely; the
    dispatch count per nuclide drops from per-(reaction x tile) to
    per-(knot-bucket x tile).

    preps: list of TwoBodyPrepared. Returns a list of (moments, g0) pairs:
    g0 is None for dense (NE_i, L+1, G) results, else the (NE_i,) window
    offsets of banded (NE_i, L+1, B) results.
    """
    from ndpp_tpu.parallel import rows as rows_mod

    b = rows_mod.put_replicated(bounds)
    ng = bounds.size - 1
    buckets: dict[int, list[int]] = {}
    for i, prep in enumerate(preps):
        k16 = unionize.bucket_pow2(prep.knots.shape[1])
        buckets.setdefault(k16, []).append(i)
        if metrics is not None:
            metrics.record_padding(prep.real_elements, prep.padded_elements)

    outs: list[tuple[np.ndarray, np.ndarray | None] | None] = [None] * len(preps)
    pending = []  # (buffer, start, length, device result)
    slices = []  # (bucket buffer, g0_all | None, prep index, row offset)
    with RunMetrics.span_or_null(metrics, "dispatch.twobody"):
        for k16, idxs in sorted(buckets.items()):
            e_all = np.concatenate([preps[i].e for i in idxs])
            kn_all = np.concatenate([unionize.pad_to(preps[i].knots, k16, axis=1) for i in idxs])
            pd_all = np.concatenate([unionize.pad_to(preps[i].pdf, k16, axis=1) for i in idxs])
            c1_all = np.concatenate([np.full(preps[i].e.size, preps[i].c1) for i in idxs])
            c2_all = np.concatenate([np.full(preps[i].e.size, preps[i].c2) for i in idxs])
            aw_all = np.concatenate([np.full(preps[i].e.size, preps[i].awr) for i in idxs])
            ne = e_all.size
            tile = rows_mod.tile_for(ne, tile_cap)
            band = _band_windows(preps, idxs, bounds)
            if band is None:
                gw, g0_all = ng, None
                bounds_rows = None
            else:
                gw, g0_all = band
                # per-row boundary windows, gathered host-side (cheap)
                bounds_rows = bounds[g0_all[:, None] + np.arange(gw + 1)[None, :]]
            buf = np.empty((ne, order + 1, gw))
            off = 0
            for i in idxs:
                slices.append((buf, g0_all, i, off))
                off += preps[i].e.size
            for start, length in unionize.tile_indices(ne, tile):
                sl = slice(start, start + length)
                b_arg = (
                    b
                    if bounds_rows is None
                    else rows_mod.put_rows(
                        unionize.pad_to(bounds_rows[sl], tile, mode="edge")
                    )
                )
                res = twobody_moments(
                    rows_mod.put_rows(unionize.pad_to(e_all[sl], tile)),
                    rows_mod.put_rows(unionize.pad_to(kn_all[sl], tile)),
                    rows_mod.put_rows(unionize.pad_to(pd_all[sl], tile)),
                    b_arg,
                    rows_mod.put_rows(unionize.pad_to(c1_all[sl], tile)),
                    rows_mod.put_rows(unionize.pad_to(c2_all[sl], tile)),
                    rows_mod.put_rows(unionize.pad_to(aw_all[sl], tile)),
                    order,
                    nq,
                    clamp,
                )
                pending.append((buf, start, length, res))
    with RunMetrics.span_or_null(metrics, "wait.twobody"):
        for buf, start, length, res in pending:
            buf[start : start + length] = np.asarray(res)[:length]
    for buf, g0_all, i, off in slices:
        n_i = preps[i].e.size
        g0_i = None if g0_all is None else g0_all[off : off + n_i]
        outs[i] = (buf[off : off + n_i], g0_i)
    return outs


def densify_banded(mom: np.ndarray, g0: np.ndarray | None, ng: int) -> np.ndarray:
    """Banded (NE, L+1, B) + per-row offsets -> dense (NE, L+1, G)."""
    from ndpp_tpu import banding

    return banding.densify(mom, g0, ng)


def scattering_moments(
    nuc: Nuclide,
    gs: GroupStructure,
    cfg: RunConfig,
    e_grid: np.ndarray,
    metrics: RunMetrics | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Combined per-unit-scatter transfer moments over all scattering MTs.

    f_{l,g'}(E) = sum_MT [ sigma_MT(E) y_MT(E) / sigma_scat(E) ] f^MT_{l,g'}(E)
    with sigma_scat = sum_MT sigma_MT (fission excluded; SURVEY.md section 3.1).

    Returns (moments (NE, L+1, G), sigma_scatter (NE,), elastic0k):
    elastic0k is (mom, g0, i0) — the UNWEIGHTED elastic moments (possibly
    banded) kept for apply_freegas's 0K subtraction (round 4: reusing them
    saves the 1-2 dispatch round-trips per nuclide that recomputing cost),
    or None when the nuclide has no elastic channel.
    """
    log = log_mod.get()
    rxns = nuc.scattering_reactions(include_fission=False)
    ne = e_grid.size
    order = cfg.legendre_order
    # the tile CAP is e_tile itself, never min(e_tile, ne): tile_for's
    # {cap/16, cap/4, cap} ladder needs a canonical cap to keep compiled
    # shapes scarce — min() would make every nuclide with NE < e_tile its
    # own never-seen tile shape, i.e. one more compile per nuclide
    tile = cfg.device.e_tile
    sigma_by_rxn = {}
    with RunMetrics.span_or_null(metrics, "prep.sigma"):
        for rxn in rxns:
            sig = nuc.sigma_on_grid(rxn)
            if e_grid.size != nuc.energy.size or not np.array_equal(e_grid, nuc.energy):
                sig = np.interp(e_grid, nuc.energy, sig)
            sigma_by_rxn[rxn.mt] = sig
        sigma_s = np.sum([sigma_by_rxn[r.mt] for r in rxns], axis=0)
    accum = np.zeros((ne, order + 1, gs.ng))

    def _accumulate(rxn, i0, mom, g0=None):
        yld = reaction_yield(rxn, e_grid, cfg.include_yield)
        w = np.where(sigma_s > 0, sigma_by_rxn[rxn.mt] / np.where(sigma_s > 0, sigma_s, 1.0), 0.0)
        wy = (w * yld)[i0:, None, None]
        if g0 is None:
            accum[i0:] += wy * mom
            return
        # banded result: add each row's (L+1, B) block at its window offset
        # (unique (row, l, group) triples — fancy-indexed += is exact)
        n, lp1, gw = mom.shape
        cols = g0[:, None] + np.arange(gw)[None, :]
        accum[i0:][
            np.arange(n)[:, None, None], np.arange(lp1)[None, :, None], cols[:, None, :]
        ] += wy * mom

    tb_items: list[tuple[Reaction, int, object]] = []
    cont_items: list[tuple[Reaction, int]] = []
    elastic0k = None
    for rxn in rxns:
        # Threshold-row restriction (round 3): a reaction only contributes
        # where sigma_MT > 0, so the kernels run on e_grid[i0:] only (one
        # margin row below the first nonzero). On threshold reactions over
        # log-spanning union grids this removes ~90% of the dispatched rows
        # (the round-3 warm profile's dominant device cost was continuum
        # kernels evaluating below-threshold rows). Exact: the combine
        # weight w is zero on the skipped rows.
        sig = sigma_by_rxn[rxn.mt]
        nz = np.nonzero(sig > 0)[0]
        if nz.size == 0:
            log.debug("MT=%d skipped: sigma == 0 on the whole grid", rxn.mt)
            continue
        i0 = max(int(nz[0]) - 1, 0)
        sub = e_grid[i0:]
        if is_twobody(rxn):
            # collected, then dispatched as ONE batched row pool per knot
            # bucket (_tiled_twobody_multi) — per-dispatch latency was the
            # measured two-body cost, not device FLOPs (round 3)
            with RunMetrics.span_or_null(metrics, "prep.twobody"):
                prep = prepare_twobody(nuc, rxn, sub)
            tb_items.append((rxn, i0, prep))
        else:
            # collected, then dispatched with cross-reaction law pooling
            # (continuum_driver.batched_continuum_moments, round 4): all
            # cm-kalbach / lab-tabular laws of a nuclide sharing a knot
            # bucket ride one tiled dispatch set
            cont_items.append((rxn, i0))
        log.debug("MT=%d queued/done (%d/%d rows)", rxn.mt, sub.size, ne)
    if cont_items:
        from ndpp_tpu.continuum_driver import batched_continuum_moments

        moms = batched_continuum_moments(
            nuc, [(rxn, e_grid[i0:]) for rxn, i0 in cont_items], gs, order, cfg, metrics
        )
        for (rxn, i0), mom in zip(cont_items, moms):
            _accumulate(rxn, i0, mom)
    if tb_items:
        outs = _tiled_twobody_multi(
            [p for _, _, p in tb_items], gs.bounds, order, cfg.device.quad_points,
            tile, metrics, cfg.clamp_outside,
        )
        for (rxn, i0, _), (mom, g0) in zip(tb_items, outs):
            _accumulate(rxn, i0, mom, g0)
            if rxn.mt == 2:
                # keep the UNWEIGHTED elastic moments: apply_freegas needs
                # exactly these on its thermal rows and previously paid 1-2
                # extra dispatch round-trips per nuclide recomputing them
                elastic0k = (mom, g0, i0)
    return accum, sigma_s, elastic0k


def process_nuclide(
    nuc: Nuclide,
    gs: GroupStructure,
    cfg: RunConfig,
    metrics: RunMetrics | None = None,
    sab_tables=None,
) -> NuclideResult:
    """Full single-nuclide pipeline -> NuclideResult.

    sab_tables: optional list of ThermalTable for this nuclide (cfg.sab);
    bound-thermal replacement supersedes free-gas where tabulated.
    """
    e_grid = unionize.moment_grid(nuc.energy)
    if cfg.thin_tol > 0:
        keep = unionize.thin_grid(e_grid, np.stack([nuc.sigma_t, nuc.sigma_el]), cfg.thin_tol)
        e_grid = e_grid[keep]
    temps = np.asarray(cfg.temperatures, dtype=np.float64)
    nt = temps.size

    base, sigma_s, elastic0k = scattering_moments(nuc, gs, cfg, e_grid, metrics)
    scatter = np.broadcast_to(base, (nt,) + base.shape).copy()

    # Bound-thermal S(alpha,beta) replacement (below each table's range),
    # then free-gas above it up to the thermal cutoff, per temperature
    from ndpp_tpu.freegas_driver import apply_freegas

    e_min_by_temp = None
    if sab_tables:
        from ndpp_tpu.thermal_driver import apply_sab, match_tables, sab_e_max

        matched = match_tables(sab_tables, list(cfg.temperatures))
        scatter = apply_sab(scatter, nuc, gs, cfg, e_grid, matched, metrics)
        e_min_by_temp = sab_e_max(matched)

    scatter = apply_freegas(scatter, nuc, gs, cfg, e_grid, metrics, e_min_by_temp, elastic0k)

    res = NuclideResult(
        name=nuc.name,
        zaid=nuc.zaid,
        awr=nuc.awr,
        kT=nuc.kT,
        energy=e_grid,
        temperatures=temps,
        scatter=scatter,
        sigma_scatter=sigma_s,
    )

    if nuc.fissionable:
        from ndpp_tpu.chi_driver import chi_collapse

        chi_collapse(res, nuc, gs, cfg, metrics)

    if metrics is not None:
        metrics.moments_computed += scatter.size
    return res


def _process_with_oom_retry(nuc, gs, cfg, metrics, sab_tables):
    """Device-OOM recovery (SURVEY.md section 5 'failure detection'): static
    padded shapes make OOM deterministic in the tile size, so halving
    device.e_tile and retrying is sound. Two halvings, then quarantine; any
    other device runtime fault quarantines the nuclide instead of killing
    the sweep."""
    from copy import deepcopy

    log = log_mod.get()
    try_cfg = cfg
    for attempt in range(3):
        try:
            return process_nuclide(nuc, gs, try_cfg, metrics, sab_tables=sab_tables)
        except RuntimeError as e:
            # jax device/compile failures surface as XlaRuntimeError or
            # jax.errors.JaxRuntimeError (both RuntimeError subclasses with
            # no stable import path); plain python RuntimeErrors quarantine
            # too rather than killing the sweep
            msg = f"{type(e).__name__}: {e}"
            # how XLA reports device OOM, at compile or at allocation
            oom = "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()
            if oom and attempt < 2 and try_cfg.device.e_tile > 64:
                try_cfg = deepcopy(try_cfg)
                try_cfg.device.e_tile //= 2
                log.warning(
                    "%s: device OOM — retrying with e_tile=%d", nuc.name, try_cfg.device.e_tile
                )
                continue
            # the quarantine reason preserves the ORIGINAL error class (msg
            # leads with type(e).__name__) and says whether OOM-shaped
            # retries were attempted, so a compiler bug misclassified as OOM
            # is still diagnosable from the quarantine record
            label = (
                f"device failure (OOM-shaped, after {attempt} tile-halving retr"
                f"{'y' if attempt == 1 else 'ies'}, e_tile={try_cfg.device.e_tile})"
                if oom
                else "device runtime failure"
            )
            raise NdppError(f"{label} for {nuc.name}: {msg[:500]}") from e
    raise AssertionError("unreachable")


def run(cfg: RunConfig) -> RunMetrics:
    """Full library run: parse -> process -> write, with quarantine + resume."""
    log = log_mod.get()
    timers = PhaseTimers()
    metrics = RunMetrics()
    t0 = time.perf_counter()

    # Sweep stall watchdog (SURVEY.md section 5): a dispatch that never
    # returns must not hold a long sweep forever; every completed phase
    # span is a heartbeat, and a stall dumps stacks + exits 4 so a
    # supervisor can restart with --resume (utils/watchdog.py).
    watchdog = None
    if cfg.device.watchdog_minutes > 0:
        from ndpp_tpu.utils.watchdog import EXIT_STALL, SweepWatchdog

        watchdog = SweepWatchdog(cfg.device.watchdog_minutes * 60.0).start()
        metrics.timers.on_add = watchdog.progress
        timers.on_add = watchdog.progress
        log_mod.get().info(
            "watchdog armed: exit(%d) after %.1f min without dispatch progress",
            EXIT_STALL,
            cfg.device.watchdog_minutes,
        )

    from ndpp_tpu.parallel import rows as rows_mod

    nd = rows_mod.configure(cfg.device.max_devices)
    if nd > 1:
        log.info("row-sharded dispatch over %d devices", nd)

    gs = cfg.group_structure()
    with timers.span("index"):
        idx = library_index.load(cfg.library)
    names = cfg.nuclides or idx.names()
    if names == ["all"]:
        names = idx.names()
    # thermal S(alpha,beta) tables (ACE class 't') are inputs to cfg.sab
    # assignments, never standalone sweep items
    names = [n for n in names if not n.endswith("t")]

    writers = open_writers(cfg, gs)
    quarantined: list[tuple[str, str]] = []

    # 3-stage pipeline (SURVEY.md section 2 'Pipeline'): host ACE parsing is
    # prefetched on a worker thread while the device computes the previous
    # nuclide; writes happen on the main thread (single writer per file).
    from concurrent.futures import ThreadPoolExecutor

    si, sn = cfg.shard_of()
    if sn > 1:
        names = names[si::sn]  # deterministic round-robin nuclide shard
        log.info("nuclide shard %s: %d of the library's nuclides", cfg.shard, len(names))
    todo = [
        n for n in names if not (cfg.resume and any(w.is_complete(n) for w in writers))
    ]
    for skipped in set(names) - set(todo):
        log.info("resume: skipping %s (complete)", skipped)

    def _parse(name: str):
        return read_ace(idx.path_for(name), name_hint=name)

    sab_cache: dict[str, list] = {}

    def _sab_tables(name: str):
        table_names = cfg.sab.get(name, [])
        if not table_names:
            return None
        from ndpp_tpu.thermal_driver import resolve_tables

        missing = [t for t in table_names if t not in sab_cache]
        for t, tab in zip(missing, resolve_tables(missing, idx)):
            sab_cache[t] = tab
        return [sab_cache[t] for t in table_names]

    pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="ndpp-parse")
    futures = {}
    prefetch_depth = 2

    # Dedicated writer thread (round 3): HDF5/ASCII writes of nuclide i
    # overlap host prep + device compute of nuclide i+1 (h5py releases the
    # GIL around I/O). Single writer per file is preserved — ALL writes
    # happen on this one thread; the bounded queue caps buffered results.
    # Writer faults stay systemic: the first exception aborts the sweep at
    # the next enqueue (or at finalize), never quarantines.
    import queue as queue_mod
    import threading

    write_q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    writer_fault: list[BaseException] = []

    def _writer_loop():
        while True:
            res = write_q.get()
            if res is None:
                return
            try:
                with timers.span("write"):
                    for w in writers:
                        w.write_nuclide(res)
            except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
                writer_fault.append(e)
                return

    writer_thread = threading.Thread(target=_writer_loop, name="ndpp-write", daemon=True)
    writer_thread.start()

    def _enqueue_write(res):
        while True:
            if writer_fault:
                raise writer_fault[0]
            try:
                write_q.put(res, timeout=1.0)
                return
            except queue_mod.Full:
                continue
    profile_ctx = None
    if cfg.device.profile:
        import jax

        trace_dir = str(Path(cfg.output.path).parent / "jax_trace")
        jax.profiler.start_trace(trace_dir)
        profile_ctx = trace_dir
        log.info("device profiling -> %s", trace_dir)
    # Fault-injection hook (SURVEY.md section 5; tests/test_watchdog.py):
    # simulate the observed environmental wedge — a dispatch that never
    # returns — right before processing nuclide index NDPP_TEST_HANG_AT.
    import os as os_mod

    hang_at = os_mod.environ.get("NDPP_TEST_HANG_AT")
    try:
        for i, name in enumerate(todo):
            if hang_at is not None and i == int(hang_at):
                log.warning("NDPP_TEST_HANG_AT=%s: simulating a wedged dispatch", hang_at)
                while True:
                    time.sleep(3600)
            for j in range(i, min(i + prefetch_depth, len(todo))):
                nm = todo[j]
                if nm not in futures:
                    futures[nm] = pool.submit(_parse, nm)
            write_phase = False
            try:
                snap = metrics.timers.snapshot()
                t_nuc = time.perf_counter()
                with timers.span("parse"):
                    nuc = futures.pop(name).result()
                with timers.span("compute"):
                    res = _process_with_oom_retry(nuc, gs, cfg, metrics, _sab_tables(name))
                # the write phase is OUTSIDE the quarantine catch: a writer
                # fault (disk full, permissions) is a systemic infrastructure
                # failure, not a per-nuclide data problem — abort the sweep
                # instead of misreporting N independent quarantines
                write_phase = True
                with timers.span("write_enqueue"):
                    _enqueue_write(res)
                write_phase = False
                metrics.nuclides_done += 1
                sub = PhaseTimers.delta(snap, metrics.timers.snapshot())
                log.info(
                    "done %s (NE=%d) %.2fs %s",
                    name,
                    res.energy.size,
                    time.perf_counter() - t_nuc,
                    " ".join(f"{k}={v:.2f}" for k, v in sub.items()),
                )
            except Exception as e:
                if write_phase:
                    raise  # writer faults are systemic; see comment above
                # quarantine this nuclide, keep sweeping (SURVEY.md section
                # 5): the sweep is a bag of independent tasks, so ANY
                # per-nuclide failure — a typed NdppError OR an unexpected
                # ValueError/IndexError escaping host prep for one
                # pathological nuclide — must not kill the remaining sweep.
                reason = str(e) if isinstance(e, NdppError) else f"{type(e).__name__}: {e}"
                quarantined.append((name, reason))
                metrics.nuclides_quarantined += 1
                log.error("quarantined %s: %s", name, reason)
    finally:
        if watchdog is not None:
            watchdog.stop()
        if profile_ctx is not None:
            import jax

            jax.profiler.stop_trace()
        pool.shutdown(wait=False, cancel_futures=True)
        # Sentinel mirrors _enqueue_write: an unbounded put on the maxsize-2
        # queue can block forever when the writer thread died on a fault with
        # two results already buffered (no consumer remains) — poll with a
        # timeout and stop once the fault is visible or the thread is gone.
        while writer_thread.is_alive() and not writer_fault:
            try:
                write_q.put(None, timeout=1.0)
                break
            except queue_mod.Full:
                continue
        writer_thread.join()
        if writer_fault:
            raise writer_fault[0]
        metrics.wall_seconds = time.perf_counter() - t0
        for k, v in metrics.timers.report().items():
            timers.add(k, v)
        metrics.phase_seconds = timers.report()
        metrics.capture_device_mem()
        for w in writers:
            w.finalize(metrics.to_dict())
    log.info("run complete: %s", metrics.json_line())
    if quarantined:
        log.warning("%d nuclide(s) quarantined: %s", len(quarantined), [q[0] for q in quarantined])
    return metrics
