"""Nuclide-axis process parallelism (SURVEY.md section 2, parallelism row 1).

The library sweep is a bag of independent per-nuclide tasks whose per-task
host work (parse/prep/write) is serial — so on a multi-card host the right
nuclide-axis design is one WORKER PROCESS per card, each running the
ordinary single-card driver over a deterministic round-robin shard of the
nuclide list (cfg.shard = "i/N"), with a final HDF5 merge
(io.library.merge_libraries). Within each worker, incident-energy rows
still shard over that worker's visible devices via parallel.rows — the two
axes compose.

Card assignment: worker i sees one card, CUDA_VISIBLE_DEVICES=<i> (or the
i-th entry of the parent's own CUDA_VISIBLE_DEVICES list). The parent never
initializes a JAX backend: JAX reserves most of a card's memory when it
first uses it, so a parent that touched card 0 would starve worker 0.
``force_cpu_devices`` instead pins each worker to a virtual CPU mesh
(tests and the CPU dry run in ``__graft_entry__.dryrun_multichip``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _worker_deck(cfg, i: int, n: int, out_path: Path, fmt: str) -> dict:
    """Nested deck dict for config.load, with this worker's shard/output."""
    d = cfg.to_dict()
    output = d.pop("output")
    device = d.pop("device")
    d["shard"] = f"{i}/{n}"
    output["path"] = str(out_path)
    output["format"] = fmt
    return {"run": d, "output": output, "device": device}


def worker_env(
    i: int, force_cpu_devices: int = 0, env_extra: dict | None = None, base: dict | None = None
) -> dict:
    """Environment of worker i: one card each, or a virtual CPU mesh."""
    env = dict(os.environ if base is None else base)
    if force_cpu_devices:
        env["NDPP_FORCE_CPU_DEVICES"] = str(force_cpu_devices)
    else:
        visible = [d for d in env.get("CUDA_VISIBLE_DEVICES", "").split(",") if d.strip()]
        if visible and i >= len(visible):
            raise ValueError(
                f"worker {i} has no card: CUDA_VISIBLE_DEVICES lists {len(visible)}"
            )
        env["CUDA_VISIBLE_DEVICES"] = visible[i].strip() if visible else str(i)
    if env_extra:
        env.update(env_extra)
    return env


def run_workers(
    cfg,
    n_workers: int,
    force_cpu_devices: int = 0,
    env_extra: dict | None = None,
    timeout_s: float = 24 * 3600,
) -> dict:
    """Run the sweep as n_workers shard subprocesses + merge; returns a summary.

    Worker i processes nuclides [i::n_workers] into <output>.shard<i>.h5
    (.txt for an ASCII run); all workers' outputs merge into
    cfg.output.path. Worker stdout/stderr
    stream to <output>.shard<i>.log. A nonzero worker exit (quarantines
    -> 3) is carried into the summary, not raised — the merge still runs
    over whatever completed (the per-nuclide quarantine model, at process
    granularity).
    """
    from ndpp_tpu.io.library import merge_libraries
    from ndpp_tpu.utils import log as log_mod

    log = log_mod.get()
    out = Path(cfg.output.path)
    # Workers write ASCII shards for an ASCII run (no h5py needed) and HDF5
    # shards otherwise. With 'both' the merged HDF5 keeps cfg.output.path
    # and its ASCII twin lands at the open_writers .txt path.
    fmt = "ascii" if cfg.output.format == "ascii" else "hdf5"
    ascii_twin = out.with_suffix(".txt") if cfg.output.format == "both" else None
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    shard_paths = []
    for i in range(n_workers):
        shard_path = out.with_name(out.stem + f".shard{i}" + (".txt" if fmt == "ascii" else ".h5"))
        shard_paths.append(shard_path)
        deck_path = out.with_name(out.stem + f".shard{i}.json")
        deck_path.write_text(json.dumps(_worker_deck(cfg, i, n_workers, shard_path, fmt)))
        env = worker_env(i, force_cpu_devices, env_extra)
        log_path = out.with_name(out.stem + f".shard{i}.log")
        logf = open(log_path, "w")
        cmd = [sys.executable, "-m", "ndpp_tpu.cli", "run", "-c", str(deck_path)]
        if cfg.resume:
            cmd.append("--resume")
        procs.append((i, subprocess.Popen(cmd, env=env, stdout=logf, stderr=subprocess.STDOUT), logf))
        log.info("worker %d/%d started (shard -> %s)", i, n_workers, shard_path.name)

    rcs = {}
    for i, p, logf in procs:
        try:
            rcs[i] = p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            rcs[i] = -9
        logf.close()
        log.info("worker %d exited rc=%d", i, rcs[i])

    present = [sp for sp in shard_paths if sp.exists()]
    merged = merge_libraries(out, present) if present else 0
    if ascii_twin is not None and merged:
        from ndpp_tpu.io.library import write_ascii_from_hdf5

        n_ascii = write_ascii_from_hdf5(out, ascii_twin)
        log.info("ASCII twin written: %s (%d nuclides)", ascii_twin, n_ascii)
    summary = {
        "workers": n_workers,
        "worker_rcs": rcs,
        "merged_nuclides": merged,
        "wall_seconds": time.perf_counter() - t0,
        "output": str(out),
        "shards": [str(s) for s in present],
    }
    log.info("run_workers complete: %s", json.dumps(summary))
    return summary
