#!/usr/bin/env python
"""Config-5 scale demonstration (BASELINE.json:11; round-1 verdict item 1).

Builds a ~300-nuclide synthetic library (the 16 named fixtures + N
parametrized stress nuclides + the bound-thermal tables), then runs the
FULL production pipeline twice at the north-star shape — P5, 361 groups,
multi-temperature, S(alpha,beta) assignments on H-1:

  pass 1 (cold): every kernel shape compiles; measures the wall the first
         user pays on an empty jit cache;
  pass 2 (warm): same deck into a fresh output in the same process, with
         every executable compiled — the steady-state end-to-end
         throughput.

Both passes run inside ONE supervised child process with the sweep
watchdog armed (config.device.watchdog_minutes). A stalled dispatch makes
the watchdog exit the child with code 4 (stack dump on stderr), and the
supervisor restarts it with --resume until both passes complete or
--max-restarts is exhausted: completed passes skip through resume
bookkeeping in seconds, and the interrupted pass continues. The
supervisor itself never initializes a JAX backend, so the child has the
card to itself.

Prints one JSON line per pass plus a summary line; exits nonzero if any
nuclide quarantines. Usage:

    python scripts/scale_demo.py [--nuclides 300] [--temps 293.6 600.0]
        [--order 5] [--groups uniform-lethargy-361] [--format hdf5|ascii]
        [--workdir DIR] [--cold-only] [--resume]
        [--watchdog-minutes 25] [--max-restarts 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The sweep always runs the tree this script sits in — a snapshot worktree
# stays pinned to its own code even when the editable install points at
# another checkout.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EXIT_STALL = 4  # matches ndpp_tpu.utils.watchdog.EXIT_STALL (parent stays jax-free)


def build_library(workdir: Path, n_total: int) -> Path:
    """16 named fixtures + (n_total - 16) stress nuclides + thermal tables."""
    from ndpp_tpu.host.ace import synth
    from ndpp_tpu.host.ace.thermal import write_thermal_ace
    from ndpp_tpu.host.ace.write import write_ace

    workdir.mkdir(parents=True, exist_ok=True)
    xsdir = workdir / "xsdir"
    marker = workdir / f".complete_{n_total}"
    if xsdir.exists() and marker.exists():
        print(f"library already built in {workdir}", flush=True)
        return xsdir
    t0 = time.perf_counter()
    lines = []
    for key in sorted(synth.ALL_FIXTURES):
        nuc = synth.build(key)
        p = write_ace(nuc, workdir / f"{key}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    n_named = len(lines)
    for i in range(max(n_total - n_named, 0)):
        nuc = synth.stress_nuclide(i)
        p = write_ace(nuc, workdir / f"stress{i:03d}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
        if (i + 1) % 50 == 0:
            print(f"  built {i + 1} stress nuclides...", flush=True)
    for key in sorted(synth.THERMAL_FIXTURES):
        tab = synth.build_thermal(key)
        p = write_thermal_ace(tab, workdir / f"{key}.ace")
        lines.append(f"{tab.name} {tab.awr:.6f} {Path(p).name} 0 1 1 0")
    xsdir.write_text("directory\n" + "\n".join(lines) + "\n")
    marker.touch()
    print(
        f"built {len(lines)}-entry library in {time.perf_counter() - t0:.1f} s -> {xsdir}",
        flush=True,
    )
    return xsdir


def make_cfg(args, xsdir: Path, out_path: Path, resume: bool):
    from ndpp_tpu import config as config_mod

    cfg = config_mod.RunConfig(
        nuclides=[],  # all non-thermal entries in the index
        library=str(xsdir),
        groups=args.groups,
        legendre_order=args.order,
        temperatures=list(args.temps),
        sab={"1001.80c": ["lwtr.20t"]},
    )
    cfg.output.path = str(out_path)
    cfg.output.format = args.format
    cfg.device.watchdog_minutes = args.watchdog_minutes
    # Fat tiles: every family's dispatch cap scales with e_tile
    # (parallel.rows.tile_for); 2048 quadruples the default caps, and the
    # OOM retry halves it per nuclide if device memory runs out.
    cfg.device.e_tile = args.e_tile
    cfg.resume = resume
    cfg.validate()
    return cfg


def run_passes(args, passes: list[str], resume: bool) -> int:
    """Child mode: ALL passes sequentially in THIS process — the warm pass
    inherits the cold pass's live jit cache. The armed watchdog may
    os._exit(4) under a wedge; on the supervisor's resumed restart,
    already-complete passes skip through in seconds."""
    from ndpp_tpu import driver
    from ndpp_tpu.utils import log as log_mod

    log_mod.setup(level=20)
    workdir = Path(args.workdir)
    xsdir = build_library(workdir, args.nuclides)
    rc = 0
    for which in passes:
        suffix = ".h5" if args.format == "hdf5" else ".txt"
        cfg = make_cfg(args, xsdir, workdir / f"library_{which}{suffix}", resume)
        t0 = time.perf_counter()
        m = driver.run(cfg)
        wall = time.perf_counter() - t0
        row = {
            "pass": which,
            "wall_s": round(wall, 1),
            "nuclides_done": m.nuclides_done,
            "quarantined": m.nuclides_quarantined,
            "moments": m.moments_computed,
            "moments_per_sec": round(m.moments_computed / max(wall, 1e-9), 1),
            "padding_efficiency": m.padding_efficiency,
            "phase_seconds": {k: round(v, 1) for k, v in m.phase_seconds.items()},
        }
        print("SCALE " + json.dumps(row), flush=True)
        if m.nuclides_quarantined:
            rc = 3
    return rc


def supervise(args, passes: list[str], argv: list[str]) -> dict:
    """Parent mode: run all passes in one child; restart it with --resume
    on a watchdog stall (exit 4) until done or --max-restarts is
    exhausted."""
    restarts = 0
    resume = args.resume
    rows: list[dict] = []
    t0 = time.perf_counter()
    while True:
        cmd = [sys.executable, __file__, *argv, "--child", ",".join(passes)]
        if resume:
            cmd.append("--resume")
        child = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        assert child.stdout is not None
        for line in child.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            if line.startswith("SCALE "):
                rows.append(json.loads(line[len("SCALE ") :]))
        rc = child.wait()
        if rc == EXIT_STALL and restarts < args.max_restarts:
            restarts += 1
            resume = True
            print(
                f"SUPERVISOR: watchdog stall (exit {EXIT_STALL}) — "
                f"restart {restarts}/{args.max_restarts} with --resume",
                flush=True,
            )
            continue
        break
    done = sum(r.get("nuclides_done", 0) for r in rows)
    quarantined = sum(r.get("quarantined", 0) for r in rows)
    return {
        "rc": rc,
        "restarts": restarts,
        "wall_s_total": round(time.perf_counter() - t0, 1),
        "nuclides_done_total": done,
        "quarantined_total": quarantined,
        "segments": rows,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nuclides", type=int, default=300)
    ap.add_argument("--temps", type=float, nargs="+", default=[293.6, 600.0])
    ap.add_argument("--order", type=int, default=5)
    ap.add_argument("--groups", default="uniform-lethargy-361")
    ap.add_argument("--format", default="hdf5", choices=["hdf5", "ascii"])
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "ndpp_scale"))
    ap.add_argument("--cold-only", action="store_true")
    ap.add_argument("--resume", action="store_true", help="resume the cold pass")
    ap.add_argument("--e-tile", type=int, default=2048)
    ap.add_argument("--watchdog-minutes", type=float, default=25.0)
    ap.add_argument("--max-restarts", type=int, default=20)
    ap.add_argument("--child", default=None, help="(internal) child mode: run these passes in-process")
    args = ap.parse_args()

    if args.child is not None:
        return run_passes(args, args.child.split(","), args.resume)

    # rebuild the child argv from parsed args (drop --resume/--child: the
    # supervisor owns both)
    argv = [
        "--nuclides", str(args.nuclides),
        "--temps", *[str(t) for t in args.temps],
        "--order", str(args.order),
        "--groups", args.groups,
        "--format", args.format,
        "--workdir", args.workdir,
        "--e-tile", str(args.e_tile),
        "--watchdog-minutes", str(args.watchdog_minutes),
    ]
    build_library(Path(args.workdir), args.nuclides)  # build once, host-only
    passes = ["cold"] if args.cold_only else ["cold", "warm"]
    row = supervise(args, passes, argv)
    rc = row["rc"] if row["rc"] != 0 else (3 if row["quarantined_total"] else 0)
    print("SCALE_SUMMARY " + json.dumps(row), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
