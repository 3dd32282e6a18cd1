#!/usr/bin/env python
"""Per-nuclide host-cost profiler (round-2 verdict Weak #2 / Next #1).

Runs a subset of the scale library twice in one process — pass 1 populates
the jit cache (cold compiles excluded from analysis), pass 2 runs under
cProfile — then prints:

  - the driver's per-phase wall breakdown (parse / prep.* / dispatch.* /
    wait.* / write) for the WARM pass, and
  - the top host functions by cumulative and self time.

Usage:
    python scripts/profile_host.py [--nuclides stress000 stress001 ...]
        [--workdir DIR] [--temps 293.6 600.0] [--order 5]
        [--groups uniform-lethargy-361]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nuclides", nargs="+", default=None)
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "ndpp_scale"))
    ap.add_argument("--temps", type=float, nargs="+", default=[293.6, 600.0])
    ap.add_argument("--order", type=int, default=5)
    ap.add_argument("--groups", default="uniform-lethargy-361")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--e-tile", type=int, default=0, help="override device.e_tile (0 = default)")
    args = ap.parse_args()

    from ndpp_tpu import config as config_mod, driver
    from ndpp_tpu.utils import log as log_mod

    log_mod.setup(level=20)
    workdir = Path(args.workdir)
    xsdir = workdir / "xsdir"
    if not xsdir.exists():
        raise SystemExit(f"{xsdir} missing — run scripts/scale_demo.py first to build the library")

    names = args.nuclides
    if names is None:
        # a representative mix: light elastic, levels, kalbach, fission+chi
        names_all = [ln.split()[0] for ln in xsdir.read_text().splitlines()[1:] if ln.strip()]
        picks = ["1001.80c", "26056.80c", "92235.80c"]
        names = [n for n in picks if n in names_all] + [n for n in names_all if n.startswith("90")][:4]

    def make_cfg(tag: str):
        cfg = config_mod.RunConfig(
            nuclides=list(names),
            library=str(xsdir),
            groups=args.groups,
            legendre_order=args.order,
            temperatures=list(args.temps),
        )
        cfg.output.path = str(workdir / f"profile_{tag}.h5")
        if args.e_tile:
            cfg.device.e_tile = args.e_tile
        cfg.validate()
        return cfg

    print(f"profiling {len(names)} nuclides: {names}", flush=True)
    t0 = time.perf_counter()
    m_cold = driver.run(make_cfg("cold"))
    print(f"COLD {time.perf_counter() - t0:.1f}s " + json.dumps(m_cold.phase_seconds), flush=True)

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    m_warm = driver.run(make_cfg("warm"))
    prof.disable()
    warm_s = time.perf_counter() - t0
    print(f"WARM {warm_s:.1f}s " + json.dumps(m_warm.phase_seconds), flush=True)
    print(
        f"WARM rate: {m_warm.moments_computed / max(warm_s, 1e-9):.3g} moments/s "
        f"({m_warm.moments_computed} moments)",
        flush=True,
    )

    for sort in ("cumulative", "tottime"):
        buf = io.StringIO()
        st = pstats.Stats(prof, stream=buf)
        st.sort_stats(sort).print_stats(args.top)
        print(f"\n===== top by {sort} =====")
        # strip the long header lines for readability
        for line in buf.getvalue().splitlines():
            if "/opt/venv" in line or "ndpp" in line or "{" in line or "ncalls" in line:
                print(line)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
