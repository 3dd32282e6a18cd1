#!/usr/bin/env python
"""Bring-up check on an NVIDIA GPU: the main path end to end, every kernel
family compiled for the card and checked against an independent reference.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --four-cards  # four cards: the phase-5 deck on four of
                                       # its nuclides, row-sharded over four
                                       # cards in one process, as `--workers 4`
                                       # (one process per card), and on one
                                       # card; each multi-card library is
                                       # compared with the one-card one

Phases of the one-card run:
  1 device   the card's name and power limit, JAX versions, the devices;
             the platform must be gpu (JAX_PLATFORMS is pinned to cuda)
  2 build    the native ACE tokenizer, built from source, must load
  3 compile  each kernel family compiled once for the card at production
             widths (compile seconds, memory_analysis); the S(alpha,beta)
             kernels are compared with their oracles here
  4 gate     selfcheck.run(): two-body, free-gas, continuum and chi against
             independent references, float64, two-legged 1e-8 metric
  5 run      `ndpp run` on the phase-5 deck: the 16 named fixtures plus
             stress nuclides 0-7, P5, 361 groups, 293.6 K and 600 K,
             S(alpha,beta) on H-1, e_tile 2048
  6 cpu      the same deck on three of its nuclides in a child process that
             never opens the card (started before phase 5, so the two runs
             overlap); the two libraries are compared

A failed phase stops the script with a non-zero exit. The last line of
stdout is the contract line, {"ok": true, "device": {...}}, and nothing else.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
STRESS = 8  # stress nuclides 0..7 beside the 16 named fixtures
COMPARE_NUCLIDES = ("1001.80c", "92235.80c", "90000.80c")  # H-1 with S(a,b), U-235, stress 0
# one per worker: + Fe-56, whose discrete levels take the banded two-body path
FOUR_CARD_NUCLIDES = COMPARE_NUCLIDES + ("26056.80c",)
PHASE5_CUT = (
    "deck cut from config 5's ~300 nuclides (BASELINE.json) to 24 "
    "(16 named fixtures + stress 0-7), forced by the run's time limit"
)
FOUR_CARD_CUT = (
    "four-card deck cut to 4 of the phase-5 deck's nuclides (one per worker: "
    "H-1 with S(a,b), U-235, stress 0, Fe-56), forced by the chip-time budget "
    "of three runs on four cards"
)


class PhaseError(RuntimeError):
    """A phase's check failed."""


def say(*args) -> None:
    print(*args, flush=True)


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def device_gate(devices, count: int = 1) -> None:
    """Refuse anything but `count` or more GPU devices."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise PhaseError(f"JAX found no GPU: platform is {platform}")
    if len(devices) < count:
        raise PhaseError(f"need {count} GPUs, JAX sees {len(devices)}")


def contract_line(devices) -> str:
    """The last line of stdout: the device as JAX reports it."""
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}}
    )


def output_format() -> str:
    """HDF5 where h5py imports, ASCII otherwise."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "ascii"
    return "hdf5"


def phase5_deck(xsdir: Path, out_path: Path, fmt: str, nuclides=()) -> dict:
    """The phase-5 deck: config 5's widths (BASELINE.json) on the fixture
    library; an empty nuclide list means every nuclide of the library."""
    return {
        "run": {
            "nuclides": list(nuclides),
            "library": str(xsdir),
            "groups": "uniform-lethargy-361",
            "legendre_order": 5,
            "temperatures": [293.6, 600.0],
            "sab": {"1001.80c": ["lwtr.20t"]},
        },
        "output": {"path": str(out_path), "format": fmt},
        "device": {"e_tile": 2048},
    }


def write_deck(path: Path, deck: dict) -> Path:
    path.write_text(json.dumps(deck, indent=1))
    return path


def build_library(lib_dir: Path, stress: int = STRESS) -> Path:
    """`ndpp fixtures`: the named fixtures, `stress` stress nuclides and the
    thermal tables; returns the xsdir path."""
    from ndpp_tpu import cli

    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["fixtures", "--out", str(lib_dir), "--stress", str(stress)])
    if rc != 0:
        raise PhaseError(f"ndpp fixtures exited {rc}")
    return lib_dir / "xsdir"


def library_metrics(path: Path) -> dict:
    """The run metrics a library file carries ({} for a merged shard
    library, which carries none)."""
    from ndpp_tpu.io.library import is_hdf5, read_ascii

    if is_hdf5(path):
        import h5py

        with h5py.File(path, "r") as f:
            if "metrics" not in f:
                return {}
            m = f["metrics"][()]
        return json.loads(m.decode() if isinstance(m, bytes) else m)
    return read_ascii(path)[1].get("metrics", {})


def nuclide_datasets(path: Path, names=None) -> dict:
    """{path: array} of the nuclide datasets of a library (all nuclides, or
    those named)."""
    from ndpp_tpu.io.library import load_datasets

    out = {}
    for key, arr in load_datasets(path).items():
        parts = key.split("/")
        if len(parts) > 3 and parts[1] == "nuclides" and (names is None or parts[2] in names):
            out[key] = arr
    return out


def compare_libraries(got: dict, ref: dict) -> dict:
    """Every dataset of `ref` against `got` with the two-legged metric of
    docs/format.md: moment arrays per (temperature, incident-energy) row,
    1-D arrays element by element after scaling by their largest value."""
    from ndpp_tpu.selfcheck import _family_gate

    missing = sorted(set(ref) ^ set(got))
    worst = {"max_abs": 0.0, "max_rel_significant": 0.0}
    failed = []
    for key in sorted(set(ref) & set(got)):
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        if a.shape != b.shape:
            failed.append(f"{key}: shape {a.shape} vs {b.shape}")
            continue
        if b.ndim == 1:  # cross sections, energies: scaled by their largest value
            scale = max(float(np.abs(b).max()), 1e-300)
            a, b = a[:, None] / scale, b[:, None] / scale
        rows = b.reshape((-1,) + b.shape[-2:]) if b.ndim > 2 else b
        g = _family_gate(a.reshape(rows.shape), rows)
        for k in ("max_abs", "max_rel_significant"):
            if g[k] > worst[k]:
                worst[k] = g[k]
                worst[k.replace("max", "where")] = key
        if not g["ok"]:
            failed.append(f"{key}: max_abs {g['max_abs']:.3e} rel_sig {g['max_rel_significant']:.3e}")
    return {**worst, "datasets": len(ref), "missing": missing, "failed": failed,
            "ok": not missing and not failed}


def run_deck(deck_path: Path) -> int:
    """`ndpp run -c deck` in this process, through the CLI entry point."""
    from ndpp_tpu import cli

    return cli.main(["run", "-c", str(deck_path)])


def check_run(out_path: Path, n_expected: int) -> dict:
    """The run's metrics, after checking it finished with every nuclide done
    and only finite moments."""
    data = nuclide_datasets(out_path)
    done = len({k.split("/")[2] for k in data})
    m = library_metrics(out_path)
    if done != n_expected or m.get("nuclides_quarantined", 0) != 0:
        raise PhaseError(
            f"{done} of {n_expected} nuclides in the library, "
            f"{m.get('nuclides_quarantined')} quarantined"
        )
    bad = [k for k, v in data.items() if not np.all(np.isfinite(v))]
    if bad:
        raise PhaseError(f"non-finite values in {bad[:5]}")
    return m


# -- phases of the one-card run ---------------------------------------------


def phase_device(count: int = 1):
    import jax
    import jaxlib

    say(f"card: {card_info()}")
    say(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, python {sys.version.split()[0]}")
    devices = jax.devices()
    say(f"devices: {devices}")
    device_gate(devices, count)
    return devices


def phase_build():
    from ndpp_tpu import native

    lib = native.get_lib()
    say(f"native tokenizer: {'loaded ' + str(native._LIB_PATH) if lib else 'NOT loaded'}")
    if lib is None:
        raise PhaseError("the native tokenizer did not build or load")
    got = native.tokenize_floats("1.5 -2.0E+03 3")
    if list(got) != [1.5, -2000.0, 3.0]:
        raise PhaseError(f"native tokenizer returned {got}")


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return " ".join(f"{f.replace('_size_in_bytes', '')}={getattr(m, f, None)}" for f in fields)


def _compile(name: str, fn, *args, **static):
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **static).compile()
    say(f"  compile {name}: {time.perf_counter() - t0:.2f} s; {_memory(compiled)}")
    return compiled


def phase_compile(ng: int = 361, order: int = 5, tile: int = 2048):
    """Compile each family at production widths; check the S(alpha,beta)
    kernels against their oracles."""
    import jax.numpy as jnp

    from ndpp_tpu import groups, selfcheck
    from ndpp_tpu.host.ace import synth
    from ndpp_tpu.host.prep_thermal import _pad_pow2, prepare_thermal
    from ndpp_tpu.ops import chi, continuum, freegas, thermal
    from ndpp_tpu.ops.twobody import twobody_moments
    from ndpp_tpu.oracle import thermal as thermal_oracle

    e0, args = selfcheck.production_inputs(tile, ng=ng)
    _compile(f"two-body {tile}x{args[0].shape[1]}xP{order}x{ng}", twobody_moments, e0, *args,
             order=order, nq=selfcheck.PROD_NQ)

    bounds = groups.get("uniform-lethargy-361").bounds if ng == 361 else np.asarray(args[2])
    rows, k = 16, 32
    e = np.geomspace(3e6, 2e7, rows)
    kn = np.linspace(1e3, e - 2e6, k, axis=-1)
    pd = np.ones((rows, k)) / np.ptp(kn, axis=1)[:, None]
    z = jnp.zeros((rows, k))
    for angular, muk, mup in (
        ("kalbach", np.array([-1.0, 1.0]), np.zeros((rows, k, 2))),
        ("tabular", np.linspace(-1.0, 1.0, 9), np.full((rows, k, 9), 0.5)),
    ):
        _compile(
            f"continuum {angular} {rows}x{k}x{ng}", continuum.cm_moments_pointwise,
            jnp.asarray(e), jnp.asarray(kn), jnp.asarray(pd), z + 0.3, z + 0.5,
            jnp.asarray(muk), jnp.asarray(mup), jnp.zeros(rows), 0.0, jnp.asarray(bounds),
            55.4, order=order, nq_w=12 if angular == "tabular" else 10, nq_y=8 if angular == "tabular" else 7,
            angular=angular, energy="tabular", clamp=True, chunk=8, ksel=0,
            group_split="lagrange", cross_edges=angular == "tabular",
        )

    window = 256
    bw = jnp.asarray(np.concatenate([[0.0], groups.get("uniform-lethargy-361").bounds[: window + 1]]))
    _compile(f"free-gas sab 8x{window + 1}", freegas.freegas_moments_sab,
             jnp.asarray(np.geomspace(1e-3, 10.0, 8)), 238.0, 0.0253, bw, order)

    kn_c = np.sort(np.random.default_rng(11).uniform(1e2, 2e6, size=(16, 24)), axis=1)
    _compile(f"chi 16x24x{ng}", chi.tabular_group_fractions, jnp.asarray(kn_c),
             jnp.ones((16, 24)), jnp.asarray(np.geomspace(1e1, 3e6, ng + 1)))

    # S(alpha,beta): the driver's shapes (thermal_driver.apply_sab) and its
    # clamped bounds, each kernel against its oracle
    b_cl = np.asarray(bounds, dtype=np.float64).copy()
    b_cl[0], b_cl[-1] = 0.0, np.inf
    b_d = jnp.asarray(b_cl)
    gates = {}
    lwtr, grph = synth.build_thermal("lwtr"), synth.build_thermal("grph")
    p = prepare_thermal(lwtr, order)
    n, pad = p.e_in.size, _pad_pow2(p.e_in.size)
    ek = np.concatenate([p.e_knots, np.repeat(p.e_knots[-1:], pad - n, 0)])
    pf = np.concatenate([p.pdf, np.zeros((pad - n,) + p.pdf.shape[1:])])
    am = np.concatenate([p.am, np.repeat(p.am[-1:], pad - n, 0)])
    c = _compile(f"thermal continuous {pad}x{ng}", thermal.thermal_continuous_moments,
                 jnp.asarray(ek), jnp.asarray(pf), jnp.asarray(am), b_d, order=order)
    got = np.asarray(c(jnp.asarray(ek), jnp.asarray(pf), jnp.asarray(am), b_d))
    idx = [0, n // 2, n - 1]
    ref = np.stack([thermal_oracle.continuous_moments_oracle(lwtr, i, b_cl, order) for i in idx])
    gates["thermal continuous"] = selfcheck._family_gate(got[idx], ref)

    q = prepare_thermal(grph, order)
    c = _compile(f"thermal discrete {q.e_in.size}x{ng}", thermal.thermal_discrete_moments,
                 jnp.asarray(q.e_out), jnp.asarray(q.w_lines), jnp.asarray(q.am_lines), b_d, clamp=True)
    got = np.asarray(c(jnp.asarray(q.e_out), jnp.asarray(q.w_lines), jnp.asarray(q.am_lines), b_d))
    idx = [0, q.e_in.size // 2, q.e_in.size - 1]
    ref = np.stack([thermal_oracle.discrete_moments_oracle(grph, i, b_cl, order) for i in idx])
    gates["thermal discrete"] = selfcheck._family_gate(got[idx], ref)

    edges, cum = grph.elastic.energy, grph.elastic.sigma
    e_el = np.concatenate([np.geomspace(edges[0] * 1.01, 4.0, 63), [edges[0] * 0.5]])
    c = _compile(f"thermal coherent elastic {e_el.size}x{ng}", thermal.coherent_elastic_moments,
                 jnp.asarray(e_el), jnp.asarray(q.e_el), jnp.asarray(q.bragg_s), b_d, order=order)
    got = np.asarray(c(jnp.asarray(e_el), jnp.asarray(q.e_el), jnp.asarray(q.bragg_s), b_d))
    ref = np.zeros_like(got)
    for i, ei in enumerate(e_el[:-1]):
        g = int(np.searchsorted(b_cl, ei, side="right") - 1)
        ref[i, :, g] = thermal_oracle.coherent_elastic_oracle(float(ei), edges, cum, order)
    gates["thermal coherent elastic"] = selfcheck._family_gate(got, ref)

    f = np.random.default_rng(5).uniform(-1.0, 1.0, size=(64, order + 1))
    f[:, 0] = 1.0
    e_inc = np.geomspace(1e-4, 4.0, 64)
    c = _compile(f"thermal incoherent elastic 64x{ng}", thermal.incoherent_elastic_placement,
                 jnp.asarray(f), jnp.asarray(e_inc), b_d)
    got = np.asarray(c(jnp.asarray(f), jnp.asarray(e_inc), b_d))
    ref = np.zeros_like(got)
    g = np.searchsorted(b_cl, e_inc, side="right") - 1
    ref[np.arange(64), :, g] = f
    gates["thermal incoherent elastic"] = selfcheck._family_gate(got, ref)

    for name, g in gates.items():
        say(f"  {name} vs oracle: {json.dumps(g)}")
    bad = [name for name, g in gates.items() if not g["ok"]]
    if bad:
        raise PhaseError(f"S(alpha,beta) kernels off their oracles: {bad}")


def phase_gate():
    from ndpp_tpu import selfcheck

    report = selfcheck.run()
    say(f"selfcheck: {json.dumps(report)}")
    failed = selfcheck.failed_families(report)
    if failed or not report["ok"]:
        raise PhaseError(f"selfcheck failed: {failed}")


def phase_run(work: Path, xsdir: Path, fmt: str) -> Path:
    say(f"  {PHASE5_CUT}")
    say(f"  output format: {fmt} (h5py {'imports' if output_format() == 'hdf5' else 'is absent'})")
    out = work / ("gpu.h5" if fmt == "hdf5" else "gpu.txt")
    deck = write_deck(work / "phase5.json", phase5_deck(xsdir, out, fmt))
    rc = run_deck(deck)
    if rc != 0:
        raise PhaseError(f"ndpp run exited {rc}")
    m = check_run(out, 16 + STRESS)
    say(
        "  metrics: "
        + json.dumps({k: m.get(k) for k in ("nuclides_done", "nuclides_quarantined", "wall_seconds",
                                            "moments_computed", "nuclide_group_moments_per_sec",
                                            "device_mem_highwater_bytes", "phase_seconds")})
    )
    return out


def cpu_child_env() -> dict:
    """Environment of a child that never opens a card."""
    return dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")


def start_cpu_run(work: Path, xsdir: Path, fmt: str):
    """Start the phase-6 CPU run of COMPARE_NUCLIDES in a child process that
    never opens a card; returns (process, output path, start time)."""
    out = work / ("cpu.h5" if fmt == "hdf5" else "cpu.txt")
    deck = write_deck(work / "cpu.json", phase5_deck(xsdir, out, fmt, COMPARE_NUCLIDES))
    log = open(work / "cpu.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ndpp_tpu.cli", "run", "-c", str(deck)],
        env=cpu_child_env(), cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
    )
    log.close()
    return proc, out, time.perf_counter()


def phase_cpu(work: Path, cpu_run, gpu_out: Path, timeout_s: float = 600.0):
    proc, out, t0 = cpu_run
    rc = proc.wait(timeout=timeout_s)
    say(f"  CPU child: rc {rc}, {time.perf_counter() - t0:.1f} s since its start")
    if rc != 0:
        raise PhaseError(f"CPU run exited {rc}: {(work / 'cpu.log').read_text()[-3000:]}")
    check_run(out, len(COMPARE_NUCLIDES))
    rep = compare_libraries(
        nuclide_datasets(gpu_out, COMPARE_NUCLIDES), nuclide_datasets(out, COMPARE_NUCLIDES)
    )
    say(f"  GPU vs CPU on {', '.join(COMPARE_NUCLIDES)}: {json.dumps(rep)}")
    if not rep["ok"]:
        raise PhaseError("GPU and CPU libraries differ")


# -- four cards ------------------------------------------------------------


def _run_child(name: str, argv: list[str], env: dict, timeout_s: float) -> None:
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ndpp_tpu.cli", *argv], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=timeout_s)
    say(f"  {name}: rc {r.returncode}, {time.perf_counter() - t0:.1f} s; {r.stdout.strip()[-2000:]}")
    if r.returncode != 0:
        raise PhaseError(f"{name} exited {r.returncode}: {r.stderr[-3000:]}")


def four_cards(work: Path, xsdir: Path, fmt: str, timeout_s: float = 1500.0) -> None:
    """The four-card deck on one card, row-sharded over four cards, and as
    four worker processes; each multi-card library against the one-card
    one. Every run is a child process, one at a time, so each has its cards
    to itself."""
    say(f"  {FOUR_CARD_CUT}")
    suffix = ".h5" if fmt == "hdf5" else ".txt"
    base = {k: v for k, v in os.environ.items() if k != "XLA_PYTHON_CLIENT_PREALLOCATE"}
    outs = {}
    for name, argv_extra, env in (
        ("one card", [], dict(base, CUDA_VISIBLE_DEVICES="0")),
        ("row-sharded over 4 cards", [], base),
        ("--workers 4", ["--workers", "4"], base),
    ):
        tag = name.split()[0].strip("-")
        outs[name] = work / f"{tag}{suffix}"
        deck = write_deck(work / f"{tag}.json", phase5_deck(xsdir, outs[name], fmt, FOUR_CARD_NUCLIDES))
        _run_child(name, ["run", "-c", str(deck), *argv_extra], env, timeout_s)
        m = check_run(outs[name], len(FOUR_CARD_NUCLIDES))
        if m:
            say(f"  {name} metrics: wall {m['wall_seconds']:.1f} s, phases {json.dumps(m['phase_seconds'])}")
    ref = nuclide_datasets(outs["one card"])
    for name in ("row-sharded over 4 cards", "--workers 4"):
        rep = compare_libraries(nuclide_datasets(outs[name]), ref)
        say(f"  {name} vs one card: {json.dumps(rep)}")
        if not rep["ok"]:
            raise PhaseError(f"{name} library differs from the one-card library")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true", help="run only the four-card comparison")
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cuda"  # a broken CUDA plugin must not fall back to the CPU
    if args.four_cards:
        # this process only checks the devices; the runs are children
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    sys.path.insert(0, str(REPO))
    import ndpp_tpu  # noqa: F401  (x64 and the compile cache)

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        work = Path(td)
        fmt = output_format()
        step = 0

        def phase(title, fn, *a):
            nonlocal step
            step += 1
            say(f"== phase {step}: {title}")
            t0 = time.perf_counter()
            try:
                res = fn(*a)
            except Exception:
                traceback.print_exc()
                say(f"== phase {step} FAILED after {time.perf_counter() - t0:.1f} s")
                raise SystemExit(1)
            say(f"== phase {step} ok ({time.perf_counter() - t0:.1f} s)")
            return res

        if args.four_cards:
            devices = phase("device (four cards)", phase_device, 4)
            xsdir = phase("fixture library", build_library, work / "lib")
            phase("phase-5 deck: one card, row-sharded, --workers 4", four_cards, work, xsdir, fmt)
        else:
            devices = phase("device", phase_device)
            phase("build", phase_build)
            phase("compile", phase_compile)
            phase("accuracy gate", phase_gate)
            xsdir = build_library(work / "lib")
            cpu_run = start_cpu_run(work, xsdir, fmt)
            try:
                gpu_out = phase("ndpp run, phase-5 deck", phase_run, work, xsdir, fmt)
                phase("GPU against CPU", phase_cpu, work, cpu_run, gpu_out)
            finally:
                if cpu_run[0].poll() is None:
                    cpu_run[0].kill()
                    cpu_run[0].wait()
    say(f"chip_smoke: all phases ok in {time.perf_counter() - t_all:.1f} s")
    # the driver's line; nothing may follow it
    print(contract_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
