"""The GPU bring-up surface that runs on the CPU: the accuracy gate's legs,
the compile-cache placement, the worker carve-up, h5py as an optional
package, the native build, the dry run's device check and chip_smoke's
own logic. What needs the card is marked ``gpu`` and runs through
``python chip_smoke.py``."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import jax

import chip_smoke
from ndpp_tpu import config as config_mod
from ndpp_tpu import selfcheck

REPO = Path(__file__).resolve().parent.parent


def _child(code: str, env_extra: dict | None = None, drop: tuple = (), timeout: int = 300):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", **(env_extra or {})})
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout,
    )


# -- accuracy gate -----------------------------------------------------------


def test_selfcheck_runs_on_cpu_without_skipping():
    report = selfcheck.run(tile=16, ng=47, families=("chi",))
    assert "skipped" not in report
    assert report["ok"] and report["chi"]["ok"]
    assert report["device"]["platform"] == "cpu"
    assert "float64" in report["numerics"]


def test_selfcheck_twobody_leg_vs_scatter_ref_and_oracle():
    r = selfcheck.check_twobody(tile=16, order=3, ng=47, nq=16)
    assert r["ok"], r
    assert r["scatter_ref"]["ok"] and r["oracle"]["ok"]
    assert r["oracle"]["rows"] == sum(len(e) for *_, e in selfcheck.ORACLE_ROWS)
    assert r["shape"] == {"tile": 16, "order": 3, "groups": 47, "nq": 16}


def test_selfcheck_family_that_raises_fails(monkeypatch):
    from ndpp_tpu import cli

    def boom():
        raise ValueError("broken kernel")

    monkeypatch.setattr(selfcheck, "check_chi", boom)
    report = selfcheck.run(families=("chi",))
    assert not report["ok"]
    assert selfcheck.failed_families(report) == ["chi"]
    assert "broken kernel" in report["chi"]["error"]
    monkeypatch.setattr(selfcheck, "run", lambda **kw: report)
    assert cli.main(["selfcheck"]) == 1


def test_family_gate_refuses_float32():
    got = np.ones((2, 3), dtype=np.float32)
    assert not selfcheck._family_gate(got, got.astype(np.float64))["ok"]


# -- compile cache ------------------------------------------------------------


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    code = "import ndpp_tpu, jax; print(jax.config.jax_compilation_cache_dir)"
    if env_dir:
        r = _child(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        want = str(tmp_path)
    else:
        r = _child(code, drop=("JAX_COMPILATION_CACHE_DIR",))
        want = str(REPO / ".jax_cache")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


# -- worker carve-up -----------------------------------------------------------


@pytest.mark.parametrize(
    "base, i, want",
    [({}, 0, "0"), ({}, 3, "3"), ({"CUDA_VISIBLE_DEVICES": "4,5,6,7"}, 2, "6")],
)
def test_worker_env_one_card_each(base, i, want):
    from ndpp_tpu.parallel.nuclides import worker_env

    env = worker_env(i, base=dict(base, PATH="/bin"))
    assert env == dict(base, PATH="/bin", CUDA_VISIBLE_DEVICES=want)  # nothing else set


def test_worker_env_cpu_mesh_and_too_few_cards():
    from ndpp_tpu.parallel.nuclides import worker_env

    env = worker_env(1, force_cpu_devices=2, env_extra={"X": "1"}, base={})
    assert env == {"NDPP_FORCE_CPU_DEVICES": "2", "X": "1"}
    with pytest.raises(ValueError, match="no card"):
        worker_env(2, base={"CUDA_VISIBLE_DEVICES": "0,1"})


def test_merge_ascii_shards(tmp_path):
    from ndpp_tpu import groups
    from ndpp_tpu.io.library import AsciiLibraryWriter, NuclideResult, merge_libraries, read_ascii

    gs = groups.get("uniform-lethargy-47")

    def shard(path, names, temps=(293.6,)):
        w = AsciiLibraryWriter(path, gs, 1, list(temps))
        for k, name in enumerate(names):
            e = np.geomspace(1e-5, 2e7, 5)
            w.write_nuclide(NuclideResult(
                name=name, zaid=1001 + k, awr=1.0 + k, kT=0.0253, energy=e,
                temperatures=np.asarray(temps), scatter=np.full((len(temps), 5, 2, 47), k + 0.5),
                sigma_scatter=np.ones(5),
            ))
        w.finalize({"nuclides_done": len(names)})
        return path

    a = shard(tmp_path / "a.txt", ["1001.80c"])
    b = shard(tmp_path / "b.txt", ["8016.80c", "26056.80c"])
    assert merge_libraries(tmp_path / "m.txt", [a, b]) == 3
    ds, attrs = read_ascii(tmp_path / "m.txt")
    assert {k.split("/")[2] for k in ds if k.startswith("/nuclides/")} == {
        "1001.80c", "8016.80c", "26056.80c"
    }
    np.testing.assert_array_equal(ds["/nuclides/26056.80c/scatter"], 1.5)
    c = shard(tmp_path / "c.txt", ["92235.80c"], temps=(600.0,))
    with pytest.raises(ValueError, match="differs"):
        merge_libraries(tmp_path / "bad.txt", [a, c])


# -- h5py is optional ----------------------------------------------------------

_NO_H5PY = """
import sys
sys.modules["h5py"] = None  # import h5py now raises ImportError
from pathlib import Path
import numpy as np
from ndpp_tpu import config as config_mod, driver
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.ace.write import write_ace
from ndpp_tpu.utils.errors import ConfigError
tmp = Path(sys.argv[1])
nuc = synth.h1_like(n_energy=24)
p = write_ace(nuc, tmp / "h1.ace")
(tmp / "xsdir").write_text(f"directory\\n{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0\\n")
deck = {"run": {"nuclides": [nuc.name], "library": str(tmp / "xsdir"), "legendre_order": 1,
                "thermal_cutoff_kt": 1e-9},
        "output": {"path": str(tmp / "lib.txt"), "format": sys.argv[2]},
        "device": {"e_tile": 64}}
try:
    cfg = config_mod._build(deck)
except ConfigError as e:
    print("CONFIG_ERROR", e)
    raise SystemExit(0)
m = driver.run(cfg)
print("DONE", m.nuclides_done, m.nuclides_quarantined, "h5py" in str(sys.modules.get("h5py")))
"""


@pytest.mark.parametrize("fmt", ["ascii", "hdf5"])
def test_run_without_h5py(tmp_path, fmt):
    r = subprocess.run(
        [sys.executable, "-c", _NO_H5PY, str(tmp_path), fmt], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    last = r.stdout.strip().splitlines()[-1]
    if fmt == "ascii":
        assert last == "DONE 1 0 False"
        assert (tmp_path / "lib.txt").read_text().startswith("NDPP-TPU ASCII LIBRARY")
    else:
        assert last.startswith("CONFIG_ERROR") and "h5py" in last
        assert not (tmp_path / "lib.txt").exists()


# -- native tokenizer ----------------------------------------------------------


def _fresh_native(monkeypatch, tmp_path):
    import ndpp_tpu.native as nat

    src = tmp_path / "ace_tokenizer.cpp"
    src.write_text((Path(nat.__file__).parent / "ace_tokenizer.cpp").read_text())
    monkeypatch.setattr(nat, "_SRC", src)
    monkeypatch.setattr(nat, "_LIB_PATH", tmp_path / "libndpp_native.so")
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.delenv("NDPP_TPU_NO_NATIVE", raising=False)
    return nat, src


def test_native_rebuilds_when_stale(monkeypatch, tmp_path):
    nat, src = _fresh_native(monkeypatch, tmp_path)
    nat._LIB_PATH.write_bytes(b"not a shared library")
    old = time.time() - 3600
    os.utime(nat._LIB_PATH, (old, old))
    assert nat._stale()
    lib = nat.get_lib()
    assert lib is not None and not nat._stale()
    np.testing.assert_array_equal(nat.tokenize_floats("1 2.5 -3E2"), [1.0, 2.5, -300.0])


def test_native_build_failure_warns_and_falls_back(monkeypatch, tmp_path):
    nat, src = _fresh_native(monkeypatch, tmp_path)
    warned = []
    monkeypatch.setattr(nat, "_warn", lambda msg, *a: warned.append(msg % a))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    assert nat.get_lib() is None
    assert len(warned) == 1 and "build failed" in warned[0]
    np.testing.assert_array_equal(nat.tokenize_floats("4 5"), [4.0, 5.0])
    assert len(warned) == 1  # once


# -- the dry run refuses to hide the device ------------------------------------


def test_ensure_devices_refuses_cpu_fallback_on_gpu_host(monkeypatch):
    import __graft_entry__ as ge

    monkeypatch.delenv("NDPP_DRYRUN_FORCE_CPU", raising=False)
    monkeypatch.setattr(ge, "_probe_devices", lambda: ("gpu", 1))
    with pytest.raises(RuntimeError, match="needs 4 gpu devices, 1 visible"):
        ge._ensure_devices(4)
    monkeypatch.setattr(ge, "_probe_devices", lambda: ("gpu", 4))
    assert ge._ensure_devices(4) == jax.devices()[0].platform


# -- chip_smoke ---------------------------------------------------------------


def test_chip_smoke_device_gate():
    with pytest.raises(chip_smoke.PhaseError, match="no GPU: platform is cpu"):
        chip_smoke.device_gate(jax.devices())
    gpus = [SimpleNamespace(platform="gpu")] * 2
    chip_smoke.device_gate(gpus)
    with pytest.raises(chip_smoke.PhaseError, match="need 4 GPUs"):
        chip_smoke.device_gate(gpus, 4)


def test_chip_smoke_contract_line():
    line = json.loads(chip_smoke.contract_line(jax.devices()))
    assert set(line) == {"ok", "device"} and line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == len(jax.devices())


def test_chip_smoke_fails_without_a_gpu():
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_phase5_deck():
    deck = chip_smoke.phase5_deck(Path("xsdir"), Path("out.txt"), "ascii")
    cfg = config_mod._build(deck)
    assert cfg.legendre_order == 5
    assert cfg.group_structure().ng == 361
    assert cfg.temperatures == [293.6, 600.0]
    assert cfg.device.e_tile == 2048
    assert cfg.sab == {"1001.80c": ["lwtr.20t"]}
    assert cfg.nuclides == []  # every nuclide of the library
    sub = config_mod._build(
        chip_smoke.phase5_deck(Path("x"), Path("o.txt"), "ascii", chip_smoke.COMPARE_NUCLIDES)
    )
    assert sub.nuclides == ["1001.80c", "92235.80c", "90000.80c"]


def test_chip_smoke_compare_libraries():
    rng = np.random.default_rng(3)
    ref = {"/nuclides/a/scatter": rng.uniform(size=(2, 5, 3, 7)), "/nuclides/a/energy": np.geomspace(1, 1e7, 5)}
    same = {k: v.copy() for k, v in ref.items()}
    assert chip_smoke.compare_libraries(same, ref)["ok"]
    off = {k: v.copy() for k, v in ref.items()}
    off["/nuclides/a/scatter"][1, 2, 0, 3] += 1e-6
    rep = chip_smoke.compare_libraries(off, ref)
    assert not rep["ok"] and rep["failed"][0].startswith("/nuclides/a/scatter")
    assert not chip_smoke.compare_libraries({}, ref)["ok"]


@pytest.fixture
def gpu_device():
    """The first device, when JAX's backend is a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (backend is {dev.platform}); run `python chip_smoke.py` on the card")
    return dev


@pytest.mark.gpu
def test_kernels_compile_and_pass_gate_on_gpu(gpu_device):
    chip_smoke.phase_compile()
    chip_smoke.phase_gate()
