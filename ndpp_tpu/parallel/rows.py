"""Flat row-sharded dispatch: every moment kernel over all visible devices.

The whole workload is embarrassingly parallel across incident-energy rows
(SURVEY.md section 5 'long-context'), so driver-level multi-device
execution needs no kernel changes at all: tile inputs are device_put with a
NamedSharding over a 1-D 'e' mesh and the ordinary jitted kernels compile
to an SPMD program partitioned along the row axis — XLA inserts no
collectives because no op couples rows. Results are pulled shard-by-shard
to host at write time (no all-gather), per the SURVEY section 5 design.

On one card everything reduces to plain device_put; on a four-card host
the same run() sweep spreads each super-tile over the four cards.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

_MESH: Mesh | None = None
_NDEV: int = 0


def configure(max_devices: int = 0) -> int:
    """(Re)build the flat 'e' mesh over up to max_devices devices (0 = all).

    Returns the device count in use. Called by the driver at run start;
    safe to call repeatedly (tests reconfigure between 1 and 8 devices).
    """
    global _MESH, _NDEV
    devs = jax.devices()
    n = len(devs) if max_devices <= 0 else min(max_devices, len(devs))
    _NDEV = n
    _MESH = Mesh(np.asarray(devs[:n]), ("e",)) if n > 1 else None
    return n


def _cast(arr):
    """Float arrays -> float64, the device compute dtype (ints/bools untouched)."""
    a = np.asarray(arr)
    if a.dtype.kind == "f" and a.dtype != np.float64:
        return a.astype(np.float64)
    return arr


def ndev() -> int:
    if _NDEV == 0:
        configure()
    return _NDEV


def put_rows(arr):
    """Host array -> device array sharded along axis 0 (rows) over the mesh."""
    if _NDEV == 0:
        configure()
    arr = _cast(arr)
    if _MESH is None:
        import jax.numpy as jnp

        return jnp.asarray(arr)
    spec = P("e", *([None] * (np.ndim(arr) - 1)))
    return jax.device_put(arr, NamedSharding(_MESH, spec))


def put_replicated(arr):
    """Host array -> device array replicated across the mesh (group bounds)."""
    if _NDEV == 0:
        configure()
    arr = _cast(arr)
    if _MESH is None:
        import jax.numpy as jnp

        return jnp.asarray(arr)
    return jax.device_put(arr, NamedSharding(_MESH, P()))


def tile_for(n: int, cap: int, e_tile: int = 512) -> int:
    """Rows per dispatch: one canonical kernel tile (cap-bounded) per device.

    `cap` is each kernel family's default row budget and SCALES with
    cfg.device.e_tile relative to its 512 default, so the driver's
    device-OOM retry (which halves e_tile) shrinks every kernel family's
    dispatch shape, not just the two-body path.

    Tiles come from a THREE-step ladder {cap/16, cap/4, cap} rather than
    every pow2, so a sweep compiles few distinct row shapes and pays a
    little padding instead. Whether that trade still pays on the H100 is
    not measured (ROADMAP D4).
    """
    nd = max(ndev(), 1)
    cap = max(16, cap * e_tile // 512)
    per = -(-n // nd)
    for t in (cap // 16, cap // 4, cap):
        if t >= 16 and per <= t:
            return t * nd
    return cap * nd
