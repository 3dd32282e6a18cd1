"""Incident-energy grid construction and thinning (host-side by mandate).

'Parsing and unionization stay on host' (BASELINE.json:5; SURVEY.md
section 2 'Grid unionization'). The ACE ESZ grid is already the union of
all reaction grids; this module adds:

  - restriction/augmentation of the moment-tabulation grid,
  - tolerance-based thinning (optional; off by default for exactness),
  - fixed-size tiling with padding for static device shapes.
"""

from __future__ import annotations

import math

import numpy as np


def moment_grid(energy: np.ndarray, extra_points: np.ndarray | None = None) -> np.ndarray:
    """The incident grid on which moments are tabulated.

    Defaults to the nuclide union grid; extra points (e.g. thermal cutoff,
    group boundaries inside the grid span) are merged in.
    """
    g = np.asarray(energy, dtype=np.float64)
    if extra_points is not None and len(extra_points):
        extra = np.asarray(extra_points, dtype=np.float64)
        extra = extra[(extra >= g[0]) & (extra <= g[-1])]
        g = np.union1d(g, extra)
    return g


def thin_grid(e: np.ndarray, values: np.ndarray, tol: float) -> np.ndarray:
    """Indices of a thinned subset of e s.t. lin-lin interpolation of each
    row of ``values`` (shape (..., NE)) stays within relative ``tol``.

    Greedy forward pass (the classic NJOY-style thinning idea): extend the
    current panel while every interior point is reproduced within tol.
    """
    e = np.asarray(e, dtype=np.float64)
    v = np.atleast_2d(np.asarray(values, dtype=np.float64))
    n = e.size
    if n <= 2 or tol <= 0:
        return np.arange(n)
    keep = [0]
    i = 0
    while i < n - 1:
        # try to jump as far as possible from i
        j = n - 1
        while j > i + 1:
            sl = slice(i + 1, j)
            t = (e[sl] - e[i]) / (e[j] - e[i])
            approx = v[:, i : i + 1] + t[None, :] * (v[:, j : j + 1] - v[:, i : i + 1])
            exact = v[:, sl]
            denom = np.maximum(np.abs(exact), 1e-300)
            if np.all(np.abs(approx - exact) / denom <= tol):
                break
            j = (i + j) // 2 if j - i > 8 else j - 1
        keep.append(j)
        i = j
    return np.unique(np.asarray(keep, dtype=np.int64))


def tile_indices(n: int, tile: int) -> list[tuple[int, int]]:
    """[(start, length)] covering n in fixed tiles; the last tile is padded by the caller."""
    return [(s, min(tile, n - s)) for s in range(0, n, tile)]


def pad_to(x: np.ndarray, n: int, axis: int = 0, mode: str = "edge") -> np.ndarray:
    """Pad along axis to length n by repeating the edge value."""
    cur = x.shape[axis]
    if cur >= n:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, n - cur)
    return np.pad(x, pads, mode=mode)


def n_tiles(n: int, tile: int) -> int:
    return max(1, math.ceil(n / tile))


def interp_rows_loglin(e_dst: np.ndarray, e_src: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Lin-log-E interpolation of per-row tensors (NEsrc, ...) -> (NEdst, ...).

    Shared by the free-gas and thermal drivers for SMOOTH-in-E moment
    shapes evaluated on bounded subgrids (delta-like shapes must be placed
    per row instead — see thermal_driver).
    """
    x = np.log(np.maximum(e_dst, 1e-300))
    xs = np.log(np.maximum(e_src, 1e-300))
    flat = vals.reshape(e_src.size, -1)
    out = np.empty((e_dst.size, flat.shape[1]))
    for j in range(flat.shape[1]):
        out[:, j] = np.interp(x, xs, flat[:, j])
    return out.reshape((e_dst.size,) + vals.shape[1:])


def bucket_pow2(n: int, lo: int = 16) -> int:
    """Smallest power of two >= n (floored at lo).

    Canonical pad sizes for the data axes (knot tables, group windows):
    buckets are chosen to MINIMIZE DISTINCT SHAPES, and so compiles, not
    padding waste. Whether that trade pays on the H100 is not measured
    (ROADMAP D4).
    """
    p = lo
    while p < n:
        p *= 2
    return p
