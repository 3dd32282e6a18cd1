"""Exact gather-free selection: one-hot f32 matmuls over split-f64 payloads.

A *selection* is a linear map with 0/1 coefficients, so it can be done
as a matmul instead of a gather: split each f64 payload into three f32
pieces (hi/mid/lo, each exactly representable and summing to the value
below f64 ulp), multiply each piece by the one-hot selection matrix with
the full-f32 dot algorithm (no TF32 or bf16 passes; exact for one-hot:
every product is the piece itself or zero, and the pieces occupy
disjoint bit ranges so f32 accumulation is exact), and reconstruct in
f64. The result matches the gather to the last bit for every payload
this framework produces (|x| < 2^103; verified element-exact in
tests/test_select.py and tests/test_continuum.py).

It was introduced because the first target gathered f64 slowly; the
H100 gathers f64 natively, and whether `take_along_axis` is faster there
is not measured yet (ROADMAP S3, D2).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Full f32 products and sums: never TF32 or bf16 passes, whatever the
# backend's default for f32 matmuls.
_F32 = lax.DotAlgorithmPreset.F32_F32_F32


def split3(x):
    """f64 -> three f32 pieces (a, b, c) with a + b + c == x below f64 ulp.

    Each rounding leaves a residual with ~29 fewer significant bits, so
    three pieces carry ~72 bits — the reconstruction a + b + c, summed
    hi-to-lo in f64, reproduces x exactly (f64 carries 53) whenever the
    third piece (~2^-48 |x|) stays in NORMAL f32 range: |x| in
    ~[3e-24, 1e38]. Below that the flushed piece leaves <= ~2^-49
    relative residual; above, the first piece overflows — callers'
    payloads (eV-scale knots, pdfs, slopes, cumulants) sit comfortably
    inside (tests/test_select.py pins both regimes).

    Each piece is rounded with reduce_precision, in f64: a round trip
    x.astype(f32).astype(f64) is a convert pair that XLA's GPU compiler
    may drop (it allows excess precision by default), which would zero
    the residuals and leave only the first piece's 2^-24 accuracy.
    """
    pieces = []
    r = x
    for _ in range(3):
        p = lax.reduce_precision(r, exponent_bits=8, mantissa_bits=23)  # f32 value, f64 dtype
        pieces.append(p.astype(jnp.float32))  # exact: p is representable
        r = r - p
    return tuple(pieces)


def _onehot(idx, k: int):
    """(..., K) f32 one-hot of int indices (out-of-range rows are all-zero)."""
    return (idx[..., None] == jnp.arange(k, dtype=idx.dtype)).astype(jnp.float32)


def select_rows(payload, idx):
    """out[t, q, ...] = payload[t, idx[t, q], ...] as exact one-hot matmuls.

    payload: (T, K) or (T, K, C) f64; idx: (T, Q) int in [0, K).
    Returns (T, Q) or (T, Q, C) f64, bit-equal to take_along_axis.
    """
    squeeze = payload.ndim == 2
    p = payload[:, :, None] if squeeze else payload
    oh = _onehot(idx, p.shape[1])  # (T, Q, K)
    out = None
    for piece in split3(p):
        part = jnp.einsum("tqk,tkc->tqc", oh, piece, precision=_F32).astype(payload.dtype)
        out = part if out is None else out + part
    return out[..., 0] if squeeze else out


def select_windows(payload, j0, nsel: int):
    """out[t, w, i, ...] = payload[t, min(j0[t, w] + i, K-1), ...], i < nsel.

    Consecutive-window selection (the kernel's windowed-knot pattern):
    ONE one-hot (T, W, K) against a shifted payload stack (T, K, nsel*C)
    — cheaper than nsel independent row selections. payload: (T, K) or
    (T, K, C) f64; j0: (T, W) int. Returns (T, W, nsel[, C]) f64.
    """
    squeeze = payload.ndim == 2
    p = payload[:, :, None] if squeeze else payload
    tt, k, c = p.shape
    # shifted[t, j, i, :] = p[t, min(j + i, K-1), :] by static slices + edge pad
    shifted = jnp.stack(
        [jnp.concatenate([p[:, i:], p[:, -1:].repeat(i, axis=1)], axis=1) for i in range(nsel)],
        axis=2,
    )  # (T, K, nsel, C)
    oh = _onehot(j0, k)  # (T, W, K)
    out = None
    for piece in split3(shifted.reshape(tt, k, nsel * c)):
        part = jnp.einsum("twk,tkc->twc", oh, piece, precision=_F32).astype(payload.dtype)
        out = part if out is None else out + part
    out = out.reshape(tt, j0.shape[1], nsel, c)
    return out[..., 0] if squeeze else out
