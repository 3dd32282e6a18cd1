"""ops/select: one-hot f32 matmul selection must be element-EXACT vs gather.

The continuum/chi/panelsplit hot paths replace f64 take_along_axis with
one-hot f32 matmuls over a 3-way split of the payload (ops/select.py
docstring). Selection is exact only if the split
reconstructs below f64 ulp AND the f32 dot is exact for 0/1
coefficients — both are asserted here under jit, which is the form the
kernels compile (an XLA fusion bug made an earlier formulation correct
eagerly but wrong under jit; see ops/continuum.py round-5 notes).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ndpp_tpu.ops import select


@pytest.mark.parametrize("c", [1, 2, 6])
def test_select_rows_exact_under_jit(c):
    rng = np.random.default_rng(3)
    t, k, q = 32, 31, 200
    pay = rng.uniform(-1.0, 1.0, (t, k, c)) * 10.0 ** rng.integers(-12, 12, (t, k, c))
    idx = rng.integers(0, k, (t, q))
    f = jax.jit(select.select_rows)
    out = np.asarray(f(jnp.asarray(pay), jnp.asarray(idx, dtype=jnp.int32)))
    ref = np.stack([pay[i][idx[i]] for i in range(t)])
    np.testing.assert_array_equal(out, ref)


def test_select_rows_2d_payload():
    rng = np.random.default_rng(5)
    t, k, q = 16, 24, 50
    pay = rng.normal(size=(t, k))
    idx = rng.integers(0, k, (t, q))
    out = np.asarray(
        jax.jit(select.select_rows)(jnp.asarray(pay), jnp.asarray(idx, dtype=jnp.int32))
    )
    ref = np.stack([pay[i][idx[i]] for i in range(t)])
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("nsel", [4, 8])
def test_select_windows_exact_under_jit(nsel):
    rng = np.random.default_rng(7)
    t, k, c, w = 32, 31, 6, 80
    pay = rng.uniform(-4e3, 4e3, (t, k, c))
    j0 = rng.integers(0, k, (t, w))  # includes starts whose window clips at K-1
    f = jax.jit(lambda p, j: select.select_windows(p, j, nsel))
    out = np.asarray(f(jnp.asarray(pay), jnp.asarray(j0, dtype=jnp.int32)))
    idx = np.minimum(j0[:, :, None] + np.arange(nsel)[None, None, :], k - 1)
    ref = np.stack([pay[i][idx[i]] for i in range(t)])
    np.testing.assert_array_equal(out, ref)


def test_split3_reconstructs_exactly():
    # Exactness domain (select.py docstring): the third piece is ~2^-48
    # of x, so it must stay in NORMAL f32 range -> |x| in ~[3e-24, 1e38]
    # reconstructs bit-exactly; below that the subnormal/flushed piece
    # leaves <= ~2^-49 relative residual (negligible vs every bar).
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.uniform(-1.0, 1.0, 4096) * 10.0 ** rng.integers(-20, 25, 4096))
    a, b, c = select.split3(x)
    rec = a.astype(x.dtype) + b.astype(x.dtype) + c.astype(x.dtype)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(x))

    # below ~3e-24 pieces flush (XLA flushes f32 subnormals): the residual
    # envelope is 2^-48 |x| plus up to 3 flushed pieces, each below the
    # smallest normal f32 (~1.2e-38) — absolute noise far under every bar
    tiny = jnp.asarray(rng.uniform(-1.0, 1.0, 1024) * 10.0 ** rng.integers(-40, -20, 1024))
    a, b, c = select.split3(tiny)
    rec = a.astype(tiny.dtype) + b.astype(tiny.dtype) + c.astype(tiny.dtype)
    resid = np.abs(np.asarray(rec - tiny))
    assert (resid <= 2.0**-48 * np.abs(np.asarray(tiny)) + 4e-38).all()


def test_quantize_ksel_rungs():
    from ndpp_tpu.continuum_driver import quantize_ksel

    k = 64  # rungs 4, 8, 16
    assert quantize_ksel(0, k) == 0  # full-knot sentinel passes through
    assert quantize_ksel(3, k) == 4
    assert quantize_ksel(4, k) == 4
    assert quantize_ksel(5, k) == 8
    assert quantize_ksel(9, k) == 16  # previously fell to the full-knot path
    assert quantize_ksel(16, k) == 16
    assert quantize_ksel(17, k) == 0  # beyond the top rung -> full knots
    assert quantize_ksel(2, 16) == 4  # tiny tables: only the >=4 rungs exist
    assert quantize_ksel(5, 16) == 0
