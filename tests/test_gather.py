"""Unit tests for the gather layouts (core/gather.py): all
three size regimes must agree with plain numpy indexing, forward and
backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.gather import ROW_LIMIT, SMALL, gather1d, gather_channels


@pytest.mark.parametrize("n", [5, SMALL, SMALL + 1, 700, ROW_LIMIT + 999])
def test_gather_channels_matches_numpy(n):
    rng = np.random.default_rng(n)
    tables = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    tables.append(rng.integers(0, 9, size=n).astype(np.int32))
    tables.append(rng.integers(0, 2, size=n).astype(bool))
    idx = rng.integers(0, n, size=257).astype(np.int32)

    out = gather_channels([jnp.asarray(t) for t in tables], jnp.asarray(idx))
    for t, o in zip(tables, out):
        assert np.asarray(o).dtype == t.dtype
        np.testing.assert_array_equal(np.asarray(o), t[idx])


@pytest.mark.parametrize("n", [SMALL + 1, 700, ROW_LIMIT + 999])
def test_gather_grad_matches_take_grad(n):
    rng = np.random.default_rng(n)
    tbl = jnp.asarray(rng.normal(size=n).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, n, size=300).astype(np.int32))
    w = jnp.asarray(rng.normal(size=300).astype(np.float32))

    g_ours = jax.grad(lambda t: jnp.sum(gather1d(t, idx) * w))(tbl)
    g_ref = jax.grad(lambda t: jnp.sum(jnp.take(t, idx, axis=0) * w))(tbl)
    np.testing.assert_allclose(
        np.asarray(g_ours), np.asarray(g_ref), rtol=1e-5, atol=1e-5
    )


def test_many_channels_chunking():
    n, c = 200, 150  # > LANE channels forces recursion
    rng = np.random.default_rng(0)
    tables = [rng.normal(size=n).astype(np.float32) for _ in range(c)]
    idx = rng.integers(0, n, size=64).astype(np.int32)
    out = gather_channels([jnp.asarray(t) for t in tables], jnp.asarray(idx))
    assert len(out) == c
    for t, o in zip(tables, out):
        np.testing.assert_array_equal(np.asarray(o), t[idx])


def test_take_packed_rgba_bit_exact_and_grad():
    """u8-packed uint32 fetch must match the f32 gather bit-for-bit on
    loader-convention values (n * f32(1/255)), and backpropagate the
    same per-texel gradients."""
    from raytpu.core.gather import take_packed_rgba
    from raytpu.io.obj import pack_rgba_u8

    rng = np.random.default_rng(7)
    n = 5000
    chans = [
        (rng.integers(0, 256, size=n).astype(np.float32)
         * np.float32(1.0 / 255.0))
        for _ in range(4)
    ]
    packed = pack_rgba_u8(*chans)
    assert packed is not None and packed.dtype == jnp.uint32
    idx = jnp.asarray(rng.integers(0, n, size=400).astype(np.int32))
    jc = [jnp.asarray(c) for c in chans]
    out = take_packed_rgba(*jc, packed, idx)
    for c, o in zip(chans, out):
        np.testing.assert_array_equal(np.asarray(o), c[np.asarray(idx)])

    # gradient w.r.t. the red channel == scatter of the cotangent
    w = jnp.asarray(rng.normal(size=400).astype(np.float32))
    g = jax.grad(
        lambda r: jnp.sum(take_packed_rgba(r, *jc[1:], packed, idx)[0] * w)
    )(jc[0])
    g_ref = jax.grad(
        lambda r: jnp.sum(jnp.take(r, idx, axis=0) * w)
    )(jc[0])
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-6)


def test_pack_rgba_u8_rejects_non_lattice():
    from raytpu.io.obj import pack_rgba_u8

    ok = np.array([0.0, 1.0, 128 * np.float32(1.0 / 255.0)], np.float32)
    bad = np.array([0.0, 0.5, 1.0], np.float32)  # 0.5 not on the lattice
    assert pack_rgba_u8(ok, ok, ok, ok) is not None
    assert pack_rgba_u8(bad, ok, ok, ok) is None


def test_take_rows_sort_backward_matches_scatter(monkeypatch):
    """The sort + prefix-sum + searchsorted VJP (big tables, where the
    exact one-hot matmul is infeasible) vs a float64 scatter-add
    reference. The MAC budget is patched down so the small test case
    actually exercises the sort path."""
    import numpy as np

    from raytpu.core import gather

    monkeypatch.setattr(gather, "_MATMUL_BWD_MACS", 1)
    rng = np.random.default_rng(0)
    n, b = 20000, 3777
    tbl = jnp.asarray(rng.random((n, 128), np.float32))
    idx = jnp.asarray(rng.integers(0, n, b, dtype=np.int32))
    g = jnp.asarray(rng.random((b, 128), np.float32))
    out, pull = jax.vjp(lambda t: gather._take_rows(t, idx), tbl)
    (grad,) = pull(g)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(tbl)[np.asarray(idx)]
    )
    ref = np.zeros((n, 128), np.float64)
    np.add.at(ref, np.asarray(idx), np.asarray(g, np.float64))
    err = np.abs(np.asarray(grad, np.float64) - ref).max()
    assert err < 1e-3, f"sort-path gradient off by {err}"


def test_take_rows_matmul_backward_exact_midsize(monkeypatch):
    """Mid-size tables (8k < rows, small batch) keep the EXACT one-hot
    matmul VJP under the MAC budget — the sort path's f32 prefix-sum
    is only traded in where the matmul is infeasible."""
    import numpy as np

    from raytpu.core import gather

    rng = np.random.default_rng(1)
    n, b = 10000, 500          # n*b = 5e6 << the MAC budget
    tbl = jnp.asarray(rng.random((n, 128), np.float32))
    idx = jnp.asarray(rng.integers(0, n, b, dtype=np.int32))
    g = jnp.asarray(rng.random((b, 128), np.float32))
    _, pull = jax.vjp(lambda t: gather._take_rows(t, idx), tbl)
    (grad,) = pull(g)
    ref = np.zeros((n, 128), np.float32)
    np.add.at(ref, np.asarray(idx), np.asarray(g))
    # duplicate indices are rare at b << n; sums of <=3 f32 terms through
    # the f32 matmul accumulate exactly like the scatter reference
    np.testing.assert_allclose(np.asarray(grad), ref, rtol=0, atol=1e-6)
