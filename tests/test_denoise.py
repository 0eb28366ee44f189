"""Denoiser tests: variance reduction on flat regions, edge preservation
via the AOV guides, differentiability, and pipeline integration."""

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.denoise import DenoiseParams, denoise


def _noisy_two_tone(key, h=32, w=32, noise=0.2):
    """Left half dark, right half bright, albedo/normal guides follow the
    same split exactly."""
    base = np.zeros((h, w, 3), np.float32)
    base[:, w // 2:] = 0.8
    base[:, : w // 2] = 0.2
    albedo = base.copy()
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 2] = 1.0
    normal[:, w // 2:, 0] = 1.0
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    color = base + rng.normal(0, noise, base.shape).astype(np.float32)
    return jnp.asarray(color), jnp.asarray(albedo), jnp.asarray(normal), base


def test_variance_reduced_on_flat_regions():
    c, a, n, base = _noisy_two_tone(jax.random.PRNGKey(0))
    out = np.asarray(denoise(c, a, n))
    raw_err = np.abs(np.asarray(c) - base)[:, :12].mean()
    den_err = np.abs(out - base)[:, :12].mean()
    assert den_err < raw_err * 0.45, (den_err, raw_err)


def test_edges_preserved_by_guides():
    c, a, n, base = _noisy_two_tone(jax.random.PRNGKey(1))
    out = np.asarray(denoise(c, a, n))
    # the two halves must stay separated: the step across the boundary
    # survives (no blur across the albedo/normal edge)
    left = out[:, : 16 - 1].mean()
    right = out[:, 16 + 1:].mean()
    assert right - left > 0.5, (left, right)


def test_differentiable():
    c, a, n, _ = _noisy_two_tone(jax.random.PRNGKey(2), h=8, w=8)

    def loss(c):
        return jnp.mean(denoise(c, a, n) ** 2)

    g = jax.grad(loss)(c)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def test_identity_when_sigmas_tiny():
    c, a, n, _ = _noisy_two_tone(jax.random.PRNGKey(3), h=8, w=8)
    p = DenoiseParams.default(
        sigma_spatial=1e-4, sigma_albedo=1e-4, sigma_normal=1e-4,
        sigma_color=1e-4, radius=2,
    )
    out = np.asarray(denoise(c, a, n, p))
    np.testing.assert_allclose(out, np.asarray(c), atol=1e-5)


def test_kpcn_matches_numpy_convolution():
    """The shipped KPCN weights through kpcn() vs a plain numpy forward
    pass: zero-padded 3x3 cross-correlations with ReLU, a softmax over
    the 49 kernel logits and the renormalized 7x7 window sum."""
    from raytpu.denoise.learned import RADIUS, load_params, kpcn

    params = load_params()
    rng = np.random.default_rng(3)
    h, w = 9, 11
    color = rng.random((h, w, 3), np.float32) * 2.0
    albedo = rng.random((h, w, 3), np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    got = np.asarray(kpcn(params, jnp.asarray(color), jnp.asarray(albedo),
                          jnp.asarray(normal)))

    def conv(x, k, b):
        xp = np.pad(x, ((1, 1), (1, 1), (0, 0)))
        out = np.zeros((h, w, k.shape[-1]))
        for dy in range(3):
            for dx in range(3):
                out += xp[dy : dy + h, dx : dx + w] @ k[dy, dx]
        return out + b

    layers = params["params"]
    x = np.concatenate([np.log1p(np.maximum(color, 0)), albedo, normal], -1)
    x = x.astype(np.float64)
    n = len(layers)
    for i in range(n):
        k = np.asarray(layers[f"Conv_{i}"]["kernel"], np.float64)
        x = conv(x, k, np.asarray(layers[f"Conv_{i}"]["bias"], np.float64))
        if i < n - 1:
            x = np.maximum(x, 0.0)
    e = np.exp(x - x.max(-1, keepdims=True))
    wts = e / e.sum(-1, keepdims=True)
    num = np.zeros((h, w, 3))
    den = np.zeros((h, w, 1))
    tap = 0
    for dy in range(-RADIUS, RADIUS + 1):
        for dx in range(-RADIUS, RADIUS + 1):
            for y in range(h):
                for xx in range(w):
                    sy, sx = y - dy, xx - dx
                    if 0 <= sy < h and 0 <= sx < w:
                        num[y, xx] += wts[y, xx, tap] * color[sy, sx]
                        den[y, xx] += wts[y, xx, tap]
            tap += 1
    want = num / np.maximum(den, 1e-8)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
