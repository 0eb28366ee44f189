"""Joint-bilateral denoiser guided by albedo + normal AOVs.

For every pixel p the filtered color is a normalized weighted sum over a
(2r+1)^2 window:

    w(p, q) = exp(-|q-p|^2     / 2 sigma_s^2)      spatial
            * exp(-|alb_q-alb_p|^2 / 2 sigma_a^2)  albedo edge-stop
            * exp(-|n_q-n_p|^2   / 2 sigma_n^2)    normal edge-stop
            * exp(-|c_q-c_p|^2   / 2 sigma_c^2)    range (color) term

This is the classic cross-bilateral used by interactive path tracers;
the albedo/normal guides are exactly the AOVs the reference feeds OIDN
(/root/reference/denoiser.h:48-60, produced by tracer main.c:137-150).

The window loop is a static Python unroll of shifted images (jnp.roll
with edge masking), so XLA sees (2r+1)^2 fused multiply-adds over
(H, W, 3) arrays — no gathers. All sigmas are
differentiable scalars; the filter itself is differentiable in the
inputs, so it can sit inside the inverse-rendering loss.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import Array

from raytpu.core.types import pytree_dataclass, static_field


@pytree_dataclass
class DenoiseParams:
    sigma_spatial: Array
    sigma_albedo: Array
    sigma_normal: Array
    sigma_color: Array
    radius: int = static_field(3)

    @staticmethod
    def default(
        sigma_spatial: float = 2.0,
        sigma_albedo: float = 0.2,
        sigma_normal: float = 0.3,
        sigma_color: float = 0.6,
        radius: int = 3,
    ) -> "DenoiseParams":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return DenoiseParams(
            f(sigma_spatial), f(sigma_albedo), f(sigma_normal), f(sigma_color),
            radius,
        )


def _shift(img: Array, dy: int, dx: int) -> tuple[Array, Array]:
    """Shift an (H, W, C) image by (dy, dx) with an out-of-bounds mask
    (H, W, 1); shifted-in texels get weight 0 rather than wrapping."""
    h, w = img.shape[:2]
    out = jnp.roll(img, (dy, dx), axis=(0, 1))
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    valid = (
        (rows - dy >= 0) & (rows - dy < h) & (cols - dx >= 0) & (cols - dx < w)
    )
    return out, valid[..., None].astype(img.dtype)


def denoise(
    color: Array,
    albedo: Array,
    normal: Array,
    params: DenoiseParams | None = None,
) -> Array:
    """Filter an (H, W, 3) linear-float color image using its AOVs.

    Matches the OIDN call-site contract (denoiser.h:63-71: inputs color +
    albedo + normal, output color), minus the quantize-first bug.
    """
    p = params if params is not None else DenoiseParams.default()
    r = p.radius

    inv2 = lambda s: 0.5 / jnp.maximum(s * s, 1e-12)
    ks, ka, kn, kc = (
        inv2(p.sigma_spatial),
        inv2(p.sigma_albedo),
        inv2(p.sigma_normal),
        inv2(p.sigma_color),
    )

    num = jnp.zeros_like(color)
    den = jnp.zeros(color.shape[:2] + (1,), color.dtype)

    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            c_q, valid = _shift(color, dy, dx)
            a_q, _ = _shift(albedo, dy, dx)
            n_q, _ = _shift(normal, dy, dx)

            d_a = jnp.sum((a_q - albedo) ** 2, -1, keepdims=True)
            d_n = jnp.sum((n_q - normal) ** 2, -1, keepdims=True)
            d_c = jnp.sum((c_q - color) ** 2, -1, keepdims=True)
            d_s = jnp.float32(dy * dy + dx * dx)

            w = valid * jnp.exp(
                -(d_s * ks + d_a * ka + d_n * kn + d_c * kc)
            )
            num = num + w * c_q
            den = den + w

    # den >= 1 always (the dy=dx=0 term has weight 1), but guard anyway
    return num / jnp.maximum(den, 1e-8)
