"""Learned denoiser: a small kernel-predicting CNN (KPCN-style).

The reference ships Intel OIDN's pretrained "RT" CNN
(/root/reference/denoiser.h:31-91); the joint bilateral
(denoise/bilateral.py) is differentiable but a visibly weaker filter
class. This module closes the gap with the standard kernel-predicting
architecture (Bako et al. 2017, scaled down):

  features = [log1p(color), albedo, normal]            (H, W, 9)
  x -> Conv3x3 stack -> per-pixel (2r+1)^2 logits -> softmax
  out[p] = sum_q softmax_w[p, q] * color[q]            (linear color)

Kernel prediction (vs direct color regression) keeps the output inside
the convex hull of the noisy neighborhood: energy-bounded, no color
shifts, stable with little training data — and the apply step is the
same shifted-adds pattern as the bilateral, so the whole model is
convolutions + elementwise and differentiable end-to-end for inverse
rendering.

Training: tools/train_denoiser.py self-generates (low-spp, high-spp)
pairs with the renderer and minimizes L1 on tonemapped color; weights
ship in raytpu/denoise/weights/kpcn.npz and load via load_params().
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

RADIUS = 3          # 7x7 predicted kernels, like the bilateral window
FEATURES = 24
DEPTH = 4
IN_CHANNELS = 9     # log1p(color), albedo, normal

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "weights", "kpcn.npz")


def _layer_shapes() -> list[tuple[int, int]]:
    """(in, out) channels of each 3x3 conv: DEPTH hidden layers with a
    ReLU, then the (2r+1)^2 kernel-logit layer."""
    widths = [IN_CHANNELS] + [FEATURES] * DEPTH + [(2 * RADIUS + 1) ** 2]
    return list(zip(widths[:-1], widths[1:]))


def _conv3x3(x: Array, kernel: Array, bias: Array) -> Array:
    """'SAME' 3x3 convolution of an (H, W, C) image, HWIO kernel."""
    y = jax.lax.conv_general_dilated(
        x[None], kernel, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y[0] + bias


def kpcn(params: Any, color: Array, albedo: Array, normal: Array) -> Array:
    """Per-pixel kernel predictor over (color, albedo, normal).
    ``params["params"]["Conv_<i>"]`` holds each layer's kernel and bias."""
    layers = params["params"]
    n = len(_layer_shapes())
    x = jnp.concatenate(
        [jnp.log1p(jnp.maximum(color, 0.0)), albedo, normal], axis=-1
    )
    for i in range(n):
        conv = layers[f"Conv_{i}"]
        x = _conv3x3(x, conv["kernel"], conv["bias"])
        if i < n - 1:
            x = jax.nn.relu(x)
    weights = jax.nn.softmax(x, axis=-1)                # (H, W, taps)
    return apply_kernels(color, weights, RADIUS)


def apply_kernels(color: Array, weights: Array, radius: int) -> Array:
    """out[p] = sum over the window of w[p, q] * color[q], with
    out-of-bounds taps renormalized away (their weight is discarded and
    the remainder rescaled, so edges stay energy-preserving)."""
    h, w = color.shape[:2]
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    num = jnp.zeros_like(color)
    den = jnp.zeros(color.shape[:2] + (1,), color.dtype)
    tap = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = jnp.roll(color, (dy, dx), axis=(0, 1))
            valid = (
                (rows - dy >= 0) & (rows - dy < h)
                & (cols - dx >= 0) & (cols - dx < w)
            )[..., None].astype(color.dtype)
            wq = weights[..., tap : tap + 1] * valid
            num = num + wq * shifted
            den = den + wq
            tap += 1
    return num / jnp.maximum(den, 1e-8)


def init_params(key: Array | None = None):
    """Random weights (LeCun-normal kernels, zero biases)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    init = jax.nn.initializers.lecun_normal()
    layers = {}
    for i, (cin, cout) in enumerate(_layer_shapes()):
        layers[f"Conv_{i}"] = {
            "kernel": init(jax.random.fold_in(key, i), (3, 3, cin, cout)),
            "bias": jnp.zeros((cout,), jnp.float32),
        }
    return {"params": layers}


def save_params(params: Any, path: str = WEIGHTS_PATH) -> None:
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        **{jax.tree_util.keystr(k): np.asarray(v) for k, v in flat},
    )


def load_params(path: str = WEIGHTS_PATH):
    """Load trained weights; returns None when no checkpoint exists yet
    (callers fall back to the bilateral filter)."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    template = init_params()
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for k, v in flat:
        name = jax.tree_util.keystr(k)
        if name not in z:
            raise ValueError(f"weights file {path} is missing {name}")
        if z[name].shape != v.shape:
            raise ValueError(
                f"{name}: checkpoint shape {z[name].shape} != {v.shape}"
            )
        leaves.append(jnp.asarray(z[name]))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def denoise_learned(
    color: Array, albedo: Array, normal: Array, params: Any = None
) -> Array:
    """OIDN-call-site-compatible entry (like denoise/bilateral.denoise).
    ``params=None`` loads the shipped checkpoint."""
    if params is None:
        params = load_params()
        if params is None:
            raise FileNotFoundError(
                f"no trained denoiser weights at {WEIGHTS_PATH}; "
                "run tools/train_denoiser.py or use --denoise=bilateral"
            )
    return kpcn(params, color, albedo, normal)
