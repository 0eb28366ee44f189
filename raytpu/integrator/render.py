"""Render orchestration: ray generation, sample accumulation, tiling.

Replaces the reference's pthread row-slab loop (fill_canva,
/root/reference/main.c:245-284) and per-pixel sample loop (main.c:264-273)
with a jitted wavefront: a tile of pixels is traced together, samples
accumulate through a ``lax.scan``, and tiles stream through one compiled
program. Pixel coordinates follow the reference exactly:
u = (i + U(-.5,.5))/(W-1), v = (j + U(-.5,.5))/(H-1) with j counted from
the bottom row (main.c:265-266); the aperture jitter is
U(-.5,.5) * ouverture (main.c:268-269).

Outputs stay in linear float; sqrt-gamma + quantization happen once at
image assembly (write_color_canva semantics, rtutility.h:56-71 — but
unlike the reference we do NOT quantize before denoising; see SURVEY.md
§7 fidelity notes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.custom_derivatives import SymbolicZero

from raytpu.camera import Camera, get_rays
from raytpu.core import rng
from raytpu.core.color import quantize, tonemap
from raytpu.core.types import RenderConfig, Scene
from raytpu.core.vec3 import Vec3
from raytpu.integrator.path import trace


class RenderSums(NamedTuple):
    """Per-pixel accumulators (sample sums, not means) — the checkpointable
    render state (SURVEY.md §5.4)."""

    radiance: Vec3
    albedo: Vec3
    normal: Vec3
    samples: Array  # scalar int32: samples accumulated so far


def sample_rays(
    cam: Camera,
    cfg: RenderConfig,
    pixel_ids: Array,
    draws: Array,
):
    """Generate one camera ray per pixel id for one sample index.
    draws: (4, B) U(0,1) camera draws from rng.ray_uniforms."""
    i = (pixel_ids % cfg.width).astype(jnp.float32)
    j = (pixel_ids // cfg.width).astype(jnp.float32)
    u = (i + (draws[0] - 0.5)) / (cfg.width - 1)
    v = (j + (draws[1] - 0.5)) / (cfg.height - 1)
    dx = (draws[2] - 0.5) * cfg.aperture_x
    dy = (draws[3] - 0.5) * cfg.aperture_y
    return get_rays(cam, u, v, cfg.focus_distance, dx, dy)


_logged_fallbacks: set = set()


def _log_fallback(reasons: str) -> None:
    """One stderr line when a GPU render of an unsupported scene is served
    by the scan path. Deduplicated per reason string for the process."""
    if reasons in _logged_fallbacks:
        return
    _logged_fallbacks.add(reasons)
    import sys

    print(
        f"raytpu: megakernel unavailable ({reasons}); "
        "scan path serves this render",
        file=sys.stderr,
    )


def kernel_serves(scene: Scene, platform: Optional[str] = None) -> bool:
    """Whether the Triton sphere megakernel serves ``scene``: on a GPU
    backend for every scene ``trace_spheres.supported`` accepts. Other
    backends, and unsupported scenes (logged once), take the scan path.
    ``platform`` defaults to ``jax.default_backend()``."""
    if (platform or jax.default_backend()) != "gpu":
        return False
    from raytpu.kernels import trace_spheres

    reasons = trace_spheres.unsupported_reasons(scene)
    if reasons:
        _log_fallback(", ".join(reasons))
    return not reasons


def render(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    pixel_ids: Array,
    key: Array,
    sample_offset: int = 0,
    n_samples: Optional[int] = None,
    init: Optional[RenderSums] = None,
    *,
    _route: Optional[str] = None,
) -> RenderSums:
    """Accumulate ``n_samples`` samples for a batch of pixels.

    Jittable and differentiable. ``sample_offset`` selects the global
    sample indices [offset, offset + n) so sample-axis sharding and
    checkpoint/resume consume exactly the same RNG streams as a
    single-device run.

    Each sample is traced by the sphere megakernel where
    :func:`kernel_serves`, else by the scan integrator. ``_route``
    ("kernel" or "scan") overrides that choice for tests and the chip
    smoke test; off a GPU the kernel runs in the Pallas interpreter.
    """
    n = cfg.spp if n_samples is None else n_samples
    if init is None:
        b = pixel_ids.shape[0]
        init = RenderSums(
            Vec3.zeros((b,)), Vec3.zeros((b,)), Vec3.zeros((b,)),
            jnp.zeros((), jnp.int32),
        )
    if _route is None:
        _route = "kernel" if kernel_serves(scene) else "scan"
    # an array, so sample_offset may be a traced value (the sharded path
    # derives it from lax.axis_index)
    args = (scene, cam, pixel_ids, key, jnp.asarray(sample_offset, jnp.int32), init)
    if _route == "kernel":
        return _accumulate_kernel(cfg, n, *args)
    if _route == "scan":
        return _accumulate(trace, cfg, n, *args)
    raise ValueError(f"unknown route {_route!r}")


def _accumulate(trace_fn, cfg, n, scene, cam, pixel_ids, key, sample_offset,
                init):
    """The sample loop: ``n`` samples from ``sample_offset`` on, each
    traced by ``trace_fn`` (integrator.path.trace or the megakernel)."""
    from raytpu.integrator.path import n_bounce_draws

    pix_keys = rng.pixel_keys(key, pixel_ids)

    # One sample's trace is rematerialized in the backward pass
    # (jax.checkpoint): without it, reverse-mode through the
    # (samples x bounces) scan-of-scan keeps every bounce's intermediates
    # for every sample alive at once — tens of GB at 1200x900. With remat
    # the residual footprint is one sample's carry plus (scene, cam,
    # keys); each sample's rays and draws are recomputed from the RNG
    # during its backward step.
    @jax.checkpoint
    def traced_sample(scene, cam, s):
        ray_keys = rng.sample_keys(pix_keys, s)
        cam_draws, bounce_draws = rng.ray_uniforms(
            ray_keys, 4, n_bounce_draws(cfg), cfg.max_bounces
        )
        origin, direction = sample_rays(cam, cfg, pixel_ids, cam_draws)
        return trace_fn(scene, cfg, origin, direction, bounce_draws)

    def sample_step(sums: RenderSums, s: Array):
        rad, alb, nrm = traced_sample(scene, cam, s)
        return (
            RenderSums(
                sums.radiance + rad,
                sums.albedo + alb,
                sums.normal + nrm,
                sums.samples + 1,
            ),
            None,
        )

    sample_idx = jnp.arange(n, dtype=jnp.int32) + sample_offset
    sums, _ = jax.lax.scan(sample_step, init, sample_idx)
    return sums


@functools.partial(jax.custom_jvp, nondiff_argnums=(0, 1))
def _accumulate_kernel(cfg, n, scene, cam, pixel_ids, key, sample_offset,
                       init):
    """_accumulate with the sphere megakernel tracing each sample.

    Differentiating it runs the scan path instead: the JVP rule is
    ``jax.jvp`` of the scan path's sample loop, so a gradient is plain
    ``jax.grad`` of the scan path. On an H100 that beat the kernel
    forward followed by any per-sample backward rule (PERF.md)."""
    from raytpu.kernels.trace_spheres import trace_megakernel

    trace_fn = functools.partial(
        trace_megakernel, interpret=jax.default_backend() != "gpu"
    )
    return _accumulate(trace_fn, cfg, n, scene, cam, pixel_ids, key,
                       sample_offset, init)


def _accumulate_kernel_jvp(cfg, n, primals, tangents):
    # Inputs with a symbolic-zero tangent enter as constants, as they do
    # under jax.grad of the scan path: the scan path's custom_vjp gathers
    # cannot be pushed forward with a known (zero) tangent.
    leaves, tree = jax.tree.flatten(primals)
    t_leaves = jax.tree.leaves(tangents)
    live = [not isinstance(t, SymbolicZero) for t in t_leaves]

    def scan_loop(*xs):
        it = iter(xs)
        full = [next(it) if on else x
                for x, on in zip(leaves, live, strict=True)]
        return _accumulate(trace, cfg, n, *jax.tree.unflatten(tree, full))

    return jax.jvp(
        scan_loop,
        [x for x, on in zip(leaves, live) if on],
        [t for t, on in zip(t_leaves, live) if on],
    )


_accumulate_kernel.defjvp(_accumulate_kernel_jvp, symbolic_zeros=True)


@functools.partial(jax.jit, static_argnums=(2,))
def _render_tile(scene, cam, cfg, pixel_ids, key):
    return render(scene, cam, cfg, pixel_ids, key)


def blocked_pixel_order(cfg: RenderConfig, block_w: int = 128,
                        block_h: int = 64) -> np.ndarray:
    """Pixel ids in screen-block-major order (128x64 blocks, row-major
    inside each block).

    Consecutive ids then form compact screen rectangles — coherent ray
    cones — instead of thin row strips. RNG keys hang off the pixel ID,
    so any order produces bit-identical per-pixel values.
    """
    w, h = cfg.width, cfg.height
    ids = np.arange(w * h, dtype=np.int32).reshape(h, w)
    out = [
        ids[y0 : y0 + block_h, x0 : x0 + block_w].ravel()
        for y0 in range(0, h, block_h)
        for x0 in range(0, w, block_w)
    ]
    return np.concatenate(out)


class RenderOutput(NamedTuple):
    image: np.ndarray      # (H, W, 3) linear float mean radiance, row 0 = top
    canvas: np.ndarray     # (H, W, 3) quantized 0..255 ints (reference canva)
    albedo: np.ndarray     # (H, W, 3) AOV mean
    normal: np.ndarray     # (H, W, 3) AOV mean


def render_image(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    key: Array,
) -> RenderOutput:
    """Full-frame render: tiles of ``cfg.pixel_tile`` pixels stream through
    one jitted program (same compiled code for every tile)."""
    n_pix = cfg.n_pixels
    tile = min(cfg.pixel_tile, n_pix)
    n_tiles = (n_pix + tile - 1) // tile
    padded = n_tiles * tile

    rad = np.zeros((n_pix, 3), np.float32)
    alb = np.zeros((n_pix, 3), np.float32)
    nrm = np.zeros((n_pix, 3), np.float32)

    # block-major pixel order (blocked_pixel_order); results scatter
    # back by pixel id. Padding repeats
    # the last id — its duplicate entries compute identical sums, so the
    # scatter is id-idempotent.
    order = blocked_pixel_order(cfg)
    all_ids = np.pad(order, (0, padded - n_pix), mode="edge")

    for t in range(n_tiles):
        ids_np = all_ids[t * tile : (t + 1) * tile]
        sums = _render_tile(scene, cam, cfg, jnp.asarray(ids_np), key)
        rad[ids_np] = np.asarray(sums.radiance.to_array())
        alb[ids_np] = np.asarray(sums.albedo.to_array())
        nrm[ids_np] = np.asarray(sums.normal.to_array())

    return assemble_image(cfg, rad, alb, nrm)


def assemble_image(
    cfg: RenderConfig, rad_sums: np.ndarray, alb_sums: np.ndarray,
    nrm_sums: np.ndarray, spp: Optional[int] = None,
) -> RenderOutput:
    """Means + tonemap + quantize; flips rows so row 0 is the top (the
    reference writes bottom-up storage top-down, main.c:460-465)."""
    spp = spp if spp is not None else cfg.spp
    h, w = cfg.height, cfg.width

    mean_rad = rad_sums.reshape(h, w, 3) / spp
    mean_alb = alb_sums.reshape(h, w, 3) / spp
    mean_nrm = nrm_sums.reshape(h, w, 3) / spp

    toned = tonemap(Vec3.from_array(jnp.asarray(mean_rad)))
    canvas = np.asarray(quantize(toned).to_array(), np.float32)

    flip = lambda a: a[::-1]  # bottom-up rows -> top-down image
    return RenderOutput(
        image=flip(mean_rad),
        canvas=flip(canvas).astype(np.int32),
        albedo=flip(mean_alb),
        normal=flip(mean_nrm),
    )
