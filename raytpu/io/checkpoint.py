"""Checkpoint / resume for long renders.

The reference writes output only once, at the very end
(/root/reference/main.c:457-465) — a killed 15000-spp render loses
everything. Here the render state *is* the per-pixel accumulator sums
(radiance / albedo / normal + samples-done), and RNG keys are derived
from (pixel_id, global_sample_index) (raytpu.core.rng), so:

  * flushing the sums every K sample-batches costs one host transfer,
  * resuming = reload sums and continue at sample_offset = samples_done,
  * a resumed render is BIT-IDENTICAL to an uninterrupted one (the same
    per-sample terms are added in the same order).

Format: a single .npz (portable, no deps) plus a JSON sidecar with the
config fingerprint so a resume against different settings fails loudly.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.camera import Camera
from raytpu.core.types import RenderConfig, Scene
from raytpu.core.vec3 import Vec3
from raytpu.integrator.render import (
    RenderOutput,
    RenderSums,
    assemble_image,
    render,
)


def _fingerprint(cfg: RenderConfig, seed: int) -> dict:
    d = dataclasses.asdict(cfg)
    d["seed"] = seed
    # pixel_tile only changes host-side batching (per-pixel sums are
    # tile-independent), so it must not invalidate a resume
    d.pop("pixel_tile", None)
    # canonicalize through a JSON round-trip, the form the sidecar
    # stores, so load_checkpoint compares like with like
    return json.loads(json.dumps(d))


def save_checkpoint(
    path: str, rad: np.ndarray, alb: np.ndarray, nrm: np.ndarray,
    samples_done: int, cfg: RenderConfig, seed: int,
) -> None:
    # sidecar first (its content — the config fingerprint — is constant
    # across flushes, so landing it before the npz is always consistent);
    # both writes are tmp + os.replace so a crash never leaves a torn file
    tmp_json = path + ".json.tmp"
    with open(tmp_json, "w") as f:
        json.dump(_fingerprint(cfg, seed), f)
    os.replace(tmp_json, path + ".json")
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp.removesuffix(".npz"),
        radiance=rad, albedo=alb, normal=nrm,
        samples_done=np.int64(samples_done),
    )
    os.replace(tmp, path)


def load_checkpoint(
    path: str, cfg: RenderConfig, seed: int
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    if not os.path.exists(path):
        return None
    if not os.path.exists(path + ".json"):
        # npz without its fingerprint sidecar (crash in the save window of
        # an old version, or a hand-deleted file): treat as no checkpoint
        # rather than crashing the resume
        return None
    with open(path + ".json") as f:
        meta = json.load(f)
    want = _fingerprint(cfg, seed)
    defaults = json.loads(json.dumps(dataclasses.asdict(RenderConfig())))
    # tolerate keys the old checkpoint predates, as long as the current
    # run uses their default values (a config field added in an upgrade
    # must not invalidate old checkpoints)
    diff = {
        k: (meta.get(k), want[k])
        for k in want
        if meta.get(k, defaults.get(k)) != want[k]
    }
    if diff:
        raise ValueError(
            f"checkpoint {path} was written with different settings: {diff}"
        )
    z = np.load(path)
    return (
        z["radiance"], z["albedo"], z["normal"], int(z["samples_done"])
    )


def render_image_checkpointed(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    key,
    ckpt_path: str,
    flush_every: int = 64,
    log=None,
    progress=None,
) -> RenderOutput:
    """Full-frame render that flushes accumulator checkpoints every
    ``flush_every`` samples and resumes from ``ckpt_path`` if present.

    ``progress``, if given, is called as ``progress(samples_done,
    rad_sums)`` after every flush (rad_sums: (n_pixels, 3) numpy) — the
    hook the CLI's RenderMonitor (previews, JSON progress lines) attaches
    to (SURVEY.md §5.5).
    """
    n_pix = cfg.n_pixels
    raw = (
        jax.random.key_data(key)
        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
        else key
    )
    seed = int(np.asarray(raw).ravel()[-1])

    state = load_checkpoint(ckpt_path, cfg, seed)
    if state is not None:
        rad, alb, nrm, done = state
        if log:
            log(f"resuming at {done}/{cfg.spp} samples from {ckpt_path}")
    else:
        rad = np.zeros((n_pix, 3), np.float32)
        alb = np.zeros((n_pix, 3), np.float32)
        nrm = np.zeros((n_pix, 3), np.float32)
        done = 0

    # stream pixels in cfg.pixel_tile batches like render_image: one whole
    # frame per device call would materialize the per-bounce (B, prims)
    # matrices for every pixel at once on the XLA fallback path (~GBs at
    # 1200x900 mesh scenes) — exactly the long-render case checkpointing
    # exists for
    tile = min(cfg.pixel_tile, n_pix)
    n_tiles = (n_pix + tile - 1) // tile
    from raytpu.integrator.render import blocked_pixel_order

    # block-major order for coherent kernel tiles (see render_image);
    # per-pixel sums are order-independent (keys hang off the pixel id),
    # so checkpoints stay bit-compatible across orderings
    all_ids = np.pad(
        blocked_pixel_order(cfg), (0, n_tiles * tile - n_pix), mode="edge"
    )

    while done < cfg.spp:
        n = min(flush_every, cfg.spp - done)
        for t in range(n_tiles):
            ids_np = all_ids[t * tile : (t + 1) * tile]
            # resume the scan CARRY from the checkpointed sums: the
            # left-fold association of the f32 adds is then identical to
            # an uninterrupted run, making resume bit-exact
            init = RenderSums(
                Vec3.from_array(jnp.asarray(rad[ids_np])),
                Vec3.from_array(jnp.asarray(alb[ids_np])),
                Vec3.from_array(jnp.asarray(nrm[ids_np])),
                jnp.asarray(done, jnp.int32),
            )
            sums = _render_batch(
                scene, cam, cfg, jnp.asarray(ids_np), key, done, init, n=n
            )
            rad[ids_np] = np.asarray(sums.radiance.to_array())
            alb[ids_np] = np.asarray(sums.albedo.to_array())
            nrm[ids_np] = np.asarray(sums.normal.to_array())
        done += n
        save_checkpoint(ckpt_path, rad, alb, nrm, done, cfg, seed)
        if log:
            log(f"{done}/{cfg.spp} samples checkpointed")
        if progress:
            progress(done, rad)

    return assemble_image(cfg, rad, alb, nrm)


@functools.partial(jax.jit, static_argnums=(2,), static_argnames=("n",))
def _render_batch(scene, cam, cfg, pixel_ids, key, offset, init, *, n):
    return render(
        scene, cam, cfg, pixel_ids, key,
        sample_offset=offset, n_samples=n, init=init,
    )
