"""Multi-host (multi-process) wiring: jax.distributed init + global-mesh
rendering.

The reference is strictly single-process (SURVEY.md §5.8 — its only
transport is cudaMemcpy); the multi-host axis is a new capability.
Design:

  * :func:`init_distributed` wraps ``jax.distributed.initialize`` with
    env-var defaults, so one binary works under any launcher that
    exports RAYTPU_COORDINATOR / RAYTPU_NUM_PROCESSES /
    RAYTPU_PROCESS_ID.
  * after init, ``jax.devices()`` is the GLOBAL device list; the same
    ('tiles','samples') mesh from :mod:`raytpu.sharding.mesh` simply
    spans processes. shard_map + psum compile to XLA collectives
    (NCCL on GPUs) — no transport code.
  * per-(pixel, sample) RNG keying makes the distributed render compute
    exactly the same sample terms as one device, so cross-host runs are
    verifiable bit-for-bit against single-process runs
    (tests/test_multihost.py runs 2 localhost CPU processes and asserts
    exactly that).

Scaling-efficiency methodology (bench.py --mesh NxM under a multi-host
launch): rays/s/chip at N hosts over rays/s/chip at 1 host. The sample
axis is embarrassingly parallel — one psum of ~3 MB per image tile at
the end of the step — so efficiency is bounded by stragglers, not
bandwidth; per-device work is identical by construction.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytpu.sharding.mesh import SAMPLE_AXIS, TILE_AXIS, make_mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list[int]] = None,
) -> bool:
    """Initialize the JAX distributed runtime (idempotent).

    Resolution order per field: explicit argument > RAYTPU_* env var.
    Returns True when a multi-process runtime was initialized, False for
    single-process (no coordinator configured).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "RAYTPU_COORDINATOR"
    )
    if num_processes is None and "RAYTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["RAYTPU_NUM_PROCESSES"])
    if process_id is None and "RAYTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["RAYTPU_PROCESS_ID"])

    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:
        # already initialized (idempotent); process_count() is safe now
        return jax.process_count() > 1

    if coordinator_address is None and num_processes is None:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def make_global_mesh(
    n_tiles: Optional[int] = None, n_samples: Optional[int] = None
) -> Mesh:
    """('tiles','samples') mesh over ALL processes' devices.

    Device order groups each process's devices contiguously along the
    trailing (samples) axis, so with n_samples a multiple of
    local_device_count the sample-axis psum stays intra-host wherever
    the factorization allows."""
    return make_mesh(n_tiles, n_samples, devices=jax.devices())


def global_pixel_ids(mesh: Mesh, n_pixels: int):
    """A globally-sharded pixel-id array: each process materializes only
    its addressable 'tiles' shards. Pads (by repeating the last pixel)
    to a multiple of the tile axis."""
    import jax.numpy as jnp

    nt = mesh.shape[TILE_AXIS]
    padded = -(-n_pixels // nt) * nt
    ids = np.minimum(np.arange(padded, dtype=np.int32), n_pixels - 1)
    sharding = NamedSharding(mesh, P(TILE_AXIS))
    return jax.make_array_from_callback(
        (padded,), sharding, lambda idx: ids[idx]
    )


def render_image_multihost(scene, cam, cfg, key, mesh: Optional[Mesh] = None):
    """Full-frame render over a (possibly multi-process) mesh; every
    process returns the SAME fully-replicated RenderOutput.

    Single shard_map step over globally-sharded pixel ids; the per-pixel
    sums come back 'tiles'-sharded and are allgathered to every host
    (pixel sums are ~36 MB at 1200x900 — negligible next to render
    time). For single-process use, prefer render_image_sharded (it
    streams pixel tiles instead of rendering the frame in one step)."""
    import jax.numpy as jnp

    from raytpu.integrator.render import assemble_image
    from raytpu.sharding.mesh import render_sharded

    mesh = mesh if mesh is not None else make_global_mesh()
    pixel_ids = global_pixel_ids(mesh, cfg.n_pixels)

    step = jax.jit(
        lambda sc, ca, pids, k: render_sharded(sc, ca, cfg, pids, k, mesh),
        static_argnums=(),
    )
    sums = step(scene, cam, pixel_ids, key)

    # gather the tiles-sharded sums to every process
    rep = NamedSharding(mesh, P())
    gather = jax.jit(lambda x: x, out_shardings=rep)
    n = cfg.n_pixels
    rad = np.asarray(jax.device_get(gather(sums.radiance.to_array())))[:n]
    alb = np.asarray(jax.device_get(gather(sums.albedo.to_array())))[:n]
    nrm = np.asarray(jax.device_get(gather(sums.normal.to_array())))[:n]
    return assemble_image(cfg, rad, alb, nrm)
