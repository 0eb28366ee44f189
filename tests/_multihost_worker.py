"""Worker process for tests/test_multihost.py: one of N localhost JAX
processes. Joins the distributed runtime, renders a small frame over the
process-spanning ('tiles','samples') mesh, writes the result to disk.

Run only via the test (env-configured); not a pytest module.
"""

import os
import sys

import numpy as np


def main() -> None:
    pid = int(os.environ["WORKER_PROCESS_ID"])
    nproc = int(os.environ["WORKER_NUM_PROCESSES"])
    coord = os.environ["WORKER_COORDINATOR"]
    out_path = os.environ["WORKER_OUT"]

    import jax

    from raytpu.sharding import (
        init_distributed,
        make_global_mesh,
        render_image_multihost,
    )

    ok = init_distributed(coord, nproc, pid)
    assert ok, "distributed init did not engage"
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.local_devices()) == 4, jax.local_devices()
    assert jax.device_count() == 4 * nproc

    from raytpu.scenes import cornell_box

    scene, cam, cfg = cornell_box()
    cfg = cfg.replace(width=16, height=12, spp=8, max_bounces=4)
    # tiles axis spans the two processes; samples axis is intra-process
    mesh = make_global_mesh(nproc, 4)
    out = render_image_multihost(scene, cam, cfg, jax.random.PRNGKey(0), mesh)

    np.savez(
        f"{out_path}.p{pid}.npz", image=out.image, canvas=out.canvas,
        albedo=out.albedo,
    )
    print(f"worker {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
