"""Multi-host (multi-process) rendering without a cluster: two localhost
CPU processes with 4 virtual devices each form one 8-device
('tiles','samples') mesh; the distributed render must agree with the
single-process 8-device render (same per-(pixel, sample) RNG terms —
SURVEY.md §5.8)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_render_matches_single_process(tmp_path):
    port = _free_port()
    out = str(tmp_path / "mh")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "WORKER_PROCESS_ID": str(pid),
            "WORKER_NUM_PROCESSES": "2",
            "WORKER_COORDINATOR": f"127.0.0.1:{port}",
            "WORKER_OUT": out,
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_multihost_worker.py")],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=300)
        logs.append(stdout)
    assert all(p.returncode == 0 for p in procs), (
        "worker failed:\n" + "\n----\n".join(logs)
    )

    # single-process reference on the test harness's 8 virtual devices,
    # same (2, 4) mesh factorization
    import jax

    from raytpu.scenes import cornell_box
    from raytpu.sharding import make_mesh, render_image_multihost

    scene, cam, cfg = cornell_box()
    cfg = cfg.replace(width=16, height=12, spp=8, max_bounces=4)
    ref = render_image_multihost(
        scene, cam, cfg, jax.random.PRNGKey(0), make_mesh(2, 4)
    )

    for pid in range(2):
        z = np.load(f"{out}.p{pid}.npz")
        # every process must hold the full, identical frame
        np.testing.assert_allclose(
            z["image"], ref.image, rtol=1e-5, atol=1e-6,
            err_msg=f"process {pid} image diverges from single-process",
        )
        assert (z["canvas"] == ref.canvas).mean() > 0.99


def test_init_distributed_noop_without_config(monkeypatch):
    """No coordinator configured anywhere -> stays single-process and
    returns False (the CLI calls this unconditionally)."""
    for k in ("RAYTPU_COORDINATOR", "RAYTPU_NUM_PROCESSES",
              "RAYTPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    from raytpu.sharding import init_distributed

    assert init_distributed() is False
