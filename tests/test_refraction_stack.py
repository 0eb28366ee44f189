"""The 19-bounce refraction-stack regime (VERDICT r2 missing #2).

The reference's deepest correctness exhibit is a 19-bounce render of
nested refractive media driving the pile.h linked-list IOR stack
(/root/reference/results/refraction_stack_1000RAYS_19RB_22-11_22h24.png;
pile.h:23-72, main.c:167-193). The production integrator reduces that
stack to ONE carried scalar (medium_n2) with a written proof
(integrator/path.py:22-31); these tests pin the reduction where it is
most stressed — three nested media, 19 bounces:

  * oracle agreement: the f64 oracle (tests/oracle.py) keeps the REAL
    linked-list stack, so agreement at depth 19 is an independent check
    of the reduction, not a self-comparison.
  * megakernel agreement + gradient parity at max_bounces=19 (the
    kernel in the Pallas interpreter here; chip_smoke.py compares the
    compiled kernel at 19 bounces on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.config import load_scene
from raytpu.core.types import RenderConfig
from raytpu.integrator.render import render


def _small_cfg(cfg, **kw):
    base = dict(width=10, height=8, spp=2)
    base.update(kw)
    return cfg.replace(**base)


@pytest.mark.golden
@pytest.mark.slow
def test_refraction_stack_matches_oracle_at_19_bounces():
    """medium_n2 reduction vs the true pile.h linked list, depth 19."""
    from tests.oracle import render_oracle

    scene, cam, cfg = load_scene("scenes/refraction_stack.toml")
    cfg = _small_cfg(cfg)
    assert cfg.max_bounces == 19, "scene spec must pin the 19-bounce depth"
    pixel_ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(77)
    sums = render(scene, cam, cfg, pixel_ids, key)
    got = np.asarray(sums.radiance.to_array(), np.float64)
    want, _, _ = render_oracle(scene, cam, cfg, key)
    err = np.abs(got - want)
    tol = 0.02 * cfg.spp + 0.02 * np.abs(want)
    bad = (err > tol).any(axis=-1)
    assert bad.mean() <= 0.02, (
        f"{bad.mean():.2%} pixels disagree with the f64 linked-list "
        f"oracle at 19 bounces (max err {err.max():.4f})"
    )


@pytest.mark.kernel
def test_refraction_stack_kernel_matches_scan_at_19_bounces():
    """Sphere megakernel agreement at the deep-bounce depth."""
    from raytpu.kernels.trace_spheres import supported

    scene, cam, cfg = load_scene("scenes/refraction_stack.toml")
    cfg = _small_cfg(cfg)
    assert supported(scene)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(78)
    a = render(scene, cam, cfg, pids, key, _route="scan")
    b = render(scene, cam, cfg, pids, key, _route="kernel")
    for name in ("radiance", "albedo", "normal"):
        x = np.asarray(getattr(a, name).to_array())
        y = np.asarray(getattr(b, name).to_array())
        bad = (np.abs(x - y) > 1e-4 + 1e-5 * np.abs(x)).any(axis=-1)
        assert bad.mean() <= 0.02, f"{name}: {bad.mean():.2%} pixels differ"


@pytest.mark.slow
def test_refraction_stack_kernel_grad_at_19_bounces():
    """Grads through the kernel route at depth 19 must match the scan
    path on sphere geometry AND material leaves. Marked slow: XLA:CPU
    compiles the 19-bounce vjp slowly."""
    from raytpu.train import combine_scene, partition_scene

    scene, cam, cfg = load_scene("scenes/refraction_stack.toml")
    cfg = _small_cfg(cfg, spp=1)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(79)
    params, static = partition_scene(scene)

    def loss(params, route):
        sums = render(combine_scene(params, static), cam, cfg, pids, key,
                      _route=route)
        return (
            jnp.mean((sums.radiance.to_array() - 0.3) ** 2)
            + jnp.mean(sums.normal.to_array() ** 2)
        )

    g_mk = jax.grad(loss)(params, "kernel")
    g_scan = jax.grad(loss)(params, "scan")
    for name, a, b in (
        ("center.z", g_mk.spheres.center.z, g_scan.spheres.center.z),
        ("radius", g_mk.spheres.radius, g_scan.spheres.radius),
        ("ior", g_mk.spheres.mat.ior, g_scan.spheres.mat.ior),
        ("diffuse.x", g_mk.spheres.mat.diffuse.x,
         g_scan.spheres.mat.diffuse.x),
    ):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=name)
    assert np.abs(np.asarray(g_scan.spheres.mat.diffuse.x)).max() > 0
