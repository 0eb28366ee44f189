"""The Triton sphere megakernel vs the scan integrator: same RNG streams,
same semantics, compared with the kernel in the Pallas interpreter on
CPU (``render(..., _route="kernel")`` interprets off a GPU). The
compiled kernel is compared on the card by chip_smoke.py and by the
``gpu``-marked test below."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core import rng
from raytpu.core.types import RenderConfig, Scene
from raytpu.core.vec3 import Vec3
from raytpu.integrator.path import n_bounce_draws, trace
from raytpu.integrator.render import kernel_serves, render, sample_rays
from raytpu.kernels import trace_spheres
from raytpu.kernels.trace_spheres import supported, trace_megakernel
from raytpu.scenes import BLACK, WHITE, cornell_box, spheres_from_rows

kernel = pytest.mark.kernel


def _compare(scene, cam, cfg, key, atol=1e-4, outlier_frac=0.02):
    """Scan vs megakernel. The two programs compile differently (the
    scan path's fusions vs the kernel's per-ray loop), so grazing hits
    on the 500-radius wall spheres (catastrophically cancelling
    discriminants) can flip for rare samples — a tiny per-pixel outlier
    fraction is allowed."""
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    a = render(scene, cam, cfg, pids, key, _route="scan")
    b = render(scene, cam, cfg, pids, key, _route="kernel")
    for name in ("radiance", "albedo", "normal"):
        x = np.asarray(getattr(a, name).to_array())
        y = np.asarray(getattr(b, name).to_array())
        bad = (np.abs(x - y) > atol + 1e-5 * np.abs(x)).any(axis=-1)
        assert bad.mean() <= outlier_frac, (
            f"{name}: {bad.mean():.2%} pixels differ "
            f"(max {np.abs(x - y).max():.4f})"
        )


@kernel
def test_cornell_matches_scan():
    scene, cam, _ = cornell_box()
    cfg = RenderConfig(width=16, height=12, spp=4, max_bounces=5)
    assert supported(scene)
    _compare(scene, cam, cfg, jax.random.PRNGKey(41))


@kernel
def test_refractive_spheres_match_scan():
    rows = [
        ((0, -501, 0), 500.0, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 1.5, -3), 0.8, BLACK, (1.0, 0.9, 0.7), 5.0, 0.0, 1.0, 1.0),
        # glass ball: alpha in the refraction window
        ((0, 0, -3), 0.7, WHITE, BLACK, 0.0, 0.2, 0.1, 1.5),
        # cutout ball
        ((0.9, 0, -2.2), 0.4, WHITE, BLACK, 0.0, 0.0, 0.0, 1.0),
    ]
    scene = Scene.from_spheres(spheres_from_rows(rows))
    from raytpu.camera import make_camera

    cam = make_camera(
        origin=(0, 0, 1), target=(0, 0, -3), up=(0, 1, 0),
        vfov_deg=50.0, aspect_ratio=1.5,
    )
    cfg = RenderConfig(width=12, height=8, spp=4, max_bounces=6)
    _compare(scene, cam, cfg, jax.random.PRNGKey(42))


@kernel
def test_ao_dof_matches_scan():
    """BASELINE config 2's features: AO probes + DoF aperture jitter."""
    scene, cam, _ = cornell_box()
    cfg = RenderConfig(
        width=12, height=8, spp=3, max_bounces=4,
        use_ao=True, ao_intensity=2.5,
        aperture_x=0.3, aperture_y=0.3, focus_distance=3.0,
    )
    assert supported(scene)
    _compare(scene, cam, cfg, jax.random.PRNGKey(43))


@kernel
def test_hsl_boost_matches_scan():
    """The CUDA fork's L*=1.2 HSL boost, in-kernel."""
    scene, cam, _ = cornell_box()
    cfg = RenderConfig(
        width=12, height=8, spp=3, max_bounces=3, hsl_l_factor=1.2
    )
    assert supported(scene)
    _compare(scene, cam, cfg, jax.random.PRNGKey(46))


@kernel
def test_unsupported_configs_fall_back():
    scene, cam, _ = cornell_box()
    # sky scenes are a kernel path (the single-slot sky composition),
    # whether or not a texture is attached (no texture = plain emitter)
    assert supported(scene.replace(sky_sphere_index=1))
    # a sky index past the sphere table is unsupported
    assert not supported(scene.replace(sky_sphere_index=99))
    # textured-sky scene renders through the kernel path
    from raytpu.core.types import SkyTexture

    sky = SkyTexture(
        rgb=Vec3(jnp.ones(4), jnp.ones(4), jnp.ones(4)), width=2, height=2
    )
    s2 = scene.replace(sky=sky, sky_sphere_index=9)
    assert supported(s2)
    cfg = RenderConfig(width=8, height=6, spp=2, max_bounces=3)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    out = render(s2, cam, cfg, pids, jax.random.PRNGKey(1), _route="kernel")
    assert np.isfinite(np.asarray(out.radiance.to_array())).all()


@kernel
def test_megakernel_sharded_matches_single_device(monkeypatch):
    """The megakernel composes with the ('tiles','samples') mesh: a
    sharded megakernel render equals the unsharded megakernel render
    (same per-(pixel, sample) RNG streams; only the psum order differs)."""
    import raytpu.sharding.mesh as sharding_mesh
    from raytpu.sharding import make_mesh, render_sharded

    scene, cam, _ = cornell_box()
    cfg = RenderConfig(width=16, height=8, spp=8, max_bounces=3)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(44)
    ref = render(scene, cam, cfg, pids, key, _route="kernel")
    monkeypatch.setattr(
        sharding_mesh, "render", functools.partial(render, _route="kernel")
    )
    got = render_sharded(scene, cam, cfg, pids, key, make_mesh(2, 4))
    np.testing.assert_allclose(
        np.asarray(got.radiance.to_array()),
        np.asarray(ref.radiance.to_array()),
        rtol=1e-5, atol=1e-5,
    )


def _grad_pair(scene, cam, cfg, key, loss_of_sums):
    from raytpu.train import combine_scene, partition_scene

    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    params, static = partition_scene(scene)

    def loss(params, route):
        sums = render(combine_scene(params, static), cam, cfg, pids, key,
                      _route=route)
        return loss_of_sums(sums)

    return jax.grad(loss)(params, "kernel"), jax.grad(loss)(params, "scan"), loss


@kernel
def test_megakernel_grad_matches_scan():
    """jax.grad through the kernel route runs its custom_jvp, whose
    rule is the scan path's; sphere-parameter cotangents must equal the
    scan configuration's gradients."""
    scene, cam, _ = cornell_box()
    cfg = RenderConfig(width=8, height=6, spp=2, max_bounces=3)
    g_mk, g_scan, loss = _grad_pair(
        scene, cam, cfg, jax.random.PRNGKey(45),
        lambda s: jnp.mean((s.radiance.to_array() - 0.2) ** 2),
    )
    np.testing.assert_allclose(
        np.asarray(g_mk.spheres.mat.diffuse.x),
        np.asarray(g_scan.spheres.mat.diffuse.x),
        rtol=1e-5, atol=1e-6,
    )
    # regression: the same grad under an ENCLOSING jit — custom-derivative
    # functions must not close over traced values
    from raytpu.train import partition_scene

    params, _ = partition_scene(scene)
    g_jit = jax.jit(lambda p: jax.grad(loss)(p, "kernel"))(params)
    np.testing.assert_allclose(
        np.asarray(g_jit.spheres.mat.diffuse.x),
        np.asarray(g_scan.spheres.mat.diffuse.x),
        rtol=1e-5, atol=1e-6,
    )


@kernel
def test_megakernel_camera_grads_match_scan():
    """Camera-pose gradients flow through the kernel route's derivative
    rule, with the scene held constant (its tangents are symbolic zeros).

    The loss targets the first-hit NORMAL AOV: radiance is piecewise
    constant in ray geometry by design (winner selection runs under
    stop_gradient — the documented silhouette-bias estimator,
    train/inverse.py), so a radiance loss has identically-zero camera
    gradients on BOTH paths. The normal = (point - center)/radius
    depends smoothly on the ray."""
    scene, cam, _ = cornell_box()
    cfg = RenderConfig(width=8, height=6, spp=2, max_bounces=3)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(47)

    def loss(cam, route):
        sums = render(scene, cam, cfg, pids, key, _route=route)
        return jnp.mean(sums.normal.to_array() * jnp.arange(3.0))

    g_mk = jax.grad(loss)(cam, "kernel")
    g_scan = jax.grad(loss)(cam, "scan")
    fk, _ = jax.tree_util.tree_flatten(g_mk)
    fs, _ = jax.tree_util.tree_flatten(g_scan)
    assert any(np.abs(np.asarray(x)).max() > 0 for x in fs)
    for a, b in zip(fk, fs):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        )


@kernel
def test_megakernel_ao_grad_matches_scan():
    """Sphere AO gradients through the kernel route equal the scan
    path's."""
    from raytpu.config import load_scene

    scene, cam, cfg0 = load_scene("scenes/cornell_dof_ao.toml")
    cfg = cfg0.replace(width=8, height=6, spp=2, max_bounces=3)
    assert cfg.use_ao
    g_mk, g_scan, _ = _grad_pair(
        scene, cam, cfg, jax.random.PRNGKey(31),
        lambda s: jnp.mean((s.radiance.to_array() - 0.2) ** 2),
    )
    for name, a, b in (
        ("diffuse.x", g_mk.spheres.mat.diffuse.x,
         g_scan.spheres.mat.diffuse.x),
        ("emission_strength", g_mk.spheres.mat.emission_strength,
         g_scan.spheres.mat.emission_strength),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7,
            err_msg=name,
        )
    assert float(np.abs(np.asarray(g_scan.spheres.mat.diffuse.x)).max()) > 0


# --- the wrapper, the path choice and the derivative rule ----------------

def _rays(scene, cfg, n, seed=0):
    """``n`` camera rays of cornell_box's camera plus their draws."""
    _, cam, _ = cornell_box()
    pids = jnp.arange(n, dtype=jnp.int32) % cfg.n_pixels
    keys = rng.sample_keys(rng.pixel_keys(jax.random.PRNGKey(seed), pids), 0)
    cam_draws, bounce_draws = rng.ray_uniforms(
        keys, 4, n_bounce_draws(cfg), cfg.max_bounces
    )
    origin, direction = sample_rays(cam, cfg, pids, cam_draws)
    return origin, direction, bounce_draws


@pytest.mark.parametrize(
    "n", [1, trace_spheres.BLOCK - 1, trace_spheres.BLOCK + 44]
)
def test_wrapper_pads_ray_batches(n):
    """Ray counts that are not a multiple of BLOCK are padded to one and
    cut back; every real ray matches the scan path."""
    scene, _, _ = cornell_box()
    cfg = RenderConfig(width=40, height=30, spp=1, max_bounces=3)
    o, d, draws = _rays(scene, cfg, n)
    got = trace_megakernel(scene, cfg, o, d, draws, True)
    want = trace(scene, cfg, o, d, draws)
    for g, w in zip(got, want):
        assert g.x.shape == (n,)
        np.testing.assert_allclose(
            np.asarray(g.to_array()), np.asarray(w.to_array()),
            rtol=1e-5, atol=1e-5,
        )


@pytest.mark.parametrize(
    "platform, n_spheres, serves",
    [("gpu", 10, True), ("cpu", 10, False), ("gpu", 65, False)],
)
def test_path_choice(platform, n_spheres, serves, capsys):
    """The kernel serves supported scenes on a GPU; other backends take
    the scan path; an unsupported scene on a GPU takes the scan path
    with a one-line reason on stderr."""
    from raytpu.integrator import render as render_mod

    rows = [((float(i), 0.0, -3.0), 0.4, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0)
            for i in range(n_spheres)]
    scene = Scene.from_spheres(spheres_from_rows(rows))
    render_mod._logged_fallbacks.clear()
    assert kernel_serves(scene, platform) is serves
    err = capsys.readouterr().err
    if platform == "gpu" and not serves:
        assert err.count("\n") == 1
        assert f"{n_spheres} spheres > {trace_spheres.MAX_SPHERES}" in err
        assert "scan path serves this render" in err
    else:
        assert err == ""


@pytest.mark.parametrize("scene_kind", ["plain", "ao", "sky"])
def test_kernel_route_grads_are_the_scan_paths(scene_kind):
    """The kernel route's derivative rule (render._accumulate_kernel) is
    jax.jvp of the scan path's sample loop: every scene and camera
    gradient equals jax.grad through the scan route."""
    from raytpu.core.types import SkyTexture
    from raytpu.train import combine_scene, partition_scene

    scene, cam, _ = cornell_box()
    cfg = RenderConfig(width=10, height=8, spp=2, max_bounces=4)
    if scene_kind == "ao":
        cfg = cfg.replace(use_ao=True, ao_samples=2)
    if scene_kind == "sky":
        # a diffuse ball inside a textured sky sphere (pure emitter, black
        # diffuse: the convention raytpu.config enforces)
        rows = [
            ((0, 0, -3), 1.0, (0.8, 0.8, 0.8), BLACK, 0.0, 0.0, 1.0, 1.0),
            ((1, 1, -2), 0.3, BLACK, (1.0, 0.8, 0.6), 3.0, 0.0, 1.0, 1.0),
            ((0, 0, 0), 1000.0, BLACK, WHITE, 1.0, 0.0, 1.0, 1.0),
        ]
        tex = np.linspace(0.1, 0.9, 3 * 32, dtype=np.float32).reshape(32, 3)
        sky = SkyTexture(rgb=Vec3(*(jnp.asarray(tex[:, c]) for c in range(3))),
                         width=8, height=4)
        scene = Scene.from_spheres(spheres_from_rows(rows)).replace(
            sky=sky, sky_sphere_index=2)
        cfg = cfg.replace(sky_texture_grads=True)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(3)
    params, static = partition_scene(scene)

    def loss(params, cam, route):
        s = render(combine_scene(params, static), cam, cfg, pids, key,
                   _route=route)
        return jnp.sum(s.radiance.x + 2.0 * s.radiance.y) + jnp.sum(
            s.normal.x * s.albedo.z)

    g_mk = jax.grad(loss, argnums=(0, 1))(params, cam, "kernel")
    g_sc = jax.grad(loss, argnums=(0, 1))(params, cam, "scan")
    nonzero = 0
    for a, b in zip(jax.tree.leaves(g_mk), jax.tree.leaves(g_sc)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )
        nonzero += bool(b.size and np.abs(np.asarray(b)).max() > 0)
    assert nonzero >= 4


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    """The compiled Triton kernel vs the compiled scan path on the card."""
    scene, cam, _ = cornell_box()
    cfg = RenderConfig(width=64, height=48, spp=4, max_bounces=6)
    _compare(scene, cam, cfg, jax.random.PRNGKey(48))
