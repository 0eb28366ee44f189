"""Sky-sphere environment mapping (sphere_uvmapping, texture.h:92-112;
the 'derniere sphere = ciel' convention, main.c:331) vs the f64 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.types import RenderConfig, Scene
from raytpu.core.vec3 import Vec3
from raytpu.core.types import SkyTexture
from raytpu.integrator.render import render
from raytpu.scenes import BLACK, spheres_from_rows

from tests.oracle import render_oracle


def _sky_scene():
    rows = [
        # one diffuse ball + the giant sky sphere (emissive via texture)
        ((0, 0, -3), 1.0, (0.8, 0.8, 0.8), BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 0, 0), 1000.0, BLACK, (1.0, 1.0, 1.0), 1.0, 0.0, 1.0, 1.0),
    ]
    scene = Scene.from_spheres(spheres_from_rows(rows))
    # small procedural equirect texture: horizontal color bands
    h, w = 8, 16
    tex = np.zeros((h * w, 3), np.float32)
    for y in range(h):
        tex[y * w : (y + 1) * w] = [y / h, 0.5, 1.0 - y / h]
    sky = SkyTexture(
        rgb=Vec3(
            jnp.asarray(tex[:, 0]), jnp.asarray(tex[:, 1]), jnp.asarray(tex[:, 2])
        ),
        width=w,
        height=h,
    )
    return scene.replace(sky=sky, sky_sphere_index=1)


def test_sky_matches_oracle():
    from raytpu.camera import make_camera

    scene = _sky_scene()
    cam = make_camera(
        origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
        vfov_deg=60.0, aspect_ratio=1.5,
    )
    cfg = RenderConfig(width=12, height=8, spp=3, max_bounces=3)
    key = jax.random.PRNGKey(31)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    sums = render(scene, cam, cfg, pids, key)
    got = np.asarray(sums.radiance.to_array(), np.float64)
    want, _, _ = render_oracle(scene, cam, cfg, key)
    err = np.abs(got - want)
    tol = 0.02 * cfg.spp + 0.02 * np.abs(want)
    bad = (err > tol).any(axis=-1)
    assert bad.mean() <= 0.05, f"{bad.mean():.2%} out (max {err.max():.4f})"
    # the sky must actually contribute color variation
    assert got.std() > 0.05


@pytest.mark.kernel
def test_sky_kernel_matches_scan():
    """The sphere megakernel's single-slot sky composition
    (kernels/trace_spheres._kernel docstring) vs the scan path: same
    RNG, black-diffuse pure-emitter sky (the reference convention the
    slot design is exact under)."""
    from raytpu.camera import make_camera
    from raytpu.kernels.trace_spheres import supported

    scene = _sky_scene()
    cam = make_camera(
        origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
        vfov_deg=60.0, aspect_ratio=1.5,
    )
    cfg = RenderConfig(width=12, height=8, spp=3, max_bounces=4)
    assert supported(scene)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(32)
    a = render(scene, cam, cfg, pids, key, _route="scan")
    b = render(scene, cam, cfg, pids, key, _route="kernel")
    for name in ("radiance", "albedo", "normal"):
        x = np.asarray(getattr(a, name).to_array())
        y = np.asarray(getattr(b, name).to_array())
        bad = (np.abs(x - y) > 1e-4 + 1e-5 * np.abs(x)).any(axis=-1)
        assert bad.mean() <= 0.02, (
            f"{name}: {bad.mean():.2%} pixels differ "
            f"(max {np.abs(x - y).max():.4f})"
        )
    # vacuity guard: the sky must light the scene
    assert np.asarray(a.radiance.to_array()).std() > 0.01


@pytest.mark.kernel
def test_sky_kernel_grad_matches_scan():
    """Sky-texture and sphere gradients through the kernel route's
    derivative rule must match the scan path."""
    from raytpu.camera import make_camera
    from raytpu.train import combine_scene, partition_scene

    scene = _sky_scene()
    cam = make_camera(
        origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
        vfov_deg=60.0, aspect_ratio=1.5,
    )
    cfg = RenderConfig(
        width=10, height=6, spp=2, max_bounces=3, sky_texture_grads=True,
    )
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(33)
    params, static = partition_scene(scene)

    def loss(params, route):
        sums = render(combine_scene(params, static), cam, cfg, pids, key,
                      _route=route)
        return jnp.mean((sums.radiance.to_array() - 0.2) ** 2)

    g_mk = jax.grad(loss)(params, "kernel")
    g_scan = jax.grad(loss)(params, "scan")
    checked = {
        "sky.rgb.x": (g_mk.sky.rgb.x, g_scan.sky.rgb.x),
        "sky.rgb.z": (g_mk.sky.rgb.z, g_scan.sky.rgb.z),
        "sph.diffuse.x": (g_mk.spheres.mat.diffuse.x,
                          g_scan.spheres.mat.diffuse.x),
        "sph.emission_strength": (g_mk.spheres.mat.emission_strength,
                                  g_scan.spheres.mat.emission_strength),
    }
    nonzero = 0
    for name, (a, b) in checked.items():
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=name
        )
        nonzero += bool(np.abs(np.asarray(b)).max() > 0)
    assert nonzero >= 3, f"only {nonzero} leaves had nonzero reference grads"


def test_packed_sky_fetch_bit_identical():
    """SkyTexture.packed (u8 row-gather fast path, built by load_sky for
    u8-exact sources): sky_emission through it must match the f32 gather
    bit-for-bit — that is the property letting the production path use
    it whenever texel grads are off."""
    import numpy as np

    from raytpu.core.types import SkyTexture
    from raytpu.io.obj import pack_rgba_u8
    from raytpu.materials.texture import sky_emission

    rng = np.random.default_rng(5)
    h, w = 8, 16
    codes = rng.integers(0, 256, (h * w, 3))
    flat = (codes.astype(np.float32) * np.float32(1.0 / 255.0))
    packed = pack_rgba_u8(
        flat[:, 0], flat[:, 1], flat[:, 2], np.ones(h * w, np.float32)
    )
    assert packed is not None
    sky = SkyTexture(
        rgb=Vec3(jnp.asarray(flat[:, 0]), jnp.asarray(flat[:, 1]),
                 jnp.asarray(flat[:, 2])),
        packed=jnp.asarray(packed), width=w, height=h,
    )
    n = 300
    k = jax.random.PRNGKey(0)
    p = Vec3(*(jax.random.normal(jax.random.fold_in(k, i), (n,))
               for i in range(3)))
    c = Vec3.zeros((n,))
    r = jnp.ones((n,))
    pn = p * (1.0 / (p.x**2 + p.y**2 + p.z**2) ** 0.5)
    a = sky_emission(sky, pn, c, r, use_packed=False)
    b = sky_emission(sky, pn, c, r, use_packed=True)
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))


def test_sky_texture_grads_flag():
    """sky_texture_grads=False (default) stops gradients at the sky
    TEXELS only: sky.rgb grads are exactly zero, while geometry /
    material / emission grads in the same scene stay nonzero. True
    restores texel grads (the sky-training path)."""
    import numpy as np

    from raytpu.train import combine_scene, partition_scene

    scene = _sky_scene()
    from raytpu.camera import make_camera

    cam = make_camera(
        origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
        vfov_deg=60.0, aspect_ratio=1.5,
    )
    pids = jnp.arange(48, dtype=jnp.int32)
    key = jax.random.PRNGKey(4)
    params, static = partition_scene(scene)

    def loss(params, c):
        sums = render(combine_scene(params, static), cam, c, pids, key)
        return jnp.sum(sums.radiance.to_array())

    cfg = RenderConfig(width=8, height=6, spp=2, max_bounces=3)
    g_off = jax.grad(loss)(params, cfg)
    g_on = jax.grad(loss)(params, cfg.replace(sky_texture_grads=True))
    assert float(jnp.abs(g_off.sky.rgb.x).max()) == 0.0
    assert float(jnp.abs(g_on.sky.rgb.x).max()) > 0.0
    # non-texel grads identical across the flag
    np.testing.assert_allclose(
        np.asarray(g_off.spheres.mat.diffuse.x),
        np.asarray(g_on.spheres.mat.diffuse.x), rtol=1e-6,
    )
    assert float(jnp.abs(g_off.spheres.mat.diffuse.x).max()) > 0.0


def test_ingraph_packed_sky_fresh_never_stale():
    """Training-path packed sky (VERDICT r4 next #3): combine_scene drops
    the load-time packed twin, and compose_sky rebuilds it IN-GRAPH from
    the live rgb (core.gather.pack_rgba_u8_traced). Three properties:

      1. unmutated u8-exact sky: the in-graph pack equals the host-side
         packer's table and compose_sky's output is bit-identical to the
         packed=<load-time table> run;
      2. mutated (non-u8-exact) sky: validity trips, the f32 gather runs,
         and the output reflects the MUTATED texels — a stale cache is
         structurally impossible;
      3. a mutated-but-still-u8-exact sky (texel codes changed) repacks
         to the NEW table, again never the stale one.
    """
    import numpy as np

    from raytpu.core.gather import pack_rgba_u8_traced
    from raytpu.io.obj import pack_rgba_u8
    from raytpu.materials.texture import compose_sky

    rng = np.random.default_rng(11)
    h, w = 8, 16
    codes = rng.integers(0, 256, (h * w, 3))
    flat = codes.astype(np.float32) * np.float32(1.0 / 255.0)
    host_packed = pack_rgba_u8(
        flat[:, 0], flat[:, 1], flat[:, 2], flat[:, 0]
    )
    packed, valid = jax.jit(pack_rgba_u8_traced)(
        jnp.asarray(flat[:, 0]), jnp.asarray(flat[:, 1]),
        jnp.asarray(flat[:, 2]), jnp.asarray(flat[:, 0]),
    )
    assert bool(valid)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(host_packed))

    # synthetic sky-slot output for compose_sky: every ray an emissive
    # early return pointing somewhere on the sphere
    n = 256
    k = jax.random.PRNGKey(7)
    d = Vec3(*(jax.random.normal(jax.random.fold_in(k, i), (n,))
               for i in range(3)))
    d = d * (1.0 / (d.x**2 + d.y**2 + d.z**2) ** 0.5)
    zero = Vec3.zeros((n,))
    one = Vec3(jnp.ones((n,)), jnp.ones((n,)), jnp.ones((n,)))
    out6 = (zero, zero, zero, one, d, jnp.ones((n,)))
    cfg = RenderConfig(width=8, height=6, spp=1, max_bounces=2)

    def sky_of(arr, packed=None):
        return SkyTexture(
            rgb=Vec3(jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1]),
                     jnp.asarray(arr[:, 2])),
            packed=packed, width=w, height=h,
        )

    def run(sky):
        scene = Scene.from_spheres(spheres_from_rows([
            ((0, 0, 0), 1000.0, BLACK, (1, 1, 1), 1.0, 0.0, 1.0, 1.0),
        ])).replace(sky=sky, sky_sphere_index=0)
        inc, alb, nrm = jax.jit(
            lambda sc: compose_sky(sc, cfg, out6)
        )(scene)
        return np.asarray(inc.to_array())

    base = run(sky_of(flat, packed=jnp.asarray(host_packed)))
    ingraph = run(sky_of(flat, packed=None))       # property 1
    np.testing.assert_array_equal(base, ingraph)

    mutated = flat.copy()
    mutated[:, 0] = mutated[:, 0] * 0.7 + 0.011    # non-u8-exact
    got = run(sky_of(mutated, packed=None))        # property 2
    want = run(sky_of(mutated, packed=pack_rgba_u8(
        mutated[:, 0], mutated[:, 1], mutated[:, 2], mutated[:, 0])))
    # the mutated run must match the exact f32 ground truth...
    truth = run(sky_of(mutated.astype(np.float64).astype(np.float32),
                       packed=None))
    np.testing.assert_allclose(got, truth, rtol=0, atol=0)
    # ...and must NOT equal the stale original anywhere texels changed
    assert np.abs(got - base).max() > 1e-3

    shifted = ((codes + 40) % 256).astype(np.float32) * np.float32(1 / 255.0)
    got3 = run(sky_of(shifted, packed=None))       # property 3
    want3 = run(sky_of(shifted, packed=pack_rgba_u8(
        shifted[:, 0], shifted[:, 1], shifted[:, 2], shifted[:, 0])))
    np.testing.assert_array_equal(got3, want3)
    assert np.abs(got3 - base).max() > 1e-3


def test_sky_texel_grads_match_finite_differences():
    """Sky TEXEL gradients (sky_texture_grads=True) FD-checked on a
    downsampled sky (VERDICT r4 next #7): at fixed RNG the estimator is
    a deterministic function of the texel values, and radiance is
    LINEAR in them (emission scale * texel), so central differences
    must match autodiff tightly. Checks the most-hit texel and one
    unhit texel (grad exactly zero)."""
    import numpy as np

    scene = _sky_scene()
    from raytpu.camera import make_camera

    cam = make_camera(
        origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
        vfov_deg=60.0, aspect_ratio=1.5,
    )
    cfg = RenderConfig(
        width=12, height=8, spp=3, max_bounces=3, sky_texture_grads=True
    )
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(12)

    def loss(rgb_x):
        sky = scene.sky.replace(
            rgb=Vec3(rgb_x, scene.sky.rgb.y, scene.sky.rgb.z)
        )
        sums = render(scene.replace(sky=sky), cam, cfg, pids, key)
        return jnp.sum(sums.radiance.x)

    x0 = scene.sky.rgb.x
    g = np.asarray(jax.grad(loss)(x0))
    assert np.abs(g).max() > 0
    hot = int(np.argmax(np.abs(g)))
    cold = int(np.argmin(np.abs(g)))
    eps = 1e-2
    for t in (hot, cold):
        lp = float(loss(x0.at[t].add(eps)))
        lm = float(loss(x0.at[t].add(-eps)))
        fd = (lp - lm) / (2 * eps)
        np.testing.assert_allclose(
            g[t], fd, rtol=1e-3, atol=1e-5,
            err_msg=f"texel {t}: ad={g[t]} fd={fd}",
        )
