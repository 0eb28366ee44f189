"""The scan path on a synthetic textured-quads scene vs the f64 oracle
(tests/oracle.py) at equal RNG: textured triangles, a per-id material
table with refraction, cutout and texture-modulated emission, and
spheres mixed in — every branch of the bounce in one scene, with no
asset files."""

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.camera import make_camera
from raytpu.core.types import (
    MatTable, RenderConfig, Scene, SkyTexture, TextureAtlas, Triangles,
)
from raytpu.core.vec3 import Vec3
from raytpu.integrator.render import render
from raytpu.scenes import spheres_from_rows

from tests.oracle import render_oracle


def _synthetic_textured_scene():
    """Two textured quads (4 tris, 2 materials, 8x8 atlas) + ground/sun/
    sky spheres. Material 1 is emissive with texture-modulated emission;
    the atlas alpha plane includes cutout (0), refractive-window (0.5)
    and opaque (1) texels."""
    rng = np.random.default_rng(7)
    w = h = 8
    rgb = rng.random((2 * h * w, 3), np.float32)
    alpha = rng.choice(
        np.float32([0.0, 0.5, 1.0]), size=2 * h * w, p=[0.2, 0.2, 0.6]
    )

    def quad(x0, z0, mat):
        # two triangles spanning [x0,x0+1]x[z0,z0+1] at y=0.5/0.0
        a = [(x0, 0.0, z0), (x0, 0.5, z0 + 1), (x0 + 1, 0.0, z0)]
        b = [(x0 + 1, 0.5, z0 + 1), (x0 + 1, 0.0, z0), (x0, 0.5, z0 + 1)]
        uv = [(0, 0), (0, 1), (1, 0)], [(1, 1), (1, 0), (0, 1)]
        return [a, b], uv, [mat, mat]

    tris, uvs, mats = [], [], []
    for verts, uv, mm in (quad(-1.0, -2.5, 0), quad(0.2, -2.0, 1)):
        tris += verts
        uvs += list(uv)
        mats += mm
    t = np.float32(tris)          # (4, 3, 3)
    u = np.float32(uvs)           # (4, 3, 2)
    v3 = lambda a: Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                        jnp.asarray(a[:, 2]))
    triangles = Triangles(
        a=v3(t[:, 0]), b=v3(t[:, 1]), c=v3(t[:, 2]),
        ua=jnp.asarray(u[:, 0, 0]), va=jnp.asarray(u[:, 0, 1]),
        ub=jnp.asarray(u[:, 1, 0]), vb=jnp.asarray(u[:, 1, 1]),
        uc=jnp.asarray(u[:, 2, 0]), vc=jnp.asarray(u[:, 2, 1]),
        mat_id=jnp.asarray(mats, jnp.int32),
    )
    atlas = TextureAtlas(
        rgb=Vec3(jnp.asarray(rgb[:, 0]), jnp.asarray(rgb[:, 1]),
                 jnp.asarray(rgb[:, 2])),
        alpha=jnp.asarray(alpha), width=w, height=h,
    )
    table = MatTable(
        emission=Vec3(jnp.float32([0, 1]), jnp.float32([0, 1]),
                      jnp.float32([0, 0.8])),
        emission_strength=jnp.float32([0.0, 2.0]),
        reflection=jnp.float32([0.3, 0.0]),
        ior=jnp.float32([1.33, 1.0]),
        alpha_const=jnp.float32([1.0, 1.0]),
        use_alpha_const=jnp.asarray([False, False]),
        emission_from_texture=jnp.asarray([False, True]),
    )
    rows = [
        ((0, -501, 0), 500.0, (0.8, 0.8, 0.75), (0, 0, 0), 0.0, 0.0, 1.0, 1.0),
        ((4, 6, 2), 1.0, (0, 0, 0), (1, 1, 1), 20.0, 0.0, 1.0, 1.0),
        ((0, 0, 0), 1e4, (0, 0, 0), (0.784, 0.965, 1.0), 1.0, 0.0, 1.0, 1.0),
    ]
    scene = Scene(
        spheres=spheres_from_rows(rows), triangles=triangles, atlas=atlas,
        mat_table=table, sky=SkyTexture.empty(), sky_sphere_index=-1,
    )
    cam = make_camera(
        origin=(0.3, 0.8, 1.5), target=(0, 0.2, -2), up=(0, 1, 0),
        vfov_deg=55.0, aspect_ratio=1.5,
    )
    return scene, cam


def test_synthetic_textured_scene_matches_oracle():
    scene, cam = _synthetic_textured_scene()
    cfg = RenderConfig(width=14, height=10, spp=4, max_bounces=5)
    key = jax.random.PRNGKey(50)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    sums = render(scene, cam, cfg, pids, key)
    want_rad, want_alb, _ = render_oracle(scene, cam, cfg, key)
    for got, want in ((sums.radiance, want_rad), (sums.albedo, want_alb)):
        got = np.asarray(got.to_array(), np.float64)
        err = np.abs(got - want)
        tol = 0.02 * cfg.spp + 0.02 * np.abs(want)
        bad = (err > tol).any(axis=-1)
        assert bad.mean() <= 0.05, f"{bad.mean():.1%} out (max {err.max():.3f})"
    # the quads must be visible: texture colour varies across the image
    assert np.asarray(sums.albedo.to_array()).std() > 0.05
