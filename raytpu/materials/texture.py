"""Texture sampling and material resolution.

Vectorizes tri_uvmapping (/root/reference/texture.h:44-89) and
sphere_uvmapping (texture.h:92-112): barycentric UV interpolation with
fmod wrap, nearest-texel fetch from the flat atlas
(index = y*W + x + W*H*mat_id), and the per-material-id physics table
(the reference hardcodes ids 1/3/4, texture.h:71-88; here it's the
scene's MatTable).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from raytpu.core.gather import (
    ROW_LIMIT, gather1d, gather_channels, take_packed_rgba,
)
from raytpu.core.types import MatTable, Materials, SkyTexture, TextureAtlas
from raytpu.core.vec3 import Vec3
from raytpu.geometry.triangle import barycentric


def wrap_uv(u: Array) -> Array:
    """fmod wrap to [0, 1) with negative correction (texture.h:53-60).
    C fmod truncates toward zero; jnp.fmod matches."""
    u = jnp.fmod(u, 1.0)
    return jnp.where(u < 0.0, u + 1.0, u)


def atlas_fetch(
    atlas: TextureAtlas, mat_id: Array, u: Array, v: Array
) -> tuple[Vec3, Array]:
    """Nearest-texel fetch (texture.h:61-69). Returns (rgb, alpha) per ray.

    x = trunc(u * W), y = trunc(v * H); after wrapping u, v are in [0, 1)
    so truncation == floor; clamped defensively for u == 1.0 edge cases
    introduced by f32 rounding.
    """
    w, h = atlas.width, atlas.height
    x = jnp.clip(jnp.floor(u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.floor(v * h).astype(jnp.int32), 0, h - 1)
    idx = (y * w + x) + (h * w) * mat_id
    n_tex = atlas.alpha.shape[0]
    if atlas.packed is not None and n_tex > ROW_LIMIT:
        # huge atlases: u8-packed uint32 row-gather (bit-exact, 4x
        # fewer bytes — keeps the table in the fast gather regime; the
        # f32 layout-3 path degrades ~25x once the table exceeds VMEM)
        r, g, b, alpha = take_packed_rgba(
            atlas.rgb.x, atlas.rgb.y, atlas.rgb.z, atlas.alpha,
            atlas.packed, idx,
        )
    else:
        r, g, b, alpha = gather_channels(
            [atlas.rgb.x, atlas.rgb.y, atlas.rgb.z, atlas.alpha], idx
        )
    return Vec3(r, g, b), alpha


def atlas_fetch_bilinear(
    atlas: TextureAtlas, mat_id: Array, u: Array, v: Array
) -> tuple[Vec3, Array]:
    """Bilinear texel filtering with wrap addressing.

    NOT a reference behavior (the reference is nearest-only) — this is
    the differentiable-rendering mode (cfg.bilinear_textures): with
    nearest sampling, radiance is piecewise-constant in every geometric
    parameter (hit point -> texel id is a step function), so vertex /
    camera / sphere-position gradients are zero almost everywhere.
    Bilinear makes UV -> color continuous, giving useful gradients
    through the hit-point -> barycentric -> UV chain.
    """
    w, h = atlas.width, atlas.height
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    x1i = jnp.mod(x0i + 1, w)
    y1i = jnp.mod(y0i + 1, h)
    base = (h * w) * mat_id

    # one concatenated gather for all four corners (one row-gather
    # forward, one VJP scan backward) instead of four separate ones
    bsz = u.shape[0]
    idx4 = jnp.concatenate([
        base + y0i * w + x0i,
        base + y0i * w + x1i,
        base + y1i * w + x0i,
        base + y1i * w + x1i,
    ])
    r4, g4, b4 = gather_channels(
        [atlas.rgb.x, atlas.rgb.y, atlas.rgb.z], idx4
    )
    corners = [
        Vec3(r4[k * bsz : (k + 1) * bsz], g4[k * bsz : (k + 1) * bsz],
             b4[k * bsz : (k + 1) * bsz])
        for k in range(4)
    ]
    c00, c10, c01, c11 = corners
    w00 = (1 - tx) * (1 - ty)
    w10 = tx * (1 - ty)
    w01 = (1 - tx) * ty
    w11 = tx * ty
    rgb = c00 * w00 + c10 * w10 + c01 * w01 + c11 * w11
    # alpha stays NEAREST: interpolated alphas at binary-cutout texel
    # edges would fall into the refraction window [1e-4, 0.99] and flip
    # the shading branch (path.py); the mode only filters COLOR
    _, alpha = atlas_fetch(atlas, mat_id, u, v)
    return rgb, alpha


def triangle_material(
    tri_a: Vec3,
    tri_b: Vec3,
    tri_c: Vec3,
    uv_a: tuple[Array, Array],
    uv_b: tuple[Array, Array],
    uv_c: tuple[Array, Array],
    normal: Vec3,
    hit_point: Vec3,
    mat_id: Array,
    atlas: TextureAtlas,
    table: MatTable,
    bilinear: bool = False,
) -> Materials:
    """tri_uvmapping (texture.h:44-89) for a batch of per-ray winning
    triangles (already gathered to (B,) shapes). ``bilinear`` switches
    the differentiable filtering mode (atlas_fetch_bilinear)."""
    w_a, w_b, w_c = barycentric(tri_a, tri_b, tri_c, normal, hit_point)
    u = wrap_uv(w_a * uv_a[0] + w_b * uv_b[0] + w_c * uv_c[0])
    v = wrap_uv(w_a * uv_a[1] + w_b * uv_b[1] + w_c * uv_c[1])

    if atlas.count > 0:
        fetch = atlas_fetch_bilinear if bilinear else atlas_fetch
        rgb, tex_alpha = fetch(atlas, mat_id, u, v)
    else:
        # Mesh without textures: the reference assigns a constant default
        # material (SKY diffuse, mesh.h:207) when no atlas is present.
        rgb = Vec3.full(mat_id.shape, 0.784, 0.965, 1.0)
        tex_alpha = jnp.ones(mat_id.shape, jnp.float32)

    # ONE row-gather for all 8-9 material-table channels
    t_chans = [
        table.emission.x, table.emission.y, table.emission.z,
        table.emission_strength, table.reflection, table.ior,
        table.alpha_const, table.use_alpha_const,
    ]
    has_eft = table.emission_from_texture is not None
    if has_eft:
        t_chans.append(table.emission_from_texture)
    g = gather_channels(t_chans, mat_id)
    emission = Vec3(g[0], g[1], g[2])
    if has_eft:
        # texture-modulated emission (superset flag; see MatTable)
        emission = Vec3.where(g[8], emission * rgb, emission)
    emission_strength, reflection, ior = g[3], g[4], g[5]
    alpha = jnp.where(g[7], g[6], tex_alpha)

    return Materials(
        diffuse=rgb,
        emission=emission,
        emission_strength=emission_strength,
        reflection=reflection,
        alpha=alpha,
        ior=ior,
    )


def checker_value(c1: Vec3, c2: Vec3, scale, p: Vec3) -> Vec3:
    """Procedural checker (checker_texture_value,
    /root/reference/texture.h:8-14): floor(p/scale) parity over x+y+z.
    Unused by the reference's shipped scenes but part of its surface."""
    x = jnp.floor(p.x / scale).astype(jnp.int32)
    y = jnp.floor(p.y / scale).astype(jnp.int32)
    z = jnp.floor(p.z / scale).astype(jnp.int32)
    even = (x + y + z) % 2 == 0
    return Vec3.where(even, c1, c2)


def sky_texel_index(d: Vec3, w: int, h: int) -> Array:
    """Equirect direction -> flat texel index (sphere_uvmapping,
    texture.h:92-112): theta = acos(-d.y); phi = atan2(-d.z, d.x) + pi;
    u = phi/2pi, v = theta/pi; nearest texel.

    THE single copy of the UV chain: the scan path (sky_emission) and
    the megakernel's outside composition (compose_sky) call it, which is
    what makes their texel indices bit-identical — do not fork it."""
    theta = jnp.arccos(jnp.clip(-d.y, -1.0, 1.0))
    phi = jnp.arctan2(-d.z, d.x) + jnp.pi
    u = phi / (2.0 * jnp.pi)
    v = theta / jnp.pi
    x = jnp.clip(jnp.floor(u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.floor(v * h).astype(jnp.int32), 0, h - 1)
    return y * w + x


def sky_emission(
    sky: SkyTexture, hit_point: Vec3, center: Vec3, radius: Array,
    use_packed: bool = False,
) -> Vec3:
    """Equirect sphere UV fetch (sphere_uvmapping, texture.h:92-112):
    d = (p - c)/r, then sky_texel_index.

    use_packed: fetch through the u8-packed uint32 table when the sky
    carries one — bit-identical values (load_sky builds it only when
    every texel is exactly n * f32(1/255)) at a quarter of the gather
    bytes; callers enable it when sky TEXEL gradients are off."""
    d = (hit_point - center) / radius
    idx = sky_texel_index(d, sky.width, sky.height)
    if use_packed and sky.packed is not None:
        from raytpu.core.gather import take_packed_rgba

        r, g, b, _ = take_packed_rgba(
            sky.rgb.x, sky.rgb.y, sky.rgb.z, sky.rgb.x, sky.packed, idx
        )
        return Vec3(r, g, b)
    return sky.rgb.take(idx)


def compose_sky(scene, cfg, out6) -> tuple[Vec3, Vec3, Vec3]:
    """Sky-slot composition for the sphere megakernel
    (kernels/trace_spheres), whose kernel records the sky hit instead of
    fetching the texel. ``out6`` = (inc, alb, nrm, scale Vec3, unit hit
    direction Vec3, early flag). The UV chain is sky_texel_index, so
    texel indices are bit-identical to the scan path's sky_emission.
    Miss lanes carry direction (0,0,0): they gather SOME texel but their
    scale and early flag are 0, so the value is discarded exactly."""
    from raytpu.core.color import hsl_boost
    from raytpu.core.gather import pack_rgba_u8_traced

    inc, alb, nrm, skl, sdir, early_p = out6
    sky = scene.sky
    idx = sky_texel_index(sdir, sky.width, sky.height)
    if not cfg.sky_texture_grads:
        # gradients stop at the texels (the scan path's stop_gradient in
        # integrator/hit.py)
        sr, sg_, sb = (jax.lax.stop_gradient(c) for c in sky.rgb)
        if sky.packed is not None:
            # u8-packed fetch: bit-identical values at a quarter of the
            # bytes (SkyTexture.packed)
            r, g, b, _ = take_packed_rgba(sr, sg_, sb, sr, sky.packed, idx)
        else:
            # training path: combine_scene dropped the packed twin so a
            # stale table can never be rendered; rebuild it in-graph from
            # the LIVE rgb — unmutated u8-exact skies keep the packed
            # fetch bit-exactly, mutated ones fail the exactness check
            # and lax.cond takes the f32 gather (tests/test_sky.py).
            packed, valid = pack_rgba_u8_traced(sr, sg_, sb, sr)

            def _fast(_):
                r, g, b, _a = take_packed_rgba(sr, sg_, sb, sr, packed, idx)
                return r, g, b

            def _slow(_):
                return tuple(gather_channels([sr, sg_, sb], idx))

            r, g, b = jax.lax.cond(valid, _fast, _slow, 0)
    else:
        r, g, b = gather_channels(list(sky.rgb), idx)
    sky_rgb = Vec3(r, g, b)
    early = early_p > 0.0
    boosted = hsl_boost(sky_rgb, cfg.hsl_l_factor, cfg.hsl_s_factor)
    inc = Vec3.where(early, boosted, inc + sky_rgb * skl)
    alb = Vec3.where(early, boosted, alb)
    return inc, alb, nrm
