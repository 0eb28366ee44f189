"""Closest-hit resolution over spheres + triangles.

The branchless reformulation of closest_hit (/root/reference/main.c:52-92):
the reference linearly scans spheres then triangles keeping the strictly
closer hit (so on exact ties the earlier primitive wins, and spheres beat
triangles). Here each primitive class produces a (B, rays x prims)
distance matrix whose argmin (first-min, matching the scan's tie-break)
selects the winner; material/normal/UV data is then gathered only for the
winning primitive per ray — unlike the reference, which runs
tri_uvmapping for every progressively-closer triangle (main.c:86).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from raytpu.core.gather import gather_channels
from raytpu.core.types import Materials, RenderConfig, Scene
from raytpu.core.vec3 import Vec3
from raytpu.geometry.sphere import (
    sphere_distance_one,
    sphere_distances,
    sphere_normal,
)
from raytpu.geometry.triangle import (
    TriangleGeom,
    precompute,
    triangle_distance_one,
    triangle_distances,
)
from raytpu.materials.texture import sky_emission, triangle_material


class Hit(NamedTuple):
    did_hit: Array   # (B,) bool
    dst: Array       # (B,) distance (inf on miss)
    point: Vec3      # (B,)
    normal: Vec3     # (B,) geometric normal (un-flipped, like the reference)
    mat: Materials   # (B,)


def closest_hit(
    scene: Scene,
    geom: Optional[TriangleGeom],
    origin: Vec3,
    direction: Vec3,
    cfg: RenderConfig,
    with_material: bool = True,
) -> Hit:
    """Vectorized closest_hit (main.c:52-92). ``geom`` is the precomputed
    triangle bundle (pass None to compute on the fly)."""
    b = origin.x.shape[0]
    n_spheres = scene.spheres.count
    n_tris = scene.triangles.count
    inf = jnp.full((b,), jnp.inf, jnp.float32)

    # Winner SELECTION runs under stop_gradient (argmin/min over the
    # (B, prims) matrices carries no useful gradient and would otherwise
    # force XLA to keep the whole matrix as a backward residual); the
    # winner's distance is then RECOMPUTED elementwise from the gathered
    # primitive, which is bitwise the same value in f32 and fully
    # differentiable w.r.t. ray + primitive parameters.
    sg = jax.lax.stop_gradient
    o_sg, d_sg = jax.tree.map(sg, (origin, direction))

    if n_tris > 0 and geom is None:
        geom = precompute(scene.triangles)

    # (B, prims) distances + first-occurrence argmin (ties resolve to the
    # earlier primitive, like the reference's scan). Only the ARGMIN is
    # reduced — the winning distances come from the recompute below, so
    # no min pass is needed. XLA fuses the distances into the argmin
    # reduction: the (B, prims) matrix is never materialized (PERF.md).
    if n_spheres > 0:
        s_dists = sphere_distances(
            o_sg, d_sg, sg(scene.spheres.center), sg(scene.spheres.radius),
            eps=cfg.sphere_eps,
        )
        s_idx = jnp.argmin(s_dists, axis=1)
    else:
        s_idx = jnp.zeros((b,), jnp.int32)
    if n_tris > 0:
        t_dists = triangle_distances(
            o_sg, d_sg, jax.tree.map(sg, geom),
            det_eps=cfg.tri_det_eps, eps=cfg.tri_eps,
        )
        t_idx = jnp.argmin(t_dists, axis=1)
    else:
        t_idx = jnp.zeros((b,), jnp.int32)

    # --- differentiable recompute of the winner's distance -------------
    if n_spheres > 0:
        # one gather for EVERY sphere winner channel (center, radius
        # and, when shading, the 10 material channels)
        sph = scene.spheres
        s_chans = [sph.center.x, sph.center.y, sph.center.z, sph.radius]
        if with_material:
            sm = sph.mat
            s_chans += [
                sm.diffuse.x, sm.diffuse.y, sm.diffuse.z,
                sm.emission.x, sm.emission.y, sm.emission.z,
                sm.emission_strength, sm.reflection, sm.alpha, sm.ior,
            ]
        sg_ = gather_channels(s_chans, s_idx)
        centers = Vec3(sg_[0], sg_[1], sg_[2])
        radii = sg_[3]
        s_t = sphere_distance_one(
            origin, direction, centers, radii, eps=cfg.sphere_eps
        )
    else:
        s_t = inf
    if n_tris > 0:
        # ALL per-triangle data the bounce needs, in ONE row-gather
        # (gather_channels packs the channels into an (T, 128) table)
        tris = scene.triangles
        chans = [
            geom.a.x, geom.a.y, geom.a.z,
            geom.edge_ab.x, geom.edge_ab.y, geom.edge_ab.z,
            geom.edge_ac.x, geom.edge_ac.y, geom.edge_ac.z,
            geom.normal_raw.x, geom.normal_raw.y, geom.normal_raw.z,
        ]
        if with_material:
            chans += [
                tris.b.x, tris.b.y, tris.b.z,
                tris.c.x, tris.c.y, tris.c.z,
                tris.ua, tris.va, tris.ub, tris.vb, tris.uc, tris.vc,
                tris.mat_id,
            ]
        g = gather_channels(chans, t_idx)
        win_a = Vec3(g[0], g[1], g[2])
        win_ab = Vec3(g[3], g[4], g[5])
        win_ac = Vec3(g[6], g[7], g[8])
        win_nraw = Vec3(g[9], g[10], g[11])
        t_t = triangle_distance_one(
            origin, direction, win_a, win_ab, win_ac, win_nraw,
            det_eps=cfg.tri_det_eps, eps=cfg.tri_eps,
        )
    else:
        t_t = inf

    # spheres scanned first; triangle wins only on strictly smaller dst
    # (main.c:52-92 tie-break), judged on the recomputed values (bitwise
    # equal to the matrix entries)
    tri_wins = t_t < s_t
    found = jnp.isfinite(jnp.where(tri_wins, t_t, s_t))

    dst = jnp.where(found, jnp.where(tri_wins, t_t, s_t), jnp.inf)
    did_hit = jnp.isfinite(dst)
    safe_dst = jnp.where(did_hit, dst, 0.0)
    point = origin + direction * safe_dst

    if not with_material:
        zero = Vec3.zeros((b,))
        return Hit(did_hit, dst, point, zero, Materials.zeros((b,)))

    # --- gather winner data -------------------------------------------
    normal = Vec3.zeros((b,))
    mat = Materials.zeros((b,))

    if n_spheres > 0:
        n_s = sphere_normal(point, centers)
        m_s = Materials(
            Vec3(sg_[4], sg_[5], sg_[6]), Vec3(sg_[7], sg_[8], sg_[9]),
            sg_[10], sg_[11], sg_[12], sg_[13],
        )
        if scene.sky_sphere_index >= 0 and scene.sky.rgb.x.shape[0] > 0:
            # textured sky emission (sphere_uvmapping path, texture.h:92-112;
            # commented out in main.c:64-71 — enabled via sky_sphere_index)
            sky_rgb = sky_emission(
                scene.sky, point, centers, radii,
                use_packed=not cfg.sky_texture_grads,
            )
            if not cfg.sky_texture_grads:
                # sky TEXEL cotangents cost a 262k-row segment-sum per
                # bounce per sample at production sky sizes (4096x2048)
                # — opt-in via cfg; every other sky-scene gradient
                # (geometry, materials, camera) is unaffected
                sky_rgb = Vec3(
                    jax.lax.stop_gradient(sky_rgb.x),
                    jax.lax.stop_gradient(sky_rgb.y),
                    jax.lax.stop_gradient(sky_rgb.z),
                )
            is_sky = s_idx == scene.sky_sphere_index
            m_s = m_s.replace(emission=Vec3.where(is_sky, sky_rgb, m_s.emission))
        sphere_sel = did_hit & ~tri_wins
        normal = Vec3.where(sphere_sel, n_s, normal)
        mat = Materials.where(sphere_sel, m_s, mat)

    if n_tris > 0:
        # channels gathered above; normalize(normal_raw) is bitwise the
        # same as gathering the precomputed unit normal
        n_t = win_nraw.normalize()
        m_t = triangle_material(
            win_a, Vec3(g[12], g[13], g[14]), Vec3(g[15], g[16], g[17]),
            (g[18], g[19]), (g[20], g[21]), (g[22], g[23]),
            n_t, point,
            g[24],
            scene.atlas, scene.mat_table,
            bilinear=cfg.bilinear_textures,
        )
        tri_sel = did_hit & tri_wins
        normal = Vec3.where(tri_sel, n_t, normal)
        mat = Materials.where(tri_sel, m_t, mat)

    return Hit(did_hit, dst, point, normal, mat)


def any_hit(
    scene: Scene,
    geom: Optional[TriangleGeom],
    origin: Vec3,
    direction: Vec3,
    cfg: RenderConfig,
) -> Array:
    """Occlusion query: did the ray hit anything? Used by the AO estimator
    (ambient_occlusion, main.c:94-116), which only consumes didHit since
    attenuation = (distance/dst)^I == 1 for normalized directions.

    The result is a non-differentiable boolean, so unlike closest_hit no
    argmin, winner gather, or differentiable recompute is needed — just
    an any-reduce over the masked distances."""
    b = origin.x.shape[0]
    sg = jax.lax.stop_gradient
    o_sg, d_sg = jax.tree.map(sg, (origin, direction))
    if scene.triangles.count > 0 and geom is None:
        geom = precompute(scene.triangles)

    found = jnp.zeros((b,), bool)
    if scene.spheres.count > 0:
        s_dists = sphere_distances(
            o_sg, d_sg, sg(scene.spheres.center), sg(scene.spheres.radius),
            eps=cfg.sphere_eps,
        )
        found = found | jnp.isfinite(s_dists).any(axis=1)
    if scene.triangles.count > 0:
        t_dists = triangle_distances(
            o_sg, d_sg, jax.tree.map(sg, geom),
            det_eps=cfg.tri_det_eps, eps=cfg.tri_eps,
        )
        found = found | jnp.isfinite(t_dists).any(axis=1)
    return found
