"""Fixed-depth light-transport integrator as a ``lax.scan`` over bounces.

This is the data-parallel reformulation of ``tracer``
(/root/reference/main.c:118-242): the reference's early-exit bounce loop
with per-ray linked-list IOR stack becomes a fixed-depth scan carrying an
alive mask and a fixed-K array stack, so the whole estimate is one traced,
differentiable computation. Reproduced semantics, bounce by bounce:

  * AOV base case (main.c:137-150): first-bounce albedo/normal, with the
    alpha-cutout carry-through (is_alpha / alpha_depth bookkeeping).
  * Emissive early return with HSL boost for primary-visible lights
    (main.c:154-160) — the i == alpha_depth guard means lights seen
    directly or through cutout holes return boosted emission outright.
  * Cosine-ish diffuse via normalize(normal + random_unit) and specular
    lerp by reflectionStrength (main.c:163-165).
  * Probabilistic refraction for alpha in [1e-4, 0.99] with the pile.h
    stack semantics (main.c:167-193): push (current_medium_n2, mat_ior)
    every refractive hit; on exit pop it and swap — including the quirk
    that entries pushed on entry are never popped (the stack leaks) and
    that exits therefore refract with n1 == n2 (straight pass-through).
    A refraction event `continue`s: no light accumulation that bounce.

    NOTE: because every exit pops exactly the pair it just pushed
    (main.c:171-181 always pushes before the exit test), nothing below
    the stack top is ever read again — the linked list is write-only
    except its top. The full (B, K) array stack therefore reduces
    exactly to ONE carried scalar per ray, ``medium_n2`` (= top.n2):
    entry refracts (n1=medium_n2, n2=mat.ior) then sets
    medium_n2 := mat.ior; exit refracts (n1=mat.ior, n2=medium_n2) and
    leaves medium_n2 unchanged. This reproduces pile.h bit-for-bit at a
    fraction of the state and compute.
  * Alpha cutout (< 1e-4): the ray passes through unchanged
    (main.c:200-206), skipping accumulation.
  * Light accumulation with the x1.3 *double-multiply* brightness hack
    (main.c:214-218 and 230-233: when any throughput channel > 0.5,
    rayColor = diffuse * (diffuse * rayColor * 1.3)).
  * Ambient occlusion (main.c:94-116, 208-222): a hemisphere occlusion
    probe whose attenuation is identically 1 when the ray hits (the
    direction is normalized so distance == dst), giving
    occlusion = hits/(samples * AO_intensity); emission is compensated by
    1.5 * AO_intensity (main.c:210).
  * Miss terminates the ray (main.c:236-238).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from raytpu.core import rng
from raytpu.core.color import hsl_boost
from raytpu.core.types import RenderConfig, Scene
from raytpu.core.vec3 import Vec3, random_unit_vector, reflect, refract
from raytpu.geometry.triangle import precompute
from raytpu.integrator.hit import any_hit, closest_hit


class TraceState(NamedTuple):
    origin: Vec3
    direction: Vec3
    ray_color: Vec3      # throughput ("rayColor")
    incoming: Vec3       # accumulated radiance ("incomingLight")
    albedo: Vec3         # denoiser AOV
    normal_aov: Vec3     # denoiser AOV
    active: Array        # (B,) bool — ray still bouncing
    is_alpha: Array      # (B,) bool — last event was a cutout pass-through
    alpha_depth: Array   # (B,) int32
    medium_n2: Array     # (B,) the pile.h stack reduced to its live top.n2


def init_state(origin: Vec3, direction: Vec3) -> TraceState:
    b = origin.x.shape[0]
    zeros = Vec3.zeros((b,))
    return TraceState(
        origin=origin,
        direction=direction,
        ray_color=Vec3.full((b,), 1.0, 1.0, 1.0),
        incoming=zeros,
        albedo=zeros,
        normal_aov=zeros,
        active=jnp.ones((b,), bool),
        is_alpha=jnp.zeros((b,), bool),
        alpha_depth=jnp.zeros((b,), jnp.int32),
        # empiler(n_pile, 1.0, 1.0) (main.c:128-129): start in vacuum/air
        medium_n2=jnp.ones((b,), jnp.float32),
    )


def n_bounce_draws(cfg: RenderConfig) -> int:
    """U(0,1) draws consumed per bounce (diffuse u/v, roulette, AO pairs)."""
    return 3 + 2 * (cfg.ao_samples if cfg.use_ao else 0)


def trace(
    scene: Scene,
    cfg: RenderConfig,
    origin: Vec3,
    direction: Vec3,
    bounce_draws: Array,
) -> tuple[Vec3, Vec3, Vec3]:
    """Estimate (radiance, albedo AOV, normal AOV) for a batch of rays.

    bounce_draws: (max_bounces, n_bounce_draws(cfg), B) U(0,1) draws from
    rng.ray_uniforms — pregenerated in one threefry batch per ray and fed
    to the scan as xs, so the consumption pattern matches the f64 oracle
    exactly.
    """
    geom = precompute(scene.triangles) if scene.triangles.count > 0 else None

    def bounce(state: TraceState, xs) -> tuple[TraceState, None]:
        i, draws = xs  # draws: (n_draws, B)
        hit = closest_hit(scene, geom, state.origin, state.direction, cfg)
        mat = hit.mat
        active = state.active

        # ---- denoiser AOV base cases (main.c:137-150) ----
        aov0 = active & (i == 0)
        albedo = Vec3.where(aov0, mat.diffuse, state.albedo)
        normal_aov = Vec3.where(aov0, hit.normal, state.normal_aov)

        aov_alpha = active & (i == state.alpha_depth) & state.is_alpha
        alb_alpha = Vec3.where(
            mat.emission_strength > 0.0, mat.emission, mat.diffuse
        )
        albedo = Vec3.where(aov_alpha, alb_alpha, albedo)
        normal_aov = Vec3.where(aov_alpha, hit.normal, normal_aov)
        is_alpha = state.is_alpha & ~aov_alpha

        # ---- emissive early return (main.c:154-160) ----
        emissive_ret = (
            active
            & hit.did_hit
            & (i == state.alpha_depth)
            & (mat.emission_strength > 0.0)
        )
        boosted = hsl_boost(mat.emission, cfg.hsl_l_factor, cfg.hsl_s_factor)
        incoming = Vec3.where(emissive_ret, boosted, state.incoming)
        albedo = Vec3.where(emissive_ret, boosted, albedo)
        normal_aov = Vec3.where(emissive_ret, hit.normal, normal_aov)
        active = active & ~emissive_ret

        live = active & hit.did_hit

        # ---- scatter directions (main.c:162-165) ----
        origin_new = Vec3.where(live, hit.point, state.origin)
        diffuse_dir = (hit.normal + random_unit_vector(draws[0], draws[1])).normalize()
        reflected_dir = reflect(state.direction, hit.normal)
        diff_ref_dir = diffuse_dir.lerp(reflected_dir, mat.reflection)

        # ---- refraction branch (main.c:167-193 + pile.h) ----
        refr_case = (
            live & (mat.alpha <= cfg.refr_alpha_hi) & (mat.alpha >= cfg.refr_alpha_lo)
        )
        exiting = state.direction.dot(hit.normal) > 0.0
        normal_eff = Vec3.where(exiting, -hit.normal, hit.normal)

        # pile.h reduced to its live top (see module docstring): entry
        # refracts (medium_n2 -> mat.ior) and enters the new medium; exit
        # refracts (mat.ior -> medium_n2) and stays in the same medium.
        cur_n2 = state.medium_n2
        n1 = jnp.where(exiting, mat.ior, cur_n2)
        n2 = jnp.where(exiting, cur_n2, mat.ior)
        medium_n2 = jnp.where(refr_case & ~exiting, mat.ior, cur_n2)

        refr_dir = refract(state.direction, normal_eff, n1, n2)
        do_refract = refr_case & (draws[2] > mat.alpha)

        # ---- opaque / cutout branches (main.c:195-206) ----
        opaque = live & (mat.alpha > cfg.refr_alpha_hi)
        cutout = live & (mat.alpha < cfg.refr_alpha_lo)
        is_alpha = jnp.where(opaque, False, is_alpha)
        is_alpha = jnp.where(cutout, True, is_alpha)
        alpha_depth = jnp.where(cutout, state.alpha_depth + 1, state.alpha_depth)

        use_diff_ref = live & ~do_refract & ~cutout
        direction_new = Vec3.where(
            do_refract,
            refr_dir,
            Vec3.where(use_diff_ref, diff_ref_dir, state.direction),
        )

        # ---- light accumulation (main.c:208-234) ----
        accum = live & ~do_refract & ~cutout
        if cfg.use_ao:
            emitted = mat.emission * (
                mat.emission_strength * (cfg.ao_emission_factor * cfg.ao_intensity)
            )
        else:
            emitted = mat.emission * mat.emission_strength
        incoming = Vec3.where(
            accum, incoming + emitted * state.ray_color, incoming
        )

        rc = state.ray_color
        bright = (
            (rc.x > cfg.bright_threshold)
            | (rc.y > cfg.bright_threshold)
            | (rc.z > cfg.bright_threshold)
        )
        # main.c:214-218: the bright branch multiplies by diffuse TWICE
        rc_bright = mat.diffuse * (mat.diffuse * (rc * cfg.bright_boost))
        rc_plain = mat.diffuse * rc
        rc_new = Vec3.where(bright, rc_bright, rc_plain)

        if cfg.use_ao:
            occ_sum = jnp.zeros_like(rc.x)
            for s in range(cfg.ao_samples):
                ao_rand = random_unit_vector(draws[3 + 2 * s], draws[4 + 2 * s])
                ao_dir = (hit.normal + ao_rand).normalize()
                occ_hit = any_hit(scene, geom, hit.point, ao_dir, cfg)
                # attenuation = (distance/dst)^AO_intensity == 1 for a
                # normalized direction (main.c:107-109)
                occ_sum = occ_sum + jnp.where(occ_hit, 1.0, 0.0)
            occlusion = occ_sum / (cfg.ao_samples * cfg.ao_intensity)
            rc_new = rc_new * occlusion

        ray_color = Vec3.where(accum, rc_new, rc)

        # ---- miss terminates (main.c:236-238) ----
        active = active & hit.did_hit

        new_state = TraceState(
            origin=origin_new,
            direction=direction_new,
            ray_color=ray_color,
            incoming=incoming,
            albedo=albedo,
            normal_aov=normal_aov,
            active=active,
            is_alpha=is_alpha,
            alpha_depth=alpha_depth,
            medium_n2=medium_n2,
        )
        return new_state, None

    state0 = init_state(origin, direction)
    steps = jnp.arange(cfg.max_bounces, dtype=jnp.int32)
    xs = (steps, bounce_draws)
    final, _ = jax.lax.scan(bounce, state0, xs)
    return final.incoming, final.albedo, final.normal_aov
