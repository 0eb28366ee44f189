"""Triton megakernel: the whole bounce loop for sphere scenes.

One Pallas program (``backend="triton"``) traces a block of ``BLOCK``
rays through every bounce: closest-sphere search, shading, refraction,
AO probes and light accumulation, with the per-ray state (origin,
direction, throughput, radiance, AOVs, alive mask, medium IOR) kept in
registers. This is the reference CUDA renderer's design — one thread
per pixel running the whole bounce loop (main_cuda.cu:86-171) — where
the XLA scan path (integrator.path.trace) writes that state to device
memory between the several fusions of every bounce.

Semantics mirror integrator.path bounce-for-bounce: AOV base cases,
emissive early return (HSL boost), diffuse/specular lerp, probabilistic
refraction with the reduced pile.h medium scalar, alpha cutout, the
x1.3 double-multiply bright quirk, miss termination. RNG draws are
precomputed outside the kernel with the same threefry streams
(rng.ray_uniforms), so the kernel consumes exactly the scan path's and
the f64 oracle's draws.

The kernel has no derivative rule: ``render()`` differentiates its
kernel route through the scan path (integrator/render.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from raytpu.core.color import hsl_boost
from raytpu.core.types import RenderConfig, Scene
from raytpu.core.vec3 import Vec3, random_unit_vector, reflect, refract
from raytpu.geometry.sphere import sphere_distance_one

# rays per program and warps per program: the fastest of 128/256/512 x
# 2/4/8 in one timing of the flagship forward on an H100 (PERF.md)
BLOCK = 128
NUM_WARPS = 4
MAX_SPHERES = 64   # past this a per-ray linear scan loses to a hierarchy
N_CHAN = 14        # table rows: cx cy cz r | dif3 emi3 estr refl alpha ior


def _closest(tab_ref, n_spheres, o: Vec3, d: Vec3, eps: float):
    """Closest sphere per ray: (distance, index); index -1 on a miss.
    Scalar table loads inside the loop; ties keep the earlier sphere,
    like the reference's strictly-closer scan (main.c:52-92)."""

    def body(s, carry):
        best, bidx = carry
        c = Vec3(tab_ref[0, s], tab_ref[1, s], tab_ref[2, s])
        t = sphere_distance_one(o, d, c, tab_ref[3, s], eps=eps)
        better = t < best
        return jnp.where(better, t, best), jnp.where(better, s, bidx)

    init = (
        jnp.full(o.x.shape, jnp.inf, jnp.float32),
        jnp.full(o.x.shape, -1, jnp.int32),
    )
    return lax.fori_loop(0, n_spheres, body, init)


def _kernel(
    tab_ref,                          # (14, S) sphere/material table
    ox, oy, oz, dx, dy, dz,           # (BLOCK,) ray tiles
    draws_ref,                        # (bounces * n_draws, BLOCK)
    *out_refs,  # (BLOCK,) planes: inc3 alb3 nrm3, + scale3 dir3 early
                # when the sky slot is on
    n_spheres, bounces, n_draws, sky_idx, cfg: RenderConfig,
):
    """Equirect sky (sky_idx >= 0): the kernel records, per ray, ONE
    sky-hit slot — the unit hit direction, the throughput scale the
    texel multiplies and an early-return flag — and
    materials.texture.compose_sky fetches the texel outside. One slot is
    exact under the reference's sky convention (the sky sphere is a pure
    emitter with BLACK diffuse, main.c:331/347, enforced by
    raytpu.config): the first sky interaction either returns early or
    multiplies the throughput by the black diffuse, so every later sky
    event contributes exactly zero."""
    sky = sky_idx >= 0
    ro = Vec3(ox[...], oy[...], oz[...])
    rd = Vec3(dx[...], dy[...], dz[...])
    shape = ro.x.shape
    f0 = jnp.zeros(shape, jnp.float32)
    f1 = jnp.ones(shape, jnp.float32)
    z3 = Vec3(f0, f0, f0)
    ao_scale = cfg.ao_emission_factor * cfg.ao_intensity if cfg.use_ao else 1.0

    st0 = dict(
        ro=ro, rd=rd, rc=Vec3(f1, f1, f1), inc=z3, alb=z3, nrm=z3,
        active=f1, is_alpha=f0,       # masks carried as f32 0/1
        alpha_depth=jnp.zeros(shape, jnp.int32), medium=f1,
    )
    if sky:
        st0.update(skl=z3, skd=z3, early=f0, slot=f0)

    def bounce(i, st):
        ro, rd, rc = st["ro"], st["rd"], st["rc"]
        active = st["active"] > 0.0
        is_alpha = st["is_alpha"] > 0.0
        alpha_depth = st["alpha_depth"]
        draw = lambda k: draws_ref[n_draws * i + k]

        # ---- closest sphere (main.c:52-92) + winner data ------------
        best, bidx = _closest(tab_ref, n_spheres, ro, rd, cfg.sphere_eps)
        did_hit = bidx >= 0
        p = ro + rd * jnp.where(did_hit, best, 0.0)
        w = jnp.maximum(bidx, 0)
        (cx, cy, cz, r, dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha,
         ior) = [jnp.where(did_hit, tab_ref[k, w], 0.0) for k in range(N_CHAN)]
        df = Vec3(dfx, dfy, dfz)
        em = Vec3(emx, emy, emz)
        c = Vec3(cx, cy, cz)
        if sky:
            # the texel fetch runs outside (compose_sky); zero the
            # placeholder emission so the in-kernel sums get nothing
            sky_win = did_hit & (bidx == sky_idx)
            em = Vec3.where(sky_win, z3, em)
            sdir = (p - c) / jnp.where(r > 0.0, r, 1.0)
        # outward normal normalize(p - c) (sphere.h:33,42); zero on a miss
        n = Vec3.where(did_hit, (p - c).normalize(), z3)

        # ---- AOV base cases (main.c:137-150) ------------------------
        aov0 = active & (i == 0)
        alb = Vec3.where(aov0, df, st["alb"])
        nrm = Vec3.where(aov0, n, st["nrm"])
        aov_alpha = active & (i == alpha_depth) & is_alpha
        alb = Vec3.where(aov_alpha, Vec3.where(estr > 0.0, em, df), alb)
        nrm = Vec3.where(aov_alpha, n, nrm)
        is_alpha = is_alpha & ~aov_alpha

        # ---- emissive early return + HSL boost (main.c:154-160) -----
        emissive_ret = active & did_hit & (i == alpha_depth) & (estr > 0.0)
        boosted = hsl_boost(em, cfg.hsl_l_factor, cfg.hsl_s_factor)
        inc = Vec3.where(emissive_ret, boosted, st["inc"])
        alb = Vec3.where(emissive_ret, boosted, alb)
        nrm = Vec3.where(emissive_ret, n, nrm)
        active = active & ~emissive_ret
        live = active & did_hit

        # ---- scatter (main.c:162-165) -------------------------------
        diffuse_dir = (n + random_unit_vector(draw(0), draw(1))).normalize()
        diff_ref = diffuse_dir.lerp(reflect(rd, n), refl)

        # ---- refraction (main.c:167-193, reduced pile.h) ------------
        refr_case = (
            live & (alpha <= cfg.refr_alpha_hi) & (alpha >= cfg.refr_alpha_lo)
        )
        exiting = rd.dot(n) > 0.0
        ne = Vec3.where(exiting, -n, n)
        medium = st["medium"]
        n1 = jnp.where(exiting, ior, medium)
        n2 = jnp.where(exiting, medium, ior)
        medium = jnp.where(refr_case & ~exiting, ior, medium)
        refr_dir = refract(rd, ne, n1, n2)
        do_refract = refr_case & (draw(2) > alpha)

        # ---- opaque / cutout (main.c:195-206) -----------------------
        cutout = live & (alpha < cfg.refr_alpha_lo)
        opaque = live & (alpha > cfg.refr_alpha_hi)
        is_alpha = jnp.where(opaque, False, is_alpha)
        is_alpha = jnp.where(cutout, True, is_alpha)
        alpha_depth = jnp.where(cutout, alpha_depth + 1, alpha_depth)
        use_dr = live & ~do_refract & ~cutout
        ro_new = Vec3.where(live, p, ro)
        rd_new = Vec3.where(do_refract, refr_dir, Vec3.where(use_dr, diff_ref, rd))

        # ---- accumulate (main.c:208-234) ----------------------------
        accum = live & ~do_refract & ~cutout
        e_scale = estr * ao_scale
        new = dict()
        if sky:
            # the first sky interaction takes the slot: an early return
            # (scale 1, boosted outside) or an accumulation (scale =
            # e_scale * rc, what the zeroed placeholder would have had)
            free = st["slot"] == 0.0
            take_e = emissive_ret & sky_win & free
            take_a = accum & sky_win & free
            take = take_e | take_a
            sc = rc * e_scale
            new["skl"] = Vec3.where(
                take_e, Vec3(f1, f1, f1), Vec3.where(take_a, sc, st["skl"])
            )
            new["skd"] = Vec3.where(take, sdir, st["skd"])
            new["early"] = jnp.where(take_e, f1, st["early"])
            new["slot"] = jnp.where(take, f1, st["slot"])
        inc = Vec3.where(accum, inc + em * e_scale * rc, inc)
        t = cfg.bright_threshold
        bright = (rc.x > t) | (rc.y > t) | (rc.z > t)
        rc_new = Vec3.where(
            bright, df * (df * (rc * cfg.bright_boost)), df * rc
        )
        if cfg.use_ao:
            # hemisphere occlusion probes (main.c:94-116)
            occ = f0
            for s in range(cfg.ao_samples):
                k = 3 + 2 * s
                ao_dir = (n + random_unit_vector(draw(k), draw(k + 1))).normalize()
                _, occ_idx = _closest(tab_ref, n_spheres, p, ao_dir, cfg.sphere_eps)
                occ = occ + jnp.where(occ_idx >= 0, 1.0, 0.0)
            rc_new = rc_new * (occ / (cfg.ao_samples * cfg.ao_intensity))
        rc = Vec3.where(accum, rc_new, rc)

        new.update(
            ro=ro_new, rd=rd_new, rc=rc, inc=inc, alb=alb, nrm=nrm,
            active=jnp.where(active & did_hit, f1, f0),
            is_alpha=jnp.where(is_alpha, f1, f0),
            alpha_depth=alpha_depth, medium=medium,
        )
        return new

    st = lax.fori_loop(0, bounces, bounce, st0)
    outs = [*st["inc"], *st["alb"], *st["nrm"]]
    if sky:
        outs += [*st["skl"], *st["skd"], st["early"]]
    for ref, val in zip(out_refs, outs, strict=True):
        ref[...] = val


def _trace_call(tab, rays, draws, *, n_spheres, bounces, n_draws, sky_idx,
                cfg, interpret):
    n = rays[0].shape[0]
    n_out = 16 if sky_idx >= 0 else 9
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    kernel = functools.partial(
        _kernel, n_spheres=n_spheres, bounces=bounces, n_draws=n_draws,
        sky_idx=sky_idx, cfg=cfg,
    )
    return pl.pallas_call(
        kernel,
        grid=(n // BLOCK,),
        in_specs=[pl.BlockSpec(tab.shape, lambda i: (0, 0))]
        + [ray_spec] * 6
        + [pl.BlockSpec((draws.shape[0], BLOCK), lambda i: (0, i))],
        out_specs=[ray_spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * n_out,
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        backend="triton",
        interpret=interpret,
        name="trace_spheres",
    )(tab, *rays, draws)


def supported(scene: Scene) -> bool:
    """Sphere-only scenes of up to MAX_SPHERES spheres (AO, DoF, HSL
    boost, refraction, cutout and the equirect sky included)."""
    return not unsupported_reasons(scene)


def unsupported_reasons(scene: Scene) -> list[str]:
    """Why ``supported`` fails, for render()'s one-line log."""
    r = []
    if scene.triangles.count != 0:
        r.append("scene has triangles")
    if scene.spheres.count == 0:
        r.append("no spheres")
    if scene.spheres.count > MAX_SPHERES:
        r.append(f"{scene.spheres.count} spheres > {MAX_SPHERES}")
    if scene.sky_sphere_index >= scene.spheres.count:
        r.append("sky_sphere_index out of range")
    return r


def _sky_idx(scene: Scene) -> int:
    """Index of the textured sky sphere, or -1 (sky slot compiled out)."""
    on = scene.sky_sphere_index >= 0 and scene.sky.rgb.x.shape[0] > 0
    return scene.sky_sphere_index if on else -1


def _forward(scene, cfg, origin, direction, bounce_draws, interpret):
    """Pad the ray batch to a multiple of BLOCK, run the kernel, unpad.
    Returns the 9 (or, with the sky slot, 16) output planes."""
    b = origin.x.shape[0]
    pad = -b % BLOCK
    rays = [jnp.pad(c, (0, pad)) for c in (*origin, *direction)]
    m = scene.spheres.mat
    tab = jnp.stack([
        *scene.spheres.center, scene.spheres.radius,
        *m.diffuse, *m.emission, m.emission_strength, m.reflection,
        m.alpha, m.ior,
    ])
    bn, nd = bounce_draws.shape[:2]
    draws = jnp.pad(bounce_draws.reshape(bn * nd, b), ((0, 0), (0, pad)))
    out = _trace_call(
        tab, rays, draws, n_spheres=scene.spheres.count, bounces=bn,
        n_draws=nd, sky_idx=_sky_idx(scene), cfg=cfg, interpret=interpret,
    )
    return [o[:b] for o in out]


def _compose(scene, cfg, planes):
    """Output planes -> (radiance, albedo, normal), fetching the sky
    texel outside the kernel when the sky slot is on."""
    from raytpu.materials.texture import compose_sky

    v = [Vec3(*planes[k : k + 3]) for k in range(0, len(planes) - 1, 3)]
    if len(planes) == 9:
        return v[0], v[1], v[2]
    return compose_sky(scene, cfg, (v[0], v[1], v[2], v[3], v[4], planes[15]))


def trace_megakernel(
    scene: Scene,
    cfg: RenderConfig,
    origin: Vec3,
    direction: Vec3,
    bounce_draws: Array,
    interpret: bool = False,
) -> tuple[Vec3, Vec3, Vec3]:
    """Drop-in for integrator.path.trace on ``supported`` scenes (forward
    only). ``interpret=True`` runs the kernel in the Pallas interpreter
    (CPU tests)."""
    planes = _forward(scene, cfg, origin, direction, bounce_draws, interpret)
    return _compose(scene, cfg, planes)
