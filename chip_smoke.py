"""Chip smoke test: raytpu's render and train paths on one GPU.

Drives the system through its own entry points (``raytpu.cli.main``,
``render``, ``make_train_step``) at full size and checks the results:

  1. device      a GPU is required (exit 1 without one); the card's name
                 and power limit come from nvidia-smi in a child process
  2. compile     the flagship forward step on both routes (Triton sphere
                 megakernel, XLA scan path) and the mesh step
  3. agreement   the compiled kernel vs the scan path (the plain
                 reference) at 1200x900: Cornell, DoF+AO, 19-bounce
                 refraction; then the kernel route's gradients vs the scan path's
  4. timing      flagship forward at 100 spp and forward+backward at
                 50 spp on both routes, in turns; then the full flagship
                 (1200x900, 1000 spp, 6 bounces) through ``cli render``
  5. train       3 inverse-rendering steps at 400x300, 16 spp
  6. mesh        a seeded 606-triangle textured scene with water and
                 glass on the scan path: forward, forward+backward
  7. denoise     bilateral and learned at 1200x900

``--four-cards`` runs only the multi-card path instead: sharded renders
on (1,4) and (2,2) meshes and one sharded train step, each compared
with one card.

Every phase raises on failure; the script exits 0 only if all pass, and
its last line is a JSON object naming the device.

    python chip_smoke.py
    python chip_smoke.py --four-cards
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = dict(width=1200, height=900, max_bounces=6)
# agreement tolerances, kernel vs scan (PERF.md): the two compilers
# contract FMAs differently, so a ray that grazes a sphere or sits on a
# refraction threshold can take the other branch and change its pixel
# by O(1). Each pixel's three channels must agree to PIXEL_RTOL relative
# (floor PIXEL_FLOOR) in this share of pixels, and the image mean to
# MEAN_RTOL.
PIXEL_RTOL = 1e-4
PIXEL_FLOOR = 1e-3
MIN_SHARE = {6: 0.99, 19: 0.97}
MEAN_RTOL = 1e-4
GRAD_RTOL = 1e-4
SHARD_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """'<name>, <power limit>' from nvidia-smi, run in a child process
    that does not touch JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {dev.platform!r})")
    return dev


def flagship_cfg(**kw):
    from raytpu.scenes import cornell_box

    scene, cam, cfg = cornell_box()
    return scene, cam, cfg.replace(**{**FLAGSHIP, **kw})


def forward_fn(cfg, route):
    import jax

    from raytpu.integrator.render import render

    return jax.jit(
        lambda sc, ca, pids, key: render(sc, ca, cfg, pids, key, _route=route)
    )


def loss_and_grad_fn(cfg, route, static, weights=1.0):
    """jit(value_and_grad) of the photometric (L2) loss, with per-pixel
    ``weights`` ((B, 1) or a scalar) applied to the residual."""
    import jax
    import jax.numpy as jnp

    from raytpu.integrator.render import render
    from raytpu.train import combine_scene

    def loss(params, cam, pids, key, target):
        sums = render(combine_scene(params, static), cam, cfg, pids, key,
                      _route=route)
        diff = (sums.radiance.to_array() * (1.0 / cfg.spp) - target) * weights
        return jnp.mean(diff * diff)

    return jax.jit(jax.value_and_grad(loss))


def pixel_ids(cfg):
    import jax.numpy as jnp

    from raytpu.integrator.render import blocked_pixel_order

    return jnp.asarray(blocked_pixel_order(cfg))


def _shape(cfg) -> str:
    return f"{cfg.width}x{cfg.height}x{cfg.spp}spp/{cfg.max_bounces}b"


def compile_timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def median_times(calls: dict, n: int = 5) -> dict:
    """Median seconds per call of each entry of ``calls`` (route ->
    zero-argument function ending in block_until_ready), timed in turns
    ABBA... so drift hits both routes alike."""
    names = list(calls)
    order = (names + names[::-1]) * n
    times = {k: [] for k in names}
    for k in order:
        if len(times[k]) == n:
            continue
        t0 = time.perf_counter()
        calls[k]()
        times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_compile():
    import jax

    scene, cam, cfg = flagship_cfg(spp=100)
    pids = pixel_ids(cfg)
    key = jax.random.PRNGKey(0)
    compiled = {}
    for route in ("scan", "kernel"):
        exe, secs = compile_timed(forward_fn(cfg, route), scene, cam, pids, key)
        compiled[route] = exe
        log(f"compile flagship fwd [{route}] {secs:.1f}s "
            f"memory {exe.memory_analysis()}")
    mscene, mcam, mcfg = mesh_scene(spp=20)
    exe, secs = compile_timed(
        forward_fn(mcfg, "scan"), mscene, mcam, pixel_ids(mcfg), key
    )
    log(f"compile mesh fwd [scan] {secs:.1f}s memory {exe.memory_analysis()}")
    return compiled


def agreement(a, b, tag: str, rtol: float, min_share: float,
              mean_rtol: float) -> np.ndarray:
    """Sums ``b`` vs reference sums ``a`` (RenderSums): the share of
    pixels whose channels agree to ``rtol`` (relative, floor
    PIXEL_FLOOR) must reach ``min_share`` for each AOV, and the mean
    radiance must agree to ``mean_rtol``. Returns the radiance mask of
    agreeing pixels."""
    keep = None
    for name in ("radiance", "albedo", "normal"):
        x = np.asarray(getattr(a, name).to_array(), np.float64)
        y = np.asarray(getattr(b, name).to_array(), np.float64)
        ok = (np.abs(y - x) <= rtol * np.maximum(np.abs(x), PIXEL_FLOOR)).all(-1)
        share = ok.mean()
        mean_rel = abs(y.mean() - x.mean()) / max(abs(x.mean()), 1e-30)
        log(f"agree {tag} {name}: {share:.6f} of pixels within {rtol} rel "
            f"(need >= {min_share}); mean rel diff {mean_rel:.3e} "
            f"(need <= {mean_rtol})")
        if not np.isfinite(y).all():
            raise AssertionError(f"{tag} {name}: output not finite")
        if share < min_share:
            raise AssertionError(f"{tag} {name}: only {share:.4%} of pixels agree")
        if name == "radiance":
            keep = ok
            if mean_rel > mean_rtol:
                raise AssertionError(f"{tag}: image mean differs by {mean_rel:.3e}")
    return keep


def phase_agreement():
    import jax

    from raytpu.config import load_scene

    log(f"tolerances: pixel {PIXEL_RTOL} rel (floor {PIXEL_FLOOR}), "
        f"pixel share {MIN_SHARE} by bounce depth, mean {MEAN_RTOL} rel, "
        f"gradients {GRAD_RTOL} rel (norm)")
    key = jax.random.PRNGKey(7)
    cases = [("cornell", *flagship_cfg(spp=8))]
    for spec in ("scenes/cornell_dof_ao.toml", "scenes/refraction_stack.toml"):
        # both specs are 4:3 like the flagship, so their cameras carry over
        s, c, k = load_scene(spec)
        bounces = k.max_bounces if "refraction" in spec else FLAGSHIP["max_bounces"]
        cases.append((spec, s, c, k.replace(
            width=FLAGSHIP["width"], height=FLAGSHIP["height"], spp=8,
            max_bounces=bounces,
        )))
    for tag, scene, cam, cfg in cases:
        pids = pixel_ids(cfg)
        a = forward_fn(cfg, "scan")(scene, cam, pids, key)
        b = forward_fn(cfg, "kernel")(scene, cam, pids, key)
        agreement(a, b, f"{tag} {_shape(cfg)} kernel vs scan", PIXEL_RTOL,
                  MIN_SHARE[cfg.max_bounces], MEAN_RTOL)
    grad_agreement()


def grads_where_outputs_agree(fns: dict, params, n: int, rtol: float):
    """Gradients of two routes over the rays (or pixels) whose outputs
    agree. Each ``fns[k](params, w)`` returns (loss weighted by ``w``,
    outputs as Vec3s); outputs agree to ``rtol`` (relative, floor 1). A
    ray whose winners differ between two compiled
    programs (a knife-edge flip, see the tolerances above) has other
    gradient terms by construction — even where both winners share a
    colour — so each program runs once with every weight 1, rays whose
    outputs differ get weight 0, and the SAME executables (so the same
    flips) run again with those weights. Returns (keep mask, {k: (loss,
    grads)})."""
    import jax
    import jax.numpy as jnp

    with jax.default_matmul_precision("highest"):
        run = {k: jax.jit(jax.value_and_grad(f, has_aux=True))
               for k, f in fns.items()}
        outs = [r(params, jnp.ones((n,), jnp.float32))[0][1]
                for r in run.values()]
        keep = np.ones((n,), bool)
        for a, b in zip(*outs):
            x = np.asarray(a.to_array(), np.float64)
            y = np.asarray(b.to_array(), np.float64)
            keep &= (np.abs(y - x) <= rtol * np.maximum(np.abs(x), 1.0)).all(-1)
        w = jnp.asarray(keep, jnp.float32)
        res = {}
        for k, r in run.items():
            (loss, _), grads = r(params, w)
            res[k] = (float(loss), grads)
    return keep, res


def compare_grads(ga, gb, rtol: float, tag: str) -> None:
    """Each leaf of ``gb`` within ``rtol`` of ``ga`` in norm (relative
    to the leaf, floored at 1e-6 of the whole gradient's norm)."""
    import jax

    la, lb = jax.tree.leaves(ga), jax.tree.leaves(gb)
    total = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2) for g in la)))
    worst = 0.0
    for a, b in zip(la, lb, strict=True):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if not np.isfinite(b).all():
            raise AssertionError(f"{tag}: gradient not finite")
        err = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-6 * total)
        worst = max(worst, err)
    log(f"{tag}: worst leaf rel diff {worst:.3e} (need <= {rtol}), "
        f"grad norm {total:.4e}")
    if worst > rtol or total == 0.0:
        raise AssertionError(f"{tag}: gradients disagree ({worst:.3e})")


def grad_agreement():
    """Gradients through the kernel route (whose derivative rule is the
    scan path's sample loop) vs jax.grad of the scan route, with float32
    products at full precision."""
    import jax
    import jax.numpy as jnp

    from raytpu.train import partition_scene

    scene, cam, cfg = flagship_cfg(width=64, height=48, spp=4)
    params, static = partition_scene(scene)
    pids = pixel_ids(cfg)
    key = jax.random.PRNGKey(3)
    target = jnp.full((cfg.n_pixels, 3), 0.2, jnp.float32)
    with jax.default_matmul_precision("highest"):
        res = {r: loss_and_grad_fn(cfg, r, static)(params, cam, pids, key, target)
               for r in ("scan", "kernel")}
    log(f"grad {_shape(cfg)}: loss scan {float(res['scan'][0]):.8f} "
        f"kernel {float(res['kernel'][0]):.8f}")
    compare_grads(res["scan"][1], res["kernel"][1], GRAD_RTOL,
                  "grad kernel route vs scan")


def phase_timing(card_line: str, compiled: dict, cli_spp: int = 1000):
    import jax
    import jax.numpy as jnp

    from raytpu.cli import main as cli_main
    from raytpu.train import partition_scene

    scene, cam, cfg = flagship_cfg(spp=100)
    pids = pixel_ids(cfg)
    key = jax.random.PRNGKey(0)
    for exe in compiled.values():
        jax.block_until_ready(exe(scene, cam, pids, key))
    med = median_times({
        r: (lambda e=e: jax.block_until_ready(e(scene, cam, pids, key)))
        for r, e in compiled.items()
    })
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    for r, t in med.items():
        log(f"time flagship fwd {_shape(cfg)} [{r}]: median of 5 "
            f"{t * 1e3:.1f} ms = {rays / t:.4e} rays/s ({card_line})")

    _, _, bcfg = flagship_cfg(spp=50)
    params, static = partition_scene(scene)
    target = jnp.zeros((bcfg.n_pixels, 3), jnp.float32)
    fns = {r: loss_and_grad_fn(bcfg, r, static) for r in ("scan", "kernel")}
    for f in fns.values():
        jax.block_until_ready(f(params, cam, pids, key, target))
    med = median_times({
        r: (lambda f=f: jax.block_until_ready(f(params, cam, pids, key, target)))
        for r, f in fns.items()
    })
    rays = bcfg.n_pixels * bcfg.spp * bcfg.max_bounces
    for r, t in med.items():
        log(f"time flagship fwd+bwd {_shape(bcfg)} [{r}]: median of 5 "
            f"{t * 1e3:.1f} ms = {rays / t:.4e} rays/s ({card_line})")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "flagship.ppm")
        t0 = time.perf_counter()
        rc = cli_main([
            "render", "cornell", "--width", "1200", "--height", "900",
            "--spp", str(cli_spp), "--bounces", "6", "--out", out,
        ])
        secs = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli render returned {rc}")
        from raytpu.io.ppm import read_ppm

        img = read_ppm(out, bottom_up=False)
        if img.shape != (900, 1200, 3) or not 0.02 < img.mean() < 0.98:
            raise AssertionError(f"flagship image {img.shape} mean {img.mean()}")
        log(f"cli render cornell 1200x900x{cli_spp}spp/6b: {secs:.1f}s wall incl. "
            f"compile, image mean {img.mean():.4f} ({card_line})")


def phase_train():
    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.integrator.render import render_image
    from raytpu.train import make_train_step

    scene, cam, cfg = flagship_cfg(width=400, height=300, spp=16)
    m = scene.spheres.mat
    perturbed = scene.replace(spheres=scene.spheres.replace(mat=m.replace(
        diffuse=m.diffuse * 0.8, emission_strength=m.emission_strength * 1.2,
    )))
    tgt = render_image(perturbed, cam, cfg, jax.random.PRNGKey(11))
    # render_image rows are top-down; pixel ids count from the bottom row
    target = jnp.asarray(tgt.image[::-1].reshape(-1, 3))
    init_fn, step_fn = make_train_step(cfg, optax.adam(1e-2))
    state, static = init_fn(scene, cam)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    losses = []
    for step in range(3):
        t0 = time.perf_counter()
        state, loss = step_fn(state, static, cam, pids, target,
                              jax.random.PRNGKey(step))
        jax.block_until_ready(state)
        losses.append(float(loss))
        finite = all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(state.params))
        log(f"train step {step}: loss {losses[-1]:.6f}, params finite "
            f"{finite}, {time.perf_counter() - t0:.2f}s")
        if not (np.isfinite(losses[-1]) and finite):
            raise AssertionError("train step produced non-finite values")


def mesh_scene(spp: int, width: int = 1200, height: int = 900, seed: int = 0):
    """A seeded block world: a 10x10-cell ground, 33 cubes and a 5-quad
    pool, 606 triangles in all, textured from a 5-material 16x16 atlas.
    Material ids follow the reference's hardcoded table
    (MatTable.reference_overrides): 1 emissive, 3 glass, 4 water."""
    import jax.numpy as jnp

    from raytpu.camera import make_camera
    from raytpu.core.types import (
        MatTable, RenderConfig, Scene, SkyTexture, Spheres, TextureAtlas,
        Triangles,
    )
    from raytpu.core.vec3 import Vec3

    rng = np.random.default_rng(seed)
    tris, mats = [], []

    def quad(p, u, v, mat):
        a, b, c, d = p, p + u, p + u + v, p + v
        tris.extend([(a, b, c), (a, c, d)])
        mats.extend([mat, mat])

    ex, ey, ez = np.eye(3)
    for i in range(10):
        for j in range(10):
            quad(np.array([i - 5.0, 0.0, j - 5.0]), ez, ex, 0)
    for k in range(33):
        x, z = rng.uniform(-4.5, 3.5, 2)
        h = rng.uniform(0.4, 1.2)
        mat = (1, 2, 3, 0)[k % 4]
        o = np.array([x, 0.0, z])
        s = (ex, ey * h, ez)
        for a_, b_, c_ in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            quad(o, s[b_], s[a_], mat)                  # near face
            quad(o + s[c_], s[a_], s[b_], mat)          # far face
    for k in range(5):
        quad(np.array([-2.0 + 0.8 * k, 0.05, 3.6]), ez * 1.2, ex * 0.8, 4)
    tri = np.asarray(tris, np.float32)                     # (606, 3, 3)
    assert tri.shape[0] == 606, tri.shape

    uv = rng.uniform(0.0, 1.0, (tri.shape[0], 6)).astype(np.float32)
    col = lambda k: jnp.asarray(tri[:, k // 3, k % 3])
    triangles = Triangles(
        a=Vec3(col(0), col(1), col(2)), b=Vec3(col(3), col(4), col(5)),
        c=Vec3(col(6), col(7), col(8)),
        ua=jnp.asarray(uv[:, 0]), va=jnp.asarray(uv[:, 1]),
        ub=jnp.asarray(uv[:, 2]), vb=jnp.asarray(uv[:, 3]),
        uc=jnp.asarray(uv[:, 4]), vc=jnp.asarray(uv[:, 5]),
        mat_id=jnp.asarray(np.asarray(mats, np.int32)),
    )
    n_mat, w = 5, 16
    texels = rng.integers(0, 256, (n_mat * w * w, 3)).astype(np.float32)
    texels *= np.float32(1.0 / 255.0)
    atlas = TextureAtlas(
        rgb=Vec3(*(jnp.asarray(texels[:, c]) for c in range(3))),
        alpha=jnp.ones((n_mat * w * w,), jnp.float32), width=w, height=w,
    )
    scene = Scene(
        spheres=Spheres.empty(), triangles=triangles, atlas=atlas,
        mat_table=MatTable.reference_overrides(n_mat), sky=SkyTexture.empty(),
    )
    cam = make_camera(origin=(0.0, 4.0, 9.0), target=(0.0, 0.3, 0.0),
                      up=(0.0, 1.0, 0.0), vfov_deg=50.0,
                      aspect_ratio=width / height)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_bounces=6)
    return scene, cam, cfg


def phase_mesh(card_line: str):
    import jax
    import jax.numpy as jnp

    from raytpu.train import partition_scene

    scene, cam, cfg = mesh_scene(spp=20)
    pids = pixel_ids(cfg)
    key = jax.random.PRNGKey(0)
    fwd = forward_fn(cfg, "scan")
    out = jax.block_until_ready(fwd(scene, cam, pids, key))
    rad = np.asarray(out.radiance.to_array())
    if not (np.isfinite(rad).all() and rad.mean() > 0):
        raise AssertionError(f"mesh render broken (mean {rad.mean()})")
    params, static = partition_scene(scene)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    vg = loss_and_grad_fn(cfg, "scan", static)
    loss, grads = jax.block_until_ready(vg(params, cam, pids, key, target))
    if not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads)):
        raise AssertionError("mesh gradients not finite")
    med = median_times({
        "fwd": lambda: jax.block_until_ready(fwd(scene, cam, pids, key)),
        "fwd+bwd": lambda: jax.block_until_ready(
            vg(params, cam, pids, key, target)),
    })
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    for k, t in med.items():
        log(f"time mesh 606 tris {_shape(cfg)} {k} [scan]: median of 5 "
            f"{t * 1e3:.1f} ms = {rays / t:.4e} rays/s ({card_line})")
    log(f"mesh image mean {rad.mean() / cfg.spp:.4f}; peak_bytes_in_use "
        f"{peak} ({peak / 2**30:.2f} GiB)")


def phase_denoise(card_line: str):
    import bench

    for name, mpix in bench.measure_denoise(1200, 900).items():
        log(f"denoise {name} 1200x900: {mpix:.1f} Mpix/s ({card_line})")


def phase_four_cards(width=1200, height=900, spp=64):
    """Sharded renders on (1,4) and (2,2) meshes and one sharded train
    step, each compared with one card. Only the psum order and the
    compiled programs around the kernel differ, so sums agree to
    SHARD_RTOL except where a knife-edge branch flips (see the
    tolerances above)."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.integrator.render import render
    from raytpu.sharding import make_mesh, render_sharded
    from raytpu.train import combine_scene, make_train_step, partition_scene

    if jax.device_count() != 4:
        raise AssertionError(f"need 4 devices, have {jax.device_count()}")
    scene, cam, cfg = flagship_cfg(width=width, height=height, spp=spp)
    pids = pixel_ids(cfg)
    key = jax.random.PRNGKey(5)
    one = jax.jit(lambda sc, ca, p, k: render(sc, ca, cfg, p, k))(scene, cam, pids, key)
    for nt, ns in ((1, 4), (2, 2)):
        mesh = make_mesh(nt, ns)
        fn = jax.jit(lambda sc, ca, p, k: render_sharded(sc, ca, cfg, p, k, mesh))
        got = jax.block_until_ready(fn(scene, cam, pids, key))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(scene, cam, pids, key))
        log(f"four cards render {_shape(cfg)} mesh ({nt},{ns}): "
            f"{time.perf_counter() - t0:.3f}s warm")
        agreement(one, got, f"four cards ({nt},{ns}) vs one card",
                  SHARD_RTOL, MIN_SHARE[6], MEAN_RTOL)

    tscene, tcam, tcfg = flagship_cfg(width=400, height=300, spp=16)
    tp = pixel_ids(tcfg)
    mesh = make_mesh(2, 2)
    params, static = partition_scene(tscene)

    def loss(sharded):
        def f(params, w):
            sc = combine_scene(params, static)
            if sharded:
                sums = render_sharded(sc, tcam, tcfg, tp, key, mesh)
            else:
                sums = render(sc, tcam, tcfg, tp, key)
            r = (sums.radiance.to_array() * (1.0 / tcfg.spp) - 0.2) * w[:, None]
            return jnp.mean(r * r), (sums.radiance, sums.albedo, sums.normal)
        return f

    keep, res = grads_where_outputs_agree(
        {"one": loss(False), "four": loss(True)}, params, tcfg.n_pixels,
        rtol=SHARD_RTOL)
    log(f"four cards grads {_shape(tcfg)} mesh (2,2): {1 - keep.mean():.4%} "
        f"of pixels masked; loss {res['four'][0]:.8f} vs one card "
        f"{res['one'][0]:.8f}")
    if keep.mean() < MIN_SHARE[6]:
        raise AssertionError(f"only {keep.mean():.4%} of pixels agree")
    compare_grads(res["one"][1], res["four"][1], SHARD_RTOL,
                  "four cards grads (2,2) vs one card")

    init_fn, step_fn = make_train_step(tcfg, optax.adam(1e-2), mesh=mesh)
    state, st = init_fn(tscene, tcam)
    target = jnp.full((tcfg.n_pixels, 3), 0.2, jnp.float32)
    state, loss = step_fn(state, st, tcam, tp, target, key)
    if not np.isfinite(float(loss)):
        raise AssertionError("sharded train step loss not finite")
    log(f"four cards make_train_step(mesh=(2,2)): loss {float(loss):.8f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded render and train step")
    args = ap.parse_args()

    import jax

    from raytpu.observe import enable_compilation_cache

    dev = require_gpu()
    card_line = card()
    log(card_line)
    log(f"jax {jax.__version__}; devices {jax.devices()}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    enable_compilation_cache()

    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        compiled = phase_compile()
        phase_agreement()
        phase_timing(card_line, compiled)
        phase_train()
        phase_mesh(card_line)
        phase_denoise(card_line)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    log(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
