"""Command-line entry points: ``python -m raytpu.cli <command>``.

Replaces the reference's recompile-to-reconfigure workflow
(/root/reference/main.c:292-328, README.md:4-60) with:

    render  <scene> [--spp --bounces --width --height --out --denoise
                     --sharded --seed --checkpoint-dir ...]
    bench   [--spp ...]        rays/sec on the current default device
    train   <scene> --target image [--steps --lr]   inverse rendering

Scenes are built-in names or TOML specs (raytpu.config).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_render_overrides(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--spp", type=int)
    ap.add_argument("--bounces", type=int)
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--seed", type=int, default=0)


def _apply_overrides(cfg, args):
    over = {}
    if args.spp is not None:
        over["spp"] = args.spp
    if args.bounces is not None:
        over["max_bounces"] = args.bounces
    if args.width is not None:
        over["width"] = args.width
    if args.height is not None:
        over["height"] = args.height
    return cfg.replace(**over) if over else cfg


def _save(path: str, canvas, image) -> None:
    """Write quantized output: .ppm (reference format, main.c:457-465) or
    anything PIL supports (.png, ...)."""
    import numpy as np

    if path.endswith(".ppm"):
        from raytpu.io.ppm import write_ppm

        write_ppm(path, canvas)
    else:
        from PIL import Image

        Image.fromarray(np.asarray(canvas, np.uint8)).save(path)


def cmd_render(argv) -> int:
    ap = argparse.ArgumentParser(prog="raytpu render")
    ap.add_argument("scene", nargs="?", default="cornell")
    ap.add_argument("--scene", dest="scene_flag", default=None)
    ap.add_argument(
        "--out", default=None,
        help="output image (.ppm/.png); default follows the reference's "
             "auto-name <scene>_<spp>RAYS_<bounces>RB_<dd>-<mm>_<HH>h<MM>.ppm "
             "(main.c:325-328)",
    )
    ap.add_argument(
        "--denoise", nargs="?", const="bilateral", default=None,
        choices=["bilateral", "learned"],
        help="post-pass denoiser: 'bilateral' (joint bilateral on the "
             "AOVs; the default when the flag is bare) or 'learned' "
             "(kernel-predicting CNN, raytpu/denoise/learned.py)",
    )
    ap.add_argument("--sharded", action="store_true",
                    help="render over all devices via the (tiles,samples) mesh")
    ap.add_argument("--aov", action="store_true",
                    help="also write <out>_albedo/<out>_normal images")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file: flush accumulators here and "
                         "resume from it (bit-identical) if present")
    ap.add_argument("--flush-every", type=int, default=64,
                    help="samples between checkpoint flushes")
    ap.add_argument("--preview", default=None,
                    help="write a preview PNG here at every flush")
    ap.add_argument("--log-json", action="store_true",
                    help="structured JSON progress lines")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace into this dir")
    ap.add_argument("--bilinear", action="store_true",
                    help="bilinear texture filtering (differentiable "
                         "mode; reference semantics are nearest)")
    _add_render_overrides(ap)
    args = ap.parse_args(argv)
    scene_name = args.scene_flag or args.scene

    import jax
    import numpy as np

    from raytpu.config import load_scene
    from raytpu.integrator.render import kernel_serves
    from raytpu.observe import RenderMonitor, trace_profile
    from raytpu.sharding import init_distributed

    # no-op unless a coordinator is configured (RAYTPU_COORDINATOR /
    # RAYTPU_NUM_PROCESSES / RAYTPU_PROCESS_ID env)
    multihost = init_distributed()

    scene, cam, cfg = load_scene(scene_name)
    cfg = _apply_overrides(cfg, args)
    if args.bilinear:
        cfg = cfg.replace(bilinear_textures=True)
    if kernel_serves(scene):
        # the megakernel needs many ray blocks in flight to fill the
        # card: stream the whole frame per call (up to ~1.2M rays), not
        # the scan path's default tile, which bounds its per-bounce
        # intermediates
        cfg = cfg.replace(pixel_tile=min(cfg.n_pixels, 1200 * 1024))
    key = jax.random.PRNGKey(args.seed)

    if args.out is None:
        # auto filename like the reference (main.c:325-328); note the
        # reference prints nbRebondMax-1 as the RB count
        import os
        from datetime import datetime

        tag = os.path.splitext(os.path.basename(scene_name))[0]
        now = datetime.now()
        args.out = (
            f"{tag}_{cfg.spp}RAYS_{cfg.max_bounces - 1}RB_"
            f"{now:%d-%m_%Hh%M}.ppm"
        )

    t0 = time.perf_counter()
    with trace_profile(args.profile_dir):
        if args.checkpoint:
            from raytpu.io.checkpoint import render_image_checkpointed

            mon = RenderMonitor(
                cfg, preview_path=args.preview,
                preview_every=args.flush_every, structured=args.log_json,
            )

            def log(msg):
                if not args.log_json:  # monitor emits the structured lines
                    print(f"[render] {msg}", file=sys.stderr, flush=True)

            out = render_image_checkpointed(
                scene, cam, cfg, key, args.checkpoint,
                flush_every=args.flush_every, log=log,
                progress=mon.update,
            )
        elif args.sharded:
            if multihost:
                from raytpu.sharding import render_image_multihost

                out = render_image_multihost(scene, cam, cfg, key)
            else:
                from raytpu.sharding import render_image_sharded

                out = render_image_sharded(scene, cam, cfg, key)
        else:
            from raytpu.integrator.render import render_image

            out = render_image(scene, cam, cfg, key)
    elapsed = time.perf_counter() - t0

    image, canvas = out.image, out.canvas
    if args.denoise:
        import jax.numpy as jnp

        from raytpu.core.color import quantize, tonemap
        from raytpu.core.vec3 import Vec3

        if args.denoise == "learned":
            from raytpu.denoise.learned import denoise_learned as denoise
        else:
            from raytpu.denoise import denoise

        image = np.asarray(
            denoise(
                jnp.asarray(out.image),
                jnp.asarray(out.albedo),
                jnp.asarray(out.normal),
            )
        )
        canvas = np.asarray(
            quantize(tonemap(Vec3.from_array(jnp.asarray(image)))).to_array(),
            np.int32,
        )

    if multihost and jax.process_index() != 0:
        return 0  # every process holds the frame; only one writes it
    _save(args.out, canvas, image)
    if args.aov:
        base, dot, ext = args.out.rpartition(".")
        for name, aov in (("albedo", out.albedo), ("normal", out.normal)):
            q = np.clip(np.abs(aov) * 255.0, 0, 255).astype(np.int32)
            _save(f"{base}_{name}{dot}{ext}", q, aov)

    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(
        f"rendered {cfg.width}x{cfg.height} spp={cfg.spp} "
        f"bounces={cfg.max_bounces} in {elapsed:.2f}s "
        f"({rays / elapsed / 1e6:.1f} Mrays/s) -> {args.out}"
    )
    return 0


def cmd_bench(argv) -> int:
    # bench.py is the canonical benchmark; reuse it
    import bench as bench_mod  # repo-root bench.py

    sys.argv = ["bench.py"] + list(argv)
    bench_mod.main()
    return 0


def cmd_train(argv) -> int:
    ap = argparse.ArgumentParser(prog="raytpu train")
    ap.add_argument("scene", nargs="?", default="cornell")
    ap.add_argument("--target", required=True, help="target image (png/ppm)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--out", default="trained.png")
    ap.add_argument("--log-every", type=int, default=10)
    _add_render_overrides(ap)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from raytpu.config import load_scene
    from raytpu.io.image import load_rgb
    from raytpu.train import combine_scene, make_train_step

    scene, cam, cfg = load_scene(args.scene)
    cfg = _apply_overrides(cfg, args)

    tgt = load_rgb(args.target)  # (H, W, 3) bottom-up
    if tgt.shape[:2] != (cfg.height, cfg.width):
        raise SystemExit(
            f"target is {tgt.shape[1]}x{tgt.shape[0]}, "
            f"config is {cfg.width}x{cfg.height}"
        )
    # target rows are bottom-up like pixel ids; compare in linear space
    target = jnp.asarray((tgt.reshape(-1, 3)) ** 2.0)  # undo sqrt gamma

    init_fn, step_fn = make_train_step(cfg, optax.adam(args.lr))
    state, static = init_fn(scene, cam)
    pids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)

    for step in range(args.steps):
        key = jax.random.PRNGKey(args.seed + step)
        state, loss = step_fn(state, static, cam, pids, target, key)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.6f}")

    from raytpu.integrator.render import render_image

    final = combine_scene(state.params, static)
    out = render_image(final, cam, cfg, jax.random.PRNGKey(args.seed))
    _save(args.out, out.canvas, out.image)
    print(f"wrote {args.out}")
    return 0


COMMANDS = {"render": cmd_render, "bench": cmd_bench, "train": cmd_train}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    from raytpu.observe import enable_compilation_cache

    enable_compilation_cache()
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; choose from {sorted(COMMANDS)}")
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
