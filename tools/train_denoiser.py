"""Train the KPCN denoiser on self-generated render pairs.

Data: (low-spp, high-spp) renders of the built-in scenes across several
seeds — the same self-supervision OIDN's training used (noisy in, less
noisy target), generated by our own renderer so the noise distribution
matches exactly what the filter will see.

Run on the GPU (renders the pairs there too):
    python tools/train_denoiser.py [--steps 1500] [--out raytpu/denoise/weights/kpcn.npz]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def build_dataset(width=256, height=192, spp_lo=(4, 8, 16), spp_hi=512,
                  cache="/tmp/raytpu_denoise_data.npz"):
    """Render (noisy, target, albedo, normal) frames for a few scenes and
    seeds; cached on disk because the high-spp targets dominate cost."""
    if os.path.exists(cache):
        z = np.load(cache)
        return [z[k] for k in ("lo", "hi", "alb", "nrm")]

    from raytpu.config import load_scene
    from raytpu.integrator.render import render_image
    from raytpu.scenes import cornell_box, cornell_box_dof_ao

    specs = [
        ("cornell", *cornell_box()[:2]),
        ("dof_ao", *cornell_box_dof_ao()[:2]),
    ]
    for name in ("scenes/pyramide.toml", "scenes/mcworld_water.toml"):
        s, c, _ = load_scene(name)
        specs.append((name, s, c))

    from raytpu.core.types import RenderConfig

    los, his, albs, nrms = [], [], [], []
    for name, scene, cam in specs:
        for seed, lo_spp in enumerate(spp_lo):
            cfg = RenderConfig(
                width=width, height=height, spp=lo_spp, max_bounces=5,
                pixel_tile=width * height,
            )
            key = jax.random.PRNGKey(100 + seed)
            t0 = time.time()
            lo = render_image(scene, cam, cfg, key)
            hi = render_image(scene, cam, cfg.replace(spp=spp_hi), key)
            print(f"{name} seed={seed} spp={lo_spp}: "
                  f"{time.time()-t0:.1f}s", flush=True)
            los.append(lo.image)
            his.append(hi.image)
            albs.append(lo.albedo)
            nrms.append(lo.normal)
    out = [np.stack(x) for x in (los, his, albs, nrms)]
    np.savez_compressed(cache, lo=out[0], hi=out[1], alb=out[2], nrm=out[3])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import optax

    from raytpu.denoise.learned import WEIGHTS_PATH, init_params, kpcn, save_params

    lo, hi, alb, nrm = build_dataset()
    n_img, H, W, _ = lo.shape
    print(f"dataset: {n_img} frames {W}x{H}")

    params = init_params(jax.random.PRNGKey(7))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(args.lr))
    opt_state = tx.init(params)

    apply_b = jax.vmap(
        kpcn, in_axes=(None, 0, 0, 0)
    )

    @jax.jit
    def step(params, opt_state, batch):
        c, a, n, t = batch

        def loss_fn(p):
            out = apply_b(p, c, a, n)
            # L1 on the sqrt-tonemapped range: errors weighted the way
            # the written image shows them (rtutility.h:56-71). The +1e-4
            # keeps sqrt' finite at 0 — black pixels are ~36% of the data
            # and sqrt's infinite slope there NaN-poisons the gradient.
            tm = lambda x: jnp.sqrt(jnp.clip(x, 0.0, 1.0) + 1e-4)
            return jnp.mean(jnp.abs(tm(out) - tm(t)))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(0)
    cs = args.crop
    t0 = time.time()
    for i in range(args.steps):
        idx = rng.integers(0, n_img, args.batch)
        ys = rng.integers(0, H - cs, args.batch)
        xs = rng.integers(0, W - cs, args.batch)
        batch = tuple(
            jnp.asarray(np.stack([
                src[j, y : y + cs, x : x + cs]
                for j, y, x in zip(idx, ys, xs)
            ]))
            for src in (lo, alb, nrm, hi)
        )
        params, opt_state, loss = step(params, opt_state, batch)
        if i % 100 == 0 or i == args.steps - 1:
            loss_v = float(loss)
            if not np.isfinite(loss_v):
                raise SystemExit(f"loss diverged (NaN/inf) at step {i}; "
                                 "refusing to save weights")
            print(f"step {i:5d}  L1 {loss_v:.5f}  "
                  f"({time.time()-t0:.0f}s)", flush=True)

    if not all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree_util.tree_leaves(params)):
        raise SystemExit("non-finite weights after training; not saving")
    out = args.out or WEIGHTS_PATH
    save_params(params, out)
    print(f"saved {out}")

    # quick scorecard on the first frame of each scene vs the bilateral
    from raytpu.denoise import denoise as bilateral
    from raytpu.denoise.learned import denoise_learned
    from raytpu.denoise.quality import psnr

    for j in range(0, n_img, 3):
        c, a, n, t = (jnp.asarray(x[j]) for x in (lo, alb, nrm, hi))
        p_noisy = psnr(c, t)
        p_bil = psnr(bilateral(c, a, n), t)
        p_kpcn = psnr(denoise_learned(c, a, n, params), t)
        print(f"frame {j}: noisy {p_noisy:.2f}  bilateral {p_bil:.2f}  "
              f"kpcn {p_kpcn:.2f} dB")


if __name__ == "__main__":
    main()
