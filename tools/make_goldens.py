"""Generate the golden-image regression corpus (tests/goldens/).

The reference's de-facto test suite is 33 golden renders
(/root/reference/results/); ours is a checked-in set of small CPU
renders of the five BASELINE configs, diffed in tests with perceptual
tolerance (tests/test_golden_images.py). Goldens are rendered on CPU
because CI runs on CPU; GPU renders differ only by compiler FMA
contraction (ulp-level sample flips), which the test tolerance absorbs.

Regenerate (only when an INTENDED behavior change lands):
    JAX_PLATFORMS=cpu python tools/make_goldens.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
import jax._src.xla_bridge as xb

xb._clear_backends()

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "goldens")

# (name, scene, overrides) — small frames, low spp (noise is fine: the
# RNG is deterministic, so a golden pins the exact estimator output)
GOLDENS = [
    ("cfg1_cornell", "cornell", dict(width=200, height=150, spp=24,
                                     max_bounces=5)),
    ("cfg2_dof_ao", "scenes/cornell_dof_ao.toml",
     dict(width=200, height=150, spp=16)),
    ("cfg3_pyramide", "scenes/pyramide.toml",
     dict(width=200, height=150, spp=16)),
    ("cfg4_grassblock", "scenes/grass_block.toml",
     dict(width=200, height=150, spp=16)),
    ("cfg5_mcworld", "scenes/mcworld_water.toml",
     dict(width=200, height=150, spp=8)),
]


def render_golden(name: str, scene_name: str, over: dict):
    from raytpu.config import load_scene
    from raytpu.integrator.render import render_image

    scene, cam, cfg = load_scene(scene_name)
    cfg = cfg.replace(pixel_tile=over["width"] * over["height"], **over)
    out = render_image(scene, cam, cfg, jax.random.PRNGKey(1234))
    return out


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    for name, scene_name, over in GOLDENS:
        import time

        t0 = time.time()
        out = render_golden(name, scene_name, over)
        Image.fromarray(out.canvas.astype(np.uint8)).save(
            os.path.join(OUT, f"{name}.png")
        )
        print(f"{name}: {time.time()-t0:.1f}s "
              f"mean={out.canvas.mean():.1f}", flush=True)


if __name__ == "__main__":
    main()
