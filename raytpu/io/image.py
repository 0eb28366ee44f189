"""Image loading for textures: ASCII PPM (the reference's format) + PNG.

The reference requires pre-converted ASCII P3 PPMs plus a
"<name>_alpha.ppm" companion (README.md:85-95, texture.h:180-196). We
read those formats exactly, and additionally load PNGs directly (via
PIL), removing the reference's ImageMagick pre-conversion step — a
capability superset.

Row convention: arrays are stored *bottom-up* (row 0 = image bottom),
matching the reference texture loaders (texture.h:126 reads rows
height-1..0), so v=0 in UV space is the image bottom.

Quantization convention: u8 samples normalize as ``n * f32(1/255)``
(not ``n / 255``, the reference's texture.h formulation; <= 1 ulp
apart on 96 of 256 values). Multiplication is correctly rounded on
every backend while a compiled division need not be, so this convention
lets the renderer reconstruct texels bit-exactly from u8-packed atlas
tables (core/gather.py take_packed_rgba), a quarter of the f32 bytes.
Every producer (here, ppm.py, the native C++ parser, solid-Kd tiles in
io/obj.py) uses the same convention, and the oracle consumes the same
Scene, so all bit-identity guarantees are preserved repo-wide.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from raytpu.io.ppm import read_ppm


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0,1], bottom-up rows."""
    if path.lower().endswith(".ppm"):
        return read_ppm(path, bottom_up=True)
    from PIL import Image

    im = Image.open(path).convert("RGB")
    arr = np.asarray(im, np.float32) * np.float32(1.0 / 255.0)
    return np.ascontiguousarray(arr[::-1])  # PIL is top-down


def load_gray(path: str) -> np.ndarray:
    """(H, W) float32 in [0,1], bottom-up rows. For PPM this is the first
    channel, matching the reference alpha read (texture.h:237:
    ``fscanf "%lf %*lf %*lf"``)."""
    if path.lower().endswith(".ppm"):
        return read_ppm(path, bottom_up=True)[..., 0]
    from PIL import Image

    im = Image.open(path).convert("L")
    arr = np.asarray(im, np.float32) * np.float32(1.0 / 255.0)
    return np.ascontiguousarray(arr[::-1])


def load_png_alpha(path: str) -> Optional[np.ndarray]:
    """Alpha channel of an RGBA PNG, or None."""
    from PIL import Image

    im = Image.open(path)
    if im.mode in ("RGBA", "LA", "PA"):
        arr = np.asarray(im.convert("RGBA"), np.float32)[..., 3] * np.float32(1.0 / 255.0)
        return np.ascontiguousarray(arr[::-1])
    return None


def load_texture_pair(mtl_png_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve a MTL ``map_Kd`` path to (rgb (H,W,3), alpha (H,W)).

    Resolution order mirrors then extends create_mat_list_mtl
    (texture.h:180-227):
      1. reference behavior: swap ".png" -> ".ppm" and "_alpha.ppm"
      2. the named file itself (PNG) + "<base>_alpha.png"
      3. the PNG's own alpha channel
      4. fully opaque
    """
    base, ext = os.path.splitext(mtl_png_path)
    ppm, alpha_ppm = base + ".ppm", base + "_alpha.ppm"
    if os.path.exists(ppm):
        rgb = load_rgb(ppm)
        if os.path.exists(alpha_ppm):
            alpha = load_gray(alpha_ppm)
        else:
            alpha = np.ones(rgb.shape[:2], np.float32)
        return rgb, alpha

    if not os.path.exists(mtl_png_path):
        raise FileNotFoundError(
            f"texture not found: {mtl_png_path} (nor {ppm})"
        )
    rgb = load_rgb(mtl_png_path)
    alpha_png = base + "_alpha.png"
    if os.path.exists(alpha_png):
        alpha = load_gray(alpha_png)
    elif ext.lower() == ".png":
        a = load_png_alpha(mtl_png_path)
        alpha = a if a is not None else np.ones(rgb.shape[:2], np.float32)
    else:
        alpha = np.ones(rgb.shape[:2], np.float32)
    return rgb, alpha
