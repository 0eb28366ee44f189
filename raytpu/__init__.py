"""raytpu — differentiable Monte-Carlo path tracer in JAX.

A brand-new JAX/XLA/Pallas framework with the full capability set of the
reference C/CUDA raytracer (xelema/tipe-raytracer): sphere and textured
triangle-mesh scenes (OBJ/MTL with PPM textures and alpha cutout maps),
depth of field, ambient occlusion, probabilistic refraction with a per-ray
IOR stack, sky-sphere environment mapping, and an albedo/normal-guided
denoise pass — built from SoA component arrays, fixed-depth
``lax.scan`` light transport and mesh-sharded pixels/samples with
``psum`` reduction, and differentiable end-to-end.

Layout (see SURVEY.md §7):
  core/        scene pytrees, Vec3 SoA math, RNG, color utilities
  geometry/    branchless vectorized sphere/triangle/AABB intersection
  materials/   texture atlas gathers, UV mapping, material resolution
  integrator/  fixed-depth bounce loop, AO, AOVs, sample accumulation
  camera.py    look-at camera with DoF aperture jitter
  sharding/    device-mesh (tiles, samples) rendering with psum
  kernels/     Triton (Pallas) megakernel for the sphere bounce loop
  denoise/     differentiable joint-bilateral denoiser (OIDN replacement)
  io/          OBJ/MTL/PPM loaders and writers (+ native C++ fast path)
  train/       inverse-rendering optimization loop
"""

__version__ = "0.1.0"

from raytpu.core.vec3 import Vec3
from raytpu.core.types import (
    Materials,
    Spheres,
    Triangles,
    TextureAtlas,
    MatTable,
    SkyTexture,
    Scene,
    RenderConfig,
)
from raytpu.camera import Camera, make_camera
from raytpu.integrator.render import render, render_image

__all__ = [
    "Vec3",
    "Materials",
    "Spheres",
    "Triangles",
    "TextureAtlas",
    "MatTable",
    "SkyTexture",
    "Scene",
    "RenderConfig",
    "Camera",
    "make_camera",
    "render",
    "render_image",
]
