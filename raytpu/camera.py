"""Look-at camera with viewport-corner parameterization and DoF.

Mirrors /root/reference/camera.h:21-54 exactly:
  init_camera builds an orthonormal (u, v, w) basis from origin/target/up,
  a viewport of height 2*tan(vfov/2) (width = ratio * height), and the
  lower-left corner ``origin - horizontal/2 - vertical/2 - w``.

  get_ray(u, v): direction = corner + u*horizontal + v*vertical - origin;
  the DoF model jitters the ray origin in *world* x/y by the aperture
  amounts and re-aims at ``origin + direction * focus_distance``
  (camera.h:42-54). Note the reference's quirk: the aperture offset is
  axis-aligned (not in the camera plane) — reproduced faithfully.

All camera fields are differentiable jnp scalars, so camera pose can be
optimized by the inverse renderer.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from raytpu.core.types import pytree_dataclass
from raytpu.core.vec3 import Vec3


@pytree_dataclass
class Camera:
    origin: Vec3        # scalar Vec3
    horizontal: Vec3
    vertical: Vec3
    lower_left: Vec3    # coin_bas_gauche


def make_camera(origin, target, up, vfov_deg, aspect_ratio) -> Camera:
    """init_camera (/root/reference/camera.h:21-40)."""
    origin = _vec(origin)
    target = _vec(target)
    up = _vec(up)
    theta = jnp.deg2rad(jnp.asarray(vfov_deg, jnp.float32))
    h = jnp.tan(theta / 2.0)
    viewport_h = 2.0 * h
    viewport_w = aspect_ratio * viewport_h

    w = (origin - target).normalize()
    u = up.cross(w).normalize()
    v = w.cross(u)

    horizontal = u * viewport_w
    vertical = v * viewport_h
    lower_left = origin - (horizontal * 0.5 + (vertical * 0.5 + w))
    return Camera(origin, horizontal, vertical, lower_left)


def get_rays(
    cam: Camera,
    u: Array,
    v: Array,
    focus_distance,
    dx_aperture: Array,
    dy_aperture: Array,
):
    """Vectorized get_ray (/root/reference/camera.h:42-54).

    u, v: (B,) viewport coordinates in [0,1] (already pixel-jittered).
    dx/dy_aperture: (B,) world-space origin jitter (already scaled by the
    aperture size). Returns (origin Vec3(B,), dir Vec3(B,)).
    """
    direction = cam.lower_left + (cam.horizontal * u + (cam.vertical * v - cam.origin))
    destination = cam.origin + direction * focus_distance
    new_origin = cam.origin + Vec3(dx_aperture, dy_aperture, jnp.zeros_like(dx_aperture))
    d = (destination - new_origin).normalize()
    return new_origin, d


def _vec(x) -> Vec3:
    if isinstance(x, Vec3):
        return x
    a = jnp.asarray(x, jnp.float32)
    return Vec3(a[0], a[1], a[2])
