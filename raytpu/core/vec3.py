"""SoA 3-vector math.

The reference stores vectors as ``struct Vec3 { double e[3]; }``
(the reference's vec3.h:7-146) and operates on them scalar-at-a-time.
This module instead represents a batch of N vectors as *three separate
(N,) component arrays* bundled in a :class:`Vec3` NamedTuple. Every
operation is then a pure elementwise op over N with dense, unit-stride
components, and the structure is a pytree so it flows through
``jit``/``grad``/``scan``/``shard_map`` unchanged.

Semantics mirror /root/reference/vec3.h and /root/reference/rtutility.h:
``dot``, ``cross``, ``length``, ``normalize``, ``negate``, ``lerp``
(rtutility.h:32-34), ``reflect`` (rtutility.h:205-208) and ``refract``
(rtutility.h:210-227) — including the reference's quirk of squaring both
refractive indices before use (rtutility.h:214-215), which is load-bearing
behavior for golden-image parity.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp
from jax import Array

Scalar = Union[float, Array]


class Vec3(NamedTuple):
    """A batch of 3-vectors stored as separate x/y/z component arrays."""

    x: Array
    y: Array
    z: Array

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def create(x: Scalar, y: Scalar, z: Scalar, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.asarray(x, dtype=dtype),
            jnp.asarray(y, dtype=dtype),
            jnp.asarray(z, dtype=dtype),
        )

    @staticmethod
    def from_array(a: Array) -> "Vec3":
        """Build from an (..., 3) array (boundary/API use only)."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def zeros(shape=(), dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype=dtype)
        return Vec3(z, z, z)

    @staticmethod
    def full(shape, x: float, y: float, z: float, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, x, dtype=dtype),
            jnp.full(shape, y, dtype=dtype),
            jnp.full(shape, z, dtype=dtype),
        )

    def to_array(self) -> Array:
        """(..., 3) array (boundary/API use only)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # ------------------------------------------------------------------
    # arithmetic (elementwise; scalar or Vec3 operands)
    # ------------------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # ------------------------------------------------------------------
    # geometry
    # ------------------------------------------------------------------
    def dot(self, o: "Vec3") -> Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> Array:
        return self.dot(self)

    def length(self) -> Array:
        return jnp.sqrt(self.length_squared())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        """Unit vector; matches vec3_normalize (vec3.h). ``eps`` guards
        zero-length inputs when differentiating (0 reproduces reference)."""
        n2 = self.length_squared()
        floor = eps if eps else 1e-38
        inv_len = jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.maximum(n2, floor)), 0.0)
        return Vec3(self.x * inv_len, self.y * inv_len, self.z * inv_len)

    def lerp(self, o: "Vec3", t: Scalar) -> "Vec3":
        """x + (y - x) * t  (rtutility.h:32-34)."""
        return self + (o - self) * t

    def max_component(self) -> Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def min_component(self) -> Array:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def clamp(self, lo: Scalar, hi: Scalar) -> "Vec3":
        return Vec3(
            jnp.clip(self.x, lo, hi),
            jnp.clip(self.y, lo, hi),
            jnp.clip(self.z, lo, hi),
        )

    # ------------------------------------------------------------------
    # indexing / structural helpers
    # ------------------------------------------------------------------
    def take(self, idx: Array) -> "Vec3":
        """Gather along the leading axis (one row-gather for all three
        components via gather_channels)."""
        from raytpu.core.gather import gather_channels

        return Vec3(*gather_channels([self.x, self.y, self.z], idx))

    def reshape(self, shape) -> "Vec3":
        return Vec3(
            self.x.reshape(shape), self.y.reshape(shape), self.z.reshape(shape)
        )

    @property
    def shape(self):
        return jnp.shape(self.x)

    @staticmethod
    def where(mask: Array, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(
            jnp.where(mask, a.x, b.x),
            jnp.where(mask, a.y, b.y),
            jnp.where(mask, a.z, b.z),
        )

    def astype(self, dtype) -> "Vec3":
        return Vec3(
            self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype)
        )


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """v - 2*(v.n)*n  — reflected_vec, /root/reference/rtutility.h:205-208."""
    return v - n * (2.0 * v.dot(n))


def refract(v: Vec3, normal: Vec3, n1: Scalar, n2: Scalar) -> Vec3:
    """Snell refraction with the reference's exact quirk.

    Mirrors refracted_vec (/root/reference/rtutility.h:210-227): both
    indices are squared before use (``n1*=n1; n2*=n2``), so the tangential
    component is scaled by (n1/n2)^2 and the radical uses (n1/n2)^4.
    Total-internal-reflection falls back to the mirror direction.
    Fully branchless for XLA/autodiff.
    """
    n1s = n1 * n1
    n2s = n2 * n2
    # The floor and ceiling only guard autodiff: rays that MISS carry a
    # zeroed material (ior = 0), making the unclamped ratio 1e40 -> inf
    # in f32; its backward partials then produce inf * 0 = NaN even
    # though the refraction result is masked out. Physical IORs give
    # ratios of O(1), far from both clamps.
    ratio = jnp.clip(n1s / jnp.maximum(n2s, 1e-20), 0.0, 1e6)
    ndotv = normal.dot(v)
    radical = 1.0 - (ratio * ratio) * (1.0 - ndotv * ndotv)
    comp_tan = (v - normal * v.dot(normal)) * ratio
    comp_norm = (-normal) * jnp.sqrt(jnp.maximum(radical, 1e-20))
    refracted = comp_tan + comp_norm
    return Vec3.where(radical > 0, refracted, reflect(v, normal))


def random_unit_vector(u: Array, v: Array) -> Vec3:
    """Uniform direction on the sphere from two U(0,1) draws.

    Mirrors random_dir_no_norm (/root/reference/rtutility.h:189-203):
    theta = 2*pi*u, phi = acos(2v - 1); the (theta, phi) inversion already
    yields a unit vector, and the reference's extra normalize is a no-op
    that we keep implicitly.

    The acos/sin pair is algebraically eliminated: cos(phi) = 2v-1 and
    sin(phi) = sqrt(1 - (2v-1)^2) (phi in [0, pi] so sin >= 0) — the
    identical distribution at two fewer transcendentals per draw. The
    f64 oracle uses the same form (tests/oracle.py).
    """
    theta = (2.0 * jnp.pi) * u
    cos_phi = jnp.clip(2.0 * v - 1.0, -1.0, 1.0)
    sin_phi = jnp.sqrt(jnp.maximum(1.0 - cos_phi * cos_phi, 0.0))
    return Vec3(jnp.cos(theta) * sin_phi, jnp.sin(theta) * sin_phi, cos_phi)
