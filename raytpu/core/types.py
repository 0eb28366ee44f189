"""Scene representation: SoA pytrees over differentiable leaves.

Replaces the reference's AoS C structs (sphere array main.c:332-347,
triangle array mesh.h:14-22, per-texel ``material`` atlas texture.h:221)
with structure-of-arrays jnp containers. Every geometric/material leaf is
a differentiable f32 array; shapes are static so everything jits cleanly.

Texture-atlas semantics (texture.h:175-354): the reference concatenates
all textures (which must share one WxH) into one
``material[W*H*nbMaterials]`` array, with per-texel diffuse + alpha and
*hardcoded per-material-index physics overrides* (texture.h:71-88: id 1 ->
emissive 1.85, id 4 -> water, id 3 -> glass). Here the atlas carries flat
per-channel arrays and the overrides generalize to a per-material-id
:class:`MatTable` that scene specs populate (the reference's hardcoded
ids become data).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from raytpu.core.vec3 import Vec3


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``replace(**kw)``.
    Fields declared with :func:`static_field` are treedef metadata
    (hashable, part of the jit cache key); all others are leaves."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)


def static_field(default):
    return dataclasses.field(default=default, metadata={"static": True})


@pytree_dataclass
class Materials:
    """Material SoA; fields mirror struct Material
    (/root/reference/hitinfo.h:6-13)."""

    diffuse: Vec3            # diffuseColor
    emission: Vec3           # emissionColor
    emission_strength: Array  # emissionStrength
    reflection: Array        # reflectionStrength in [0,1]
    alpha: Array             # opacity; <1e-4 cutout, <=0.99 refractive
    ior: Array               # materialIndex (refractive index)

    @staticmethod
    def create(diffuse, emission, emission_strength, reflection, alpha, ior):
        return Materials(
            diffuse=_as_vec(diffuse),
            emission=_as_vec(emission),
            emission_strength=jnp.asarray(emission_strength, jnp.float32),
            reflection=jnp.asarray(reflection, jnp.float32),
            alpha=jnp.asarray(alpha, jnp.float32),
            ior=jnp.asarray(ior, jnp.float32),
        )

    @staticmethod
    def zeros(shape=()):
        z = jnp.zeros(shape, jnp.float32)
        return Materials(Vec3(z, z, z), Vec3(z, z, z), z, z, z, z)

    def take(self, idx: Array) -> "Materials":
        from raytpu.core.gather import gather_channels

        (dx, dy, dz, ex, ey, ez, es, rf, al, io) = gather_channels(
            [
                self.diffuse.x, self.diffuse.y, self.diffuse.z,
                self.emission.x, self.emission.y, self.emission.z,
                self.emission_strength, self.reflection, self.alpha, self.ior,
            ],
            idx,
        )
        return Materials(Vec3(dx, dy, dz), Vec3(ex, ey, ez), es, rf, al, io)

    @staticmethod
    def where(mask: Array, a: "Materials", b: "Materials") -> "Materials":
        return Materials(
            Vec3.where(mask, a.diffuse, b.diffuse),
            Vec3.where(mask, a.emission, b.emission),
            jnp.where(mask, a.emission_strength, b.emission_strength),
            jnp.where(mask, a.reflection, b.reflection),
            jnp.where(mask, a.alpha, b.alpha),
            jnp.where(mask, a.ior, b.ior),
        )


def _as_vec(v) -> Vec3:
    if isinstance(v, Vec3):
        return v
    a = jnp.asarray(v, jnp.float32)
    return Vec3.from_array(a)


@pytree_dataclass
class Spheres:
    """Sphere SoA (struct Sphere, /root/reference/sphere.h:7-11)."""

    center: Vec3   # (S,)
    radius: Array  # (S,)
    mat: Materials  # (S,)

    @property
    def count(self) -> int:
        return self.radius.shape[0]

    @staticmethod
    def empty() -> "Spheres":
        return Spheres(Vec3.zeros((0,)), jnp.zeros((0,)), Materials.zeros((0,)))


@pytree_dataclass
class Triangles:
    """Triangle SoA (struct Triangle, /root/reference/mesh.h:14-22):
    vertices A/B/C, per-vertex UVs, per-triangle material-id into the
    texture atlas (quelMatPourTri, mesh.h:173)."""

    a: Vec3
    b: Vec3
    c: Vec3
    ua: Array
    va: Array
    ub: Array
    vb: Array
    uc: Array
    vc: Array
    mat_id: Array  # (T,) int32 index into atlas / MatTable

    @property
    def count(self) -> int:
        return self.mat_id.shape[0]

    @staticmethod
    def empty() -> "Triangles":
        z = jnp.zeros((0,))
        return Triangles(
            Vec3.zeros((0,)), Vec3.zeros((0,)), Vec3.zeros((0,)),
            z, z, z, z, z, z, jnp.zeros((0,), jnp.int32),
        )


@pytree_dataclass
class TextureAtlas:
    """All mesh textures concatenated (texture.h:175-354): flat per-channel
    arrays of length M*H*W indexed by mat_id*H*W + y*W + x. All textures
    share one (H, W), exactly like the reference (texture.h:221)."""

    rgb: Vec3     # (M*H*W,) each channel
    alpha: Array  # (M*H*W,)
    width: int = static_field(1)
    height: int = static_field(1)
    # Optional u8-packed copy (r | g<<8 | b<<16 | a<<24) as a
    # (ceil(M*H*W/128), 128) uint32 row-gather table — 4x smaller than
    # the four f32 channels (pyramide_eau: 147MB as f32). Built by
    # io.obj.build_atlas ONLY when every channel is exactly
    # n * f32(1/255) for integer n (the loader convention), so the
    # device-side reconstruction is bit-identical to the f32 tables;
    # None means "no exact u8 form" and fetches use the f32 path.
    packed: Array = None

    @property
    def count(self) -> int:
        if self.width * self.height == 0:
            return 0
        return self.alpha.shape[0] // (self.width * self.height)

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas(Vec3.zeros((0,)), jnp.zeros((0,)), 1, 1)


@pytree_dataclass
class MatTable:
    """Per-material-id physics overrides, generalizing the hardcoded id
    checks in tri_uvmapping (/root/reference/texture.h:71-88)."""

    emission: Vec3            # (M,) emissionColor override
    emission_strength: Array  # (M,)
    reflection: Array         # (M,)
    ior: Array                # (M,)
    alpha_const: Array        # (M,) value used when use_alpha_const
    use_alpha_const: Array    # (M,) bool: True -> ignore texel alpha
    # bool: emission is modulated by the diffuse texel (superset of the
    # reference, whose emissive overrides are flat colors texture.h:71-88).
    # None (a table built before the field existed — positional
    # construction, unpickled scenes) means all-False; consumers
    # (materials.texture.triangle_material) treat it so.
    emission_from_texture: Array = None

    @staticmethod
    def default(n: int) -> "MatTable":
        return MatTable(
            emission=Vec3.zeros((n,)),
            emission_strength=jnp.zeros((n,)),
            reflection=jnp.zeros((n,)),
            ior=jnp.ones((n,)),
            alpha_const=jnp.ones((n,)),
            use_alpha_const=jnp.zeros((n,), bool),
            emission_from_texture=jnp.zeros((n,), bool),
        )

    @staticmethod
    def reference_overrides(n: int) -> "MatTable":
        """The exact texture.h:71-88 hardcoded table, as data: id 1 emissive
        white 1.85 with alpha forced to 1; id 4 water (alpha .6, ior 1.33,
        refl .93); id 3 glass (alpha .1, ior 1.5, refl .3)."""
        t = MatTable.default(n)
        em = t.emission
        es = np.zeros(n, np.float32)
        rf = np.zeros(n, np.float32)
        io = np.ones(n, np.float32)
        ac = np.ones(n, np.float32)
        ua = np.zeros(n, bool)
        ex = np.zeros(n, np.float32)
        ey = np.zeros(n, np.float32)
        ez = np.zeros(n, np.float32)
        if n > 1:
            ex[1] = ey[1] = ez[1] = 1.0
            es[1] = 1.85
            ac[1] = 1.0
            ua[1] = True
        if n > 4:
            ac[4] = 0.6
            ua[4] = True
            io[4] = 1.33
            rf[4] = 0.93
        if n > 3:
            ac[3] = 0.1
            ua[3] = True
            io[3] = 1.50
            rf[3] = 0.3
        return MatTable(
            emission=Vec3(jnp.asarray(ex), jnp.asarray(ey), jnp.asarray(ez)),
            emission_strength=jnp.asarray(es),
            reflection=jnp.asarray(rf),
            ior=jnp.asarray(io),
            alpha_const=jnp.asarray(ac),
            use_alpha_const=jnp.asarray(ua),
            emission_from_texture=jnp.zeros(n, bool),
        )


@pytree_dataclass
class SkyTexture:
    """Equirect sky texture for sphere_uvmapping (texture.h:92-112) applied
    to the last sphere ("derniere sphere = ciel", main.c:331).

    ``packed``: optional u8-packed uint32 row-gather table
    (io.obj.pack_rgba_u8) — production sky assets are 4096x2048 PNGs,
    far past the fast-gather regime for the f32 layout; the packed
    fetch reconstructs the same f32 values bit-exactly at a quarter of
    the bytes and is used whenever sky TEXEL gradients are off
    (RenderConfig.sky_texture_grads)."""

    rgb: Vec3  # (H*W,) per channel
    packed: Optional[Array] = None
    width: int = static_field(1)
    height: int = static_field(1)

    @staticmethod
    def empty() -> "SkyTexture":
        return SkyTexture(Vec3.zeros((0,)), None, 1, 1)


@pytree_dataclass
class Scene:
    """Full differentiable scene: spheres + textured triangle mesh + atlas
    + per-id material table + optional sky texture."""

    spheres: Spheres
    triangles: Triangles
    atlas: TextureAtlas
    mat_table: MatTable
    sky: SkyTexture
    # static: index of the sky sphere for textured-sky emission, or -1.
    # (main.c:64-71 keeps this path commented out; -1 reproduces that.)
    sky_sphere_index: int = static_field(-1)

    @staticmethod
    def from_spheres(spheres: Spheres) -> "Scene":
        return Scene(
            spheres=spheres,
            triangles=Triangles.empty(),
            atlas=TextureAtlas.empty(),
            mat_table=MatTable.default(1),
            sky=SkyTexture.empty(),
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters — the compile-time literals of main.c:292-328
    promoted to a config object. Hashable so it can be a jit static arg."""

    width: int = 400
    height: int = 300
    spp: int = 100                  # nbRayonParPixel
    max_bounces: int = 5            # nbRebondMax
    use_ao: bool = False            # useAO (main.c:316)
    ao_intensity: float = 2.5       # AO_intensity (main.c:317)
    ao_samples: int = 1             # nbSamples in ambient_occlusion (main.c:95)
    focus_distance: float = 3.0     # focus_distance (main.c:304)
    aperture_x: float = 0.0         # ouverture_x
    aperture_y: float = 0.0         # ouverture_y
    hsl_l_factor: float = 1.0       # emissive HSL boost (main.c:156; 1.2 in CUDA)
    hsl_s_factor: float = 1.0
    bright_boost: float = 1.3       # throughput boost hack (main.c:214-216)
    bright_threshold: float = 0.5
    ao_emission_factor: float = 1.5  # emitted *= 1.5*AO_intensity when useAO (main.c:210)
    sphere_eps: float = 1e-4        # sphere.h:29 root acceptance
    tri_det_eps: float = 1e-6       # mesh.h:88 backface cull
    tri_eps: float = 1e-7           # mesh.h:88 dst/u/v/w acceptance
    refr_alpha_lo: float = 1e-4     # main.c:167 alpha window
    refr_alpha_hi: float = 0.99
    # execution shape
    pixel_tile: int = 16384          # rays per wavefront
    # differentiable-mode texture filtering: nearest (reference
    # semantics, piecewise-constant in geometry) vs bilinear (continuous
    # UV->color, giving nonzero vertex/camera gradients)
    bilinear_textures: bool = False
    # equirect-sky TEXEL gradients: the pullback of the per-bounce sky
    # gather is a (sky-rows)-sized segment sum per sample — ~10-50x the
    # whole backward at the reference's 4096x2048 sky assets — for a
    # leaf almost no inverse problem optimizes (the reference's sky is
    # a fixed file, main.c:374). Off: sky texels are stop_gradient'd
    # (every OTHER gradient in a sky scene — geometry, materials,
    # camera, emission — is unaffected). On: full texel gradients, used
    # by the sky-training tests.
    sky_texture_grads: bool = False

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
