"""Scene/config specs: the reference's compile-time literals as data.

The reference hardcodes every render parameter and the whole scene inside
``main()`` (/root/reference/main.c:292-347 — resolution, camera, DoF,
spp, bounces, AO, file paths, the sphere array) and the per-material
physics inside ``tri_uvmapping`` (/root/reference/texture.h:71-88);
changing a scene means recompiling. Here the same information lives in a
TOML scene spec (SURVEY.md §5.6):

    [render]   width/height/spp/bounces/ao/aperture/focus/...
    [camera]   origin/target/up/vfov
    [[spheres]] center/radius/diffuse/emission/...
    [mesh]     obj/mtl/translate + [[mesh.materials]] id overrides
    [sky]      file (equirect texture on the last sphere)

Paths resolve relative to the TOML file. ``load_scene`` also accepts the
built-in named scenes (the BASELINE.json configs).
"""

from __future__ import annotations

import os
import tomllib
from typing import Optional

import jax.numpy as jnp
import numpy as np

from raytpu.camera import Camera, make_camera
from raytpu.core.types import (
    MatTable,
    RenderConfig,
    Scene,
    SkyTexture,
    Spheres,
    TextureAtlas,
    Triangles,
)
from raytpu.core.vec3 import Vec3


def _spheres_from_spec(rows: list[dict]) -> Spheres:
    from raytpu.scenes import spheres_from_rows

    return spheres_from_rows(
        [
            (
                tuple(r["center"]),
                float(r["radius"]),
                tuple(r.get("diffuse", (0.0, 0.0, 0.0))),
                tuple(r.get("emission", (0.0, 0.0, 0.0))),
                float(r.get("emission_strength", 0.0)),
                float(r.get("reflection", 0.0)),
                float(r.get("alpha", 1.0)),
                float(r.get("ior", 1.0)),
            )
            for r in rows
        ]
    )


def _mat_table_from_spec(n: int, overrides: list[dict]) -> MatTable:
    """[[mesh.materials]] entries generalize texture.h:71-88's hardcoded
    per-id physics: {id, emission, emission_strength, reflection, ior,
    alpha} — alpha present means 'force constant alpha for this id'."""
    em = np.zeros((n, 3), np.float32)
    es = np.zeros(n, np.float32)
    rf = np.zeros(n, np.float32)
    io = np.ones(n, np.float32)
    ac = np.ones(n, np.float32)
    ua = np.zeros(n, bool)
    eft = np.zeros(n, bool)
    for o in overrides:
        i = int(o["id"])
        if not 0 <= i < n:
            raise ValueError(f"material override id {i} out of range [0,{n})")
        em[i] = np.asarray(o.get("emission", em[i]), np.float32)
        es[i] = float(o.get("emission_strength", es[i]))
        rf[i] = float(o.get("reflection", rf[i]))
        io[i] = float(o.get("ior", io[i]))
        if "alpha" in o:
            ac[i] = float(o["alpha"])
            ua[i] = True
        eft[i] = bool(o.get("emission_from_texture", False))
    return MatTable(
        emission=Vec3(jnp.asarray(em[:, 0]), jnp.asarray(em[:, 1]), jnp.asarray(em[:, 2])),
        emission_strength=jnp.asarray(es),
        reflection=jnp.asarray(rf),
        ior=jnp.asarray(io),
        alpha_const=jnp.asarray(ac),
        use_alpha_const=jnp.asarray(ua),
        emission_from_texture=jnp.asarray(eft),
    )


def _concat_triangles(parts: list[Triangles]) -> Triangles:
    cat = lambda f: jnp.concatenate([getattr(t, f) for t in parts])
    catv = lambda f: Vec3(
        jnp.concatenate([getattr(t, f).x for t in parts]),
        jnp.concatenate([getattr(t, f).y for t in parts]),
        jnp.concatenate([getattr(t, f).z for t in parts]),
    )
    return Triangles(
        a=catv("a"), b=catv("b"), c=catv("c"),
        ua=cat("ua"), va=cat("va"), ub=cat("ub"), vb=cat("vb"),
        uc=cat("uc"), vc=cat("vc"), mat_id=cat("mat_id"),
    )


def _concat_tables(parts: list[MatTable]) -> MatTable:
    cat = lambda f: jnp.concatenate([getattr(t, f) for t in parts])
    return MatTable(
        emission=Vec3(
            jnp.concatenate([t.emission.x for t in parts]),
            jnp.concatenate([t.emission.y for t in parts]),
            jnp.concatenate([t.emission.z for t in parts]),
        ),
        emission_strength=cat("emission_strength"),
        reflection=cat("reflection"),
        ior=cat("ior"),
        alpha_const=cat("alpha_const"),
        use_alpha_const=cat("use_alpha_const"),
        emission_from_texture=cat("emission_from_texture"),
    )


def _load_meshes(specs: list[dict], base: str, collapse: bool = True):
    """[[meshes]] entries -> concatenated (Triangles, TextureAtlas,
    MatTable) with per-mesh material-slot offsets. The atlas is built in
    one pass over every mesh's materials so the shared-tile-size rule
    (texture.h:221) applies globally and untextured materials get solid
    Kd tiles at the common size."""
    from raytpu.io.mesh_formats import parse_mesh
    from raytpu.io.obj import build_atlas, mesh_to_triangles, parse_mtl

    tri_parts, table_parts = [], []
    paths, colors, alphas = [], [], []
    offset = 0
    for m in specs:
        mesh = parse_mesh(os.path.join(base, m["obj"]))
        tris = mesh_to_triangles(
            mesh, tuple(m.get("translate", (0.0, 0.0, 0.0)))
        )
        n_mat = max(len(mesh.mat_names), 1)
        mtl = (
            parse_mtl(os.path.join(base, m["mtl"]))
            if m.get("textures", True) and "mtl" in m
            else {}
        )
        entries = [mtl.get(n, {}) for n in mesh.mat_names] or [{}]
        entries = entries + [{}] * (n_mat - len(entries))
        paths += [e.get("map_kd") for e in entries]
        colors += [e.get("kd") for e in entries]
        alphas += [e.get("d") for e in entries]
        table_parts.append(_mat_table_from_spec(n_mat, m.get("materials", [])))
        tri_parts.append(tris.replace(mat_id=tris.mat_id + offset))
        offset += n_mat
    atlas = build_atlas(
        paths, fallback_colors=colors, fallback_alphas=alphas,
        collapse=collapse,
    )
    return (
        _concat_triangles(tri_parts),
        atlas,
        _concat_tables(table_parts),
    )


def load_scene_file(path: str) -> tuple[Scene, Camera, RenderConfig]:
    """Parse a TOML scene spec into (Scene, Camera, RenderConfig)."""
    with open(path, "rb") as f:
        spec = tomllib.load(f)
    base = os.path.dirname(os.path.abspath(path))

    r = spec.get("render", {})
    cfg = RenderConfig(
        width=int(r.get("width", 400)),
        height=int(r.get("height", 300)),
        spp=int(r.get("spp", 100)),
        max_bounces=int(r.get("bounces", 5)),
        use_ao=bool(r.get("ao", False)),
        ao_intensity=float(r.get("ao_intensity", 2.5)),
        focus_distance=float(r.get("focus_distance", 3.0)),
        aperture_x=float(r.get("aperture_x", 0.0)),
        aperture_y=float(r.get("aperture_y", 0.0)),
        # note: a TOML "ior_stack_depth" key is accepted but ignored — the
        # pile.h stack reduces exactly to one carried scalar regardless of
        # nesting depth (proof in integrator/path.py), so no config knob
        # exists for it anymore
        bilinear_textures=bool(r.get("bilinear_textures", False)),
    )

    c = spec.get("camera", {})
    cam = make_camera(
        origin=tuple(c.get("origin", (0.0, 0.0, 0.0))),
        target=tuple(c.get("target", (0.0, 0.0, -1.0))),
        up=tuple(c.get("up", (0.0, 1.0, 0.0))),
        vfov_deg=float(c.get("vfov", 70.0)),
        aspect_ratio=cfg.width / cfg.height,
    )

    spheres = (
        _spheres_from_spec(spec["spheres"]) if "spheres" in spec else Spheres.empty()
    )

    triangles = Triangles.empty()
    atlas = TextureAtlas.empty()
    mat_table = MatTable.default(1)
    if "meshes" in spec:
        # multi-mesh scene (superset of the reference's single mesh +
        # move_mesh translation): concatenated triangle SoA with
        # per-mesh material-slot offsets; all texture tiles still share
        # one (W, H) (texture.h:221)
        triangles, atlas, mat_table = _load_meshes(
            spec["meshes"], base, collapse=not cfg.bilinear_textures
        )
    elif "mesh" in spec:
        from raytpu.io.mesh_formats import parse_mesh
        from raytpu.io.obj import build_atlas, mesh_to_triangles, parse_mtl

        m = spec["mesh"]
        # extension-routed: .obj (reference format), .ply, .stl — the
        # CUDA fork's assimp import surface (triangle.hu:61-167)
        obj_path = os.path.join(base, m["obj"])
        mesh = parse_mesh(obj_path)
        triangles = mesh_to_triangles(
            mesh, tuple(m.get("translate", (0.0, 0.0, 0.0)))
        )
        n_mat = max(len(mesh.mat_names), 1)
        if m.get("textures", True) and "mtl" in m and mesh.mat_names:
            mtl_path = os.path.join(base, m["mtl"])
            mtl = parse_mtl(mtl_path)
            entries = [mtl.get(n, {}) for n in mesh.mat_names]
            atlas = build_atlas(
                [e.get("map_kd") for e in entries],
                fallback_colors=[e.get("kd") for e in entries],
                fallback_alphas=[e.get("d") for e in entries],
                # nearest fetch: collapsing is bit-exact; bilinear
                # interpolates across texels, so keep full resolution
                collapse=not cfg.bilinear_textures,
            )
        mat_table = _mat_table_from_spec(n_mat, m.get("materials", []))
        if m.get("mtl_physics", False) and "mtl" in m and mesh.mat_names:
            # CUDA-fork behavior: reflectionStrength = shininess / 100
            # (triangle.hu:118-124), applied where the spec didn't
            # explicitly override reflection
            import numpy as _np

            mtl = parse_mtl(os.path.join(base, m["mtl"]))
            ns = _np.array(
                [
                    (mtl.get(n, {}).get("ns") or 0.0) / 100.0
                    for n in mesh.mat_names
                ],
                _np.float32,
            )
            explicit = {int(o["id"]) for o in m.get("materials", [])
                        if "reflection" in o}
            keep = _np.array(
                [i in explicit for i in range(n_mat)], bool
            )
            refl = _np.where(
                keep, _np.asarray(mat_table.reflection), ns[:n_mat]
            )
            mat_table = mat_table.replace(
                reflection=jnp.asarray(refl, jnp.float32)
            )

    if triangles.count > 1 and bool(spec.get("morton", True)):
        # Morton-order triangles for chunk-cull locality (see
        # raytpu/geometry/morton.py; output-identical, disable with a
        # top-level `morton = false` in the spec)
        from raytpu.geometry.morton import morton_order

        triangles = morton_order(triangles)

    sky = SkyTexture.empty()
    sky_index = -1
    if "sky" in spec:
        from raytpu.io.obj import load_sky

        sky = load_sky(os.path.join(base, spec["sky"]["file"]))
        sky_index = int(spec["sky"].get("sphere_index", spheres.count - 1))
        # the reference's sky convention ("derniere sphere = ciel",
        # main.c:331/347): the sky sphere is a PURE emitter — black
        # diffuse, no refraction window. The sphere megakernel's
        # single-slot sky composition (kernels/trace_spheres) is exact
        # under exactly this convention, so enforce it at load.
        d = spheres.mat.diffuse
        import numpy as _np2

        if (
            float(_np2.abs(_np2.asarray(d.x[sky_index]))) > 0.0
            or float(_np2.abs(_np2.asarray(d.y[sky_index]))) > 0.0
            or float(_np2.abs(_np2.asarray(d.z[sky_index]))) > 0.0
        ):
            raise ValueError(
                f"{path}: the [sky] sphere (index {sky_index}) must have "
                "black diffuse (the reference's pure-emitter sky "
                "convention; required for the megakernel fast path)"
            )

    scene = Scene(
        spheres=spheres,
        triangles=triangles,
        atlas=atlas,
        mat_table=mat_table,
        sky=sky,
        sky_sphere_index=sky_index,
    )
    return scene, cam, cfg


def load_scene(name_or_path: str) -> tuple[Scene, Camera, RenderConfig]:
    """Built-in scene name or a path to a .toml spec."""
    from raytpu import scenes as builtin

    builtins = {
        "cornell": builtin.cornell_box,
        "cornell_dof_ao": builtin.cornell_box_dof_ao,
        "cornell_cuda": builtin.cornell_box_cuda,
    }
    if name_or_path in builtins:
        return builtins[name_or_path]()
    if os.path.exists(name_or_path):
        return load_scene_file(name_or_path)
    raise ValueError(
        f"unknown scene {name_or_path!r}; built-ins: {sorted(builtins)} "
        f"or a path to a .toml scene spec"
    )
