"""The scene, camera and denoiser pytrees (frozen dataclasses registered
with jax.tree_util): flatten/unflatten round trips, static fields in the
treedef, and replace()."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.camera import Camera
from raytpu.core.types import SkyTexture, TextureAtlas
from raytpu.core.vec3 import Vec3
from raytpu.denoise.bilateral import DenoiseParams
from raytpu.scenes import cornell_box


def _cases():
    scene, cam, _ = cornell_box()
    sky = SkyTexture(rgb=Vec3(jnp.ones(8), jnp.ones(8), jnp.ones(8)),
                     width=4, height=2)
    return {
        "scene": scene.replace(sky=sky, sky_sphere_index=9),
        "camera": cam,
        "atlas": TextureAtlas(Vec3.zeros((6,)), jnp.ones(6), 3, 2),
        "denoise": DenoiseParams.default(radius=2),
    }


@pytest.mark.parametrize("name", ["scene", "camera", "atlas", "denoise"])
def test_pytree_round_trip_and_replace(name):
    obj = _cases()[name]
    leaves, treedef = jax.tree.flatten(obj)
    assert all(isinstance(l, jax.Array) for l in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert type(back) is type(obj) and jax.tree.structure(back) == treedef
    # static fields live in the treedef: they survive a jit boundary as
    # Python values and change the structure when they change
    statics = [f.name for f in dataclasses.fields(obj) if f.metadata.get("static")]
    doubled = jax.jit(lambda t: jax.tree.map(lambda x: x * 2, t))(obj)
    for s in statics:
        assert getattr(doubled, s) == getattr(obj, s)
        assert isinstance(getattr(doubled, s), int)
    # replace() returns a new frozen instance and leaves the original
    first = dataclasses.fields(obj)[0].name
    new_val = jax.tree.map(jnp.zeros_like, getattr(obj, first))
    rep = obj.replace(**{first: new_val})
    assert rep is not obj
    np.testing.assert_array_equal(
        jax.tree.leaves(getattr(rep, first))[0],
        jax.tree.leaves(new_val)[0],
    )
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, new_val)


def test_camera_is_a_pytree_of_vec3():
    _, cam, _ = cornell_box()
    assert isinstance(cam, Camera)
    assert len(jax.tree.leaves(cam)) == 12
