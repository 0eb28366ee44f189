"""Checkpoint/resume: a killed-and-resumed render must be bit-identical
to an uninterrupted one (SURVEY.md §5.4), and mismatched settings must
fail loudly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.types import RenderConfig
from raytpu.io.checkpoint import (
    load_checkpoint,
    render_image_checkpointed,
    save_checkpoint,
)
from raytpu.integrator.render import render_image
from raytpu.scenes import cornell_box


@pytest.fixture(scope="module")
def setup():
    scene, cam, _ = cornell_box()
    cfg = RenderConfig(width=16, height=8, spp=8, max_bounces=3)
    return scene, cam, cfg, jax.random.PRNGKey(11)


def test_checkpointed_matches_straight(tmp_path, setup):
    scene, cam, cfg, key = setup
    straight = render_image(scene, cam, cfg, key)
    ck = render_image_checkpointed(
        scene, cam, cfg, key, str(tmp_path / "r.npz"), flush_every=3
    )
    np.testing.assert_array_equal(straight.image, ck.image)
    np.testing.assert_array_equal(straight.canvas, ck.canvas)


def test_resume_is_bit_identical(tmp_path, setup):
    scene, cam, cfg, key = setup
    path = str(tmp_path / "r.npz")

    # simulate a kill after 4 of 8 samples: run with spp=4 but the full
    # config fingerprint by rendering partial batches directly
    partial = render_image_checkpointed(
        scene, cam, cfg.replace(spp=4), key, path, flush_every=4
    )
    # rewrite the sidecar as if it were the spp=8 run interrupted halfway
    st = load_checkpoint(path, cfg.replace(spp=4), 11)
    rad, alb, nrm, done = st
    assert done == 4
    save_checkpoint(path, rad, alb, nrm, done, cfg, 11)

    resumed = render_image_checkpointed(scene, cam, cfg, key, path)
    straight = render_image(scene, cam, cfg, key)
    np.testing.assert_array_equal(straight.image, resumed.image)


def test_mismatched_settings_fail(tmp_path, setup):
    scene, cam, cfg, key = setup
    path = str(tmp_path / "r.npz")
    render_image_checkpointed(scene, cam, cfg, key, path)
    with pytest.raises(ValueError, match="different settings"):
        render_image_checkpointed(
            scene, cam, cfg.replace(max_bounces=4), key, path
        )
