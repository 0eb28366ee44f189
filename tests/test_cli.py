"""End-to-end CLI tests: render and train drive the full stack through
``raytpu.cli.main`` exactly as a user would."""

import json
import os

import numpy as np
import pytest

from raytpu.cli import main


def test_render_png(tmp_path):
    out = str(tmp_path / "x.png")
    rc = main([
        "render", "cornell", "--spp", "4", "--width", "32", "--height",
        "24", "--out", out,
    ])
    assert rc == 0 and os.path.exists(out)
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (24, 32, 3)
    assert img.mean() > 5  # not black


def test_render_ppm_scene_spec(tmp_path):
    out = str(tmp_path / "x.ppm")
    rc = main([
        "render", "scenes/cornell.toml", "--spp", "2", "--width", "16",
        "--height", "12", "--out", out,
    ])
    assert rc == 0
    from raytpu.io.ppm import read_ppm

    img = read_ppm(out, bottom_up=False)
    assert img.shape == (12, 16, 3)


def test_render_denoise_and_aov(tmp_path):
    out = str(tmp_path / "d.png")
    rc = main([
        "render", "cornell", "--spp", "2", "--width", "16", "--height",
        "12", "--out", out, "--denoise", "--aov",
    ])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "d_albedo.png"))
    assert os.path.exists(str(tmp_path / "d_normal.png"))


def test_render_checkpoint_preview_and_json(tmp_path, capsys):
    """--preview writes a preview PNG at every flush and --log-json emits
    machine-parseable progress lines (the monitor must actually be driven
    by the checkpointed render, SURVEY.md §5.5)."""
    out = str(tmp_path / "x.png")
    prev = str(tmp_path / "preview.png")
    ckpt = str(tmp_path / "state.npz")
    rc = main([
        "render", "cornell", "--spp", "4", "--width", "16", "--height",
        "12", "--out", out, "--checkpoint", ckpt, "--flush-every", "2",
        "--preview", prev, "--log-json",
    ])
    assert rc == 0 and os.path.exists(out)
    assert os.path.exists(prev), "--preview never wrote a file"
    from PIL import Image

    assert np.asarray(Image.open(prev)).shape == (12, 16, 3)
    json_lines = [
        json.loads(l)
        for l in capsys.readouterr().err.splitlines()
        if l.startswith("{")
    ]
    assert len(json_lines) == 2  # one per flush (spp=4 / flush_every=2)
    assert json_lines[-1]["samples"] == 4
    assert json_lines[-1]["rays_per_s"] > 0


def test_train_reduces_loss(tmp_path, capsys):
    # target = a render of the scene itself, so optimization must converge
    target = str(tmp_path / "t.png")
    main([
        "render", "cornell", "--spp", "4", "--width", "12", "--height",
        "8", "--out", target,
    ])
    out = str(tmp_path / "trained.png")
    rc = main([
        "train", "cornell", "--target", target, "--steps", "6",
        "--spp", "2", "--width", "12", "--height", "8", "--lr", "3e-2",
        "--out", out, "--log-every", "1",
    ])
    assert rc == 0 and os.path.exists(out)
    lines = [
        l for l in capsys.readouterr().out.splitlines()
        if l.startswith("step ")
    ]
    first = float(lines[0].split()[-1])
    last = float(lines[-1].split()[-1])
    assert last < first


def test_render_path_choice_is_automatic(tmp_path, monkeypatch):
    """No flag or environment variable picks the path: the CLI asks
    kernel_serves (platform + scene), which on this CPU backend sends
    the render to the scan path — the image equals render_image's."""
    import jax

    from raytpu.integrator import render as render_mod
    from raytpu.io.ppm import read_ppm
    from raytpu.scenes import cornell_box

    calls = []
    real = render_mod.kernel_serves

    def spy(scene, platform=None):
        calls.append(real(scene, platform))
        return calls[-1]

    monkeypatch.setattr(render_mod, "kernel_serves", spy)
    out = str(tmp_path / "x.ppm")
    rc = main([
        "render", "cornell", "--spp", "2", "--width", "16",
        "--height", "12", "--out", out,
    ])
    assert rc == 0 and calls and not any(calls)
    scene, cam, cfg = cornell_box()
    want = render_mod.render_image(
        scene, cam, cfg.replace(width=16, height=12, spp=2),
        jax.random.PRNGKey(0),
    )
    got = read_ppm(out, bottom_up=False)
    np.testing.assert_array_equal(
        np.round(got * 255.0), want.canvas.astype(np.float32)
    )


def test_runs_without_flax_and_pil(tmp_path):
    """`import raytpu` and a small `cli render` to PPM need neither flax
    nor PIL (both blocked through sys.modules in a fresh interpreter)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "x.ppm")
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import raytpu\n"
        "from raytpu.cli import main\n"
        f"rc = main(['render', 'cornell', '--spp', '1', '--width', '8',"
        f" '--height', '6', '--out', {out!r}])\n"
        "assert 'flax' not in [m.split('.')[0] for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    from raytpu.io.ppm import read_ppm

    assert read_ppm(out, bottom_up=False).shape == (6, 8, 3)
