"""RenderMonitor: progress lines, JSON mode, preview writing."""

import io
import json

import numpy as np

from raytpu.core.types import RenderConfig
from raytpu.observe import RenderMonitor, trace_profile


def test_progress_lines():
    cfg = RenderConfig(width=8, height=4, spp=10, max_bounces=3)
    buf = io.StringIO()
    mon = RenderMonitor(cfg, out=buf)
    mon.update(5)
    line = buf.getvalue()
    assert "5/10 spp" in line and "Mrays/s" in line and "eta" in line


def test_json_mode():
    cfg = RenderConfig(width=8, height=4, spp=10)
    buf = io.StringIO()
    mon = RenderMonitor(cfg, out=buf, structured=True)
    mon.update(10)
    rec = json.loads(buf.getvalue())
    assert rec["samples"] == 10 and rec["spp"] == 10
    assert rec["rays_per_s"] > 0


def test_preview_write(tmp_path):
    cfg = RenderConfig(width=8, height=4, spp=4, max_bounces=2)
    p = str(tmp_path / "prev.png")
    mon = RenderMonitor(cfg, out=io.StringIO(), preview_path=p, preview_every=1)
    sums = np.random.default_rng(0).uniform(0, 4, (cfg.n_pixels, 3)).astype(np.float32)
    mon.update(2, sums=sums)
    from PIL import Image

    img = np.asarray(Image.open(p))
    assert img.shape == (4, 8, 3)


def test_trace_profile_noop():
    with trace_profile(None):
        pass  # must not require jax import side effects


def test_compilation_cache_dir(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache lives
    in the checkout's .jax_cache, which .gitignore lists."""
    import os

    from raytpu.observe import compilation_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    assert compilation_cache_dir() == "/somewhere/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compilation_cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
