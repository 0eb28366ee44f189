"""Observability: structured progress, throughput metrics, profiling.

The reference's only observability is a racy percent ticker
(/root/reference/main.c:48,250-258: unsynchronized ``rendered_pixels``
increments from every worker) and one wall-clock print at the end
(main.c:491-496). Here:

  * :class:`RenderMonitor` — structured per-batch progress lines with
    rays/s, percent done and ETA (rays counted as W*H*spp*bounces, the
    SURVEY §5.1 metric), plus optional periodic preview PNG writes.
  * :func:`trace_profile` — context manager around ``jax.profiler`` for
    capturing device traces viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Optional

import numpy as np

from raytpu.core.types import RenderConfig


class RenderMonitor:
    """Tracks sample progress for one render and emits log lines.

    >>> mon = RenderMonitor(cfg)
    >>> mon.update(samples_done=64)   # after each flushed batch
    """

    def __init__(
        self,
        cfg: RenderConfig,
        out=None,
        preview_path: Optional[str] = None,
        preview_every: int = 0,
        structured: bool = False,
    ):
        self.cfg = cfg
        self.out = out  # None -> sys.stderr at emit time (late bound)
        self.preview_path = preview_path
        self.preview_every = preview_every
        self.structured = structured
        self.t0 = time.perf_counter()
        self.samples_done = 0
        self._last_preview = 0

    @property
    def rays_per_sample(self) -> int:
        return self.cfg.n_pixels * self.cfg.max_bounces

    def update(self, samples_done: int, sums=None) -> None:
        self.samples_done = samples_done
        elapsed = time.perf_counter() - self.t0
        rays = samples_done * self.rays_per_sample
        rps = rays / elapsed if elapsed > 0 else 0.0
        frac = samples_done / self.cfg.spp
        eta = elapsed * (1 - frac) / frac if frac > 0 else float("inf")
        if self.structured:
            line = json.dumps({
                "samples": samples_done, "spp": self.cfg.spp,
                "elapsed_s": round(elapsed, 2),
                "rays_per_s": round(rps, 1), "eta_s": round(eta, 1),
            })
        else:
            line = (
                f"[render] {samples_done}/{self.cfg.spp} spp "
                f"({100*frac:.1f}%)  {rps/1e6:.1f} Mrays/s  "
                f"elapsed {elapsed:.1f}s  eta {eta:.1f}s"
            )
        print(line, file=self.out or sys.stderr, flush=True)

        if (
            self.preview_path
            and self.preview_every
            and sums is not None
            and samples_done - self._last_preview >= self.preview_every
        ):
            self._last_preview = samples_done
            self.write_preview(sums, samples_done)

    def write_preview(self, rad_sums: np.ndarray, samples_done: int) -> None:
        """rad_sums: (n_pixels, 3) radiance sums accumulated so far."""
        import jax.numpy as jnp

        from raytpu.core.color import quantize, tonemap
        from raytpu.core.vec3 import Vec3

        h, w = self.cfg.height, self.cfg.width
        mean = rad_sums.reshape(h, w, 3) / max(samples_done, 1)
        toned = tonemap(Vec3.from_array(jnp.asarray(mean)))
        canvas = np.asarray(quantize(toned).to_array(), np.uint8)[::-1]
        from PIL import Image

        Image.fromarray(canvas).save(self.preview_path)


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str]):
    """jax.profiler.trace wrapper; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` in the
    checkout (listed in .gitignore). A fixed path, because the path is
    part of the cache key."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache for the CLI, bench.py and
    chip_smoke.py; library users opt in themselves."""
    import os

    import jax

    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
