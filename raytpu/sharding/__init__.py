"""Device-mesh sharded rendering.

The reference parallelizes over pixels only: pthread row slabs on CPU
(/root/reference/main.c:404-453) and one CUDA thread per pixel
(/root/reference/main_cuda.cu:143-147, 281-282); samples are sequential
in both, and there is no multi-device or multi-node path at all
(SURVEY.md §2 "Parallelism strategies").

Generalization: a 2-axis ``jax.sharding.Mesh``
(``('tiles', 'samples')``). Pixels are sharded over ``tiles`` (the
renderer's data-parallel axis — disjoint outputs, no communication,
like the pthread slabs but load-balanced by construction since every
pixel costs the same fixed-depth scan). Samples are sharded over
``samples``: each device renders the *same* pixels at ``spp / n``
samples using disjoint global sample indices, and the radiance sums are
combined with one ``psum`` over the axis — the renderer's analog of a
data-parallel gradient all-reduce. Because
RNG keys are derived from (pixel_id, global_sample_id)
(raytpu.core.rng), every mesh factorization computes exactly the same
per-sample terms as a single device; the sums agree up to f32
summation order (the psum of per-device partials associates the adds
differently), which the determinism tests assert to 1e-5 on a virtual
8-device CPU mesh.
"""

from raytpu.sharding.mesh import (
    make_mesh,
    render_sharded,
    render_image_sharded,
)
from raytpu.sharding.multihost import (
    init_distributed,
    make_global_mesh,
    render_image_multihost,
)

__all__ = [
    "make_mesh",
    "render_sharded",
    "render_image_sharded",
    "init_distributed",
    "make_global_mesh",
    "render_image_multihost",
]
