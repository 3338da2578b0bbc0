"""The wavefront path tracer that renders ``.bin`` training data
(counterpart of ``sbmc_tpu/render``): :mod:`.scene` (the scene model),
:mod:`.assets` (OBJ, texture and envmap pools), :mod:`.prng` (JAX's
threefry keys on the host) and :mod:`.pathtracer` (the tracer and the
dataset writer)."""

from sbmc_tpu_torch.render.pathtracer import (  # noqa: F401
    TracerScene,
    random_tracer_scene,
    render_pass,
    render_tile_wavefront,
    render_tiles_wavefront,
)
