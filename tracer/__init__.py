"""tracer — a differentiable wavefront ray tracer built from scratch in JAX,
running on an NVIDIA GPU through XLA.

Capability parity target: Kuuro-neko/HAI719-Raytracing (a C++ CPU path
tracer; see SURVEY.md). Architecture is batch-first, not a translation:

- rays are SoA batches `(origins[N,3], dirs[N,3], times[N])`, never objects;
- sphere/quad intersection tests every ray against the whole primitive
  table at once, as fused elementwise XLA code
  (see `tracer/geometry/primitives.py`);
- the reference's pointer KD-tree (`src/KDTree.cpp`) is recast as a flattened
  SoA BVH with stackless skip-link traversal (`tracer/accel/bvh.py`);
- the recursive integrator (`src/Scene.h:258-342`) is a wavefront bounce loop
  under `lax.scan` (`tracer/render/integrator.py`);
- scanline `std::thread` parallelism (`main.cpp:229-238`) is `shard_map`
  over a `jax.sharding.Mesh` (`tracer/dist/sharding.py`);
- everything is differentiable end-to-end (vertices, materials, texels,
  camera pose), `tracer/diff`.
"""

from tracer.core.config import RenderConfig
from tracer.render.renderer import render, render_image
from tracer.scenes import zoo

__all__ = ["RenderConfig", "render", "render_image", "zoo"]
__version__ = "0.1.0"
