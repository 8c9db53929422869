"""Benchmark: Cornell-box throughput on one GPU.

Prints ONE JSON line:
  {"metric": "primary_rays_per_s_fwd_cornell", "value": N, "unit": "rays/s",
   ...extras, "device": {"platform", "kind", "count"}}

"Primary rays" = width*height*spp camera rays; each one costs up to
`max_bounces` scene traversals plus `lights*shadow_rays*max_bounces` shadow
traversals, reported separately as `total_rays_per_s`. The fwd+bwd number
follows the gradient protocol of BASELINE.md: the gradient of mean
radiance w.r.t. (mat_diffuse, sph_center, tex_data) at 16 spp.

Timing: each function is compiled and run once, then timed over `reps`
calls that each end in `jax.block_until_ready`; the median is reported.
The benchmark refuses to run without a GPU: a CPU number is not a device
number.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

import jax
import jax.numpy as jnp


def require_gpu():
    """The first JAX device, or SystemExit when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r} devices")
    return dev


def timeit(jfn, args, reps):
    """(median seconds per call, first-call seconds). The first call
    compiles (or hits the persistent cache) and is reported apart."""
    t0 = time.perf_counter()
    jax.block_until_ready(jfn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), first


def main():
    from tracer import compile_cache
    from tracer.core.config import RenderConfig
    from tracer.render.renderer import render_pixels
    from tracer.render.camera import default_camera
    from tracer.scene.device import compile_scene
    from tracer.scenes import zoo

    dev = require_gpu()
    compile_cache.enable()
    width = int(os.environ.get("BENCH_WIDTH", 850))
    height = int(os.environ.get("BENCH_HEIGHT", 480))
    spp = int(os.environ.get("BENCH_SPP", 16))
    reps = int(os.environ.get("BENCH_REPS", 5))

    cfg = RenderConfig(width=width, height=height, nsamples=spp)
    scene = compile_scene(zoo.setup_cornell_box(width / height))
    camera = default_camera(aspect=width / height)
    n_pix = width * height
    pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
    base_key = jax.random.key(0)

    # `render_pixels` IS the product path the CLI render uses (one
    # compiled frame chunk, a scan over samples).
    def frame(scene, camera, pixel_ids, base_key):
        return render_pixels(scene, camera, cfg, width, height, pixel_ids,
                             spp, base_key)

    dt, first = timeit(jax.jit(frame), (scene, camera, pixel_ids, base_key),
                       reps)
    primary = n_pix * spp
    n_lights = scene.light_pos.shape[0]  # cornell: 0
    per_primary = cfg.max_bounces * (1 + n_lights * cfg.shadow_rays)

    def loss(diff, center, tex, scene, camera, pixel_ids, base_key):
        s2 = dataclasses.replace(scene, mat_diffuse=diff, sph_center=center,
                                 tex_data=tex)
        acc = render_pixels(s2, camera, cfg, width, height, pixel_ids,
                            spp, base_key)
        return jnp.mean(acc / spp)

    gargs = (scene.mat_diffuse, scene.sph_center, scene.tex_data, scene,
             camera, pixel_ids, base_key)
    dt_bwd, first_bwd = timeit(
        jax.jit(jax.grad(loss, argnums=(0, 1, 2))), gargs, reps)

    print(json.dumps({
        "metric": "primary_rays_per_s_fwd_cornell",
        "value": primary / dt,
        "unit": "rays/s",
        "total_rays_per_s": primary * per_primary / dt,
        "fwdbwd_primary_rays_per_s": primary / dt_bwd,
        "first_call_s": {"fwd": first, "fwdbwd": first_bwd},
        "config": f"{width}x{height}@{spp}spp b{cfg.max_bounces}",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
