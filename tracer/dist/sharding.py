"""Multi-device distribution via `shard_map` over a device mesh.

The reference's entire parallelism story is one std::thread per scanline on
one machine (its `main.cpp:229-238`). The recast here (SURVEY.md §2
parallelism inventory):

- **dp** axis — data parallel over pixels/tiles: each device traces a
  disjoint slice of the pixel stream (the analog of scanline threads).
- **sp** axis — "sequence" parallel over the sample stream: per-pixel
  sample batches are split across devices and reduced with `psum` (the
  ray/sample stream is the sequence dimension; rays are embarrassingly
  parallel so no ring/Ulysses machinery is needed).
- TP/PP/EP are N/A for this workload (no weight matrices, no pipeline
  stages, no experts) — scene geometry and the material/texture tables are
  replicated per device; only *parameter gradients* (vertices, materials,
  texels, camera pose) need cross-device reduction, which autodiff inserts
  as `psum` when differentiating through the `shard_map`. On one host of
  four GPUs joined all to all by NVLink every pair of devices talks at the
  same rate, so the mesh shape follows the algorithm alone: dp needs no
  traffic in the forward pass, sp costs one psum of the pixel radiance.

Determinism: pixel->device assignment is a pure function of (pixel id,
mesh shape), so a resumed/elastic job re-renders identical pixels
(SURVEY.md §5 failure recovery).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tracer.core import rng
from tracer.core.config import RenderConfig
from tracer.render import integrator
from tracer.render.camera import Camera, generate_rays


def make_ray_mesh(n_dp: Optional[int] = None, n_sp: int = 1,
                  devices=None) -> Mesh:
    """A (dp, sp) mesh over the available devices, in jax.devices()
    order. Across several hosts pass `devices` host-major, so that `sp`
    (the sample psum) stays within a host and `dp` (independent tiles, no
    forward traffic) spans hosts."""
    devices = devices if devices is not None else jax.devices()
    if n_dp is None:
        n_dp = len(devices) // n_sp
    devices = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(devices, ("dp", "sp"))


def _trace_pixels(scene, camera: Camera, cfg: RenderConfig, width: int,
                  height: int, pixel_ids, sample_ids, base_key):
    """Radiance for pixel_ids x sample_ids, averaged over the samples.
    pixel_ids: [n] i32; sample_ids: [s] i32. Returns [n, 3]."""
    def one_sample(sid):
        # pixel_ids vary over dp only; sid varies over sp. Promote the ray
        # state to varying over both mesh axes so the integrator's scan
        # carry types line up under shard_map.
        pids = jax.lax.pcast(pixel_ids, ("sp",), to="varying")
        keys = rng.ray_keys(base_key, pids)
        keys = rng.salted(keys, sid)
        jit_uv = rng.uniform(rng.salted(keys, rng.PIXEL_JITTER), (2,))
        x = (pids % width).astype(jnp.float32)
        y = (pids // width).astype(jnp.float32)
        u = (x + jit_uv[:, 0]) / width
        v = (y + jit_uv[:, 1]) / height
        time = rng.uniform(rng.salted(keys, rng.RAY_TIME))
        o, d = generate_rays(camera, u, v)
        return integrator.trace(scene, cfg, o, d, time, keys)

    rad = jax.lax.map(one_sample, sample_ids)   # [s, n, 3]
    return jnp.sum(rad, axis=0)


def render_pixels_sharded(scene, camera: Camera, cfg: RenderConfig,
                          width: int, height: int, pixel_ids, nsamples: int,
                          base_key, mesh: Mesh):
    """Pixel radiance [N, 3], pixels sharded over dp, samples over sp.

    `pixel_ids` must be divisible by mesh.shape['dp'], and `nsamples` by
    mesh.shape['sp']. Differentiable w.r.t. scene/camera parameters —
    reverse-mode AD through the shard_map produces psum'ed (replicated)
    parameter gradients.
    """
    n_sp = mesh.shape["sp"]
    sample_ids = jnp.arange(nsamples, dtype=jnp.int32)

    # check_vma=False: the replay backward accumulates the texel-atlas
    # cotangent across the bounce scan; jax's varying-manual-axes checker
    # types the zero init as replicated but the per-bounce scatter-add as
    # varying and rejects the carry (jax-ml/jax#26623-family carry-typing
    # limitation; the error message itself prescribes this workaround).
    # NOTE this disables the missing-psum type check for this whole
    # function and its backward — re-enable once the carry-typing bug is
    # fixed upstream. Semantics are unaffected: every cross-device
    # reduction here is an explicit psum, and test_dist pins sharded ==
    # single-device bitwise.
    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), P("dp"), P("sp")),
        out_specs=P("dp"))
    def fwd(scene_, camera_, pids, sids):
        rad = _trace_pixels(scene_, camera_, cfg, width, height, pids, sids,
                            base_key)
        rad = jax.lax.psum(rad, "sp")
        return rad / jnp.float32(nsamples)

    return fwd(scene, camera, pixel_ids, sample_ids)


def train_step(scene, camera: Camera, cfg: RenderConfig, width: int,
               height: int, pixel_ids, target, nsamples: int, base_key,
               mesh: Mesh, lr: float = 1e-2):
    """One differentiable-rendering optimization step over the device
    mesh — a thin delegation to the product training machinery
    (`tracer.train.make_step`, the same pure step `fit()` jits), so the
    sharded path exercises the same parameter handling and optimizer
    plumbing as single-device training. Jittable. Gradients cross the
    mesh via the psums autodiff inserts for the shard_map — the
    equivalent of an all-reduce over scanline workers.

    Returns (loss, new_scene, new_camera).
    """
    import optax

    from tracer import train as T

    trainable = ["sph_center", "sph_radius", "mat_diffuse", "tex_data",
                 "mesh_verts", "cam_position"]
    opt = optax.sgd(lr)
    params = T.split_params(scene, camera, trainable)
    step_fn = T.make_step(opt, cfg, target, width, height, nsamples, mesh)
    params, _, loss, _ = step_fn(params, opt.init(params), scene, camera,
                                 pixel_ids, base_key)
    new_scene, new_camera = T.apply_params(scene, camera, params)
    return loss, new_scene, new_camera
