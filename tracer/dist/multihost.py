"""Multi-host execution: jax.distributed process groups, host-major
meshes, and cross-host film gathering.

The reference is strictly single-machine (its `main.cpp:229-238` —
pthread fork/join); this module is the SURVEY §5 / §7-stage-7 recast:
tiles×samples sharded over a (dp, sp) mesh whose dp axis is laid out
host-major, so independent pixel tiles span hosts (zero cross-host
traffic in the forward pass) while the sample-psum and parameter-gradient
reductions stay among each host's devices. On one host (one process, e.g.
four GPUs joined all to all by NVLink) the same functions run unchanged:
the mesh is then (devices // n_sp, n_sp).

Typical multi-host usage (one process per host):

    from tracer.dist import multihost as mh
    mh.initialize()                       # jax.distributed from env vars
    mesh = mh.make_pod_mesh()             # dp = hosts x leftover devices
    img  = mh.render_image_multihost(scene, cam, cfg, mesh)   # full frame

The same code path is exercised hardware-free by
tests/test_multiprocess.py: 2 CPU processes x 4 virtual devices each.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tracer.core.config import RenderConfig
from tracer.render.camera import Camera


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize, with env-var fallback
    (JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID). No-op for a
    single process."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_pod_mesh(n_sp: Optional[int] = None) -> Mesh:
    """Host-major (dp, sp) mesh over ALL processes' devices.

    sp (sample-psum, the collective-heavy axis) = devices WITHIN one host,
    so its reductions never cross hosts; dp (independent pixel tiles) =
    hosts x the remaining per-host devices, where forward traffic is ~zero.
    Device order is jax.devices() sorted host-major (process_index, local
    order), which IS jax.devices()' order."""
    devs = jax.devices()
    n_hosts = jax.process_count()
    per_host = len(devs) // n_hosts
    if n_sp is None:
        n_sp = per_host
    assert per_host % n_sp == 0, (per_host, n_sp)
    grid = np.asarray(devs).reshape(n_hosts * (per_host // n_sp), n_sp)
    return Mesh(grid, ("dp", "sp"))


def global_pixel_array(pixel_ids: np.ndarray, mesh: Mesh):
    """Build a dp-sharded GLOBAL device array from host-replicated pixel
    ids (every process passes the same full [N] array)."""
    sh = NamedSharding(mesh, P("dp"))
    return jax.make_array_from_callback(
        pixel_ids.shape, sh, lambda idx: pixel_ids[idx])


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (scene, camera, keys) across the whole mesh."""
    sh = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.make_array_from_callback(
            jnp.shape(x), sh, lambda idx: np.asarray(x)[idx]), tree)


def gather_film(global_rad) -> np.ndarray:
    """Fetch a dp-sharded [N, 3] radiance array to EVERY host as numpy
    (jax.experimental.multihost_utils.process_allgather semantics — the
    multi-host analog of main.cpp's thread-join + shared image buffer)."""
    if jax.process_count() == 1:
        return np.asarray(global_rad)
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(global_rad, tiled=True))


def render_image_multihost(scene, camera: Camera, cfg: RenderConfig,
                           mesh: Mesh, width: Optional[int] = None,
                           height: Optional[int] = None,
                           nsamples: Optional[int] = None) -> np.ndarray:
    """Full-frame multi-host render -> gamma-corrected [H, W, 3] on every
    host. Pixels are padded to a multiple of dp so the shard_map shapes are
    static; the pad pixels re-render pixel 0 and are dropped."""
    from tracer.core.mathutils import gamma_correct
    from tracer.dist.sharding import render_pixels_sharded

    width = width or cfg.width
    height = height or cfg.height
    nsamples = nsamples or cfg.nsamples
    n_dp = mesh.shape["dp"]
    n_pix = width * height
    n_pad = ((n_pix + n_dp - 1) // n_dp) * n_dp
    pids = np.arange(n_pad, dtype=np.int32) % n_pix
    g_pids = global_pixel_array(pids, mesh)
    scene_r, cam_r = replicate((scene, camera), mesh)
    base_key = jax.random.key(cfg.seed)

    rad = jax.jit(
        lambda s, c, p: render_pixels_sharded(
            s, c, cfg, width, height, p, nsamples, base_key, mesh)
    )(scene_r, cam_r, g_pids)
    film = gather_film(rad)[:n_pix]
    img = np.asarray(gamma_correct(jnp.asarray(film)))
    return np.clip(img, 0.0, 1.0).reshape(height, width, 3)
