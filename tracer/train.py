"""Differentiable-rendering optimization loop — the framework's `fit()`.

The reference is a one-shot renderer (`rendu.ppm`, its
`main.cpp:251-262`); inverse rendering is this framework's
own north-star surface (BASELINE.md gradient-fidelity metric): given a
target image, recover trainable scene parameters (sphere geometry,
material albedos, texture/normal-map texels, mesh vertices, camera pose)
by gradient descent through the renderer.

Product path (SURVEY.md section 5 checkpoint/resume + observability):
- optax Adam on an L2 image loss;
- per-step JSON metrics (loss, global grad norm, step time);
- (params, opt state, step) checkpoints with EXACT resume: leaves are
  saved bit-for-bit with np.savez and restored into the same pytree
  structure, so an interrupted run continues on the identical trajectory.

Scope: gradients flow through the SHADING of the selected hits (albedo,
texels, normals, positions at fixed visibility) — hit selection is
detached by design (SURVEY.md section 7), so parameters whose loss signal
is dominated by coverage/silhouette changes (e.g. large object-position
offsets) need edge-sampling/soft-visibility machinery this framework does
not implement; optimize them only in regimes where shading gradients
dominate.

CLI: `python -m tracer.cli train ...` (tracer/cli.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import jax
import numpy as np
import optax
import jax.numpy as jnp

from tracer.core.config import RenderConfig
from tracer.render.camera import Camera

# Scene fields that may be optimized (differentiable parameter surfaces;
# SURVEY.md section 2: verts/materials/texels/camera are parameters).
SCENE_FIELDS = ("sph_center", "sph_radius", "mat_diffuse", "mat_ior",
                "mat_transparency", "mat_check1", "mat_check2",
                "mat_light_color", "mat_light_intensity",
                "tex_data", "nm_data", "mesh_verts",
                "quad_v0", "quad_er", "quad_eu")
CAM_FIELD = "cam_position"
CAM_QUAT_FIELD = "cam_quaternion"
CAM_FIELDS = (CAM_FIELD, CAM_QUAT_FIELD)


def split_params(scene, camera: Camera, trainable: Sequence[str]):
    """Trainable pytree from (scene, camera)."""
    params = {}
    for k in trainable:
        if k == CAM_FIELD:
            params[k] = camera.position
        elif k == CAM_QUAT_FIELD:
            # raw 4-vector; generate_rays normalizes, so the optimizer can
            # move it freely and the effective pose stays on SO(3)
            params[k] = camera.quaternion
        elif k in SCENE_FIELDS:
            params[k] = getattr(scene, k)
        else:
            raise ValueError(
                f"unknown trainable {k!r}; scene fields: {SCENE_FIELDS} "
                f"or camera fields: {CAM_FIELDS}")
    return params


def apply_params(scene, camera: Camera, params: Dict):
    """(scene, camera) with `params` substituted."""
    sfields = {k: v for k, v in params.items() if k not in CAM_FIELDS}
    scene = dataclasses.replace(scene, **sfields)
    if CAM_FIELD in params:
        camera = dataclasses.replace(camera, position=params[CAM_FIELD])
    if CAM_QUAT_FIELD in params:
        camera = dataclasses.replace(camera,
                                     quaternion=params[CAM_QUAT_FIELD])
    return scene, camera


def _save_ckpt(path: str, step: int, params, opt_state):
    leaves = jax.tree_util.tree_leaves((params, opt_state))
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    tmp = path + ".tmp.npz"
    np.savez(tmp, step=np.int64(step), **arrays)
    os.replace(tmp, path)  # atomic (renderer/film.py tile-ckpt discipline)


def _load_ckpt(path: str, params, opt_state):
    with np.load(path) as z:
        step = int(z["step"])
        tmpl, treedef = jax.tree_util.tree_flatten((params, opt_state))
        leaves = []
        for i, t in enumerate(tmpl):
            a = z[f"leaf_{i}"]
            assert a.shape == tuple(t.shape) and a.dtype == t.dtype, (
                f"checkpoint leaf {i} mismatch: {a.shape}/{a.dtype} vs "
                f"{t.shape}/{t.dtype} — trainable set or scene changed?")
            leaves.append(jnp.asarray(a))
    return step, jax.tree_util.tree_unflatten(treedef, leaves)


def make_step(opt, cfg: RenderConfig, target, width: int, height: int,
              nsamples: int, mesh=None):
    """Build the PURE (jittable) optimization step shared by fit() and
    the sharded demo step (tracer/dist/sharding.train_step): L2 image
    loss, value_and_grad over the trainable params, one optax update.

    Returns step_fn(params, opt_state, scene, camera, pixel_ids,
    base_key) -> (params, opt_state, loss, grad_norm)."""
    from tracer.render.renderer import render_pixels
    from tracer.dist.sharding import render_pixels_sharded

    target = jnp.asarray(target, jnp.float32).reshape(-1, 3)

    def loss_fn(params, scene, camera, pixel_ids, base_key):
        s, c = apply_params(scene, camera, params)
        if mesh is not None:
            img = render_pixels_sharded(s, c, cfg, width, height,
                                        pixel_ids, nsamples, base_key,
                                        mesh)
        else:
            img = render_pixels(s, c, cfg, width, height, pixel_ids,
                                nsamples, base_key) / nsamples
        return jnp.mean((img - target) ** 2)

    def step_fn(params, opt_state, scene, camera, pixel_ids, base_key):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, camera,
                                                  pixel_ids, base_key)
        gnorm = optax.global_norm(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, gnorm

    return step_fn


def fit(scene, camera: Camera, cfg: RenderConfig, target,
        trainable: Sequence[str], steps: int, lr: float = 1e-2,
        width: Optional[int] = None, height: Optional[int] = None,
        nsamples: Optional[int] = None, base_key=None,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
        log: Optional[Callable[[str], None]] = None, mesh=None,
        optimizer=None):
    """Optimize `trainable` so the render matches `target` [H, W, 3].

    Returns (scene, camera, history) — history is a list of per-step
    metric dicts. With `ckpt_dir`, resumes from `ckpt_dir/train.npz` if
    present and checkpoints every `ckpt_every` steps (exact resume).
    With `mesh` (a jax.sharding.Mesh), the render is sharded over its
    (dp, sp) axes and gradients cross the mesh via autodiff psums.
    """
    from tracer.render.renderer import render_pixels
    from tracer.dist.sharding import render_pixels_sharded

    width = width or cfg.width
    height = height or cfg.height
    nsamples = nsamples or cfg.nsamples
    base_key = base_key if base_key is not None else jax.random.key(cfg.seed)
    target = jnp.asarray(target, jnp.float32).reshape(-1, 3)
    pixel_ids = jnp.arange(width * height, dtype=jnp.int32)

    params = split_params(scene, camera, trainable)
    opt = optimizer if optimizer is not None else optax.adam(lr)
    opt_state = opt.init(params)
    step_fn = jax.jit(make_step(opt, cfg, target, width, height,
                                nsamples, mesh))

    start = 0
    ckpt_path = None
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt_path = os.path.join(ckpt_dir, "train.npz")
        if os.path.exists(ckpt_path):
            start, (params, opt_state) = _load_ckpt(ckpt_path, params,
                                                    opt_state)

    history = []
    for s in range(start, steps):
        t0 = time.perf_counter()
        params, opt_state, loss, gnorm = step_fn(
            params, opt_state, scene, camera, pixel_ids, base_key)
        rec = {"step": s + 1, "loss": float(loss),
               "grad_norm": float(gnorm),
               "step_s": round(time.perf_counter() - t0, 4)}
        history.append(rec)
        if log:
            log(json.dumps(rec))
        if ckpt_path and ((s + 1) % ckpt_every == 0 or s + 1 == steps):
            _save_ckpt(ckpt_path, s + 1, params, opt_state)

    scene, camera = apply_params(scene, camera, params)
    return scene, camera, history
