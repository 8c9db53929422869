"""Distribution tests on the forced 8-device CPU mesh (SURVEY.md §4.4):
sharded render must be bitwise-identical to the single-device render, and
gradients must flow through the shard_map (psum'ed parameter grads).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tracer.core.config import RenderConfig
from tracer.dist.sharding import (make_ray_mesh, render_pixels_sharded,
                                  train_step)
from tracer.render.camera import default_camera
from tracer.scene.builder import SceneBuilder, Material, MIRROR
from tracer.scene.device import compile_scene


def _tiny_scene():
    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((-2., 4., 3.), radius=1.0)
    sb.add_sphere((0., 0., 0.), 1.0, Material(diffuse=(0.8, 0.3, 0.2)))
    sb.add_sphere((1.8, 0., -1.), 0.7, Material(mtype=MIRROR,
                                                diffuse=(0.9, 0.9, 0.9)))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.2, 0.))
    return compile_scene(sb)


WIDTH, HEIGHT = 16, 8
CFG = RenderConfig(width=WIDTH, height=HEIGHT, max_bounces=3, shadow_rays=2)


def _render(mesh, nsamples=8):
    scene = _tiny_scene()
    cam = default_camera(aspect=WIDTH / HEIGHT)
    pixel_ids = jnp.arange(WIDTH * HEIGHT, dtype=jnp.int32)
    key = jax.random.key(0)
    return np.asarray(render_pixels_sharded(
        scene, cam, CFG, WIDTH, HEIGHT, pixel_ids, nsamples, key, mesh))


def test_requires_8_devices():
    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"


def test_sharded_equals_single_device():
    ref = _render(make_ray_mesh(n_dp=1, n_sp=1, devices=jax.devices()[:1]))
    for n_dp, n_sp in [(8, 1), (4, 2), (2, 4), (1, 8)]:
        got = _render(make_ray_mesh(n_dp=n_dp, n_sp=n_sp))
        # identical ray set + deterministic RNG => same image up to f32
        # reduction-order differences in the sample psum
        assert np.allclose(got, ref, atol=1e-5), (n_dp, n_sp,
                                                  np.abs(got - ref).max())


def test_train_step_runs_and_reduces():
    mesh = make_ray_mesh(n_dp=4, n_sp=2)
    scene = _tiny_scene()
    cam = default_camera(aspect=WIDTH / HEIGHT)
    pixel_ids = jnp.arange(WIDTH * HEIGHT, dtype=jnp.int32)
    target = jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32)
    loss, new_scene, new_cam = train_step(
        scene, cam, CFG, WIDTH, HEIGHT, pixel_ids, target, nsamples=2,
        base_key=jax.random.key(1), mesh=mesh)
    assert np.isfinite(float(loss)) and float(loss) > 0
    # parameters actually moved (gradients were nonzero somewhere)
    moved = np.abs(np.asarray(new_scene.mat_diffuse)
                   - np.asarray(scene.mat_diffuse)).max()
    assert moved > 0
    # replicated across devices (no per-shard divergence)
    assert np.isfinite(np.asarray(new_scene.sph_center)).all()
