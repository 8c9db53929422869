"""Hand-written replay backward (render/replay_bwd.py) vs the autodiff
replay vjp: full cotangent pytrees must agree leaf-by-leaf on the phase-1
scene class (Cornell-like: emissive + textured + normal-mapped quads,
glass/mirror/motion-blur spheres, no lights, no meshes)."""

from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tracer.core import rng as trng
from tracer.core.config import RenderConfig
from tracer.render import integrator, replay_bwd
from tracer.render.camera import default_camera, generate_rays
from tracer.scene.builder import SceneBuilder, Material
from tracer.scene.device import compile_scene

GLASS, MIRROR = 1, 2
TEX_CHECKERBOARD, TEX_IMAGE = 1, 2


def _scene():
    sb = SceneBuilder()
    rs = np.random.RandomState(3)
    img = (rs.rand(8, 8, 3) * 255).astype(np.uint8)
    nm = (rs.rand(8, 8, 3) * 255).astype(np.uint8)
    ti = sb.add_texture(img)
    ni = sb.add_normal_map(nm)

    m_tex = Material(diffuse=(0.9, 0.8, 0.7))
    m_tex.texture_type = TEX_IMAGE
    m_tex.texture_id = ti
    m_tex.normal_map_id = ni
    sb.add_square((-2., -1., -4.), (1., 0., 0.), (0., 1., 0.), 4., 2.,
                  m_tex)

    m_chk = Material(diffuse=(0.4, 0.5, 0.6))
    m_chk.texture_type = TEX_CHECKERBOARD
    m_chk.checkerboard_color1 = (0.9, 0.2, 0.1)
    m_chk.checkerboard_color2 = (0.1, 0.2, 0.9)
    m_chk.texture_scale_x = 3.0
    m_chk.texture_scale_y = 2.0
    sb.add_square((-2., -1.2, 0.), (1., 0., 0.), (0., 0., -1.), 4., 4.,
                  m_chk)

    m_em = Material(diffuse=(0.2, 0.2, 0.2))
    m_em.emissive = True
    m_em.light_color = (0.9, 0.7, 0.5)
    m_em.light_intensity = 2.5
    sb.add_square((-1., 1.4, -2.), (1., 0., 0.), (0., 0., 1.), 2., 2.,
                  m_em)

    sb.add_sphere((0.5, -0.2, -2.0), 0.5, Material(
        mtype=GLASS, diffuse=(0.9, 0.9, 0.9), index_medium=1.5))
    sb.add_sphere((-0.8, 0.0, -2.5), 0.45, Material(
        mtype=MIRROR, diffuse=(0.8, 0.8, 0.8)))
    m_mb = Material(diffuse=(0.6, 0.3, 0.2))
    m_mb.motion_blur_translation = (0.0, 0.3, 0.0)
    sb.add_sphere((1.2, 0.6, -3.0), 0.4, m_mb)
    return compile_scene(sb)


def _rays(n=64, seed=0):
    cam = default_camera(aspect=1.0)
    k = jax.random.fold_in(jax.random.key(7), seed)
    u = jax.random.uniform(k, (n,), minval=0.2, maxval=0.8)
    v = jax.random.uniform(jax.random.fold_in(k, 1), (n,),
                           minval=0.2, maxval=0.8)
    o, d = generate_rays(cam, u, v)
    keys = trng.ray_keys(jax.random.key(11),
                         jnp.arange(n, dtype=jnp.int32))
    t = jax.random.uniform(jax.random.fold_in(k, 2), (n,))
    return o, d, t, keys


def _vjp(scene, cfg, o, d, t, keys, g, hand):
    def f(scene, o, d, t):
        return integrator.trace(scene, cfg, o, d, t, keys)

    if hand:
        assert replay_bwd.hand_bwd_ok(scene, cfg)
        out, vjp = jax.vjp(f, scene, o, d, t)
        return out, vjp(g)
    with mock.patch.object(replay_bwd, "hand_bwd_ok",
                           lambda *a: False):
        out, vjp = jax.vjp(f, scene, o, d, t)
        return out, vjp(g)


@pytest.mark.parametrize("compat,max_bounces", [
    ("reference", 4), ("physical", 4), ("reference", 1), ("physical", 2)])
def test_hand_bwd_matches_autodiff(compat, max_bounces):
    """max_bounces 1 and 2 cover the unrolled last bounce with no and one
    scanned bounce before it."""
    scene = _scene()
    assert scene.pair_mode and scene.tex_data.shape[0] > 1
    cfg = RenderConfig(max_bounces=max_bounces, compat=compat)
    o, d, t, keys = _rays()
    g = jax.random.normal(jax.random.key(5), (o.shape[0], 3))

    out_a, (gs_a, go_a, gd_a, gt_a) = _vjp(scene, cfg, o, d, t, keys, g,
                                           hand=False)
    out_h, (gs_h, go_h, gd_h, gt_h) = _vjp(scene, cfg, o, d, t, keys, g,
                                           hand=True)
    np.testing.assert_array_equal(np.asarray(out_a), np.asarray(out_h))

    def close(name, a, b, atol=2e-4):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(
            b, a, atol=atol * scale, rtol=2e-4,
            err_msg=f"cotangent mismatch: {name}")

    close("o", go_a, go_h)
    close("d", gd_a, gd_h)
    close("time", gt_a, gt_h)
    for fname in ["sph_center", "sph_radius", "mat_mb", "quad_v0",
                  "quad_er", "quad_eu", "quad_tan", "quad_bitan",
                  "mat_check1", "mat_check2", "mat_diffuse",
                  "mat_light_color", "mat_light_intensity",
                  "mat_emissive", "mat_ior", "mat_transparency",
                  "mat_texscale", "tex_data", "nm_data", "dark_sky"]:
        close(fname, getattr(gs_a, fname), getattr(gs_h, fname))


def test_gate_rejects_other_classes():
    from tracer.scenes import zoo
    cfg = RenderConfig()
    cornell = compile_scene(zoo.setup_cornell_box(1.5))
    assert replay_bwd.hand_bwd_ok(cornell, cfg)
    lit = compile_scene(zoo.setup_single_sphere())
    # single_sphere has an explicit light -> falls back to autodiff replay
    assert (lit.light_pos.shape[0] == 0) == replay_bwd.hand_bwd_ok(
        lit, cfg)
