"""The plain XLA paths that replaced the fused kernels, against brute force:
the soft-shadow factor against tests/oracle.py, and the per-ray BVH walk
against an all-triangle test, on procedural meshes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tracer.core import rng as trng
from tracer.core.config import RenderConfig
from tracer.geometry import primitives as prim
from tracer.render import integrator
from tracer.scene.builder import SceneBuilder, Material
from tracer.scene.device import compile_scene
from tracer.scenes.procedural import lumpy_sphere
from tests.oracle import Oracle

EPS = 1e-5


def _shadow_scene(occluder):
    """Two lights over a floor line; opaque occluders between them."""
    sb = SceneBuilder()
    sb.add_light((-2., 4., 3.), radius=1.0)
    sb.add_light((3., 2., 1.), radius=0.5)
    if occluder == "mesh":
        m = sb.add_mesh(lumpy_sphere(6, 10, seed=1))
        m.scale((0.9, 0.9, 0.9)).translate((-0.6, 0.9, 0.9))
    else:
        sb.add_sphere((-0.6, 0.9, 0.9), 0.8, Material())
        q = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 1., 1.,
                          Material())
        q.rotate_x(-90).translate((1.6, 0.2, -0.6))
    return sb


@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("occluder", ["analytic", "mesh"])
def test_shadow_factor_matches_oracle(compat, occluder):
    """integrator._shadow_factor_jnp vs the oracle's Scene::computeShadow
    fed the same light-sample points: per ray, the fraction of the K
    shadow rays that reach each light."""
    sb = _shadow_scene(occluder)
    scene = compile_scene(sb)
    orc = Oracle(sb, rand=lambda: 0.5)   # opaque: every hit blocks
    cfg = RenderConfig(shadow_rays=6, compat=compat)
    n = 64
    t = np.linspace(-1.0, 3.0, n).astype(np.float32)
    p = (jnp.asarray(t), jnp.full(n, -1.4, jnp.float32),
         jnp.asarray(-0.75 * t))
    time = jnp.zeros(n)
    keys = trng.ray_keys(jax.random.key(7), jnp.arange(n, dtype=jnp.int32))
    P = np.stack([np.asarray(c, np.float64) for c in p], -1)
    for i, light in enumerate(sb.lights):
        got = np.asarray(integrator._shadow_factor_jnp(
            scene, cfg, p, time, keys, EPS, i))
        skeys = trng.salted(keys, trng.SHADOW_LIGHT_POS, i)
        blocked = np.zeros((cfg.shadow_rays, n))
        for k in range(cfg.shadow_rays):
            ruv = (trng.cube_unit_vector_lane_p(skeys, k)
                   if compat == "reference"
                   else trng.sphere_unit_vector_lane_p(skeys, k))
            ruv = np.stack([np.asarray(c, np.float64) for c in ruv], -1)
            lp = np.asarray(light.pos, np.float64) + light.radius / 2 * ruv
            for r in range(n):
                off = lp[r] - P[r]
                tl = np.linalg.norm(off)
                sd = off / tl
                blocked[k, r] = orc.compute_shadow(P[r] + EPS * sd, sd, 0.0,
                                                   tl)
        want = 1.0 - blocked.mean(axis=0)
        # a shadow ray grazing an occluder's edge may resolve differently
        # in float32: allow one flipped sample on a few rays
        bad = np.abs(got - want) > 1e-6
        assert bad.mean() <= 0.05, (i, got[bad], want[bad])
        assert np.abs(got - want).max() <= 1.0 / cfg.shadow_rays + 1e-6
        if i == 0:   # light 0 sits behind the occluders: real penumbra
            assert want.min() < 1.0 and want.max() > 0.0


@pytest.mark.parametrize("leaf_width", [4, 8, 16])
def test_bvh_walk_matches_bruteforce(leaf_width):
    """prim.mesh_closest_hits (the per-ray skip-link walk) vs the oracle's
    all-triangle test, for rays from outside and inside a closed mesh."""
    sb = SceneBuilder()
    sb.add_mesh(lumpy_sphere(9, 14, seed=4, bump=0.3))
    scene = compile_scene(sb, leaf_width=leaf_width)
    assert scene.leaf_width == leaf_width
    orc = Oracle(sb)
    rs = np.random.RandomState(leaf_width)
    n = 96
    o = rs.randn(n, 3)
    o *= 3.0 / np.linalg.norm(o, axis=1, keepdims=True)   # outside
    o[: n // 4] *= 0.1           # inside: back faces only, so all miss
    d = rs.uniform(-0.8, 0.8, (n, 3)) - o                 # toward the mesh
    d[: n // 4] = rs.randn(n // 4, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    t_w, tri_w = prim.mesh_closest_hits(jnp.asarray(o), jnp.asarray(d),
                                        scene, EPS)
    t_w, tri_w = np.asarray(t_w)[:, 0], np.asarray(tri_w)[:, 0]
    n_hit = 0
    for r in range(n):
        h = orc.isect_mesh(sb.meshes[0], o[r].astype(np.float64),
                           d[r].astype(np.float64), 0.0)
        if h is None:
            assert t_w[r] > 1e30, (r, t_w[r])
            continue
        n_hit += 1
        assert abs(t_w[r] - h["t"]) < 2e-3 * max(1.0, h["t"]), (r, t_w[r],
                                                               h["t"])
        assert tri_w[r] == h["ti"] or abs(t_w[r] - h["t"]) < 1e-5
    assert n_hit > n // 2   # most outside rays hit
