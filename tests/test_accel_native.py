"""Native (C++) BVH builder vs the numpy builder and brute force."""

import numpy as np
import jax.numpy as jnp
import pytest

from tracer.accel.bvh import build_bvh, triangle_bounds
from tracer.accel.native import build_bvh_native


def _random_tris(n=200, seed=0):
    rng = np.random.RandomState(seed)
    verts = rng.randn(n, 3, 3).astype(np.float32)
    lo = verts.min(axis=1) - 1e-5
    hi = verts.max(axis=1) + 1e-5
    return lo, hi


def _validate(bvh, lo, hi):
    n = lo.shape[0]
    # every triangle appears exactly once across the leaves
    tris = bvh.leaf_tris[bvh.leaf_tris >= 0]
    assert sorted(tris.tolist()) == list(range(n))
    # every leaf's triangles are inside the leaf box
    for i in range(bvh.n_nodes):
        ls = bvh.node_leaf_start[i]
        if ls < 0:
            continue
        ids = bvh.leaf_tris[ls:ls + bvh.leaf_width]
        ids = ids[ids >= 0]
        assert (bvh.node_lo[i][None] <= lo[ids] + 1e-4).all()
        assert (bvh.node_hi[i][None] >= hi[ids] - 1e-4).all()
    # skip links frame valid subtrees
    assert (bvh.node_skip > np.arange(bvh.n_nodes)).all()
    assert (bvh.node_skip <= bvh.n_nodes).all()


def test_numpy_builder_valid():
    lo, hi = _random_tris()
    bvh = build_bvh(lo, hi, leaf_width=4)
    _validate(bvh, lo, hi)


def test_native_builder_valid():
    lo, hi = _random_tris(500, seed=2)
    bvh = build_bvh_native(lo, hi, leaf_width=4)
    if bvh is None:
        pytest.skip("native builder unavailable (no g++?)")
    _validate(bvh, lo, hi)


def test_native_traversal_matches_numpy_traversal():
    """Same closest hit through either builder's tree."""
    from tracer.scene.builder import SceneBuilder, MeshObject
    from tracer.scene.device import compile_scene
    from tracer.geometry import primitives as prim

    from tests.test_primitives import _filter_degenerate

    rng = np.random.RandomState(5)
    verts = rng.randn(80, 3).astype(np.float32)
    tris = rng.randint(0, 80, (120, 3)).astype(np.int32)
    tris = _filter_degenerate(verts, tris)

    sb = SceneBuilder()
    sb.add_mesh(MeshObject(verts, tris))
    scene_np = compile_scene(sb, use_native=False)
    scene_cc = compile_scene(sb, use_native=True)

    o = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    d = rng.randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    t1, _ = prim.mesh_closest_hits(jnp.asarray(o), jnp.asarray(d), scene_np,
                                   1e-5)
    t2, _ = prim.mesh_closest_hits(jnp.asarray(o), jnp.asarray(d), scene_cc,
                                   1e-5)
    assert np.allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5, atol=1e-5)


def test_leaf_width_8_parity():
    """cfg.bvh_leaf_size round-trips into the build, and the plain path
    (BVH walk for hits and shadow rays) gives the same radiance at leaf
    widths 4, 8 and 16 on a procedural mesh."""
    import jax
    from tracer.core import rng as trng
    from tracer.core.config import RenderConfig
    from tracer.render import integrator
    from tracer.render.camera import default_camera, generate_rays
    from tracer.scene.builder import SceneBuilder, Material
    from tracer.scene.device import compile_scene
    from tracer.scenes.procedural import lumpy_sphere

    def scene(lw):
        sb = SceneBuilder()
        sb.add_light((-2., 4., 3.), radius=1.0)
        sb.add_mesh(lumpy_sphere(8, 12, seed=2, material=Material(
            diffuse=(0.7, 0.5, 0.3))))
        s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8.,
                          8., Material(diffuse=(0.3, 0.6, 0.9)))
        s.rotate_x(-90).translate((0., -1.4, 0.))
        return compile_scene(sb, leaf_width=lw)

    n = 96
    cam = default_camera(aspect=1.0)
    u = jnp.linspace(0.2, 0.8, n)
    v = jnp.linspace(0.3, 0.7, n)
    o, d = generate_rays(cam, u, v)
    keys = trng.ray_keys(jax.random.key(5), jnp.arange(n, dtype=jnp.int32))
    tm = jnp.zeros(n)
    cfg = RenderConfig(max_bounces=2, shadow_rays=2)

    out = {}
    for lw in (4, 8, 16):
        sc = scene(lw)
        assert sc.leaf_width == lw
        assert sc.bvh_leaf_tris.shape[0] % lw == 0
        out[lw] = np.asarray(integrator.trace(sc, cfg, o, d, tm, keys))
    assert np.abs(out[8]).max() > 0
    # leaf width is an accel knob, not a semantic one
    for lw in (4, 16):
        np.testing.assert_allclose(out[lw], out[8], atol=2e-5, rtol=0)


def test_builder_reports_fallback(monkeypatch, tmp_path):
    """When the native library cannot be built, the numpy builder runs and
    says so: a warning, and builder() names it."""
    from tracer.accel import native

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "_lib_path",
                        lambda: str(tmp_path / "libtracer_native.so"))
    with pytest.warns(RuntimeWarning, match="numpy builder"):
        assert build_bvh_native(*_random_tris(20)) is None
    assert native.builder().startswith("numpy")
