"""Command-line interface — the replacement for the reference's GLUT
keyboard UI (its `main.cpp:266-342`): `render` replaces the
`r` key, `benchmark` the FPS counter, `grad-check` the MONORAY debug probe,
`probe` is MONORAY itself (single-ray trace of one pixel, Constants.h:6 +
main.cpp:216-227).

    python -m tracer.cli render --scene cornell_box --out rendu.ppm
    python -m tracer.cli render --scene flamingo --spp 4 --width 320
    python -m tracer.cli probe --scene cornell_box --x 220 --y 270
    python -m tracer.cli benchmark
    python -m tracer.cli grad-check
    python -m tracer.cli scenes
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _build(name: str, width: int, height: int, seed: int, cfg=None):
    from tracer.scene.device import compile_scene
    from tracer.scenes import zoo

    if name not in zoo.BY_NAME:
        raise SystemExit(f"unknown scene {name!r}; try: "
                         + ", ".join(sorted(zoo.BY_NAME)))
    fn = zoo.BY_NAME[name]
    if name == "cornell_box":
        sb = fn(width / height)
    elif name == "random_spheres":
        sb = fn(seed)
    else:
        sb = fn()
    kw = {}
    if cfg is not None:  # BVH build knobs ride the config (Constants.h:15-16)
        kw = dict(leaf_width=cfg.bvh_leaf_size,
                  bvh_max_depth=cfg.bvh_max_depth)
    return compile_scene(sb, **kw)


def _camera(args):
    """Camera from the pose flags (default: the reference app's startup
    pose — eye (0,0,6.1), identity orientation, fov 45, main.cpp:418 /
    Camera.cpp:24-37). `--cam-pos/--cam-quat/--look-at/--fov` reach any
    trackball pose the reference UI could produce (Camera.cpp:41-132)."""
    import dataclasses
    import jax.numpy as jnp
    from tracer.render.camera import default_camera, look_at_quaternion

    def vec(s, n, name):
        parts = [float(x) for x in s.split(",")]
        if len(parts) != n:
            raise SystemExit(f"--{name} wants {n} comma-separated floats")
        return jnp.asarray(parts, jnp.float32)

    cam = default_camera(aspect=args.width / args.height)
    if args.cam_pos:
        cam = dataclasses.replace(cam,
                                  position=vec(args.cam_pos, 3, "cam-pos"))
    if args.cam_quat and args.look_at:
        raise SystemExit("--cam-quat and --look-at are exclusive")
    if args.cam_quat:
        q = vec(args.cam_quat, 4, "cam-quat")
        cam = dataclasses.replace(
            cam, quaternion=q / jnp.maximum(jnp.linalg.norm(q), 1e-20))
    if args.look_at:
        cam = dataclasses.replace(cam, quaternion=look_at_quaternion(
            cam.position, vec(args.look_at, 3, "look-at")))
    if args.fov is not None:
        cam = dataclasses.replace(cam, fov_deg=jnp.float32(args.fov))
    return cam


def cmd_render(args):
    from tracer.core.config import RenderConfig
    from tracer.render.renderer import render_image

    cfg = RenderConfig(nsamples=args.spp, width=args.width,
                       height=args.height, max_bounces=args.bounces,
                       shadow_rays=args.shadow_rays, compat=args.compat,
                       seed=args.seed, bvh_leaf_size=args.bvh_leaf,
                       bvh_max_depth=args.bvh_depth)
    scene = _build(args.scene, args.width, args.height, args.seed, cfg)
    cam = _camera(args)
    t0 = time.perf_counter()
    render_image(scene, cam, cfg, args.out, progress=args.progress,
                 ckpt_dir=args.ckpt_dir, tile=args.tile)
    dt = time.perf_counter() - t0
    n_rays = args.width * args.height * args.spp
    print(f"rendered {args.scene} {args.width}x{args.height}@{args.spp}spp "
          f"-> {args.out} in {dt:.2f}s ({n_rays / dt / 1e6:.2f} Mrays/s "
          f"incl. compile)")


def cmd_probe(args):
    """MONORAY: trace a single pixel's ray and print the radiance."""
    import jax
    import jax.numpy as jnp
    from tracer.core import rng as trng
    from tracer.core.config import RenderConfig
    from tracer.render import integrator
    from tracer.render.camera import generate_rays

    cfg = RenderConfig(max_bounces=args.bounces, compat=args.compat,
                       seed=args.seed, bvh_leaf_size=args.bvh_leaf,
                       bvh_max_depth=args.bvh_depth)
    scene = _build(args.scene, args.width, args.height, args.seed, cfg)
    cam = _camera(args)
    u = jnp.asarray([args.x / args.width], jnp.float32)
    v = jnp.asarray([args.y / args.height], jnp.float32)
    o, d = generate_rays(cam, u, v)
    keys = trng.ray_keys(jax.random.key(cfg.seed),
                         jnp.asarray([args.y * args.width + args.x]))
    rad = integrator.trace(scene, cfg, o, d, jnp.zeros(1), keys)
    import numpy as np
    print(json.dumps({
        "pixel": [args.x, args.y],
        "origin": np.asarray(o)[0].tolist(),
        "direction": np.asarray(d)[0].tolist(),
        "radiance": np.asarray(rad)[0].tolist(),
    }))


def _compile_stats(args):
    """benchmark --compile: trace / lower / compile wall seconds for the
    flagship frame chunk (render_pixels on the selected scene). With the
    persistent compilation cache (tracer/compile_cache.py), the compile
    stage of a previously-seen (scene-shape, config) pair is a cache hit."""
    import jax
    import jax.numpy as jnp
    from tracer import compile_cache
    from tracer.core.config import RenderConfig
    from tracer.render.renderer import render_pixels

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, compat=args.compat,
                       seed=args.seed)
    scene = _build(args.scene, args.width, args.height, args.seed, cfg)
    cam = _camera(args)
    pid = jnp.arange(args.width * args.height, dtype=jnp.int32)
    key = jax.random.key(cfg.seed)
    spp = args.spp

    cache = compile_cache.cache_dir()
    jf = jax.jit(
        lambda s, c, p, k: jnp.mean(render_pixels(
            s, c, cfg, args.width, args.height, p, spp, k)),
    )
    t0 = time.perf_counter()
    traced = jf.trace(scene, cam, pid, key)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    lowered = traced.lower()
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    v = float(compiled(scene, cam, pid, key))
    t_run = time.perf_counter() - t0
    print(json.dumps({
        "scene": args.scene,
        "config": f"{args.width}x{args.height}@{spp}spp "
                  f"b{cfg.max_bounces}",
        "trace_s": round(t_trace, 3),
        "lower_s": round(t_lower, 3),
        "compile_s": round(t_compile, 3),
        "first_run_s": round(t_run, 3),
        "cache_dir": cache,
        "cache_entries": (len(os.listdir(cache)) if os.path.isdir(cache)
                          else 0),
        "mean_radiance": v,
        "device": str(jax.devices()[0]),
    }))


def cmd_benchmark(args):
    if args.compile_stats:
        return _compile_stats(args)
    if not (args.occupancy or args.profile):
        import bench
        bench.main()
        return

    import jax
    import numpy as np
    import jax.numpy as jnp
    from tracer.core import rng as trng
    from tracer.core.config import RenderConfig
    from tracer.render import integrator
    from tracer.render.camera import generate_rays

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, compat=args.compat,
                       seed=args.seed, bvh_leaf_size=args.bvh_leaf,
                       bvh_max_depth=args.bvh_depth)
    scene = _build(args.scene, args.width, args.height, args.seed, cfg)
    cam = _camera(args)
    n = args.width * args.height
    pid = jnp.arange(n, dtype=jnp.int32)
    keys = trng.ray_keys(jax.random.key(cfg.seed), pid)
    jit_uv = trng.uniform(trng.salted(keys, trng.PIXEL_JITTER), (2,))
    x = (pid % args.width).astype(jnp.float32)
    y = (pid // args.width).astype(jnp.float32)
    o, d = generate_rays(cam, (x + jit_uv[:, 0]) / args.width,
                         (y + jit_uv[:, 1]) / args.height)
    tm = trng.uniform(trng.salted(keys, trng.RAY_TIME))

    @jax.jit
    def frame(o, d, tm, keys):
        rad, aux = integrator.trace(scene, cfg, o, d, tm, keys,
                                    with_aux=True)
        return jnp.mean(rad), aux["occupancy"]

    mean, occ = frame(o, d, tm, keys)  # compile + run
    if args.profile:
        with jax.profiler.trace(args.profile):
            mean, occ = frame(o, d, tm, keys)
            float(mean)
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        m = float(frame(o, d, tm, keys)[0])  # noqa: F841 (sync fetch)
    dt = (time.perf_counter() - t0) / reps
    print(json.dumps({
        "scene": args.scene,
        "config": f"{args.width}x{args.height} b{cfg.max_bounces} 1spp",
        "primary_rays_per_s": round(n / dt),
        "occupancy_per_bounce": [round(float(v), 4)
                                 for v in np.asarray(occ)],
        "device": str(jax.devices()[0].device_kind),
    }))


def cmd_grad_check(args):
    import dataclasses
    import jax.numpy as jnp
    from tracer.core import rng as trng
    from tracer.core.config import RenderConfig
    from tracer.diff.fd import compare_ad_fd
    from tracer.render import integrator
    from tracer.render.camera import default_camera, generate_rays
    from tracer.scene.builder import SceneBuilder, Material
    from tracer.scene.device import compile_scene
    import jax

    sb = SceneBuilder()
    sb.add_light((-2., 4., 3.), radius=0.0)
    sb.add_sphere((0., 0., 0.), 1.0, Material(diffuse=(0.8, 0.3, 0.2)))
    scene = compile_scene(sb)
    cfg = RenderConfig(max_bounces=1)
    cam = default_camera(aspect=1.0)
    n = 5
    u = jnp.linspace(0.48, 0.52, n)
    v = jnp.full(n, 0.5)
    o, d = generate_rays(cam, u, v)
    keys = trng.ray_keys(jax.random.key(0), jnp.arange(n, dtype=jnp.int32))

    results = {}
    for pname, field, idx in [("sphere_center", "sph_center", 0),
                              ("sphere_radius", "sph_radius", 0),
                              ("albedo", "mat_diffuse", 1)]:
        def loss(p, field=field, idx=idx):
            arr = getattr(scene, field).at[idx].set(p)
            s2 = dataclasses.replace(scene, **{field: arr})
            return jnp.sum(integrator.trace(s2, cfg, o, d, jnp.zeros(n),
                                            keys))
        p0 = getattr(scene, field)[idx]
        _, _, err, ok = compare_ad_fd(jax.jit(loss), p0)
        results[pname] = {"max_abs_err": err, "ok": ok}

    # mesh vertex positions (shared-vertex grads, reference Mesh.h:111-124)
    from tracer.scene.builder import MeshObject
    import numpy as np
    sbm = SceneBuilder()
    sbm.add_light((-2., 4., 3.), radius=0.0)
    sbm.add_mesh(MeshObject(
        [(-1.5, -1.0, 0.0), (0.0, -1.0, 0.0), (0.0, 1.0, 0.0),
         (1.5, -1.0, 0.0)], [(0, 1, 2), (1, 3, 2)],
        material=Material(diffuse=(0.7, 0.4, 0.2))))
    scm = compile_scene(sbm)
    um = jnp.linspace(0.44, 0.56, n)
    om, dm = generate_rays(cam, um, jnp.full(n, 0.45))

    def loss_v(p):
        s2 = dataclasses.replace(scm, mesh_verts=scm.mesh_verts.at[1].set(p))
        return jnp.sum(integrator.trace(s2, cfg, om, dm, jnp.zeros(n), keys))

    _, _, err, ok = compare_ad_fd(jax.jit(loss_v), scm.mesh_verts[1])
    results["mesh_vertex"] = {"max_abs_err": err, "ok": ok}

    # texture-atlas texels (Material.cpp:82-88)
    sbt = SceneBuilder()
    sbt.add_light((0., 0., 5.), radius=0.0)
    img = (np.arange(4 * 4 * 3).reshape(4, 4, 3) * 5 + 16).astype(np.uint8)
    mt = Material(diffuse=(1.0, 1.0, 1.0))
    mt.texture_type = 2
    mt.texture_id = sbt.add_texture(img)
    sbt.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 4., 4., mt)
    sct = compile_scene(sbt)
    ot, dt_ = generate_rays(cam, jnp.linspace(0.35, 0.65, n),
                            jnp.full(n, 0.5))

    @jax.jit
    def loss_t(p):
        s2 = dataclasses.replace(sct, tex_data=p)
        return jnp.sum(integrator.trace(s2, cfg, ot, dt_, jnp.zeros(n),
                                        keys))

    g_ad = np.asarray(jax.grad(loss_t)(sct.tex_data), np.float64)
    touched = np.argwhere(np.abs(g_ad).sum(axis=1) > 0)[:, 0][:2]
    ok_t = touched.size > 0
    err_t = 0.0
    p0n = np.asarray(sct.tex_data, np.float64)
    for i in touched:
        for a in range(3):
            dp = np.zeros_like(p0n)
            dp[i, a] = 1e-3
            lp = float(loss_t(jnp.asarray(p0n + dp, jnp.float32)))
            lm = float(loss_t(jnp.asarray(p0n - dp, jnp.float32)))
            fd = (lp - lm) / 2e-3
            err_t = max(err_t, abs(g_ad[i, a] - fd))
            ok_t &= abs(g_ad[i, a] - fd) < 1e-2 + 5e-2 * max(abs(fd), 1.0)
    results["texels"] = {"max_abs_err": err_t, "ok": bool(ok_t)}

    print(json.dumps(results, indent=2))
    if not all(r["ok"] for r in results.values()):
        sys.exit(1)


def cmd_train(args):
    """Inverse-rendering demo/product loop: render a target from the true
    scene, perturb the trainable parameters, recover them by Adam through
    the differentiable renderer. With --ckpt-dir, an interrupted run
    resumes bit-exactly ((params, opt state, step) checkpoints)."""
    import dataclasses
    import jax
    import numpy as np
    import jax.numpy as jnp
    from tracer.core.config import RenderConfig
    from tracer.render.renderer import render_pixels
    from tracer import train as T

    cfg = RenderConfig(nsamples=args.spp, width=args.width,
                       height=args.height, max_bounces=args.bounces,
                       shadow_rays=args.shadow_rays, compat=args.compat,
                       seed=args.seed, bvh_leaf_size=args.bvh_leaf,
                       bvh_max_depth=args.bvh_depth)
    scene = _build(args.scene, args.width, args.height, args.seed, cfg)
    cam = _camera(args)
    trainable = [t.strip() for t in args.train.split(",") if t.strip()]

    base_key = jax.random.key(cfg.seed)
    pid = jnp.arange(args.width * args.height, dtype=jnp.int32)
    target = (render_pixels(scene, cam, cfg, args.width, args.height, pid,
                            args.spp, base_key) / args.spp)

    # deterministic perturbation of every trainable parameter
    true_params = T.split_params(scene, cam, trainable)
    pk = jax.random.key(args.seed + 1)
    pert = {}
    for i, (k, v) in enumerate(sorted(true_params.items())):
        scale = args.perturb * (jnp.abs(v).mean() + 0.1)
        pert[k] = v + scale * jax.random.normal(
            jax.random.fold_in(pk, i), v.shape, v.dtype)
    scene0, cam0 = T.apply_params(scene, cam, pert)

    def dist(params):
        return {k: float(jnp.abs(params[k] - true_params[k]).max())
                for k in true_params}

    print(json.dumps({"event": "start", "trainable": trainable,
                      "param_err": dist(pert)}))
    s2, c2, hist = T.fit(scene0, cam0, cfg, target, trainable,
                         steps=args.steps, lr=args.lr, width=args.width,
                         height=args.height, nsamples=args.spp,
                         base_key=base_key, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log=print)
    final = T.split_params(s2, c2, trainable)
    print(json.dumps({"event": "done",
                      "loss_first": hist[0]["loss"] if hist else None,
                      "loss_last": hist[-1]["loss"] if hist else None,
                      "param_err": dist(final)}))


def cmd_scenes(args):
    from tracer.scenes import zoo
    for i, (name, _) in sorted(zoo.SCENES.items()):
        print(f"{i:2d}  {name}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tracer", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="cornell_box")
        sp.add_argument("--width", type=int, default=850)
        sp.add_argument("--height", type=int, default=480)
        sp.add_argument("--bounces", type=int, default=6)
        sp.add_argument("--compat", default="reference",
                        choices=["reference", "physical"])
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--bvh-leaf", type=int, default=16,
                        dest="bvh_leaf",
                        help="BVH leaf width (triangles per leaf)")
        sp.add_argument("--bvh-depth", type=int, default=64,
                        dest="bvh_depth", help="BVH max depth")
        sp.add_argument("--cam-pos", default=None, metavar="X,Y,Z",
                        help="camera position (default 0,0,6.1 — the "
                             "reference app's startup pose)")
        sp.add_argument("--cam-quat", default=None, metavar="W,X,Y,Z",
                        help="camera orientation quaternion")
        sp.add_argument("--look-at", default=None, metavar="X,Y,Z",
                        help="aim the camera at this point "
                             "(alternative to --cam-quat)")
        sp.add_argument("--fov", type=float, default=None,
                        help="vertical field of view in degrees "
                             "(default 45, Camera.cpp:24)")

    r = sub.add_parser("render", help="ray trace a scene to an image")
    common(r)
    r.add_argument("--spp", type=int, default=20)
    r.add_argument("--shadow-rays", type=int, default=10)
    r.add_argument("--out", default="rendu.ppm")
    r.add_argument("--progress", action="store_true")
    r.add_argument("--ckpt-dir", default=None,
                   help="tile-checkpoint dir: atomic per-tile saves; "
                        "re-running resumes, re-rendering only missing tiles")
    r.add_argument("--tile", type=int, default=128,
                   help="checkpoint tile size (with --ckpt-dir)")
    r.set_defaults(fn=cmd_render)

    pr = sub.add_parser("probe", help="MONORAY single-ray debug probe")
    common(pr)
    pr.add_argument("--x", type=int, default=220)
    pr.add_argument("--y", type=int, default=270)
    pr.set_defaults(fn=cmd_probe)

    b = sub.add_parser("benchmark", help="Cornell rays/s benchmark; "
                       "--occupancy/--profile give per-bounce counters "
                       "and a jax.profiler trace for any scene")
    common(b)
    b.add_argument("--spp", type=int, default=16)
    b.add_argument("--compile", dest="compile_stats",
                   action="store_true",
                   help="report trace/lower/compile seconds for the "
                        "flagship frame (persistent cache makes later "
                        "runs start warm)")
    b.add_argument("--occupancy", action="store_true",
                   help="report per-bounce active-lane occupancy + rays/s")
    b.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of one frame to DIR")
    b.set_defaults(fn=cmd_benchmark)

    g = sub.add_parser("grad-check", help="AD vs finite-difference check")
    g.set_defaults(fn=cmd_grad_check)

    t = sub.add_parser(
        "train", help="inverse rendering: recover perturbed scene params "
        "by Adam through the renderer; checkpoints + exact resume")
    common(t)
    t.add_argument("--spp", type=int, default=4)
    t.add_argument("--shadow-rays", type=int, default=4)
    t.add_argument("--train", default="mat_diffuse",
                   help="comma list of trainable fields "
                        "(scene fields or cam_position)")
    t.add_argument("--steps", type=int, default=40)
    t.add_argument("--lr", type=float, default=1e-2)
    t.add_argument("--perturb", type=float, default=0.05,
                   help="relative scale of the initial perturbation")
    t.add_argument("--ckpt-dir", default=None,
                   help="save (params, opt state, step) here; re-running "
                        "resumes exactly")
    t.add_argument("--ckpt-every", type=int, default=10)
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("scenes", help="list built-in scenes")
    s.set_defaults(fn=cmd_scenes)

    args = p.parse_args(argv)
    from tracer import compile_cache
    compile_cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
