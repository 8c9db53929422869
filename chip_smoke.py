"""Smoke test of the renderer on NVIDIA GPUs, through the entry points a
user calls, at the reference's own settings.

    python chip_smoke.py          # one GPU: the six phases below
    python chip_smoke.py --four   # four GPUs: the sharded paths only

One GPU (phases in order; any failure exits non-zero):
1. device   — refuse anything but a GPU; print its kind, count, the JAX
               version, `nvidia-smi`'s name and power limit, and the BVH
               builder in use;
2. parity   — render the committed CPU self-goldens (single_square,
               random_spheres, debug_refraction, cornell_box) on the GPU
               and compare with the self-golden tolerance;
3. forward  — Cornell at 850x480, 20 spp, 6 bounces through tracer.render,
               with its generated image maps at full size;
4. gradient — the fwd+bwd protocol (d mean radiance / d (mat_diffuse,
               sph_center, tex_data), 850x480, 16 spp) and `grad-check`;
5. mesh     — a 52,896-triangle procedural mesh with one light at 850x480,
               1 spp, 6 bounces; a crop is compared with the CPU backend;
6. train    — 3 train.fit steps on Cornell, then an exact resume.

Four GPUs: render_pixels_sharded as (dp=4, sp=1) and (dp=2, sp=2) against
single-GPU render_pixels, dist.sharding.train_step against the one-GPU
step, and multihost.render_image_multihost in one process.

Every number printed carries the card's name and power limit. The last
line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Tolerance between the CPU goldens and the GPU (tests/test_golden_images.py
gpu_drift): mean abs error < 5e-3, and at most 0.5% of pixels off by more
than 0.15. Every contraction runs at Precision.HIGHEST, so no float32
product is rounded to TF32; what differs is reduction order and last bits
(fused multiply-adds, transcendental ulps). Those flip a Monte Carlo
decision only where a ray grazes a surface, e.g. random_spheres' 100x100
floor near the horizon, where t divides by a d.n close to zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import tempfile
import time
import traceback

FULL_W, FULL_H = 850, 480
CARD = "card unknown"       # set by phase 1: nvidia-smi name, power limit


def say(msg: str):
    print(msg, flush=True)


def num(label: str, value):
    """One measured number, tagged with the card it was taken on."""
    say(f"[{CARD}] {label}: {value}")


def nvidia_smi() -> list[str]:
    """`name, power.limit` per card, read by a child process that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def timed(fn, *args, reps=3):
    """(median seconds over `reps` warm calls, seconds of the first call).
    Each call ends in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), first, out


def peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def require_gpu():
    """The first JAX device; SystemExit unless it is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {dev.platform!r})")
    return dev


def phase_device(n_cards: int):
    global CARD
    import jax
    from tracer.accel import native

    dev = require_gpu()
    if len(jax.devices()) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(jax.devices())}")
    cards = nvidia_smi()
    for line in cards:
        say(line)
    CARD = cards[0]
    say(f"device_kind={dev.device_kind} count={len(jax.devices())} "
        f"jax={jax.__version__}")
    say(f"bvh builder: {native.builder()}")
    return dev


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

GOLDEN_SCENES = ("single_square", "random_spheres", "debug_refraction",
                 "cornell_box")


def phase_parity():
    import numpy as np
    from tests import test_golden_images as tg

    cases = {c[0]: c[1:] for c in tg.SELF_CASES}
    cases.update({c[0]: (c[2], c[3], c[4], c[5]) for c in tg.CASES})
    for name in GOLDEN_SCENES:
        w, h, spp, bounces = cases[name]
        img = tg._render(name, w, h, spp, bounces)
        gold = np.load(os.path.join(tg.GOLD, f"{name}_{w}x{h}_{spp}spp.npy"))
        ok, msg = tg.gpu_drift(img, gold)
        say(f"parity {name} {w}x{h}@{spp}spp: {msg}")
        if not ok:
            raise AssertionError(f"{name}: GPU render differs from the CPU "
                                 "golden beyond tolerance")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def cornell(width, height):
    from tracer.render.camera import default_camera
    from tracer.scene.device import compile_scene
    from tracer.scenes import maps, zoo

    scene = compile_scene(zoo.setup_cornell_box(width / height))
    # 2 image textures and 3 normal maps at SIZE^2 texels, plus the atlas's
    # 1-texel "missing" slot: a fallback to the magenta checker fails here
    n = maps.SIZE * maps.SIZE
    if (scene.tex_data.shape[0] != 1 + 2 * n
            or scene.nm_data.shape[0] != 1 + 3 * n):
        raise AssertionError(
            f"Cornell atlases hold {scene.tex_data.shape[0]} / "
            f"{scene.nm_data.shape[0]} texels, not the generated maps")
    return scene, default_camera(aspect=width / height)


def phase_forward(dev, scene, cam, width=FULL_W, height=FULL_H, spp=20):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import tracer
    from tracer.core.config import RenderConfig
    from tracer.render.renderer import render_pixels

    cfg = RenderConfig(width=width, height=height, nsamples=spp)
    t0 = time.perf_counter()
    img = tracer.render(scene, cam, cfg)
    num("forward tracer.render first call (compile + run) s",
        time.perf_counter() - t0)
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad image {img.shape}")
    if img.mean() < 0.02:
        raise AssertionError(f"black image, mean {img.mean()}")
    say(f"forward image mean {img.mean():.5f}")

    pid = jnp.arange(width * height, dtype=jnp.int32)
    key = jax.random.key(cfg.seed)
    frame = jax.jit(lambda s, c, p, k: render_pixels(
        s, c, cfg, width, height, p, spp, k))
    dt, first, _ = timed(frame, scene, cam, pid, key)
    num(f"forward {width}x{height}@{spp}spp b{cfg.max_bounces} "
        "compile s (set-up)", first)
    num(f"forward {width}x{height}@{spp}spp frame s (median of 3)", dt)
    num("forward primary rays/s", width * height * spp / dt)
    num("forward peak_bytes_in_use", peak_bytes(dev))


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def grad_fn(cfg, width, height, spp):
    import jax
    import jax.numpy as jnp
    from tracer.render.renderer import render_pixels

    def loss(diff, center, tex, scene, camera, pixel_ids, base_key):
        s2 = dataclasses.replace(scene, mat_diffuse=diff, sph_center=center,
                                 tex_data=tex)
        acc = render_pixels(s2, camera, cfg, width, height, pixel_ids,
                            spp, base_key)
        return jnp.mean(acc / spp)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


def phase_gradients(dev, scene, cam, width=FULL_W, height=FULL_H, spp=16):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tracer import cli
    from tracer.core.config import RenderConfig

    cfg = RenderConfig(width=width, height=height, nsamples=spp)
    pid = jnp.arange(width * height, dtype=jnp.int32)
    args = (scene.mat_diffuse, scene.sph_center, scene.tex_data, scene, cam,
            pid, jax.random.key(0))
    dt, first, grads = timed(grad_fn(cfg, width, height, spp), *args)
    # Cornell has no point lights and only nearest-texel (piecewise
    # constant) textures, so its radiance is piecewise constant in sphere
    # position: d/d sph_center is exactly zero there; it must be finite.
    for name, g in zip(("mat_diffuse", "sph_center", "tex_data"), grads):
        g = np.asarray(g)
        say(f"grad {name}: finite={np.isfinite(g).all()} "
            f"max|g|={np.abs(g).max():.4e}")
        if not np.isfinite(g).all():
            raise AssertionError(f"gradient of {name} is not finite")
        if name != "sph_center" and not np.abs(g).max() > 0:
            raise AssertionError(f"gradient of {name} is zero")
    num(f"fwd+bwd {width}x{height}@{spp}spp compile s (set-up)", first)
    num(f"fwd+bwd {width}x{height}@{spp}spp step s (median of 3)", dt)
    num("fwd+bwd primary rays/s", width * height * spp / dt)
    num("fwd+bwd peak_bytes_in_use", peak_bytes(dev))

    say("grad-check (AD vs central finite differences):")
    try:
        cli.main(["grad-check"])
    except SystemExit as e:
        if e.code:
            raise AssertionError("grad-check failed") from None


# ---------------------------------------------------------------------------
# profile (one Cornell sample, forward and fwd+bwd)
# ---------------------------------------------------------------------------

_SCOPES = ("traverse", "sky", "shade", "direct_light", "scatter", "bwd",
           "fold")


def _op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the named scope (of _SCOPES) in its
    metadata, from compiled HLO text."""
    out = {}
    for m in re.finditer(r"^\s*%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"",
                         hlo_text, re.M):
        parts = m.group(2).split("/")
        scope = next((p for p in parts if p in _SCOPES), "other")
        out[m.group(1)] = scope
    return out


def profile(label, compiled, args, out_dir):
    """Trace one call of `compiled`; print its ten costliest device
    operations with their named scope, the per-scope device time and the
    device busy share of the call's wall time."""
    import glob
    import jax

    scopes = _op_scopes(compiled.as_text())
    with jax.profiler.trace(out_dir):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    per_op, spans = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith(("XLA Modules", "XLA Ops",
                                     "Steps", "Framework")):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("hlo_op", ev.name))
                tot, cnt = per_op.get(op, (0.0, 0))
                per_op[op] = (tot + ev.duration_ns, cnt + 1)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not per_op:
        layout = {pl.name: [ln.name for ln in pl.lines][:6]
                  for pl in pd.planes}
        raise AssertionError(f"{label}: the trace holds no device operation;"
                             f" planes and lines: {layout}")
    spans.sort()
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_scope = {}
    for op, (tot, _) in per_op.items():
        sc = scopes.get(op, "other")
        by_scope[sc] = by_scope.get(sc, 0.0) + tot
    total = sum(t for t, _ in per_op.values())
    num(f"profile {label}: device ms (sum of ops)", f"{total / 1e6:.3f}")
    num(f"profile {label}: wall ms of the traced call", f"{wall * 1e3:.3f}")
    num(f"profile {label}: device busy share of that wall time",
        f"{busy / 1e9 / wall:.3f}")
    for sc, t in sorted(by_scope.items(), key=lambda kv: -kv[1]):
        num(f"profile {label}: scope {sc} ms", f"{t / 1e6:.3f}")
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:10]
    for op, (tot, cnt) in top:
        num(f"profile {label}: top op {op} [{scopes.get(op, 'other')}] "
            f"x{cnt} ms", f"{tot / 1e6:.3f}")


# XLA replays a GPU program as CUDA graphs ("command buffers"), which the
# trace shows as one event; the profiled compiles turn them off so that
# each fused kernel is its own event.
_PROFILE_OPTIONS = {"xla_gpu_enable_command_buffer": ""}


def phase_profile(scene, cam, out_root, width=FULL_W, height=FULL_H):
    import jax
    import jax.numpy as jnp
    from tracer.core.config import RenderConfig
    from tracer.render.renderer import render_pixels

    cfg = RenderConfig(width=width, height=height, nsamples=1)
    pid = jnp.arange(width * height, dtype=jnp.int32)
    key = jax.random.key(0)
    fwd = jax.jit(lambda s, c, p, k: render_pixels(
        s, c, cfg, width, height, p, 1, k))
    args = (scene, cam, pid, key)
    gargs = (scene.mat_diffuse, scene.sph_center, scene.tex_data) + args
    for i, (label, fn, a) in enumerate((
            ("cornell forward 1 sample", fwd, args),
            ("cornell fwd+bwd 1 sample", grad_fn(cfg, width, height, 1),
             gargs))):
        try:
            compiled = fn.lower(*a).compile(_PROFILE_OPTIONS)
        except Exception as e:                  # noqa: BLE001 — reported
            say(f"profile: XLA refused {_PROFILE_OPTIONS} ({e}); the trace "
                "then shows command buffers, not kernels")
            compiled = fn.lower(*a).compile()
        jax.block_until_ready(compiled(*a))
        profile(label, compiled, a, os.path.join(out_root, str(i)))


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def mesh_scene(n_lat=117, n_lon=228):
    from tracer.scene.builder import Material, SceneBuilder
    from tracer.scene.device import compile_scene
    from tracer.scenes.procedural import lumpy_sphere

    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((-2.0, 4.0, 3.0), radius=1.0)
    m = sb.add_mesh(lumpy_sphere(n_lat, n_lon, seed=3))
    m.scale((1.4, 1.4, 1.4)).translate((0.0, -0.2, 0.0))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      Material(diffuse=(0.6, 0.6, 0.6)))
    s.rotate_x(-90).translate((0., -1.6, 0.))
    t0 = time.perf_counter()
    scene = compile_scene(sb)
    return scene, time.perf_counter() - t0, len(sb.meshes[0].tris)


def phase_mesh(dev, width=FULL_W, height=FULL_H, n_lat=117, n_lon=228,
               crop=16):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tracer.core.config import RenderConfig
    from tracer.core.mathutils import gamma_correct
    from tracer.render.camera import default_camera
    from tracer.render.renderer import render_pixels

    scene, build_s, n_tris = mesh_scene(n_lat, n_lon)
    say(f"mesh: {n_tris} triangles, {scene.bvh_lo.shape[0]} BVH nodes, "
        f"leaf width {scene.leaf_width}")
    num("mesh scene build (BVH on host) s", build_s)
    cam = default_camera(aspect=width / height)
    cfg = RenderConfig(width=width, height=height, nsamples=1)
    key = jax.random.key(0)
    fn = jax.jit(lambda s, c, p, k: render_pixels(
        s, c, cfg, width, height, p, 1, k))
    pid = jnp.arange(width * height, dtype=jnp.int32)
    dt, first, rad = timed(fn, scene, cam, pid, key, reps=1)
    rad = np.asarray(rad)
    if not np.isfinite(rad).all():
        raise AssertionError("mesh render is not finite")
    num(f"mesh {width}x{height}@1spp b{cfg.max_bounces} compile s "
        "(set-up)", first)
    num(f"mesh {width}x{height}@1spp frame s", dt)
    num("mesh primary rays/s", width * height / dt)
    num("mesh peak_bytes_in_use", peak_bytes(dev))

    # a crop through the mesh's silhouette, traced by the CPU backend
    y0, x0 = height // 2 - crop // 2, width // 2 - crop
    ys, xs = np.mgrid[y0:y0 + crop, x0:x0 + 2 * crop]
    crop_ids = (ys * width + xs).reshape(-1).astype(np.int32)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        on_cpu = jax.device_put((scene, cam, jnp.asarray(crop_ids), key),
                                cpu)
        rad_cpu = np.asarray(jax.jit(lambda s, c, p, k: render_pixels(
            s, c, cfg, width, height, p, 1, k))(*on_cpu))
    a = np.clip(np.asarray(gamma_correct(rad[crop_ids])), 0, 1)
    b = np.clip(np.asarray(gamma_correct(rad_cpu)), 0, 1)
    err = np.abs(a - b)
    say(f"mesh crop {crop}x{2 * crop} GPU vs CPU: mean abs err "
        f"{err.mean():.6f} max {err.max():.6f}")
    if not (err.mean() < 5e-3 and err.max() < 0.15 and b.mean() > 0.01):
        raise AssertionError("mesh crop: GPU and CPU renders differ")


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

def phase_train(dev, width=FULL_W, height=FULL_H, spp=4):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tracer import train as T
    from tracer.core.config import RenderConfig
    from tracer.render.renderer import render_pixels

    scene, cam = cornell(width, height)
    cfg = RenderConfig(width=width, height=height, nsamples=spp)
    key = jax.random.key(1)
    pid = jnp.arange(width * height, dtype=jnp.int32)
    target = render_pixels(scene, cam, cfg, width, height, pid, spp,
                           key) / spp
    s0 = dataclasses.replace(scene, mat_diffuse=scene.mat_diffuse * 0.8,
                             tex_data=scene.tex_data * 0.9)
    kw = dict(trainable=["mat_diffuse", "tex_data"], lr=1e-2, width=width,
              height=height, nsamples=spp, base_key=key)
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        _, _, h3 = T.fit(s0, cam, cfg, target, steps=3, ckpt_dir=ck,
                         ckpt_every=3, **kw)
        num("train 3 steps incl. compile s", time.perf_counter() - t0)
        for h in h3:
            num(f"train step {h['step']} loss / step s",
                f"{h['loss']:.6e} / {h['step_s']}")
        if not all(np.isfinite(h["loss"]) for h in h3):
            raise AssertionError("non-finite training loss")
        sr, _, hr = T.fit(s0, cam, cfg, target, steps=4, ckpt_dir=ck, **kw)
    su, _, hu = T.fit(s0, cam, cfg, target, steps=4, **kw)
    if hr[0]["step"] != 4 or hr[0]["loss"] != hu[3]["loss"]:
        raise AssertionError(f"resume: step {hr[0]} vs uninterrupted "
                             f"{hu[3]}")
    for f in ("mat_diffuse", "tex_data"):
        if not np.array_equal(np.asarray(getattr(sr, f)),
                              np.asarray(getattr(su, f))):
            raise AssertionError(f"resume: {f} differs from the "
                                 "uninterrupted run")
    say(f"train: resumed step 4 loss {hr[0]['loss']:.6e} equals the "
        "uninterrupted run, parameters bit-identical")
    num("train peak_bytes_in_use", peak_bytes(dev))


# ---------------------------------------------------------------------------
# four GPUs
# ---------------------------------------------------------------------------

def four_cards(devices, width=FULL_W, height=FULL_H, spp=8, train_spp=4):
    """Sharded paths on `devices` (4) against one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tracer.core.config import RenderConfig
    from tracer.dist import multihost as mh
    from tracer.dist.sharding import (make_ray_mesh, render_pixels_sharded,
                                      train_step)
    from tracer.render.camera import default_camera
    from tracer.render.renderer import render, render_pixels
    from tracer.scene.device import compile_scene
    from tracer.scenes import zoo

    # psum reorders one sum of per-device partial radiance; per-pixel work
    # is otherwise identical
    tol = dict(atol=1e-5, rtol=1e-5)
    scene = compile_scene(zoo.setup_random_spheres())    # lights + blur
    cam = default_camera(aspect=width / height)
    cfg = RenderConfig(width=width, height=height, nsamples=spp)
    key = jax.random.key(0)
    pid = jnp.arange(width * height, dtype=jnp.int32)
    one = jax.jit(lambda s, c, p, k: render_pixels(
        s, c, cfg, width, height, p, spp, k) / spp)
    dt1, _, ref = timed(one, scene, cam, pid, key)
    ref = np.asarray(ref)
    num(f"random_spheres {width}x{height}@{spp}spp 1 device s", dt1)
    for n_dp, n_sp in ((4, 1), (2, 2)):
        mesh = make_ray_mesh(n_dp=n_dp, n_sp=n_sp, devices=devices)
        fn = jax.jit(lambda s, c, p, k, mesh=mesh: render_pixels_sharded(
            s, c, cfg, width, height, p, spp, k, mesh))
        dt, first, got = timed(fn, scene, cam, pid, key)
        got = np.asarray(got)
        diff = np.abs(got - ref).max()
        say(f"sharded dp={n_dp} sp={n_sp}: max |diff| vs 1 device {diff:.3e}")
        num(f"sharded dp={n_dp} sp={n_sp} compile s (set-up)", first)
        num(f"sharded dp={n_dp} sp={n_sp} frame s", dt)
        num(f"sharded dp={n_dp} sp={n_sp} efficiency vs 1 device",
            f"{dt1 / (len(devices) * dt):.3f}")
        if not np.allclose(got, ref, **tol):
            raise AssertionError(f"sharded dp={n_dp} sp={n_sp} differs")

    cs, ccam = cornell(width, height)
    ccfg = RenderConfig(width=width, height=height, nsamples=train_spp)
    target = jnp.zeros((width * height, 3), jnp.float32)
    s0 = dataclasses.replace(cs, mat_diffuse=cs.mat_diffuse * 0.8)
    lr = 1e-2

    def step(mesh):
        fn = jax.jit(lambda s, c: train_step(
            s, c, ccfg, width, height, pid, target, train_spp, key, mesh,
            lr=lr))
        loss, s1, c1 = fn(s0, ccam)
        return float(loss), s1, c1

    l1, s1, c1 = step(make_ray_mesh(1, 1, devices=devices[:1]))
    l4, s4, c4 = step(make_ray_mesh(2, 2, devices=devices))
    say(f"train_step loss 1 device {l1:.8e}, 4 devices {l4:.8e}")
    if not np.isclose(l1, l4, **tol):
        raise AssertionError("sharded train_step loss differs")
    for f in ("sph_center", "sph_radius", "mat_diffuse", "tex_data"):
        g1 = (np.asarray(getattr(s0, f)) - np.asarray(getattr(s1, f))) / lr
        g4 = (np.asarray(getattr(s0, f)) - np.asarray(getattr(s4, f))) / lr
        scale = max(np.abs(g1).max(), 1e-12)
        say(f"train_step grad {f}: max|g| {scale:.3e}, max |diff| "
            f"{np.abs(g1 - g4).max():.3e}")
        if not np.allclose(g4, g1, atol=1e-4 * scale, rtol=1e-4):
            raise AssertionError(f"sharded gradient of {f} differs")
    gcam1 = np.asarray(ccam.position) - np.asarray(c1.position)
    gcam4 = np.asarray(ccam.position) - np.asarray(c4.position)
    if not np.allclose(gcam4, gcam1, atol=1e-6, rtol=1e-4):
        raise AssertionError("sharded camera gradient differs")

    mesh = mh.make_pod_mesh(n_sp=2)
    img = mh.render_image_multihost(scene, cam, cfg, mesh)
    want = render(scene, cam, cfg)
    diff = np.abs(img - want).max()
    say(f"multihost render (1 process, mesh {dict(mesh.shape)}): max |diff| "
        f"vs tracer.render {diff:.3e}")
    if not np.allclose(img, want, **tol):
        raise AssertionError("render_image_multihost differs")


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args(argv)
    try:
        import jax
        from tracer import compile_cache
    except ImportError as e:
        raise SystemExit(f"chip_smoke: cannot import the renderer ({e}); "
                         "run it from the repository root")

    dev = phase_device(4 if args.four else 1)
    compile_cache.enable()
    t_start = time.perf_counter()
    failed = []

    def phase(name, fn, *a):
        """Run one phase; a failure is reported and the next phase runs."""
        say(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn(*a)
        except Exception:                      # noqa: BLE001 — reported
            traceback.print_exc()
            failed.append(name)
        say(f"== {name} {'FAILED' if name in failed else 'ok'} in "
            f"{time.perf_counter() - t0:.1f} s")

    if args.four:
        phase("four GPUs", four_cards, jax.devices()[:4])
    else:
        scene, cam = cornell(FULL_W, FULL_H)
        phase("parity", phase_parity)
        phase("forward", phase_forward, dev, scene, cam)
        phase("gradients", phase_gradients, dev, scene, cam)
        with tempfile.TemporaryDirectory() as prof:
            phase("profile", phase_profile, scene, cam, prof)
        phase("mesh", phase_mesh, dev)
        phase("train", phase_train, dev)
    say(f"total s: {time.perf_counter() - t_start:.1f}")
    if failed:
        raise SystemExit(f"chip_smoke: failed phases: {', '.join(failed)}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
