"""Golden-image regression (VERDICT r1 next-step #9).

Two layers:
1. STRUCTURAL parity vs the reference's own committed renders
   (/root/reference/img/rendus/*.png, README.md:38-46): normalized
   cross-correlation of downsampled luma-structure. The reference images
   are interactive GLUT screenshots — unknown trackball pose/spp, and this
   checkout is missing several large assets (sky/space.ppm, two OFF
   meshes: .MISSING_LARGE_BLOBS), so only the scenes shot from the startup
   camera with surviving assets correlate; NCC is mean/exposure-invariant
   and is checked with loose tripwire thresholds.
2. SELF-goldens: small renders committed under tests/goldens/ pin today's
   output tightly — any future semantic drift in the integrator trips this
   even where layer 1 is loose. Regenerate with
   `python tests/test_golden_images.py regen` after INTENDED changes.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from tracer.core.config import RenderConfig
from tracer.render.camera import default_camera
from tracer.render.renderer import render
from tracer.scene.device import compile_scene
from tracer.scenes import zoo

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "goldens")
REF = "/root/reference/img/rendus"

# (our scene, reference png, render W, H, spp, bounces, min NCC)
CASES = [
    # thresholds: measured NCC at these configs is ~0.70 / ~0.74 / ~0.59;
    # tripwires sit a safety margin below (scene-structure collapse, not
    # sampling noise, is what they catch)
    ("cornell_box", "cornell3.png", 96, 96, 4, 6, 0.60),
    # backrooms_pool has NO scene lights: every wall is lit only by paths
    # that stochastically reach the 16 emissive panels, so low-spp renders
    # are binary noise and NCC tracks spp (measured 4spp 0.52, 8spp 0.63,
    # 16spp 0.74, 32spp 0.82 vs the high-spp reference screenshot). 16 spp
    # is the cheapest config whose structure dominates the noise.
    ("backrooms_pool", "pool.png", 144, 80, 16, 6, 0.65),
    ("flamingo", "flamingo.png", 96, 72, 2, 4, 0.45),
]

# SELF-golden-only cases for the rest of the zoo (VERDICT r3 missing #6):
# no reference screenshot matches these configs/poses, but the committed
# renders pin every scene's semantics — including motion blur
# (rt_in_a_weekend / random_spheres, Scene.h:829-924) and sphere image
# textures (raccoon, Scene.h:1080). (scene, W, H, spp, bounces)
SELF_CASES = [
    ("single_sphere", 96, 54, 2, 3),
    ("single_square", 96, 54, 2, 3),
    ("mesh", 64, 36, 1, 2),
    ("rt_in_a_weekend", 96, 54, 2, 3),
    ("random_spheres", 96, 54, 2, 3),
    ("debug_refraction", 96, 54, 2, 4),
    ("raccoon", 96, 54, 2, 3),
    ("flamingo_pond", 64, 36, 1, 2),
]


def _render(scene_name, w, h, spp, bounces):
    if scene_name == "cornell_box":
        sb = zoo.setup_cornell_box(w / h)
    else:
        sb = getattr(zoo, f"setup_{scene_name}")()
    scene = compile_scene(sb)
    cfg = RenderConfig(width=w, height=h, nsamples=spp, max_bounces=bounces,
                       shadow_rays=4)
    return render(scene, default_camera(aspect=w / h), cfg)


def _downsample(img, gh, gw):
    h, w = img.shape[:2]
    yb = np.linspace(0, h, gh + 1).astype(int)
    xb = np.linspace(0, w, gw + 1).astype(int)
    out = np.zeros((gh, gw, 3), np.float32)
    for i in range(gh):
        for j in range(gw):
            out[i, j] = img[yb[i]:yb[i + 1], xb[j]:xb[j + 1]].mean((0, 1))
    return out


def _ncc(a, b):
    a = a - a.mean()
    b = b - b.mean()
    den = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / max(den, 1e-9))


def _load_ref(name):
    from PIL import Image
    im = np.asarray(Image.open(os.path.join(REF, name))).astype(np.float32)
    return im[:, :, :3] / 255.0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_golden(case):
    scene_name, ref_png, w, h, spp, bounces, min_ncc = case
    img = _render(scene_name, w, h, spp, bounces)

    # layer 2: tight self-golden
    gpath = os.path.join(GOLD, f"{scene_name}_{w}x{h}_{spp}spp.npy")
    assert os.path.exists(gpath), (
        f"missing golden {gpath}; run `python tests/test_golden_images.py "
        f"regen`")
    gold = np.load(gpath)
    # backends may differ by accumulated ulps; the structure must be tight
    err = np.abs(img - gold)
    assert err.mean() < 5e-3 and err.max() < 0.15, (
        f"self-golden drift: mean={err.mean():.5f} max={err.max():.3f}")

    # layer 1: loose structural parity vs the reference screenshot
    ref = _load_ref(ref_png)
    G = 24
    gw = max(int(round(G * (w / h))), 8)
    ncc = _ncc(_downsample(img, G, gw), _downsample(ref, G, gw))
    assert ncc >= min_ncc, (
        f"{scene_name} vs {ref_png}: NCC {ncc:.3f} < {min_ncc}")


@pytest.mark.parametrize("case", SELF_CASES, ids=[c[0] for c in SELF_CASES])
def test_self_golden(case):
    scene_name, w, h, spp, bounces = case
    img = _render(scene_name, w, h, spp, bounces)
    gpath = os.path.join(GOLD, f"{scene_name}_{w}x{h}_{spp}spp.npy")
    assert os.path.exists(gpath), (
        f"missing golden {gpath}; run `python tests/test_golden_images.py "
        f"regen`")
    gold = np.load(gpath)
    err = np.abs(img - gold)
    assert err.mean() < 5e-3 and err.max() < 0.15, (
        f"self-golden drift: mean={err.mean():.5f} max={err.max():.3f}")
    assert np.isfinite(img).all()


# GPU vs the committed CPU goldens: the same mean bound, but the 0.15 max
# bound may fail on at most 0.5% of pixels. Measured on an H100: three
# scenes match to ~1e-6, while random_spheres differs by more than 0.15 at
# 8 of 5,184 pixels (max 0.34), all where rays graze its 100x100 floor
# near the horizon. There t = (D - o.n) / (d.n) divides by a d.n near zero,
# so last-bit differences (fused multiply-adds, transcendental ulps) move
# the hit point far enough to change a shadow or bounce decision.
GPU_OUTLIER_SHARE = 0.005


def gpu_drift(img, gold):
    """(ok, message) for a GPU render against its CPU golden."""
    err = np.abs(img - gold)
    share = float((err.max(-1) > 0.15).mean())
    msg = (f"mean={err.mean():.6f} max={err.max():.4f} "
           f"share>0.15={share:.5f}")
    return (bool(np.isfinite(img).all() and err.mean() < 5e-3
                 and share <= GPU_OUTLIER_SHARE), msg)


GPU_CASES = [c for c in SELF_CASES
             if c[0] in ("single_square", "random_spheres",
                         "debug_refraction")] + [
    (c[0], c[2], c[3], c[4], c[5]) for c in CASES if c[0] == "cornell_box"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_self_golden_on_gpu(case, gpu):
    """The committed CPU goldens hold on the GPU (gpu_drift): contractions
    run at Precision.HIGHEST (no TF32), so only reduction order and
    last-bit differences remain, which can flip a Monte Carlo decision
    where a ray grazes a surface."""
    import jax

    scene_name, w, h, spp, bounces = case
    with jax.default_device(gpu):
        img = _render(scene_name, w, h, spp, bounces)
    gold = np.load(os.path.join(GOLD, f"{scene_name}_{w}x{h}_{spp}spp.npy"))
    ok, msg = gpu_drift(img, gold)
    assert ok, f"GPU drift: {msg}"


def regen():
    os.makedirs(GOLD, exist_ok=True)
    for scene_name, _, w, h, spp, bounces, _ in CASES:
        img = _render(scene_name, w, h, spp, bounces)
        path = os.path.join(GOLD, f"{scene_name}_{w}x{h}_{spp}spp.npy")
        np.save(path, img.astype(np.float32))
        print("wrote", path, img.shape, round(float(img.mean()), 4))
    for scene_name, w, h, spp, bounces in SELF_CASES:
        img = _render(scene_name, w, h, spp, bounces)
        path = os.path.join(GOLD, f"{scene_name}_{w}x{h}_{spp}spp.npy")
        np.save(path, img.astype(np.float32))
        print("wrote", path, img.shape, round(float(img.mean()), 4))


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        import jax
        jax.config.update("jax_platforms", "cpu")  # match the test backend
        regen()
