"""Branchless texturing / emission / skybox / normal mapping.

Recast of the reference's `Material::{texture, sphere_texture, emit,
get_normal}` (`src/Material.cpp:13-130`) and `Scene::skyboxTexture`
(`Scene.h:149-161`): the C++ switch dispatch becomes masked selects over a
gathered material row, and texel fetch is a differentiable gather into the
flat atlas — texels are trainable parameters.

All functions take per-ray gathered material fields (shape [N] / [N,3]).
"""

from __future__ import annotations

import jax.numpy as jnp

from tracer.core.mathutils import normalize, trunc_mod2, cpp_fmod

TEX_NONE = 0
TEX_CHECKERBOARD = 1
TEX_IMAGE = 2

def _atlas_fetch(data, off, w, h, slot, u, v, scale_x, scale_y):
    """Nearest-texel fetch replicating Material.cpp:82-88:
    u' = fmod(u*sx, 1), v' = 1 - fmod(v*sy, 1), x = int(u'*(w-1)),
    y = int(v'*(h-1)), index = y*w + x. Returns (rgb [N,3], present [N])."""
    W = w[slot]
    H = h[slot]
    present = (W > 0) & (H > 0)
    uu = cpp_fmod(u * scale_x, 1.0)
    vv = 1.0 - cpp_fmod(v * scale_y, 1.0)
    x = jnp.trunc(uu * (W - 1).astype(jnp.float32)).astype(jnp.int32)
    y = jnp.trunc(vv * (H - 1).astype(jnp.float32)).astype(jnp.int32)
    x = jnp.clip(x, 0, jnp.maximum(W - 1, 0))
    y = jnp.clip(y, 0, jnp.maximum(H - 1, 0))
    idx = off[slot] + y * W + x
    idx = jnp.clip(idx, 0, data.shape[0] - 1)
    return data[idx], present


def _magenta_checker(u, v):
    """Missing-image fallback (Material.cpp:74-81): 8x8 black/magenta."""
    same = trunc_mod2(u * 8.0) == trunc_mod2(v * 8.0)
    black = jnp.zeros(3, jnp.float32)
    magenta = jnp.array([1.0, 0.0, 1.0], jnp.float32)
    return jnp.where(same[:, None], black[None, :], magenta[None, :])


def texture_color(scene, mid, u, v, base):
    """Material::texture (Material.cpp:63-92): returns the diffuse color
    after texturing — `base` (the material diffuse) when TEX_NONE."""
    textype = scene.mat_textype[mid]
    sx = scene.mat_texscale[mid, 0]
    sy = scene.mat_texscale[mid, 1]
    # checkerboard (Material.cpp:66-72)
    same = trunc_mod2(u * sx) == trunc_mod2(v * sy)
    checker = jnp.where(same[:, None], scene.mat_check1[mid],
                        scene.mat_check2[mid])
    # image
    slot = scene.mat_tex[mid]
    img, present = _atlas_fetch(scene.tex_data, scene.tex_off, scene.tex_w,
                                scene.tex_h, slot, u, v, sx, sy)
    img = jnp.where(present[:, None], img, _magenta_checker(u, v))
    out = jnp.where((textype == TEX_CHECKERBOARD)[:, None], checker, base)
    out = jnp.where((textype == TEX_IMAGE)[:, None], img, out)
    return out


def emission_color(scene, mid, u, v):
    """Material::emit (Material.cpp:13-24): texture (or light_color when
    untextured) times intensity; zero when not emissive."""
    textype = scene.mat_textype[mid]
    lc = scene.mat_light_color[mid]
    tex = texture_color(scene, mid, u, v, lc)
    col = jnp.where((textype == TEX_NONE)[:, None], lc, tex)
    col = col * scene.mat_light_intensity[mid][:, None]
    return col * scene.mat_emissive[mid][:, None]


def perturb_normal(scene, mid, u, v, tangent, bitangent, normal):
    """Material::get_normal (Material.cpp:114-130): tangent-space normal map
    using the quad's *stale* setQuad tangent frame (quirk parity — see
    tracer/scene/builder.py). No-op when the material has no normal map."""
    slot = scene.mat_nm[mid]
    sx = scene.mat_texscale[mid, 0]
    sy = scene.mat_texscale[mid, 1]
    raw, present = _atlas_fetch(scene.nm_data, scene.nm_off, scene.nm_w,
                                scene.nm_h, slot, u, v, sx, sy)
    # decode [0,1] -> [-1,1] ( /127.5 - 1 on bytes == *2 - 1 on [0,1] floats
    # up to the same quantization: raw stores byte/255, so byte/127.5 - 1 =
    # raw*2 - 1 exactly )
    nm = raw * 2.0 - 1.0
    n2 = (nm[:, 0:1] * tangent + nm[:, 1:2] * bitangent
          + nm[:, 2:3] * normal)
    n2 = normalize(n2)
    use = present & (slot > 0)
    return jnp.where(use[:, None], n2, normal)


def skybox_color(scene, d, n_remaining, compat_reference: bool):
    """Scene::skyboxTexture (Scene.h:149-161).

    Image path: equirect lookup scaled by NRemainingBounces (quirk).
    No image: black if dark_sky, else white->blue gradient whose blue term
    is scaled by (NRemainingBounces+1) (quirk: the *(N+1) binds to the blue
    constant only, Scene.h:153)."""
    if scene.has_sky_image:
        u = 0.5 + jnp.arctan2(d[:, 2], d[:, 0]) / (2.0 * jnp.pi)
        v = 0.5 - jnp.arcsin(jnp.clip(d[:, 1], -1.0, 1.0)) / jnp.pi
        x = jnp.clip((u * scene.sky_w.astype(jnp.float32)).astype(jnp.int32),
                     0, scene.sky_w - 1)
        y = jnp.clip((v * scene.sky_h.astype(jnp.float32)).astype(jnp.int32),
                     0, scene.sky_h - 1)
        idx = jnp.clip(y * scene.sky_w + x, 0, scene.sky_data.shape[0] - 1)
        col = scene.sky_data[idx]
        if compat_reference:
            col = col * n_remaining.astype(jnp.float32)[:, None]
        return col
    a = 0.5 * (d[:, 1] + 1.0)
    blue = jnp.array([0.5, 0.7, 1.0], jnp.float32)
    white = jnp.ones(3, jnp.float32)
    scale = (n_remaining.astype(jnp.float32) + 1.0 if compat_reference
             else jnp.ones_like(n_remaining, jnp.float32))
    grad = ((1.0 - a)[:, None] * white[None, :]
            + a[:, None] * blue[None, :] * scale[:, None])
    return grad * (1.0 - scene.dark_sky)


# ---------------------------------------------------------------------------
# Planar variants — the integrator hot path (see tracer/core/vec3p.py).
# Colors/normals are (r,g,b)/(x,y,z) tuples of [N]; same semantics as the
# array versions above, which remain for unit tests.
# ---------------------------------------------------------------------------

from tracer.core import vec3p as vp  # noqa: E402


def _atlas_fetch_p(data, off, w, h, slot, u, v, scale_x, scale_y):
    """Planar twin of _atlas_fetch: returns ((r,g,b) [N], present [N]).
    ONE row-gather `data[idx]` instead of three planar column gathers."""
    W = w[slot]
    H = h[slot]
    present = (W > 0) & (H > 0)
    uu = cpp_fmod(u * scale_x, 1.0)
    vv = 1.0 - cpp_fmod(v * scale_y, 1.0)
    x = jnp.trunc(uu * (W - 1).astype(jnp.float32)).astype(jnp.int32)
    y = jnp.trunc(vv * (H - 1).astype(jnp.float32)).astype(jnp.int32)
    x = jnp.clip(x, 0, jnp.maximum(W - 1, 0))
    y = jnp.clip(y, 0, jnp.maximum(H - 1, 0))
    idx = jnp.clip(off[slot] + y * W + x, 0, data.shape[0] - 1)
    return vp.splat(data[idx]), present


def _magenta_checker_p(u, v):
    """Missing-image fallback (Material.cpp:74-81), planar."""
    same = trunc_mod2(u * 8.0) == trunc_mod2(v * 8.0)
    on = jnp.where(same, 0.0, 1.0)
    return (on, jnp.zeros_like(on), on)


def _texel_index(P, off_r, W, H, u, v, sx, sy):
    """Nearest-texel flat index (Material.cpp:82-88) + present mask."""
    present = (W > 0) & (H > 0)
    uu = cpp_fmod(u * sx, 1.0)
    vv = 1.0 - cpp_fmod(v * sy, 1.0)
    x = jnp.trunc(uu * (W - 1).astype(jnp.float32)).astype(jnp.int32)
    y = jnp.trunc(vv * (H - 1).astype(jnp.float32)).astype(jnp.int32)
    x = jnp.clip(x, 0, jnp.maximum(W - 1, 0))
    y = jnp.clip(y, 0, jnp.maximum(H - 1, 0))
    idx = jnp.clip(off_r + y * W + x, 0, P - 1)
    return idx, present


def tex_image_fetch_p(scene, mid, u, v):
    """The (at most ONE) per-bounce texture-atlas fetch, shared by diffuse
    texturing and emission (both use the same (slot, u, v) index). Statically
    skipped when the scene has no image textures (atlas = 1-row sentinel):
    present=False then routes TEX_IMAGE materials to the magenta fallback,
    exactly as a missing image does (Material.cpp:74-81)."""
    if scene.tex_data.shape[0] <= 1:
        z = jnp.zeros_like(u)
        return (z, z, z), jnp.zeros_like(u, dtype=bool)
    sx = scene.mat_texscale[:, 0][mid]
    sy = scene.mat_texscale[:, 1][mid]
    return _atlas_fetch_p(scene.tex_data, scene.tex_off, scene.tex_w,
                          scene.tex_h, scene.mat_tex[mid], u, v, sx, sy)


def texture_color_p(scene, mid, u, v, base, fetched=None):
    """Planar Material::texture — `base` is a planar color. Pass `fetched`
    (from tex_image_fetch_p) to reuse one atlas gather across call sites."""
    textype = scene.mat_textype[mid]
    sx = scene.mat_texscale[:, 0][mid]
    sy = scene.mat_texscale[:, 1][mid]
    same = trunc_mod2(u * sx) == trunc_mod2(v * sy)
    checker = vp.where(same, vp.gather(vp.cols(scene.mat_check1), mid),
                       vp.gather(vp.cols(scene.mat_check2), mid))
    img, present = (fetched if fetched is not None
                    else tex_image_fetch_p(scene, mid, u, v))
    img = vp.where(present, img, _magenta_checker_p(u, v))
    out = vp.where(textype == TEX_CHECKERBOARD, checker, base)
    return vp.where(textype == TEX_IMAGE, img, out)


def emission_color_p(scene, mid, u, v, fetched=None):
    """Planar Material::emit."""
    textype = scene.mat_textype[mid]
    lc = vp.gather(vp.cols(scene.mat_light_color), mid)
    tex = texture_color_p(scene, mid, u, v, lc, fetched)
    col = vp.where(textype == TEX_NONE, lc, tex)
    k = scene.mat_light_intensity[mid] * scene.mat_emissive[mid]
    return vp.scale(k, col)


def perturb_normal_p(scene, mid, u, v, tangent, bitangent, normal):
    """Planar Material::get_normal (normal mapping; quirk parity as above).
    Statically skipped (no gather) when the scene has no normal maps."""
    if scene.nm_data.shape[0] <= 1:
        return normal
    slot = scene.mat_nm[mid]
    sx = scene.mat_texscale[:, 0][mid]
    sy = scene.mat_texscale[:, 1][mid]
    raw, present = _atlas_fetch_p(scene.nm_data, scene.nm_off, scene.nm_w,
                                  scene.nm_h, slot, u, v, sx, sy)
    nm = tuple(2.0 * c - 1.0 for c in raw)
    n2 = vp.normalize(tuple(
        nm[0] * tangent[i] + nm[1] * bitangent[i] + nm[2] * normal[i]
        for i in range(3)))
    use = present & (slot > 0)
    return vp.where(use, n2, normal)


def skybox_color_p(scene, d, n_remaining, compat_reference: bool):
    """Planar Scene::skyboxTexture (Scene.h:149-161)."""
    if scene.has_sky_image:
        u = 0.5 + jnp.arctan2(d[2], d[0]) / (2.0 * jnp.pi)
        v = 0.5 - jnp.arcsin(jnp.clip(d[1], -1.0, 1.0)) / jnp.pi
        x = jnp.clip((u * scene.sky_w.astype(jnp.float32)).astype(jnp.int32),
                     0, scene.sky_w - 1)
        y = jnp.clip((v * scene.sky_h.astype(jnp.float32)).astype(jnp.int32),
                     0, scene.sky_h - 1)
        idx = jnp.clip(y * scene.sky_w + x, 0, scene.sky_data.shape[0] - 1)
        col = vp.splat(scene.sky_data[idx])  # one row gather
        if compat_reference:
            col = vp.scale(n_remaining.astype(jnp.float32), col)
        return col
    a = 0.5 * (d[1] + 1.0)
    scale = (n_remaining.astype(jnp.float32) + 1.0 if compat_reference
             else 1.0)
    w = 1.0 - a
    k = (1.0 - scene.dark_sky)
    return (k * (w + a * 0.5 * scale), k * (w + a * 0.7 * scale),
            k * (w + a * 1.0 * scale))
