"""Procedural image maps for the Cornell box, generated from a seed.

The reference's Cornell scene (`Scene.h:421-619`) loads five image maps that
are not part of this repository: two textures (brick, sand) and three
normal maps (brick, floor bumps, water). `generate(name)` builds a stand-in
for each, deterministically from a fixed seed, and `ensure(name, root)`
writes it as a binary PPM under the asset root the first time a scene asks
for it, so every run sees the same maps.

Size: 512x512 per map. This is an assumption: the reference files are
absent, and earlier profiling notes put Cornell's atlases at about 1.6M
texels; five 512x512 maps give 1.31M (0.52M texture + 0.79M normal-map
texels). Only +, *, / and sqrt are used, so the bytes do not depend on the
platform's transcendental functions.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

SIZE = 512

# asset-relative path -> (generator name, seed)
MAPS = {
    "img/planeTextures/brickwall.ppm": ("brick", 11),
    "img/normalMaps/brickwall_normal.ppm": ("brick_normal", 11),
    "img/normalMaps/n1.ppm": ("bumps_normal", 12),
    "img/planeTextures/sand.ppm": ("sand", 13),
    "img/normalMaps/water_normal.ppm": ("water_normal", 14),
}

_BRICK_W, _BRICK_H, _MORTAR = 64, 32, 4


def _value_noise(rs, n, cells):
    """[n, n] smooth value noise in [0, 1] over a (cells+1)^2 lattice."""
    g = rs.rand(cells + 1, cells + 1)
    x = np.arange(n) * (cells / n)
    i = x.astype(np.int64)
    f = x - i
    f = f * f * (3.0 - 2.0 * f)               # smoothstep weights
    fy, fx = f[:, None], f[None, :]
    a, b = g[i][:, i], g[i][:, i + 1]
    c, d = g[i + 1][:, i], g[i + 1][:, i + 1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def _fbm(rs, n, cells=(4, 8, 16, 32, 64)):
    """Octave sum of value noise, normalized to [0, 1]."""
    out = np.zeros((n, n))
    amp, total = 1.0, 0.0
    for c in cells:
        out += amp * _value_noise(rs, n, c)
        total += amp
        amp *= 0.5
    return out / total


def _brick_layout(n):
    """(mortar mask [n, n] bool, brick id [n, n] int) of a running bond."""
    y, x = np.mgrid[0:n, 0:n]
    row = y // _BRICK_H
    xs = x + (row % 2) * (_BRICK_W // 2)
    col = xs // _BRICK_W
    mortar = ((y % _BRICK_H) < _MORTAR) | ((xs % _BRICK_W) < _MORTAR)
    return mortar, row * (n // _BRICK_W + 2) + col


def _normal_map(h, strength):
    """Tangent-space normal map (bytes) of a height field h [n, n]."""
    gy, gx = np.gradient(h)
    nx, ny, nz = -strength * gx, -strength * gy, np.ones_like(h)
    inv = 1.0 / np.sqrt(nx * nx + ny * ny + nz * nz)
    rgb = np.stack([nx * inv, ny * inv, nz * inv], axis=-1)
    return _to_u8(rgb * 0.5 + 0.5)


def _to_u8(img):
    return np.clip(np.floor(img * 255.0 + 0.5), 0, 255).astype(np.uint8)


def _brick(rs, n):
    mortar, bid = _brick_layout(n)
    tint = rs.rand(bid.max() + 1)[bid]                   # per-brick shade
    grain = _fbm(rs, n, (16, 64, 128))
    base = np.array([0.60, 0.26, 0.18])
    k = (0.8 + 0.3 * tint + 0.2 * (grain - 0.5))[..., None]
    rgb = base * k
    rgb = np.where(mortar[..., None], np.array([0.74, 0.72, 0.68]) *
                   (0.9 + 0.2 * grain)[..., None], rgb)
    return _to_u8(rgb)


def _brick_normal(rs, n):
    mortar, _ = _brick_layout(n)
    h = np.where(mortar, 0.0, 1.0) + 0.15 * _fbm(rs, n, (32, 128))
    return _normal_map(h, 2.0)


def _bumps_normal(rs, n):
    return _normal_map(_fbm(rs, n, (8, 16, 32, 64)), 24.0)


def _sand(rs, n):
    grain = _fbm(rs, n, (8, 32, 128, 256))
    speck = rs.rand(n, n)
    k = (0.8 + 0.3 * grain + 0.1 * (speck - 0.5))[..., None]
    return _to_u8(np.array([0.87, 0.76, 0.57]) * k)


def _water_normal(rs, n):
    return _normal_map(_fbm(rs, n, (4, 8, 16)), 40.0)


_GENERATORS = {
    "brick": _brick, "brick_normal": _brick_normal,
    "bumps_normal": _bumps_normal, "sand": _sand,
    "water_normal": _water_normal,
}


def generate(path: str) -> np.ndarray:
    """The uint8 [SIZE, SIZE, 3] image for asset-relative `path`."""
    kind, seed = MAPS[path]
    return _GENERATORS[kind](np.random.RandomState(seed), SIZE)


def ppm_bytes(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + img.tobytes()


def ensure(path: str, root: str) -> str:
    """Write map `path` under `root` unless it exists; returns its path.

    The file is written to a temporary name and renamed into place, so
    processes that build it at the same time never see a partial file."""
    dest = os.path.join(root, path)
    if os.path.exists(dest):
        return dest
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest), prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(ppm_bytes(generate(path)))
        os.replace(tmp, dest)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return dest
