"""Planar 3-vector helpers: a vector batch is a tuple (x, y, z) of [N]
arrays instead of one [N,3] array.

Why: an [N,3] array has a 3-wide minor dimension, so elementwise chains
over it read strided triples. Planar components are contiguous [N] arrays,
one per axis, which XLA fuses into plain per-ray loops. The integrator hot
path uses this layout throughout, converting to/from [N,3] only at API
boundaries.

All ops broadcast like jnp; a "vec" is any 3-tuple of broadcast-compatible
arrays. Everything is differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp


def splat(a):
    """[..., 3] array -> (x, y, z) components."""
    return a[..., 0], a[..., 1], a[..., 2]


def cols(table):
    """[K, 3] table -> ([K], [K], [K]) column views."""
    return table[..., 0], table[..., 1], table[..., 2]


def pack(v):
    """(x, y, z) -> [..., 3]."""
    return jnp.stack(jnp.broadcast_arrays(*v), axis=-1)


def gather(v, idx):
    """Per-component gather: (x[idx], y[idx], z[idx])."""
    return v[0][idx], v[1][idx], v[2][idx]


def add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def scale(s, v):
    return s * v[0], s * v[1], s * v[2]


def mul(a, b):
    """Component (Hadamard) product."""
    return a[0] * b[0], a[1] * b[1], a[2] * b[2]


def axpy(s, a, b):
    """s*a + b."""
    return s * a[0] + b[0], s * a[1] + b[1], s * a[2] + b[2]


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def neg(v):
    return -v[0], -v[1], -v[2]


def norm(v, eps: float = 0.0):
    n2 = dot(v, v)
    return jnp.sqrt(n2 if eps == 0.0 else jnp.maximum(n2, eps * eps))


def normalize(v, eps: float = 1e-20):
    inv = 1.0 / jnp.maximum(norm(v), eps)
    return scale(inv, v)


def where(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def full_like(v, val):
    return (jnp.full_like(v[0], val), jnp.full_like(v[1], val),
            jnp.full_like(v[2], val))


def reflect(d, n):
    """Mirror reflection (reference: Functions.cpp:38-40)."""
    k = 2.0 * dot(d, n)
    return d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2]


def refract(d, n, etai_over_etat):
    """RTiOW-form refraction (reference: Functions.cpp:42-47), per-ray eta."""
    cos_theta = jnp.minimum(dot(d, n), 1.0)
    perp = scale(etai_over_etat, axpy(cos_theta, n, d))
    k = jnp.abs(1.0 - dot(perp, perp))
    # clamp: sqrt'(0)=inf would leak NaN via 0*inf through lobe selects
    par = -jnp.sqrt(jnp.maximum(k, 1e-12))
    return axpy(par, n, perp)
