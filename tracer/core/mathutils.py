"""Pure-jnp shading math (differentiable).

Batched equivalents of the reference's scalar helpers
(its `src/Functions.cpp:20-60`), vectorized over a leading ray
axis. All functions broadcast: vectors are `[..., 3]`.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS_NORM = 1e-20


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def normalize(v, eps: float = EPS_NORM):
    """Normalize along the last axis; safe at zero length."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


def norm(v):
    return jnp.linalg.norm(v, axis=-1)


def reflect(d, n):
    """Mirror reflection (reference: Functions.cpp:38-40)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d, n, etai_over_etat):
    """RTiOW-form refraction (reference: Functions.cpp:42-47).

    `etai_over_etat` is `[...]`-shaped (per ray).
    """
    cos_theta = jnp.minimum(dot(d, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (d + cos_theta[..., None] * n)
    k = jnp.abs(1.0 - dot(r_out_perp, r_out_perp))
    # clamp: sqrt'(0)=inf would leak NaN via 0*inf through the glass-lobe
    # selection masks on lanes that aren't actually refracting
    r_out_parallel = -jnp.sqrt(jnp.maximum(k, 1e-12))[..., None] * n
    return r_out_perp + r_out_parallel


def schlick_reflectance(cosine, ref_idx):
    """Schlick's approximation (reference: Functions.cpp:49-54).

    pow(m, 5) is spelled as explicit multiplies so the hand-written
    backward (tracer/render/replay_bwd.py) reproduces it bit-identically —
    jnp.power's lowering is backend-dependent, and a 1-ULP difference here
    can flip a glass ray's Bernoulli lobe choice."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = jnp.maximum(1.0 - cosine, 0.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def gamma_correct(color):
    """Per-channel 1/2.2 gamma (reference: Functions.cpp:56-60)."""
    return jnp.power(jnp.maximum(color, 0.0), 1.0 / 2.2)


def trunc_mod2(x):
    """C++ `(int)(x) % 2` — truncation toward zero then signed remainder.

    Used by the checkerboard rule (reference: Material.cpp:67)."""
    return jnp.fmod(jnp.trunc(x), 2.0)


def cpp_fmod(x, y):
    """C `fmod` semantics (sign follows x), matching Material.cpp:82-83."""
    return jnp.fmod(x, y)
