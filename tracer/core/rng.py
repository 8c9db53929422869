"""Counter-based RNG for the wavefront tracer.

The reference uses a global / thread-local mt19937 stream
(its `src/Functions.cpp:4-8`, `main.cpp:181`). A batched device renderer
needs a stateless counter-based design: every random draw is a pure function of
(seed, pixel, sample, bounce, purpose), so forward and backward replay the
identical Bernoulli/jitter decisions — which is what makes the stochastic
shadow and glass paths differentiable-consistent and the renderer
reproducible under any sharding.

Implementation: a PCG output-hash chain (pcg_output_rxs_m_xs_32_32, the
single-word hash recommended for GPU rendering by Jarzynski & Olano,
"Hash Functions for GPU Rendering", JCGT 2020). A "key" is a plain uint32
array; deriving a sub-stream (`salted`) is one hash application; a uniform
draw is one hash + a 24-bit mantissa scale. Everything is uint32
elementwise arithmetic with no cross-ray traffic, so XLA fuses draws straight into the
consuming compute — unlike threefry key-chains, which cost a 20-round block
cipher per fold_in. The hand-written backward (render/replay_bwd.py)
re-draws the forward's numbers bit for bit from the same keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Purpose salts — one sub-stream per use site.
PIXEL_JITTER = 0
RAY_TIME = 1
SCATTER_DIR = 2
SCATTER_GLASS = 3
SHADOW_LIGHT_POS = 4
SHADOW_BERNOULLI = 5

# 2^32 / phi — Weyl increment for salts. Kept as a python int: a
# module-level eager jnp scalar would be captured as a device-array
# constant by every jit.
_GOLDEN = 0x9E3779B9


def _pcg(x):
    """pcg_output_rxs_m_xs_32_32: one LCG step + RXS-M-XS output function."""
    x = x.astype(jnp.uint32) * jnp.uint32(747796405) + jnp.uint32(2891336453)
    w = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x) \
        * jnp.uint32(277803737)
    return (w >> jnp.uint32(22)) ^ w


def _mix(key, salt):
    """Derive a sub-stream: full-avalanche hash of (key, salt)."""
    salt = jnp.asarray(salt).astype(jnp.uint32)
    return _pcg(key ^ (salt * jnp.uint32(_GOLDEN) + jnp.uint32(1)))


def _seed_word(base_key):
    """Fold a jax typed key (or raw int) into one uint32 seed word."""
    if isinstance(base_key, (int,)):
        return jnp.uint32(base_key & 0xFFFFFFFF)
    try:
        data = jax.random.key_data(base_key)
    except TypeError:
        data = jnp.asarray(base_key)
    data = data.astype(jnp.uint32).reshape(-1)
    word = data[0]
    for i in range(1, data.shape[0]):
        word = _pcg(word ^ data[i])
    return word


def ray_keys(base_key, ray_ids):
    """Vectorized per-ray keys: hash the flat ray id with the seed.

    `ray_ids` is int32 `[N]`; returns uint32 keys `[N]`.
    """
    seed = _seed_word(base_key)
    return _mix(jnp.broadcast_to(seed, ray_ids.shape), ray_ids)


def salted(keys, *salts):
    """Derive sub-stream keys from one or more scalar salts."""
    for s in salts:
        keys = _mix(keys, s)
    return keys


def lane_keys(keys, n):
    """Expand keys `[...]` into `[..., n]` independent per-lane keys."""
    lanes = jnp.arange(n, dtype=jnp.uint32)
    return _mix(keys[..., None], lanes + jnp.uint32(2))


def _to_unit_float(bits):
    """uint32 -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / 16777216.0)


def uniform(keys, shape_suffix=(), minval=0.0, maxval=1.0):
    """Per-key uniforms: keys `[...]` -> `[..., *shape_suffix]` float32.

    Each suffix lane is an independent sub-stream of its key.
    """
    n = 1
    for s in shape_suffix:
        n *= s
    if shape_suffix:
        bits = _pcg(lane_keys(keys, n))
        bits = bits.reshape(keys.shape + tuple(shape_suffix))
    else:
        bits = _pcg(_mix(keys, 0))
    u = _to_unit_float(bits)
    if minval != 0.0 or maxval != 1.0:
        u = minval + (maxval - minval) * u
    return u


def cube_unit_vector(keys, shape_suffix=()):
    """The reference's `random_unit_vector` (Functions.cpp:14-18):
    a normalized uniform cube sample — NOT uniform on the sphere. Replicated
    exactly for distribution parity under compat=reference.
    """
    p = uniform(keys, shape_suffix + (3,), -1.0, 1.0)
    # explicit x*x+y*y+z*z (not linalg.norm, which differs by 1 ULP) so the
    # planar twins below are bit-identical — pinned by tests/test_rng_twins.py
    n = jnp.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
                 + p[..., 2] * p[..., 2])[..., None]
    return p / jnp.maximum(n, 1e-20)


def sphere_unit_vector(keys, shape_suffix=()):
    """Uniform-on-sphere sample (compat=physical)."""
    u = uniform(keys, shape_suffix + (2,))
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


# ---------------------------------------------------------------------------
# Planar twins (see tracer/core/vec3p.py): same bit streams, component form
# ---------------------------------------------------------------------------

def uniform_lanes_p(keys, n, minval=0.0, maxval=1.0):
    """Planar twin of `uniform(keys, (n,))`: a list of n [N] arrays that are
    bit-identical to that call's columns (lane i key = _mix(keys, i+2))."""
    out = []
    for i in range(n):
        u = _to_unit_float(_pcg(_mix(keys, jnp.uint32(i + 2))))
        if minval != 0.0 or maxval != 1.0:
            u = minval + (maxval - minval) * u
        out.append(u)
    return out


def _cube_normalize_p(p):
    # divide (not multiply-by-reciprocal): bit-identical to the array twin
    n = jnp.maximum(jnp.sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]), 1e-20)
    return p[0] / n, p[1] / n, p[2] / n


def cube_unit_vector_p(keys):
    """Planar twin of `cube_unit_vector(keys)` (bit-identical draws)."""
    p = tuple(uniform_lanes_p(keys, 3, -1.0, 1.0))
    return _cube_normalize_p(p)


def sphere_unit_vector_p(keys):
    """Planar twin of `sphere_unit_vector(keys)` (bit-identical draws)."""
    u0, u1 = uniform_lanes_p(keys, 2)
    z = 1.0 - 2.0 * u0
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u1
    return r * jnp.cos(phi), r * jnp.sin(phi), z


def cube_unit_vector_lane_p(keys, k):
    """Planar twin of lane k of `cube_unit_vector(keys, (K,))`: that call
    draws uniform(keys, (K,3)) whose flat lane for (k, axis) is k*3+axis,
    so lane keys are _mix(keys, k*3+axis+2)."""
    p = tuple(
        -1.0 + 2.0 * _to_unit_float(_pcg(_mix(keys, jnp.uint32(k * 3 + a + 2))))
        for a in range(3))
    return _cube_normalize_p(p)


def sphere_unit_vector_lane_p(keys, k):
    """Planar twin of lane k of `sphere_unit_vector(keys, (K,))` (which
    draws uniform(keys, (K,2)), flat lane k*2+axis)."""
    u0 = _to_unit_float(_pcg(_mix(keys, jnp.uint32(k * 2 + 2))))
    u1 = _to_unit_float(_pcg(_mix(keys, jnp.uint32(k * 2 + 3))))
    z = 1.0 - 2.0 * u0
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u1
    return r * jnp.cos(phi), r * jnp.sin(phi), z


def uniform_lane_key_p(keys, k):
    """Planar twin of column k of `lane_keys(keys, K)`."""
    return _mix(keys, jnp.uint32(k + 2))


def uniform_lanes_leading_p(keys, n):
    """[n, N] uniforms whose row i is bit-identical to column i of
    `uniform(keys, (n,))` — the planar (rays-in-lanes) orientation."""
    lanes = jnp.arange(n, dtype=jnp.uint32)[:, None]
    return _to_unit_float(_pcg(_mix(keys[None, :], lanes + jnp.uint32(2))))
