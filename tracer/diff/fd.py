"""Finite-difference gradient checking harness (BASELINE.md's
"pixel-grad allclose vs central finite differences" metric).

The discrete decisions inside the tracer (closest-hit argmin, BVH walk,
Bernoulli shadow draws) are non-differentiable; AD flows gradients through
the analytic re-evaluation of the *selected* primitive only. FD therefore
matches AD away from visibility discontinuities, and the stochastic paths
replay identical random draws on both sides of the FD probe because the RNG
is a pure function of (seed, pixel, sample, bounce) — see tracer/core/rng.py.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp


def fd_gradient(loss: Callable, p0, eps: float = 1e-3) -> np.ndarray:
    """Central finite differences of `loss` at p0 (any array shape)."""
    p0 = np.asarray(p0, np.float64)
    g = np.zeros_like(p0).reshape(-1)
    flat = p0.reshape(-1)
    for i in range(flat.size):
        dp = np.zeros_like(flat)
        dp[i] = eps
        lp = float(loss(jnp.asarray((flat + dp).reshape(p0.shape),
                                    jnp.float32)))
        lm = float(loss(jnp.asarray((flat - dp).reshape(p0.shape),
                                    jnp.float32)))
        g[i] = (lp - lm) / (2 * eps)
    return g.reshape(p0.shape)


def compare_ad_fd(loss: Callable, p0, eps: float = 1e-3,
                  atol: float = 1e-2, rtol: float = 5e-2):
    """Returns (g_ad, g_fd, max_abs_err, ok)."""
    g_ad = np.asarray(jax.grad(loss)(jnp.asarray(p0, jnp.float32)),
                      np.float64)
    g_fd = fd_gradient(loss, p0, eps)
    err = np.abs(g_ad - g_fd)
    ok = bool((err < atol + rtol * np.maximum(np.abs(g_fd), 1.0)).all())
    return g_ad, g_fd, float(err.max()), ok
