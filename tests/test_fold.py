"""The texel-cotangent fold of the record-replay backward
(integrator.fold_texel_updates) vs numpy's unbuffered np.add.at."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from tracer.render.integrator import fold_texel_updates


def _flat(data, idx, g):
    i3 = jnp.concatenate([idx * 3, idx * 3 + 1, idx * 3 + 2])
    v3 = jnp.concatenate([g[0], g[1], g[2]])
    return data.reshape(-1).at[i3].add(v3).reshape(data.shape)


def test_fold_updates_fallback_matches():
    key = jax.random.key(3)
    P, M = 500, 1000
    idx = jax.random.randint(key, (2, M), 0, P, jnp.int32)
    g = jax.random.normal(key, (2, 3, M), jnp.float32)
    data = jnp.zeros((P, 3), jnp.float32)
    gs = [tuple(g[b, a] for a in range(3)) for b in range(2)]
    got = fold_texel_updates(data, [idx[0], idx[1]], gs)
    want = _flat(_flat(data, idx[0], g[0]), idx[1], g[1])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5)


def _ids(kind, rs, P, M):
    if kind == "duplicates":      # every id hit many times
        return rs.randint(0, 37, M)
    if kind == "empty":           # no updates at all
        return np.zeros(0, np.int64)
    # skewed: half the stream on 3 hot texels, the rest over a far window
    hot = rs.randint(0, 3, M // 2)
    return np.concatenate([hot, rs.randint(P - 50, P, M - M // 2)])


@pytest.mark.parametrize("kind", ["duplicates", "empty", "skewed"])
def test_fold_matches_add_at(kind):
    rs = np.random.RandomState(7)
    P, M = 300, 4000
    # index arrays keep a per-bounce shape, as the record does
    ids = [_ids(kind, rs, P, M) for _ in range(2)]
    ids = [ix.reshape(-1, 8) if ix.size else ix for ix in ids]
    gs = [tuple(rs.randn(*ix.shape).astype(np.float32) for _ in range(3))
          for ix in ids]
    data = rs.randn(P, 3).astype(np.float32)
    want = data.astype(np.float64)
    for ix, g in zip(ids, gs):
        np.add.at(want, ix.reshape(-1),
                  np.stack([c.reshape(-1) for c in g], -1))
    got = fold_texel_updates(
        jnp.asarray(data), [jnp.asarray(ix, jnp.int32) for ix in ids],
        [tuple(jnp.asarray(c) for c in g) for g in gs])
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=1e-5)
    if kind == "empty":
        np.testing.assert_array_equal(np.asarray(got), data)
