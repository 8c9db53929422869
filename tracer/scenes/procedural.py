"""Procedural triangle meshes built in code from a seed.

The reference's OFF meshes are not part of this repository; these stand-ins
give the BVH build and walk real triangle counts to work on. `lumpy_sphere`
is a closed, star-shaped UV sphere whose radius is perturbed by a few
seeded waves; every triangle faces outward (the reference culls back faces,
Triangle.h:88-92).
"""

from __future__ import annotations

import numpy as np

from tracer.scene.builder import Material, MeshObject


def lumpy_sphere(n_lat: int, n_lon: int, seed: int = 0, bump: float = 0.12,
                 material: Material = None) -> MeshObject:
    """Unit-scale lumpy sphere with 2 * n_lon * (n_lat - 1) triangles and
    per-vertex colors. n_lat >= 2 latitude bands, n_lon >= 3 segments."""
    rs = np.random.RandomState(seed)
    waves = rs.randn(6, 3) * 3.0
    phase = rs.rand(6) * 2.0 * np.pi

    theta = np.pi * np.arange(1, n_lat) / n_lat            # interior rings
    phi = 2.0 * np.pi * np.arange(n_lon) / n_lon
    t, p = np.meshgrid(theta, phi, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.cos(t),
                     np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    dirs = np.concatenate([ring, [[0., 1., 0.], [0., -1., 0.]]])
    r = 1.0 + bump * np.mean(np.sin(dirs @ waves.T + phase), axis=1)
    verts = dirs * r[:, None]

    def rid(i, j):
        return i * n_lon + j % n_lon

    north, south = (n_lat - 1) * n_lon, (n_lat - 1) * n_lon + 1
    j = np.arange(n_lon)
    tris = [np.stack([np.full(n_lon, north), rid(0, j + 1), rid(0, j)], 1)]
    for i in range(n_lat - 2):
        tris.append(np.stack([rid(i, j), rid(i, j + 1), rid(i + 1, j + 1)],
                             1))
        tris.append(np.stack([rid(i, j), rid(i + 1, j + 1), rid(i + 1, j)],
                             1))
    last = n_lat - 2
    tris.append(np.stack([np.full(n_lon, south), rid(last, j),
                          rid(last, j + 1)], 1))
    tris = np.concatenate(tris).astype(np.int32)

    # orient every face outward (the mesh is star-shaped about the origin)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    inward = np.sum(np.cross(b - a, c - a) * (a + b + c), axis=1) < 0
    tris[inward] = tris[inward][:, ::-1]

    colors = 0.5 + 0.5 * dirs
    return MeshObject(verts.astype(np.float32), tris,
                      vert_colors=colors.astype(np.float32),
                      material=material or Material(diffuse=(0.7, 0.6, 0.5)))
