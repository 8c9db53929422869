"""Batched ray/primitive intersection (pure jnp, differentiable).

Batched recast of the reference's per-object `intersect` methods:
- `Sphere::intersect`   src/Sphere.h:91-132
- `Square::intersect`   /root/reference/src/Square.h:65-126
- `Triangle::getIntersection` /root/reference/src/Triangle.h:77-126
- `AABB::intersects`    /root/reference/src/AABB.h:48-65

Instead of one ray vs one object, every function evaluates a ray *batch*
`[N]` against a whole primitive *table* `[K]` at once; the inner products
(`d·n`, `o·n`, `d·center`, ...) are elementwise broadcasts that XLA fuses,
and all branches become masks. Semantics replicate the reference exactly,
including its quirks:

- sphere: nearest quadratic root only — rays starting inside a sphere get NO
  hit (t<0 is rejected at Sphere.h:119), so a glass sphere refracts on entry
  and never on exit;
- quads: backface-culled unless the material is glass (Square.h:84-88);
  geometry is re-derived from the transformed vertices each call
  (Square.h:68-72), so the traced normal is always
  normalize(cross(v1-v0, v3-v0)) regardless of the stored member;
- triangles: backface-culled (Triangle.h:88-92), accepts t >= 0 (not
  epsilon! Triangle.h:97) — a mesh's closest hit can be a t~0 self-hit that
  the scene then rejects wholesale (Scene.h:224), which is what lets
  scattered rays exit glass meshes;
- motion blur: sphere centers and quad origins translate by
  `ray.time * material.motion_blur_translation` (Sphere.h:94, Square.h:68);
  triangles do not move.

INF marks "no candidate"; the scene-level intersector takes a strict argmin
in (spheres, squares, meshes) order, matching the strict `<` accumulation of
`Scene::computeIntersection` (Scene.h:202-230).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.core.mathutils import dot, normalize

# Python float, NOT an eager jnp scalar: a module-level device array would
# be captured as a constant by every jit.
INF = 3.0e38
GLASS = 1


def _nk(a, b):
    """[N,3] x [K,3] -> [N,K] inner products.

    Deliberately a broadcast-multiply-sum, NOT a dot_general: the
    contraction dim is 3, so a matmul would do no useful work while its
    boundary forces XLA to materialize every [N,K] intermediate in device
    memory. As an elementwise chain the whole candidate computation fuses
    into one kernel (one read of the ray batch, one write of t[N,K]) and
    stays exact f32 — no reduced-precision (TF32) rounding of intersection
    geometry."""
    return jnp.sum(a[:, None, :] * b[None, :, :], axis=-1)


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def sphere_ts(o, d, time, center, radius, mb, valid, eps):
    """Candidate hit parameters vs every sphere.

    o,d: [N,3]; time: [N]; center: [S,3]; radius, valid: [S]; mb: [S,3].
    Returns t [N,S] with INF where there is no scene-acceptable hit
    (reference accepts the *smaller* root t only, requires t >= -eps at the
    sphere and t >= eps at the scene, Sphere.h:105-123 + Scene.h:210).
    """
    d_c = _nk(d, center)                     # [N,S]
    d_mb = _nk(d, mb)
    o_c = _nk(o, center)
    o_mb = _nk(o, mb)
    c_sq = jnp.sum(center * center, axis=-1)          # [S]
    mb_sq = jnp.sum(mb * mb, axis=-1)
    c_mb = jnp.sum(center * mb, axis=-1)
    o_sq = dot(o, o)[:, None]                          # [N,1]
    d_sq = dot(d, d)[:, None]
    t_ = time[:, None]

    # timed center tc = c + t*mb;  b = 2 d·(o - tc);  cc = |o - tc|^2 - r^2
    d_tc = d_c + t_ * d_mb
    o_tc = o_c + t_ * o_mb
    tc_sq = c_sq[None, :] + 2.0 * t_ * c_mb[None, :] + t_ * t_ * mb_sq[None, :]
    b = 2.0 * (dot(d, o)[:, None] - d_tc)
    cc = o_sq - 2.0 * o_tc + tc_sq - (radius * radius)[None, :]
    delta = b * b - 4.0 * d_sq * cc
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    t = (-b - sq) / (2.0 * d_sq)
    ok = (delta >= 0.0) & (t >= eps) & (valid[None, :] > 0.5)
    return jnp.where(ok, t, INF)


def sphere_hit_detail(o, d, time, center, radius, mb, eps):
    """Full hit record for ONE selected sphere per ray (all args gathered
    per-ray: center [N,3], radius [N], mb [N,3]). Differentiable w.r.t.
    center/radius/mb. Returns (point, normal, theta, phi)."""
    tc = center + time[:, None] * mb
    oc = o - tc
    a = dot(d, d)
    b = 2.0 * dot(d, oc)
    c = dot(oc, oc) - radius * radius
    delta = b * b - 4.0 * a * c
    # max() (not +eps) so lanes where this sphere was NOT the selected hit
    # (delta<=0 garbage) get a ZERO gradient through the clamp instead of
    # the inf derivative of sqrt at 0 leaking 0*inf=NaN through the
    # selection `where`s.
    sq = jnp.sqrt(jnp.maximum(delta, 1e-12))
    t = (-b - sq) / (2.0 * a)
    p = o + t[:, None] * d
    n = normalize(p - tc)
    # clip strictly inside (-1, 1): arccos' diverges at the poles and theta
    # only feeds texture-index (non-differentiable) paths anyway.
    theta = jnp.arccos(jnp.clip(-n[:, 1], -1.0 + 1e-7, 1.0 - 1e-7))
    phi = jnp.arctan2(-n[:, 2], n[:, 0] + 1e-20) + jnp.pi   # Sphere.h:130
    return t, p, n, theta, phi


# ---------------------------------------------------------------------------
# Quads
# ---------------------------------------------------------------------------

def quad_ts(o, d, time, v0, er, eu, n, mb, mat_is_glass, valid, eps):
    """Candidate ts vs every quad. [N,Q] with INF where invalid.

    er = v1-v0, eu = v3-v0 (transformed); n = normalize(cross(er,eu))
    precomputed (constant — motion blur translates v0 only, Square.h:68-72).
    mat_is_glass: [Q] bool-ish for the backface exception (Square.h:84-88).
    """
    dotRN = _nk(d, n)                                  # [N,Q]
    v0_n = jnp.sum(v0 * n, axis=-1)                    # [Q]
    mb_n = jnp.sum(mb * n, axis=-1)
    o_n = _nk(o, n)
    t_ = time[:, None]
    D = v0_n[None, :] + t_ * mb_n[None, :]
    t = (D - o_n) / dotRN

    # p = o + t d ;  q = p - (v0 + time*mb) ; s1 = q·er ; s2 = q·eu
    o_er = _nk(o, er)
    d_er = _nk(d, er)
    v0_er = jnp.sum(v0 * er, axis=-1)
    mb_er = jnp.sum(mb * er, axis=-1)
    s1 = o_er + t * d_er - (v0_er[None, :] + t_ * mb_er[None, :])
    o_eu = _nk(o, eu)
    d_eu = _nk(d, eu)
    v0_eu = jnp.sum(v0 * eu, axis=-1)
    mb_eu = jnp.sum(mb * eu, axis=-1)
    s2 = o_eu + t * d_eu - (v0_eu[None, :] + t_ * mb_eu[None, :])
    er2 = jnp.sum(er * er, axis=-1)[None, :]
    eu2 = jnp.sum(eu * eu, axis=-1)[None, :]

    front = dotRN < 0.0
    two_sided = mat_is_glass[None, :] > 0.5
    ok = (dotRN != 0.0) & (front | two_sided) & (t >= eps)
    ok &= (s1 >= 0.0) & (s1 <= er2) & (s2 >= 0.0) & (s2 <= eu2)
    ok &= valid[None, :] > 0.5
    return jnp.where(ok, t, INF)


def quad_hit_detail(o, d, time, v0, er, eu, mb):
    """Hit record for ONE selected quad per ray (gathered args [N,...]).
    Differentiable w.r.t. v0/er/eu. Returns (t, point, normal, u, v)."""
    n = normalize(jnp.cross(er, eu))
    bl = v0 + time[:, None] * mb
    dotRN = dot(d, n)
    D = dot(bl, n)
    # keep masked lanes' magnitudes bounded (selected quads have |d.n|>>0)
    safe = jnp.where(jnp.abs(dotRN) < 1e-9,
                     jnp.where(dotRN < 0, -1e-9, 1e-9), dotRN)
    t = (D - dot(o, n)) / safe
    p = o + t[:, None] * d
    q = p - bl
    u = dot(q, er) / jnp.maximum(dot(er, er), 1e-30)
    v = dot(q, eu) / jnp.maximum(dot(eu, eu), 1e-30)
    return t, p, n, u, v


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

def triangle_test(o, d, a, b, c):
    """Ray vs gathered triangles, elementwise-batched (shapes broadcast:
    o,d [...,3] vs a,b,c [...,3]). Returns (t, valid) with reference
    semantics (backface cull, t >= 0, barycentric in [0,1])."""
    nn = jnp.cross(b - a, c - a)
    n = normalize(nn)
    dotRN = dot(d, n)
    D = dot(a, n)
    t = (D - dot(o, n)) / jnp.where(dotRN == 0.0, 1e-30, dotRN)
    p = o + t[..., None] * d
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = jnp.where(denom == 0.0, 1e-30, denom)
    w1 = (d11 * d20 - d01 * d21) / denom
    w2 = (d00 * d21 - d01 * d20) / denom
    w0 = 1.0 - w1 - w2
    ok = (dotRN < 0.0) & (t >= 0.0)
    for w in (w0, w1, w2):
        ok &= (w >= 0.0) & (w <= 1.0)
    return t, ok


def triangle_hit_detail(o, d, a, b, c):
    """Differentiable hit record for ONE selected triangle per ray.
    Returns (t, point, normal, w0, w1, w2)."""
    nn = jnp.cross(b - a, c - a)
    n = normalize(nn)
    dotRN = dot(d, n)
    D = dot(a, n)
    t = (D - dot(o, n)) / jnp.where(dotRN == 0.0, 1e-30, dotRN)
    p = o + t[..., None] * d
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = jnp.maximum(jnp.abs(d00 * d11 - d01 * d01), 1e-30)
    sign = jnp.sign(d00 * d11 - d01 * d01 + 1e-38)
    w1 = sign * (d11 * d20 - d01 * d21) / denom
    w2 = sign * (d00 * d21 - d01 * d20) / denom
    w0 = 1.0 - w1 - w2
    return t, p, n, w0, w1, w2


# ---------------------------------------------------------------------------
# AABB slab test
# ---------------------------------------------------------------------------

def slab_hit(o, d, lo, hi, tmin, tmax):
    """Reference AABB::intersects (AABB.h:48-65): reject when tmax<=tmin.

    Broadcast-friendly: o,d [...,3]; lo,hi [...,3]. Uses tmin=0 (slightly
    more conservative than the reference's EPSILON start) so t~0 triangle
    self-hits are never culled — see module docstring.
    """
    inv = 1.0 / d
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tnear = jnp.minimum(t0, t1)
    tfar = jnp.maximum(t0, t1)
    tmin_ = jnp.maximum(tmin, jnp.max(tnear, axis=-1))
    tmax_ = jnp.minimum(tmax, jnp.min(tfar, axis=-1))
    return tmax_ > tmin_


# ---------------------------------------------------------------------------
# BVH traversal (stackless skip-link walk)
# ---------------------------------------------------------------------------

def bvh_closest_hit(o, d, scene, root: int, end: int, leaf_width: int = 4):
    """Closest triangle hit within one mesh's node range [root, end).

    o, d: [N,3]. Returns (t [N], tri [N] i32) — t=INF on miss. The walk is
    the batched equivalent of KDTree::intersect (KDTree.cpp:31-69):
    preorder + skip links instead of recursion; fixed-width leaves so the
    leaf test is a static gather of `leaf_width` triangles.
    """
    lw = leaf_width

    def per_ray(o1, d1):
        def cond(carry):
            i, _, _ = carry
            return i < end

        def body(carry):
            i, best_t, best_tri = carry
            lo = scene.bvh_lo[i]
            hi = scene.bvh_hi[i]
            hit = slab_hit(o1, d1, lo, hi, 0.0, best_t)
            ls = scene.bvh_leaf_start[i]
            is_leaf = ls >= 0

            def leaf_test(args):
                best_t, best_tri = args
                tids = jax.lax.dynamic_slice(scene.bvh_leaf_tris, (ls,), (lw,))
                a = scene.tri_a[tids]
                b = scene.tri_b[tids]
                c = scene.tri_c[tids]
                t, ok = triangle_test(o1[None, :], d1[None, :], a, b, c)
                t = jnp.where(ok, t, INF)
                j = jnp.argmin(t)
                tmin = t[j]
                better = tmin < best_t
                return (jnp.where(better, tmin, best_t),
                        jnp.where(better, tids[j], best_tri))

            do_leaf = hit & is_leaf
            best_t, best_tri = jax.lax.cond(
                do_leaf, leaf_test, lambda x: x, (best_t, best_tri))
            nxt = jnp.where(hit, jnp.where(is_leaf, scene.bvh_skip[i], i + 1),
                            scene.bvh_skip[i])
            return nxt, best_t, best_tri

        _, t, tri = jax.lax.while_loop(
            cond, body, (jnp.int32(root), jnp.float32(INF), jnp.int32(-1)))
        return t, tri

    return jax.vmap(per_ray)(o, d)


def mesh_closest_hits(o, d, scene, eps):
    """Per-mesh closest hit over all meshes: returns (t [N,Nm], tri [N,Nm]).

    Mirrors the reference's per-mesh KD query loop (Scene.h:222-228). The
    scene-level eps cut (t >= EPSILON) is applied by the caller; here t is
    the raw mesh-closest (which may be < eps — quirk parity, see
    primitives.py docstring)."""
    n_meshes = scene.mesh_mat.shape[0]
    ts, tris = [], []
    # mesh_root/mesh_end are static metadata on the DeviceScene pytree.
    for m in range(n_meshes):
        t, tri = bvh_closest_hit(o, d, scene, scene.mesh_root[m],
                                 scene.mesh_end[m], scene.leaf_width)
        ts.append(t)
        tris.append(tri)
    if n_meshes == 0:
        N = o.shape[0]
        return (jnp.full((N, 0), INF), jnp.full((N, 0), -1, jnp.int32))
    return jnp.stack(ts, axis=1), jnp.stack(tris, axis=1)


# ---------------------------------------------------------------------------
# Planar variants — the integrator hot path (see tracer/core/vec3p.py).
# Same semantics as the array versions above (which remain the reference
# implementation for unit tests); shapes are [K, N] with rays N minor
# instead of [N, K].
# ---------------------------------------------------------------------------

from tracer.core import vec3p as vp  # noqa: E402


def sphere_ts_planar(o, d, a2, time, center, radius, mb, valid, eps):
    """Candidate ts vs every sphere, planar. o,d: planar [N]; a2 = d.d [N];
    center/mb: [S,3]; radius/valid: [S]. Returns t [S, N] (INF = no hit)."""
    cx, cy, cz = (c[:, None] for c in vp.cols(center))
    mx, my, mz = (c[:, None] for c in vp.cols(mb))
    t_ = time[None, :]
    ocx = o[0][None, :] - (cx + t_ * mx)
    ocy = o[1][None, :] - (cy + t_ * my)
    ocz = o[2][None, :] - (cz + t_ * mz)
    b = 2.0 * (d[0][None, :] * ocx + d[1][None, :] * ocy
               + d[2][None, :] * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[:, None]
    delta = b * b - 4.0 * a2[None, :] * cc
    t = (-b - jnp.sqrt(jnp.maximum(delta, 0.0))) / (2.0 * a2[None, :])
    ok = (delta >= 0.0) & (t >= eps) & (valid[:, None] > 0.5)
    return jnp.where(ok, t, INF)


def quad_ts_planar(o, d, time, v0, er, eu, n, mb, mat_is_glass, valid, eps):
    """Candidate ts vs every quad, planar. Returns t [Q, N]."""
    nx, ny, nz = (c[:, None] for c in vp.cols(n))
    dotRN = d[0][None, :] * nx + d[1][None, :] * ny + d[2][None, :] * nz
    o_n = o[0][None, :] * nx + o[1][None, :] * ny + o[2][None, :] * nz
    v0_n = jnp.sum(v0 * n, axis=-1)[:, None]
    mb_n = jnp.sum(mb * n, axis=-1)[:, None]
    t_ = time[None, :]
    D = v0_n + t_ * mb_n
    t = (D - o_n) / jnp.where(dotRN == 0.0, 1e-30, dotRN)

    ex, ey, ez = (c[:, None] for c in vp.cols(er))
    o_er = o[0][None, :] * ex + o[1][None, :] * ey + o[2][None, :] * ez
    d_er = d[0][None, :] * ex + d[1][None, :] * ey + d[2][None, :] * ez
    v0_er = jnp.sum(v0 * er, axis=-1)[:, None]
    mb_er = jnp.sum(mb * er, axis=-1)[:, None]
    s1 = o_er + t * d_er - (v0_er + t_ * mb_er)

    ux, uy, uz = (c[:, None] for c in vp.cols(eu))
    o_eu = o[0][None, :] * ux + o[1][None, :] * uy + o[2][None, :] * uz
    d_eu = d[0][None, :] * ux + d[1][None, :] * uy + d[2][None, :] * uz
    v0_eu = jnp.sum(v0 * eu, axis=-1)[:, None]
    mb_eu = jnp.sum(mb * eu, axis=-1)[:, None]
    s2 = o_eu + t * d_eu - (v0_eu + t_ * mb_eu)

    er2 = jnp.sum(er * er, axis=-1)[:, None]
    eu2 = jnp.sum(eu * eu, axis=-1)[:, None]
    front = dotRN < 0.0
    two_sided = mat_is_glass[:, None] > 0.5
    ok = (dotRN != 0.0) & (front | two_sided) & (t >= eps)
    ok &= (s1 >= 0.0) & (s1 <= er2) & (s2 >= 0.0) & (s2 <= eu2)
    ok &= valid[:, None] > 0.5
    return jnp.where(ok, t, INF)


def sphere_hit_detail_planar(o, d, a2, time, center, radius, mb, eps):
    """Planar hit record for ONE gathered sphere per ray: center/mb planar
    [N], radius [N]. Returns (t, p, n, theta, phi) with p/n planar."""
    tc = vp.axpy(time, mb, center)
    oc = vp.sub(o, tc)
    b = 2.0 * vp.dot(d, oc)
    c = vp.dot(oc, oc) - radius * radius
    delta = b * b - 4.0 * a2 * c
    # max() (not +eps): non-selected lanes' garbage gets a zero grad through
    # the clamp instead of sqrt'(0)=inf leaking 0*inf=NaN through selects
    sq = jnp.sqrt(jnp.maximum(delta, 1e-12))
    t = (-b - sq) / (2.0 * a2)
    p = vp.axpy(t, d, o)
    n = vp.normalize(vp.sub(p, tc))
    theta = jnp.arccos(jnp.clip(-n[1], -1.0 + 1e-7, 1.0 - 1e-7))
    phi = jnp.arctan2(-n[2], n[0] + 1e-20) + jnp.pi   # Sphere.h:130
    return t, p, n, theta, phi


def quad_hit_detail_planar(o, d, time, v0, er, eu, mb):
    """Planar hit record for ONE gathered quad per ray (all args planar
    [N]). Returns (t, p, n, u, v)."""
    n = vp.normalize(vp.cross(er, eu))
    bl = vp.axpy(time, mb, v0)
    dotRN = vp.dot(d, n)
    safe = jnp.where(jnp.abs(dotRN) < 1e-9,
                     jnp.where(dotRN < 0, -1e-9, 1e-9), dotRN)
    t = (vp.dot(bl, n) - vp.dot(o, n)) / safe
    p = vp.axpy(t, d, o)
    q = vp.sub(p, bl)
    u = vp.dot(q, er) / jnp.maximum(vp.dot(er, er), 1e-30)
    v = vp.dot(q, eu) / jnp.maximum(vp.dot(eu, eu), 1e-30)
    return t, p, n, u, v


def triangle_hit_detail_planar(o, d, a, b, c):
    """Planar hit record for ONE gathered triangle per ray (a,b,c planar
    [N]). Returns (t, p, n, w0, w1, w2)."""
    v0 = vp.sub(b, a)
    v1 = vp.sub(c, a)
    n = vp.normalize(vp.cross(v0, v1))
    dotRN = vp.dot(d, n)
    t = (vp.dot(a, n) - vp.dot(o, n)) / jnp.where(dotRN == 0.0, 1e-30, dotRN)
    p = vp.axpy(t, d, o)
    v2 = vp.sub(p, a)
    d00 = vp.dot(v0, v0)
    d01 = vp.dot(v0, v1)
    d11 = vp.dot(v1, v1)
    d20 = vp.dot(v2, v0)
    d21 = vp.dot(v2, v1)
    raw = d00 * d11 - d01 * d01
    denom = jnp.maximum(jnp.abs(raw), 1e-30)
    sign = jnp.sign(raw + 1e-38)
    w1 = sign * (d11 * d20 - d01 * d21) / denom
    w2 = sign * (d00 * d21 - d01 * d20) / denom
    w0 = 1.0 - w1 - w2
    return t, p, n, w0, w1, w2
