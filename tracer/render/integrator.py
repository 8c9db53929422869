"""The wavefront path-tracing integrator.

Wavefront recast of the reference's `Scene::rayTraceRecursive` /
`rayTrace` (`src/Scene.h:258-350`): the depth-6 recursion becomes a
`lax.scan` over bounces carrying a SoA ray-batch state
(origin, direction, time, throughput, active, accumulated radiance); per
bounce, one fused pass does closest-hit (planar-component candidate tests
over the sphere / quad tables + stackless BVH walks per mesh), branchless
material fetch, direct lighting with NB_ECH jittered shadow rays per light,
and BSDF scatter. All reference quirks are replicated under
compat=reference:

- `lights[0].material` used as the color for every light (Scene.h:311);
- each light's soft-shadow factor multiplies the *accumulated* direct color
  of all lights so far (Scene.h:333 `color *= shadow` inside the loop);
- the final radiance is divided by MAXBOUNCES (Scene.h:347-349);
- glass: `cannot_refract = ri*sin - 0.6 > 1` fudge and the inverted
  eta ratio (Material.cpp:32-39: entering uses `index_medium`, leaving
  `1/index_medium`);
- emission only for spheres and squares (Scene.h:277,285 — mesh hits skip
  `emit`);
- skybox scaled by remaining bounces (Scene.h:153,160);
- "unit" vectors are normalized cube samples (Functions.cpp:14-18);
- stochastic transparency shadows: an occluder blocks unless a fresh
  uniform draw is <= its transparency (Scene.h:235-255).

compat=physical fixes all of the above.

Layout: the whole hot path works on PLANAR vectors — tuples (x, y, z) of
contiguous [N] arrays — instead of [N,3] arrays with a 3-wide minor dim
(see tracer/core/vec3p.py), so every elementwise chain is a plain
per-ray loop that XLA fuses. Candidate tensors are [K, N] (objects
leading, rays minor); the selection argmin reduces over the leading axis.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp

from tracer.core import rng
from tracer.core import vec3p as vp
from tracer.core.config import RenderConfig
from tracer.core.mathutils import schlick_reflectance
from tracer.geometry import primitives as prim

INF = prim.INF
DIFFUSE, GLASS, MIRROR = 0, 1, 2


def _scene_candidates_p(scene, o, d, a2, time, eps):
    """All candidate ts in (spheres, squares, meshes) order: [S+Q+Nm, N].
    o, d planar [N]; a2 = d.d [N]. Also returns per-mesh tri ids [Nm, N]."""
    t_sph = prim.sphere_ts_planar(o, d, a2, time, scene.sph_center,
                                  scene.sph_radius,
                                  scene.mat_mb[scene.sph_mat],
                                  scene.sph_valid, eps)
    is_glass = (scene.mat_type[scene.quad_mat] == GLASS).astype(jnp.float32)
    t_quad = prim.quad_ts_planar(o, d, time, scene.quad_v0, scene.quad_er,
                                 scene.quad_eu, scene.quad_normal,
                                 scene.mat_mb[scene.quad_mat], is_glass,
                                 scene.quad_valid, eps)
    Nm = scene.mesh_mat.shape[0]
    if Nm > 0:
        # The per-ray BVH walk consumes [N,3] rays.
        t_mesh_raw, tri_mesh = prim.mesh_closest_hits(
            vp.pack(o), vp.pack(d), scene, eps)
        # Scene-level eps cut: a mesh whose *closest* hit is below eps is
        # rejected wholesale (Scene.h:224) — quirk parity.
        t_mesh = jnp.where(t_mesh_raw >= eps, t_mesh_raw, INF).T  # [Nm,N]
        tri_mesh = tri_mesh.T
    else:
        N = o[0].shape[0]
        t_mesh = jnp.full((0, N), INF)
        tri_mesh = jnp.full((0, N), -1, jnp.int32)
    return jnp.concatenate([t_sph, t_quad, t_mesh], axis=0), tri_mesh


def _scene_candidates(scene, o, d, time, eps):
    """Array-API wrapper (tests/benchmarks): o,d [N,3] -> t [N, S+Q+Nm],
    tri ids [N, Nm]."""
    op, dp = vp.splat(o), vp.splat(d)
    t_all, tri = _scene_candidates_p(scene, op, dp, vp.dot(dp, dp), time,
                                     eps)
    return t_all.T, tri.T


def _shadow_blocked_p(scene, o, d, time, t_light, keys, eps):
    """Stochastic-transparency shadow test (Scene::computeShadow,
    Scene.h:235-255): blocked iff ANY occluder with eps <= t < t_light
    passes `uniform() > transparency`. One independent draw per occluder
    (equivalent in distribution to the reference's early-out loop).

    o, d planar [M] shadow rays; t_light, keys: [M]. Returns blocked [M].
    """
    t_all, _ = _scene_candidates_p(scene, o, d, vp.dot(d, d), time, eps)
    mat_ids = jnp.concatenate([scene.sph_mat, scene.quad_mat,
                               scene.mesh_mat])
    transp = scene.mat_transparency[mat_ids]          # [K]
    hit = t_all < t_light[None, :]
    u = rng.uniform_lanes_leading_p(keys, t_all.shape[0])      # [K, M]
    blocked = jnp.any(hit & (u > transp[:, None]), axis=0)
    return blocked.astype(jnp.float32)


def _geo_packs(scene):
    """Scene-constant packed parameter tables: ONE row fetch per hit ray
    replaces ~30 per-column gathers. XLA hoists these concats out of the
    bounce scan. Material ids ride as f32 columns (exact for ids<2^24).
    """
    sph = jnp.concatenate([
        scene.sph_center, scene.sph_radius[:, None],
        scene.mat_mb[scene.sph_mat],
        scene.sph_mat.astype(jnp.float32)[:, None]], axis=1)      # [S, 8]
    quad = jnp.concatenate([
        scene.quad_v0, scene.quad_er, scene.quad_eu,
        scene.mat_mb[scene.quad_mat], scene.quad_tan, scene.quad_bitan,
        scene.quad_mat.astype(jnp.float32)[:, None]], axis=1)     # [Q, 19]
    matf = jnp.concatenate([
        scene.mat_texscale,                                       # 0:2
        scene.mat_check1, scene.mat_check2,                       # 2:5, 5:8
        scene.mat_diffuse,                                        # 8:11
        scene.mat_light_color,                                    # 11:14
        scene.mat_light_intensity[:, None],                       # 14
        scene.mat_emissive[:, None],                              # 15
        scene.mat_transparency[:, None],                          # 16
        scene.mat_ior[:, None]], axis=1)                          # 17
    mati = jnp.stack([
        scene.mat_textype,
        scene.tex_off[scene.mat_tex], scene.tex_w[scene.mat_tex],
        scene.tex_h[scene.mat_tex],
        scene.nm_off[scene.mat_nm], scene.nm_w[scene.mat_nm],
        scene.nm_h[scene.mat_nm],
        scene.mat_type, scene.mat_nm], axis=1)                   # [M, 9] i32
    return sph, quad, matf, mati


def _rows(table, idx):
    """Differentiable small-table row fetch as a one-hot matmul,
    onehot[N,K] @ table[K,F]. Exact: one-hot entries are 0/1 with a single
    nonzero per row, and HIGHEST precision keeps true-f32 products (no
    TF32). Gradients flow to `table` (onehot^T @ g)."""
    K = table.shape[0]
    oh = (idx[:, None] == jnp.arange(K, dtype=idx.dtype)[None, :]).astype(
        table.dtype)
    return jnp.dot(oh, table, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def _rows_i(table_i32, idx):
    """_rows for int32 tables with values < 2^24 (exact in f32)."""
    out = _rows(table_i32.astype(jnp.float32), idx)
    return out.astype(jnp.int32)


def _mesh_detail_p(scene, o, d, j, tid):
    """Differentiable mesh-hit detail: barycentric position/normal via the
    SHARED vertex table (so vertex grads scatter-add onto mesh_verts) and
    interpolated vertex/face colors (Scene.h:291-298). Returns planar
    (p_m, n_m, col_m, has_col). Callers pass any j/tid; non-mesh lanes
    produce garbage that must be masked by an is_mesh select.

    Layout: ONE per-triangle packed row (3 verts + 3 colors + has_col,
    padded to 24 f32) replaces 18 narrow per-column gathers. The [T, 24]
    pack is built from mesh_verts per frame (T-sized gathers, hoisted out
    of the bounce scan), so vertex gradients still scatter-add onto the
    SHARED mesh_verts table through the pack's vjp."""
    tid = jnp.clip(tid, 0, scene.tri_va.shape[0] - 1)
    pack = jnp.concatenate([
        scene.mesh_verts[scene.tri_va],
        scene.mesh_verts[scene.tri_vb],
        scene.mesh_verts[scene.tri_vc],
        scene.tri_col_a, scene.tri_col_b, scene.tri_col_c,
        scene.tri_has_col[:, None]], axis=1)            # [T, 19]
    pack = jnp.pad(pack, ((0, 0), (0, 24 - pack.shape[1])))
    row = pack[tid]                                     # [N, 24]
    a = (row[:, 0], row[:, 1], row[:, 2])
    b = (row[:, 3], row[:, 4], row[:, 5])
    c = (row[:, 6], row[:, 7], row[:, 8])
    _, p_m, n_m, w0, w1, w2 = prim.triangle_hit_detail_planar(o, d, a, b, c)
    col_m = tuple(w0 * row[:, 9 + i] + w1 * row[:, 12 + i]
                  + w2 * row[:, 15 + i] for i in range(3))
    return p_m, n_m, col_m, row[:, 18]


def _gather_hit_p(scene, o, d, a2, time, j, tid, eps, fetch_tex=True,
                  tex_saved=None):
    """Recompute the selected hit differentiably and fetch shading inputs.

    j: [N] winning candidate index into (spheres | squares | meshes);
    tid: [N] selected global triangle id (any value when not a mesh hit).
    Returns dict of per-ray planar fields. Discrete selection (j, tri ids)
    is non-differentiable by construction; gradients flow through the
    analytic re-evaluation of the winning primitive (SURVEY.md §7).
    `fetch_tex=False` (static) skips the texture AND normal-map atlas
    gathers entirely; callers may only pass it when `diffuse` and the
    mapped normal are dead downstream (last bounce, no lights) and no
    emissive material is TEX_IMAGE (scene.emissive_tex_image False):
    emission then provably never selects the fetched texel, so the live
    outputs are bit-identical."""
    from tracer.render import shading

    N = j.shape[0]
    S = scene.sph_center.shape[0]
    Q = scene.quad_v0.shape[0]
    is_sph = j < S
    is_quad = (j >= S) & (j < S + Q)
    is_mesh = j >= S + Q

    sph_pack, quad_pack, matf, mati = _geo_packs(scene)

    # --- sphere branch ---------------------------------------------------
    js = jnp.clip(j, 0, S - 1)
    srow = _rows(sph_pack, js)                                   # [N, 8]
    mid_s = srow[:, 7].astype(jnp.int32)
    _, p_s, n_s, theta, phi = prim.sphere_hit_detail_planar(
        o, d, a2, time, (srow[:, 0], srow[:, 1], srow[:, 2]),
        srow[:, 3], (srow[:, 4], srow[:, 5], srow[:, 6]), eps)

    # --- quad branch -----------------------------------------------------
    jq = jnp.clip(j - S, 0, Q - 1)
    qrow = _rows(quad_pack, jq)                                  # [N, 19]
    mid_q = qrow[:, 18].astype(jnp.int32)
    _, p_q, n_q, u_q, v_q = prim.quad_hit_detail_planar(
        o, d, time, (qrow[:, 0], qrow[:, 1], qrow[:, 2]),
        (qrow[:, 3], qrow[:, 4], qrow[:, 5]),
        (qrow[:, 6], qrow[:, 7], qrow[:, 8]),
        (qrow[:, 9], qrow[:, 10], qrow[:, 11]))
    p_sq = vp.where(is_quad, p_q, p_s)
    n_sq = vp.where(is_quad, n_q, n_s)
    mid_sq = jnp.where(is_sph, mid_s, mid_q)
    tan_q = (qrow[:, 12], qrow[:, 13], qrow[:, 14])
    bitan_q = (qrow[:, 15], qrow[:, 16], qrow[:, 17])

    # --- mesh branch (shared-vertex gathers: grads scatter-add onto
    # mesh_verts — one gradient per shared vertex, reference Mesh.h:111-124)
    Nm = scene.mesh_mat.shape[0]
    if Nm > 0:
        jm = jnp.clip(j - S - Q, 0, Nm - 1)
        p_m, n_m, col_m, has_col = _mesh_detail_p(scene, o, d, j, tid)
        mid_m = scene.mesh_mat[jm]
    else:
        zero = vp.full_like(o, 0.0)
        p_m = n_m = col_m = zero
        mid_m = jnp.zeros(N, jnp.int32)
        has_col = jnp.zeros(N, jnp.float32)

    # --- select ----------------------------------------------------------
    mid = jnp.where(is_mesh, mid_m, mid_sq)
    p = vp.where(is_mesh, p_m, p_sq)
    n = vp.where(is_mesh, n_m, n_sq)

    # texture coordinates: spheres use (phi/2pi, theta/pi) for both texture
    # and emission (Scene.h:275-277); squares use (u, v).
    u_tex = jnp.where(is_sph, phi / (2.0 * jnp.pi), u_q)
    v_tex = jnp.where(is_sph, theta / jnp.pi, v_q)

    # packed material row for the hit (one-hot matmul fetch)
    mrf = _rows(matf, mid)
    mri = _rows_i(mati, mid)
    sx, sy = mrf[:, 0], mrf[:, 1]
    textype = mri[:, 0]

    # ONE shared atlas fetch serves both diffuse texturing and emission
    # (Material.cpp:63-92 / 13-24 use the same (slot, u, v) texel).
    has_tex = fetch_tex and scene.tex_data.shape[0] > 1
    has_nm = fetch_tex and scene.nm_data.shape[0] > 1
    raw_nm = npresent = None
    rec_idx_t = rec_idx_n = None
    if tex_saved is not None:
        # REPLAY: the record pass already fetched these texels; they
        # re-enter as DIFFERENTIABLE replay inputs (split out by
        # _rec_split_tex), and their cotangents are folded onto the
        # atlases by ONE top-level scatter per atlas in _trace_cv_bwd.
        # The atlas gather never runs in the differentiable replay, and
        # neither do the texel index staircases (idx has zero gradient
        # through trunc anyway).
        simg, srnm, sidx_t, sidx_n, spres, snpres = tex_saved
        # records carry the present masks as f32 rows; normalize to bool
        spres = spres > 0.5
        snpres = snpres > 0.5
        if has_tex or has_nm:
            img = simg
            present = spres
        else:
            img = vp.full_like(o, 0.0)
            present = jnp.zeros(N, bool)
        if has_nm:
            raw_nm = srnm
            npresent = snpres
    else:
        if has_tex:
            rec_idx_t, present = shading._texel_index(
                scene.tex_data.shape[0], mri[:, 1], mri[:, 2], mri[:, 3],
                u_tex, v_tex, sx, sy)
            img = vp.splat(scene.tex_data[rec_idx_t])
        else:
            img = vp.full_like(o, 0.0)
            present = jnp.zeros(N, bool)
        if has_nm:
            rec_idx_n, npresent = shading._texel_index(
                scene.nm_data.shape[0], mri[:, 4], mri[:, 5], mri[:, 6],
                u_tex, v_tex, sx, sy)
            raw_nm = vp.splat(scene.nm_data[rec_idx_n])
    from tracer.core.mathutils import trunc_mod2
    same = trunc_mod2(u_tex * sx) == trunc_mod2(v_tex * sy)
    checker = vp.where(same, (mrf[:, 2], mrf[:, 3], mrf[:, 4]),
                       (mrf[:, 5], mrf[:, 6], mrf[:, 7]))
    img_fb = vp.where(present, img, shading._magenta_checker_p(u_tex, v_tex))

    # diffuse after texturing (Scene.h:275/283) — meshes ignore textures and
    # use interpolated vertex/face colors when present (Scene.h:291-298).
    base = (mrf[:, 8], mrf[:, 9], mrf[:, 10])
    textured = vp.where(textype == shading.TEX_CHECKERBOARD, checker, base)
    textured = vp.where(textype == shading.TEX_IMAGE, img_fb, textured)
    diffuse = vp.where(is_mesh, vp.where(has_col > 0.5, col_m, base),
                       textured)

    # normal mapping — squares only (Scene.h:284, sphere call commented out)
    if has_nm:
        nm = tuple(2.0 * c - 1.0 for c in raw_nm)
        n2 = vp.normalize(tuple(
            nm[0] * tan_q[a] + nm[1] * bitan_q[a] + nm[2] * n[a]
            for a in range(3)))
        use = npresent & (mri[:, 8] > 0)
        n_mapped = vp.where(use, n2, n)
        n = vp.where(is_quad, n_mapped, n)

    # emission — spheres and squares only (Scene.h:277,285)
    lc = (mrf[:, 11], mrf[:, 12], mrf[:, 13])
    etex = vp.where(textype == shading.TEX_CHECKERBOARD, checker, lc)
    etex = vp.where(textype == shading.TEX_IMAGE, img_fb, etex)
    ecol = vp.where(textype == shading.TEX_NONE, lc, etex)
    k_emit = mrf[:, 14] * mrf[:, 15]
    emis = vp.scale(k_emit, ecol)
    emis = vp.where(is_mesh, vp.full_like(emis, 0.0), emis)

    # per-bounce texel record for the replay backward (see tex_saved)
    if tex_saved is not None:
        tex_rec = tex_saved
    else:
        zi = jnp.zeros(N, jnp.int32)
        zb = jnp.zeros(N, bool)
        z3 = vp.full_like(o, 0.0)
        tex_rec = (img, raw_nm if raw_nm is not None else z3,
                   rec_idx_t if rec_idx_t is not None else zi,
                   rec_idx_n if rec_idx_n is not None else zi,
                   present,
                   npresent if npresent is not None else zb)

    return dict(mid=mid, p=p, n=n, diffuse=diffuse, emission=emis,
                u=u_tex, v=v_tex, transp=mrf[:, 16], ior=mrf[:, 17],
                mtype=mri[:, 7], tex_rec=tex_rec)


def _shadow_factors_all(scene, cfg: RenderConfig, p, time, keys, eps):
    """Per-light soft-shadow factors [L x [N]]. Discrete Bernoulli
    visibility: zero gradient by construction."""
    return [_shadow_factor_jnp(scene, cfg, p, time, keys, eps, i)
            for i in range(scene.light_pos.shape[0])]


def _direct_lighting_p(scene, cfg: RenderConfig, p, n, transp, diffuse,
                       shadows):
    """Per-light Lambert combined with the given soft-shadow factors
    (Scene.h:305-334). p, n, diffuse planar [N]; transp: the hit
    material's transparency [N]; shadows: list of [N] factors (constants
    under grad); returns planar color [N]."""
    L = scene.light_pos.shape[0]
    ref = cfg.compat == "reference"
    color = vp.full_like(p, 0.0)
    for i in range(L):
        lpos = tuple(scene.light_pos[i, a] for a in range(3))   # scalars
        ldir = vp.normalize(vp.sub(lpos, p))
        dotLN = vp.dot(ldir, n)
        lcol_row = scene.light_color[0] if ref else scene.light_color[i]
        lam = jnp.maximum(0.0, dotLN) * (1.0 - transp)
        contrib = tuple(lcol_row[a] * diffuse[a] * lam for a in range(3))
        shadow = shadows[i]
        if ref:
            # quirk: multiplies everything accumulated so far (Scene.h:333)
            color = vp.scale(shadow, vp.add(color, contrib))
        else:
            color = vp.add(color, vp.mul(contrib, (shadow,) * 3))
    return color


def _shadow_factor_jnp(scene, cfg: RenderConfig, p, time, keys, eps, i):
    """Soft-shadow factor for light i: K jittered samples toward the light
    sphere (Scene.h:319-334), stacked into a [K*N] planar megabatch."""
    N = p[0].shape[0]
    K = cfg.shadow_rays
    ref = cfg.compat == "reference"
    lpos = tuple(scene.light_pos[i, a] for a in range(3))
    skeys = rng.salted(keys, rng.SHADOW_LIGHT_POS, i)
    delta = scene.light_radius[i] / 2.0
    offs, tls, keys_k = [], [], []
    for k in range(K):
        ruv = (rng.cube_unit_vector_lane_p(skeys, k) if ref
               else rng.sphere_unit_vector_lane_p(skeys, k))
        lp = vp.axpy(delta, ruv, lpos)
        off = vp.sub(lp, p)
        offs.append(off)
        tls.append(vp.norm(off))
        keys_k.append(rng.uniform_lane_key_p(
            rng.salted(keys, rng.SHADOW_BERNOULLI, i), k))
    off = tuple(jnp.stack([offs[k][a] for k in range(K)])
                .reshape(K * N) for a in range(3))
    t_light = jnp.stack(tls).reshape(K * N)
    bkeys = jnp.stack(keys_k).reshape(K * N)
    inv = 1.0 / jnp.maximum(t_light, 1e-20)
    sdir = vp.scale(inv, off)
    p_rep = tuple(jnp.broadcast_to(p[a][None, :], (K, N))
                  .reshape(K * N) for a in range(3))
    so = vp.axpy(cfg.epsilon, sdir, p_rep)
    t_rep = jnp.broadcast_to(time[None, :], (K, N)).reshape(K * N)
    blocked = _shadow_blocked_p(scene, so, sdir, t_rep, t_light, bkeys,
                                eps).reshape(K, N)
    return 1.0 - jnp.mean(blocked, axis=0)


def _scatter_p(scene, cfg: RenderConfig, d, n, p, mtype, ior, keys):
    """Material::scatter (Material.cpp:26-60), branchless planar.
    mtype/ior: the hit material's lobe type [N] i32 and refraction index [N]
    (from the packed hit record)."""
    ref = cfg.compat == "reference"

    # glass
    going_out = vp.dot(d, n) > 0.0
    # Non-glass materials carry ior=0; 1/0 = inf on their (discarded)
    # glass-lobe lanes and d(1/ior) = -inf leaks NaN through the zero
    # cotangent of the lobe select in the backward. Safe denominator:
    # glass iors are O(1), so this never changes a glass lane.
    ior_inv = 1.0 / jnp.where(ior > 1e-12, ior, 1.0)
    if ref:
        ri = jnp.where(going_out, ior_inv, ior)       # inverted-eta quirk
    else:
        ri = jnp.where(going_out, ior, ior_inv)
    cos_t = jnp.minimum(-vp.dot(d, n), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    if ref:
        cannot = (ri * sin_t - 0.6) > 1.0             # -0.6 fudge quirk
    else:
        cannot = (ri * sin_t) > 1.0
    u_glass = rng.uniform(rng.salted(keys, rng.SCATTER_GLASS))
    use_reflect = cannot | (schlick_reflectance(cos_t, ri) > u_glass)
    d_glass = vp.where(use_reflect, vp.reflect(d, n), vp.refract(d, n, ri))

    # diffuse
    skey = rng.salted(keys, rng.SCATTER_DIR)
    ruv = (rng.cube_unit_vector_p(skey) if ref
           else rng.sphere_unit_vector_p(skey))
    d_diff = vp.add(n, ruv)
    tiny = vp.norm(d_diff) <= cfg.epsilon
    d_diff = vp.where(tiny, n, d_diff)

    d_out = vp.where(mtype == GLASS, d_glass,
                     vp.where(mtype == MIRROR, vp.reflect(d, n), d_diff))
    d_out = vp.normalize(d_out)
    o_out = vp.axpy(cfg.epsilon, d_out, p)
    return o_out, d_out


def _init_state(o, d, time):
    """Initial bounce-scan carry.

    Derived from the ray inputs (not fresh constants) so that under
    shard_map it carries the same varying-manual-axes type as the
    per-bounce outputs -- otherwise the scan rejects the carry
    (sharded-typing mismatch). `d` is the one input guaranteed to vary
    over every mesh axis (o may be a broadcast camera position, which is
    replicated), so everything is promoted through a zero multiple of it.
    """
    op, dp = vp.splat(o), vp.splat(d)
    zero = dp[0] * 0.0 + op[0] * 0.0 + time * 0.0
    z3 = (zero, zero, zero)
    return dict(
        o=vp.add(op, z3), d=dp, time=time + zero,
        throughput=tuple(zero + 1.0 for _ in range(3)),
        active=zero == 0.0,
        acc=z3,
    )


def _bounce_core(scene, cfg: RenderConfig, keys, state, b, saved=None,
                 last=False, with_rec=False):
    """One bounce of the wavefront loop (Scene::rayTraceRecursive body,
    Scene.h:258-342).

    saved=None: full candidate pass + shadow sampling; additionally
    returns rec = (j_enc [N] i32 (-1 = miss), tid [N] i32, shadows
    [L, N] f32, tex_rec) -- the discrete selections AND fetched texels
    of this bounce (tex_rec: see _gather_hit_p).

    saved=(j_enc, tid, shadows, tex_rec): REPLAY -- skip the candidate
    argmin, the shadow search AND the atlas gathers; re-derive only the
    selected hit differentiably. Recorded texel values enter as
    differentiable replay inputs whose cotangents _trace_cv_bwd folds
    onto the atlases with one top-level scatter per atlas (the backward
    of the render: custom VJP below; SURVEY.md section 7).

    last=True (static): this is the final bounce, unrolled OUT of the
    lax.scan by the _trace_* drivers. Only `acc` of the returned state is
    live, so XLA dead-code-eliminates the scatter and state updates; with
    no lights and no emissive TEX_IMAGE material the texture/normal-map
    gathers are statically skipped too (see _gather_hit_p fetch_tex).
    """
    from tracer.render import shading

    eps = cfg.epsilon
    B = cfg.max_bounces
    ref = cfg.compat == "reference"
    L = scene.light_pos.shape[0]

    o, d, time = state["o"], state["d"], state["time"]
    active = state["active"]
    throughput = state["throughput"]
    acc = state["acc"]
    n_rem = B - b  # NRemainingBounces at this depth
    occupancy = jnp.mean(jnp.where(active, 1.0, 0.0))

    bkeys = rng.salted(keys, b)
    a2 = vp.dot(d, d)
    zero = o[0] * 0.0

    if saved is None:
        with jax.named_scope("traverse"):
            t_all, tri_mesh = _scene_candidates_p(scene, o, d, a2, time, eps)
        j = jnp.argmin(t_all, axis=0)
        tmin = jnp.min(t_all, axis=0)
        miss = tmin >= INF * 0.5
        S = scene.sph_center.shape[0]
        Q = scene.quad_v0.shape[0]
        if scene.mesh_mat.shape[0] > 0:
            jm = jnp.clip(j - S - Q, 0, scene.mesh_mat.shape[0] - 1)
            tid = jnp.take_along_axis(tri_mesh, jm[None, :], axis=0)[0]
        else:
            tid = jnp.zeros_like(j)
    else:
        reci_s, recf_s, shadows_saved = saved
        j_enc, tid = reci_s[0], reci_s[1]
        tex_saved = ((recf_s[0], recf_s[1], recf_s[2]),
                     (recf_s[3], recf_s[4], recf_s[5]),
                     reci_s[2], reci_s[3], recf_s[6], recf_s[7])
        miss = j_enc < 0
        j = jnp.maximum(j_enc, 0)

    # sky on miss (Scene.h:300-303). where-select (not multiply-by-
    # weight) so a NaN/Inf on an inactive lane can never poison acc.
    with jax.named_scope("sky"):
        sky = shading.skybox_color_p(
            scene, d, jnp.broadcast_to(n_rem, zero.shape), ref)
    acc = tuple(acc[a] + jnp.where(active & miss,
                                   throughput[a] * sky[a], 0.0)
                for a in range(3))

    fetch_tex = not (last and L == 0 and not scene.emissive_tex_image)
    with jax.named_scope("shade"):
        hit = _gather_hit_p(scene, o, d, a2, time, j, tid, eps,
                            fetch_tex=fetch_tex,
                            tex_saved=None if saved is None else tex_saved)
    live = active & ~miss

    with jax.named_scope("direct_light"):
        if saved is None:
            shadows = _shadow_factors_all(scene, cfg, hit["p"], time,
                                          bkeys, eps)
        else:
            shadows = [shadows_saved[i] for i in range(L)]
        direct = _direct_lighting_p(scene, cfg, hit["p"], hit["n"],
                                    hit["transp"], hit["diffuse"],
                                    shadows)
    acc = tuple(acc[a] + jnp.where(
        live, throughput[a] * (direct[a] + hit["emission"][a]), 0.0)
        for a in range(3))

    with jax.named_scope("scatter"):
        o2, d2 = _scatter_p(scene, cfg, d, hit["n"], hit["p"],
                            hit["mtype"], hit["ior"], bkeys)
    state = dict(
        o=vp.where(live, o2, o),
        d=vp.where(live, d2, d),
        time=time,
        throughput=vp.where(live, vp.mul(throughput, hit["diffuse"]),
                            throughput),
        active=live,
        acc=acc,
    )
    if saved is None and with_rec:
        j_enc = jnp.where(miss, -1, j.astype(jnp.int32))
        shadows_y = (jnp.stack(shadows) if L > 0
                     else jnp.zeros((0,) + zero.shape, jnp.float32))
        img, rnm, it, inn, pres, npres = hit["tex_rec"]
        reci = jnp.stack([j_enc, tid.astype(jnp.int32), it, inn])
        recf = jnp.stack([img[0], img[1], img[2], rnm[0], rnm[1], rnm[2],
                          jnp.where(pres, 1.0, 0.0),
                          jnp.where(npres, 1.0, 0.0)])
        return state, occupancy, (reci, recf, shadows_y)
    return state, occupancy, None


def _finish(state, cfg: RenderConfig):
    out = vp.pack(state["acc"])
    if cfg.compat == "reference":
        out = out / jnp.float32(cfg.max_bounces)  # Scene.h:347-349 quirk
    return out


def _trace_scan(scene, cfg: RenderConfig, o, d, time, keys,
                with_aux=False):
    """The plain autodiff path (also the with_aux/occupancy path).

    Rematerialize each bounce in the backward pass: the default scan AD
    saves dozens of [N]-sized residuals per bounce and runs an unfused
    bwd body; recomputing the forward body instead keeps the backward
    fused and its memory O(carry).

    The final bounce is unrolled out of the scan: its scatter/state
    updates (and, when statically dead, its texture gathers) are then
    eliminated -- a scan body cannot specialize its last iteration."""
    B = cfg.max_bounces

    def bounce(state, b):
        state, occupancy, _ = _bounce_core(scene, cfg, keys, state, b)
        return state, occupancy

    state, occ = jax.lax.scan(jax.checkpoint(bounce),
                              _init_state(o, d, time), jnp.arange(B - 1))
    state, occ_last, _ = _bounce_core(scene, cfg, keys, state,
                                      jnp.int32(B - 1), last=True)
    out = _finish(state, cfg)
    if with_aux:
        occ = jnp.concatenate([occ, occ_last[None]])
        return out, {"occupancy": occ}
    return out


def _trace_record(scene, cfg: RenderConfig, o, d, time, keys,
                  with_states=False):
    """Forward pass that also returns the per-bounce discrete record:
    (scan record for bounces 0..B-2, last-bounce record).

    with_states=True additionally records each bounce's INPUT state
    (o, d, throughput, active) as one stacked [10, N] array per bounce —
    the residuals the hand-written backward (render/replay_bwd.py) needs
    so the backward is a single reverse sweep with no replay forward."""
    B = cfg.max_bounces

    def st10(state):
        return jnp.stack(list(state["o"]) + list(state["d"])
                         + list(state["throughput"])
                         + [jnp.where(state["active"], 1.0, 0.0)])

    def bounce(state, b):
        y = (st10(state),) if with_states else ()
        state, _, rec = _bounce_core(scene, cfg, keys, state, b,
                                     with_rec=True)
        return state, (rec,) + y

    state, ys = jax.lax.scan(bounce, _init_state(o, d, time),
                             jnp.arange(B - 1))
    states = None
    if with_states:
        rec, st_scan = ys
        states = (st_scan, st10(state))
    else:
        (rec,) = ys
    state, _, rec_last = _bounce_core(scene, cfg, keys, state,
                                      jnp.int32(B - 1), last=True,
                                      with_rec=True)
    out = _finish(state, cfg)
    if with_states:
        return out, (rec, rec_last), states
    return out, (rec, rec_last)


def _trace_replay(scene, cfg: RenderConfig, o, d, time, keys, rec):
    """Differentiable replay conditioned on the recorded selections: no
    candidate pass, no BVH walks, no shadow search -- only the selected
    hit's analytic re-derivation and the shading chain. This is the
    function whose VJP is the renderer's backward.

    Remat per bounce (like _trace_scan): the plain scan-AD backward of
    even this residual-sized body lowers to unfused operations, while
    re-running the (gather-free) replay body forward inside the backward
    keeps the bwd fused."""
    B = cfg.max_bounces
    rec_scan, rec_last = rec

    def bounce(state, xs):
        b, saved = xs
        state, _, _ = _bounce_core(scene, cfg, keys, state, b, saved=saved)
        return state, None

    xs = (jnp.arange(B - 1), rec_scan)
    state, _ = jax.lax.scan(jax.checkpoint(bounce),
                            _init_state(o, d, time), xs)
    state, _, _ = _bounce_core(scene, cfg, keys, state, jnp.int32(B - 1),
                               saved=rec_last, last=True)
    return _finish(state, cfg)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _trace_cv(scene, cfg: RenderConfig, o, d, time, keys):
    return _trace_scan(scene, cfg, o, d, time, keys)


def _trace_cv_fwd(scene, cfg, o, d, time, keys):
    from tracer.render import replay_bwd
    if replay_bwd.hand_bwd_ok(scene, cfg):
        out, rec, states = _trace_record(scene, cfg, o, d, time, keys,
                                         with_states=True)
        rec, states = jax.lax.optimization_barrier((rec, states))
        return out, (scene, o, d, time, keys, rec, states)
    out, rec = _trace_record(scene, cfg, o, d, time, keys)
    # Hard boundary between the record forward and the replay backward:
    # the barrier forces the residuals to materialize, so the scheduler
    # cannot interleave the two scans.
    rec = jax.lax.optimization_barrier(rec)
    return out, (scene, o, d, time, keys, rec, None)


def _rec_split_tex(rec):
    """Split the record into (texel values, skeleton): the recf stacks
    (texel values + present masks) become differentiable replay INPUTS so
    their cotangents surface as plain vjp outputs; the integer record and
    shadows stay constants in the skeleton. (The mask rows' cotangents
    are discarded — masks only route selects.)"""
    texvals = tuple(recf for _, recf, _ in rec)
    skel = tuple((reci, sh) for reci, _, sh in rec)
    return texvals, skel


def _rec_join_tex(skel, texvals):
    return tuple((reci, recf, sh)
                 for (reci, sh), recf in zip(skel, texvals))


def fold_texel_updates(data_g, idxs, gs):
    """Fold per-bounce texel-cotangent updates onto a [P, 3] atlas grad.

    idxs: list of i32 index arrays (any shape); gs: matching list of planar
    (gx, gy, gz) cotangents. The three channels are interleaved into ONE
    flat scalar scatter-add instead of three row scatters."""
    idx = jnp.concatenate([ix.reshape(-1) for ix in idxs])
    i3 = jnp.concatenate([idx * 3, idx * 3 + 1, idx * 3 + 2])
    v3 = jnp.concatenate(
        [jnp.concatenate([gg[a].reshape(-1) for gg in gs])
         for a in range(3)])
    return data_g.reshape(-1).at[i3].add(v3).reshape(data_g.shape)


def _trace_cv_bwd(cfg, res, g):
    """Backward = vjp of the replay. The recorded texel values enter as
    differentiable replay arguments (not through a per-bounce scatter-add
    custom VJP): their cotangents come back as dense per-bounce arrays and
    are folded onto the atlases with ONE top-level scatter per atlas.
    Keeping the scatters out of the backward scan (a) lets XLA drop them
    entirely when the caller never uses the atlas gradients and (b) keeps
    the [P,3] cotangent accumulators out of the scan carry.

    For the phase-1 scene class (replay_bwd.hand_bwd_ok) the vjp is
    replaced by the HAND-WRITTEN reverse sweep (render/replay_bwd.py):
    one reverse scan over bounces, no replay forward, no autodiff graph —
    only the atlas fold below is shared."""
    scene, o, d, time, keys, rec, states = res
    texvals0, skel = _rec_split_tex(rec)

    with jax.named_scope("bwd"):
        if states is not None:
            from tracer.render import replay_bwd
            gscene, go, gd, gtime, gtex = replay_bwd.replay_backward(
                scene, cfg, o, d, time, keys, rec, states, g)
        else:
            def replay(scene, o, d, time, texvals):
                return _trace_replay(scene, cfg, o, d, time, keys,
                                     _rec_join_tex(skel, texvals))

            _, vjp = jax.vjp(replay, scene, o, d, time, texvals0)
            gscene, go, gd, gtime, gtex = vjp(g)

    gimg = [(g[..., 0, :], g[..., 1, :], g[..., 2, :]) for g in gtex]
    grnm = [(g[..., 3, :], g[..., 4, :], g[..., 5, :]) for g in gtex]
    idx_t = [reci[..., 2, :] for reci, _ in skel]
    idx_n = [reci[..., 3, :] for reci, _ in skel]
    # The last bounce's fetch is statically skipped when nothing can
    # consume a texel there (integrator._bounce_core fetch_tex): its
    # recorded indices/cotangents are structural zeros — drop them from
    # the fold instead of scattering one zero update per ray.
    if scene.light_pos.shape[0] == 0 and not scene.emissive_tex_image:
        gimg, grnm = gimg[:-1], grnm[:-1]
        idx_t, idx_n = idx_t[:-1], idx_n[:-1]
    with jax.named_scope("fold"):
        if scene.tex_data.shape[0] > 1:
            gscene = dataclasses.replace(
                gscene, tex_data=fold_texel_updates(gscene.tex_data, idx_t,
                                                    gimg))
        if scene.nm_data.shape[0] > 1:
            gscene = dataclasses.replace(
                gscene, nm_data=fold_texel_updates(gscene.nm_data, idx_n,
                                                   grnm))
    gkeys = np.zeros(keys.shape, jax.dtypes.float0)
    return gscene, go, gd, gtime, gkeys


_trace_cv.defvjp(_trace_cv_fwd, _trace_cv_bwd)


def trace(scene, cfg: RenderConfig, o, d, time, keys, with_aux=False):
    """Trace a ray batch to radiance [N,3].

    o,d: [N,3]; time: [N]; keys: [N] per-ray PRNG keys (pixel+sample
    folded). Equivalent of Scene::rayTrace (Scene.h:345-350) over a batch.
    `with_aux=True` additionally returns {"occupancy": [B]} -- the
    fraction of lanes still active at the START of each bounce
    (observability; SURVEY.md section 5 tracing plan).

    Differentiation goes through a record-replay custom VJP: the forward
    records each bounce's discrete selections (winning primitive, mesh
    triangle, Bernoulli shadow factors) and the backward differentiates a
    replay that re-derives only the selected hits -- the candidate
    argmin, BVH walks and shadow search never run in the backward.
    Disable with cfg.custom_vjp='off' (plain remat'd scan autodiff)."""
    if with_aux or getattr(cfg, "custom_vjp", "on") == "off":
        return _trace_scan(scene, cfg, o, d, time, keys, with_aux)
    return _trace_cv(scene, cfg, o, d, time, keys)
