"""Hand-written backward pass of the record-replay renderer (SURVEY §7
stage 6: "forward first, then hand-written backward kernel").

The custom-VJP backward used to be `jax.vjp` of the jnp replay — XLA
autodiff of a remat'd scan whose backward cost ~2 forwards (PERF.md).
The replay bounce is closed-form once the discrete record (winning
primitive, texels, Bernoulli draws) is fixed, so its vector-Jacobian
product can be written out by hand: ONE reverse scan over bounces, each
step re-deriving the bounce's primal values from the recorded selections
and chaining cotangents — no replay forward, no autodiff graph.

This module holds the adjoint MATH as pure planar jnp. It differentiates
exactly the computation of the jnp replay path (`integrator._bounce_core`
with `saved=...` → `_gather_hit_p` / `_scatter_p` / `_finish`), the same
chain `jax.vjp(replay)` differentiates — verified leaf-by-leaf against it
by tests/test_replay_bwd.py.

Phase-1 scene-class gate (`hand_bwd_ok`): no meshes, no explicit lights,
no sky image, no sphere texturing — the Cornell flagship class (emissive
textured quads + normal maps + glass/mirror spheres). Other scenes keep
the autodiff-replay backward.

Structural facts the derivation uses:
- u/v texture coordinates have identically-zero cotangents here: they are
  consumed only through trunc staircases (checker parity, texel indices,
  magenta fallback — all zero-derivative), so theta/phi/arccos and the
  quad u/v ADJOINT chains are dead (u/v primal is still recomputed for
  the checker parity masks);
- with L == 0 the direct-lighting loop vanishes, so the hit position p
  feeds only the scatter origin and `transp` has zero cotangent;
- the accumulated-radiance cotangent is constant across bounces (acc is a
  pure running sum), so it rides as a per-lane constant `gpix` instead of
  a scan carry.

Reference for the computation being differentiated: the reference's
`src/Scene.h:258-342` + `Material.cpp:26-130`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.core import rng

DIFFUSE, GLASS, MIRROR = 0, 1, 2
TEX_NONE, TEX_CHECKERBOARD, TEX_IMAGE = 0, 1, 2


def hand_bwd_ok(scene, cfg) -> bool:
    """Static gate for the hand-written backward (phase-1 scene class).
    Every field tested here is static metadata (shapes / meta booleans)."""
    no_atlas = (scene.tex_data.shape[0] <= 1
                and scene.nm_data.shape[0] <= 1)
    return (scene.mesh_mat.shape[0] == 0
            and scene.light_pos.shape[0] == 0
            and not scene.has_sky_image
            and not scene.sphere_uv_needed
            and not scene.emissive_tex_image
            and (no_atlas or (scene.pair_mode
                              and scene.pair_pack.shape[0] > 1)))


# ---------------------------------------------------------------------------
# planar helpers (3-tuples of [N] arrays)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _sc(k, a):
    return (k * a[0], k * a[1], k * a[2])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _wh(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def _mask(m, a):
    z = jnp.zeros_like(a[0])
    return (jnp.where(m, a[0], z), jnp.where(m, a[1], z),
            jnp.where(m, a[2], z))


def _norm_fwd(v, eps=1e-20):
    """vec3p.normalize forward: (unit, inv, sel); sel marks the
    differentiable branch of 1/max(|v|, eps)."""
    s = jnp.sqrt(_dot(v, v))
    inv = 1.0 / jnp.maximum(s, eps)
    return _sc(inv, v), inv, s >= eps


def _norm_bwd(unit, inv, sel, g):
    """Adjoint of u = v / max(|v|, eps): gv = inv*(g - sel*u*(u.g))."""
    k = jnp.where(sel, _dot(unit, g), 0.0)
    return (inv * (g[0] - unit[0] * k), inv * (g[1] - unit[1] * k),
            inv * (g[2] - unit[2] * k))


def _trunc_mod2(x):
    """mathutils.trunc_mod2 in floor form: exact for x >= 0 (every REAL
    textured lane has u,v >= 0 by the quad inside-test; garbage lanes'
    parity masks never reach an output)."""
    t = jnp.floor(x)
    return t - 2.0 * jnp.floor(t * 0.5)


# ---------------------------------------------------------------------------
# one-bounce adjoint
# ---------------------------------------------------------------------------

def bounce_bwd(o, d, tp, active, tm, bk, j_enc, img, rnm, ptex, pnm,
               mrf, textype, mtype, use_nm, srow, qrow,
               go2, gd2, gtp2, gpix, *, S, Q, ref, eps, n_rem, dark,
               has_pair, last=False):
    """Adjoint of one replay bounce for the phase-1 class.

    Inputs (planar): o/d/tp/img/rnm/go2/gd2/gtp2/gpix 3-tuples of [N];
    active bool [N]; tm time [N]; bk uint32 [N] (bounce-salted PCG key);
    j_enc recorded winner [N] i32; ptex/pnm present masks
    [N] f32; mrf/srow/qrow per-lane hit rows as COLUMN LISTS (18/8/19 of
    [N]); textype/mtype/use_nm [N] i32 (from the int material row).
    go2/gd2/gtp2 are the next-state cotangents (ignored when last=True).

    Returns (go, gd, gtp, gtm, gimg, grnm, gmrf, gsrow, gqrow, gdark)
    with row cotangents as column lists matching the inputs."""
    zero = jnp.zeros_like(tm)
    z3 = (zero, zero, zero)
    miss = j_enc < 0
    j = jnp.maximum(j_enc, 0)
    live = active & jnp.logical_not(miss)
    is_sph = j < S
    is_quad = jnp.logical_not(is_sph) & (j < S + Q)
    if last:
        go2 = gd2 = gtp2 = z3

    # ================= primal recompute (what the adjoint needs) ========
    a2 = _dot(d, d)

    # sphere detail (primitives.sphere_hit_detail_planar)
    center = (srow[0], srow[1], srow[2])
    radius = srow[3]
    mb_s = (srow[4], srow[5], srow[6])
    tc = _add(center, _sc(tm, mb_s))
    oc = _sub(o, tc)
    b_s = 2.0 * _dot(d, oc)
    c_s = _dot(oc, oc) - radius * radius
    delta = b_s * b_s - 4.0 * a2 * c_s
    sq = jnp.sqrt(jnp.maximum(delta, 1e-12))
    t_s = (-b_s - sq) / (2.0 * a2)
    p_s = _add(o, _sc(t_s, d))
    vns = _sub(p_s, tc)
    n_s, inv_ns, sel_ns = _norm_fwd(vns)

    # quad detail (primitives.quad_hit_detail_planar)
    v0 = (qrow[0], qrow[1], qrow[2])
    er = (qrow[3], qrow[4], qrow[5])
    eu = (qrow[6], qrow[7], qrow[8])
    mb_q = (qrow[9], qrow[10], qrow[11])
    tan = (qrow[12], qrow[13], qrow[14])
    bitan = (qrow[15], qrow[16], qrow[17])
    cr = _cross(er, eu)
    n_q, inv_nq, sel_nq = _norm_fwd(cr)
    bl = _add(v0, _sc(tm, mb_q))
    dotRN = _dot(d, n_q)
    safe = jnp.where(jnp.abs(dotRN) < 1e-9,
                     jnp.where(dotRN < 0, -1e-9, 1e-9), dotRN)
    num_q = _dot(bl, n_q) - _dot(o, n_q)
    t_q = num_q / safe
    p_q = _add(o, _sc(t_q, d))
    qv = _sub(p_q, bl)
    u_q = _dot(qv, er) / jnp.maximum(_dot(er, er), 1e-30)
    v_q = _dot(qv, eu) / jnp.maximum(_dot(eu, eu), 1e-30)

    p = _wh(is_quad, p_q, p_s)
    n0 = _wh(is_quad, n_q, n_s)

    # material fields (matf layout, integrator._geo_packs)
    sx, sy = mrf[0], mrf[1]
    c1 = (mrf[2], mrf[3], mrf[4])
    c2 = (mrf[5], mrf[6], mrf[7])
    base = (mrf[8], mrf[9], mrf[10])
    lc = (mrf[11], mrf[12], mrf[13])
    intens, emsv, ior = mrf[14], mrf[15], mrf[17]

    # texture selects. sphere lanes never have a textype here (gate:
    # sphere_uv_needed False), so quad u/v serve the parity masks.
    u_t, v_t = u_q, v_q
    same = _trunc_mod2(u_t * sx) == _trunc_mod2(v_t * sy)
    checker = _wh(same, c1, c2)
    same8 = _trunc_mod2(u_t * 8.0) == _trunc_mod2(v_t * 8.0)
    on = jnp.where(same8, 0.0, 1.0)
    magenta = (on, zero, on)
    present = ptex > 0.5
    img_fb = _wh(present, img, magenta)
    is_chk = textype == TEX_CHECKERBOARD
    is_img = textype == TEX_IMAGE
    is_none = textype == TEX_NONE
    textured = _wh(is_chk, checker, base)
    diffuse = _wh(is_img, img_fb, textured)

    # normal mapping (quads only; Scene.h:284)
    if has_pair:
        nmv = (2.0 * rnm[0] - 1.0, 2.0 * rnm[1] - 1.0, 2.0 * rnm[2] - 1.0)
        v2 = tuple(nmv[0] * tan[a] + nmv[1] * bitan[a] + nmv[2] * n0[a]
                   for a in range(3))
        n2u, inv_n2, sel_n2 = _norm_fwd(v2)
        upd = is_quad & (pnm > 0.5) & (use_nm > 0)
        n = _wh(upd, n2u, n0)
    else:
        n = n0

    # emission (Material::emit; mesh-skip quirk is vacuous here)
    etex = _wh(is_chk, checker, lc)
    etex = _wh(is_img, img_fb, etex)
    ecol = _wh(is_none, lc, etex)
    kem = intens * emsv
    emis = _sc(kem, ecol)

    # procedural sky (shading.skybox_color_p, no image)
    a_sky = 0.5 * (d[1] + 1.0)
    scale = (n_rem + 1.0) if ref else 1.0
    w_sky = 1.0 - a_sky
    k_sky = 1.0 - dark
    sky = (k_sky * (w_sky + a_sky * 0.5 * scale),
           k_sky * (w_sky + a_sky * 0.7 * scale),
           k_sky * (w_sky + a_sky * 1.0 * scale))

    # ================= adjoint (reverse order) ==========================
    amiss = active & miss

    # state selects: o'=wh(live,o2,o), d'=wh(live,d2,d),
    # tp'=wh(live,tp*diffuse,tp), acc'=acc+amiss*tp*sky+live*tp*emis
    g_o2 = _mask(live, go2)
    g_o = _mask(jnp.logical_not(live), go2)
    g_d2s = _mask(live, gd2)
    g_d = _mask(jnp.logical_not(live), gd2)
    g_tp = tuple(jnp.where(live, gtp2[a] * diffuse[a], gtp2[a])
                 + jnp.where(amiss, gpix[a] * sky[a], 0.0)
                 + jnp.where(live, gpix[a] * emis[a], 0.0)
                 for a in range(3))
    g_diffuse = list(_mask(live, tuple(gtp2[a] * tp[a] for a in range(3))))
    g_sky = _mask(amiss, tuple(gpix[a] * tp[a] for a in range(3)))
    g_emis = _mask(live, tuple(gpix[a] * tp[a] for a in range(3)))

    # sky: d/d(a) of comp c = k*(coef_c*scale - 1); d(a)/d(dy) = 0.5
    coef = (0.5, 0.7, 1.0)
    g_a = sum(g_sky[a] * k_sky * (coef[a] * scale - 1.0) for a in range(3))
    g_dy_sky = 0.5 * g_a
    g_dark = -sum(g_sky[a] * (w_sky + a_sky * coef[a] * scale)
                  for a in range(3))

    # emission: emis = kem * ecol
    g_kem = sum(g_emis[a] * ecol[a] for a in range(3))
    g_ecol = _sc(kem, g_emis)
    gm14 = g_kem * emsv
    gm15 = g_kem * intens
    m_img_e = jnp.logical_not(is_none) & is_img
    m_chk_e = jnp.logical_not(is_none) & jnp.logical_not(is_img) & is_chk
    m_lc_e = is_none | (jnp.logical_not(is_img) & jnp.logical_not(is_chk))
    g_imgfb = list(_mask(m_img_e, g_ecol))
    g_checker = list(_mask(m_chk_e, g_ecol))
    g_lc = _mask(m_lc_e, g_ecol)

    # diffuse: wh(is_img, img_fb, wh(is_chk, checker, base))
    m_chk_d = jnp.logical_not(is_img) & is_chk
    m_base = jnp.logical_not(is_img) & jnp.logical_not(is_chk)
    for a in range(3):
        g_imgfb[a] += jnp.where(is_img, g_diffuse[a], 0.0)
        g_checker[a] += jnp.where(m_chk_d, g_diffuse[a], 0.0)
    g_base = _mask(m_base, tuple(g_diffuse))

    # img_fb / checker leaves
    gimg = _mask(present, tuple(g_imgfb))
    g_c1 = _mask(same, tuple(g_checker))
    g_c2 = _mask(jnp.logical_not(same), tuple(g_checker))

    # ---------- scatter adjoint (skipped on the unrolled last bounce,
    # whose scatter/state outputs are statically dead) ----------
    g_n = list(z3)
    g_p = list(z3)
    g_ior = zero
    g_d_sc = list(z3)
    if not last:
        ddn = _dot(d, n)
        going_out = ddn > 0.0
        iw = jnp.where(ior > 1e-12, ior, 1.0)
        ior_inv = 1.0 / iw
        if ref:
            ri = jnp.where(going_out, ior_inv, ior)
        else:
            ri = jnp.where(going_out, ior, ior_inv)
        cos_t = jnp.minimum(-ddn, 1.0)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        if ref:
            cannot = (ri * sin_t - 0.6) > 1.0
        else:
            cannot = (ri * sin_t) > 1.0
        # the forward's draws (integrator._scatter_p), bit for bit
        u_glass = rng.uniform(rng.salted(bk, rng.SCATTER_GLASS))
        r0 = (1.0 - ri) / (1.0 + ri)
        r0 = r0 * r0
        mm = jnp.maximum(1.0 - cos_t, 0.0)
        m2 = mm * mm
        schlick = r0 + (1.0 - r0) * (m2 * m2 * mm)
        use_reflect = cannot | (schlick > u_glass)
        kr = 2.0 * ddn
        rf = tuple(d[a] - kr * n[a] for a in range(3))
        cth = jnp.minimum(ddn, 1.0)
        pp = tuple(ri * (cth * n[a] + d[a]) for a in range(3))
        kkw = 1.0 - _dot(pp, pp)
        kk = jnp.abs(kkw)
        m_r = jnp.maximum(kk, 1e-12)
        sqm = jnp.sqrt(m_r)
        par = -sqm
        rr = tuple(par * n[a] + pp[a] for a in range(3))
        skey = rng.salted(bk, rng.SCATTER_DIR)
        if ref:
            ruv = rng.cube_unit_vector_p(skey)
        else:
            ruv = rng.sphere_unit_vector_p(skey)
        ddf0 = _add(n, ruv)
        tinyn = jnp.sqrt(_dot(ddf0, ddf0)) <= eps
        is_g = mtype == GLASS
        is_m = mtype == MIRROR
        d_glass = _wh(use_reflect, rf, rr)
        ddf = _wh(tinyn, n, ddf0)
        v_lobe = _wh(is_g, d_glass, _wh(is_m, rf, ddf))
        d2u, inv_d2, sel_d2 = _norm_fwd(v_lobe)

        # reverse: o2 = p + eps*d2
        g_p = list(g_o2)
        g_d2 = tuple(g_d2s[a] + eps * g_o2[a] for a in range(3))
        g_v = _norm_bwd(d2u, inv_d2, sel_d2, g_d2)
        g_dglass = _mask(is_g, g_v)
        g_rf = list(_mask(is_m & jnp.logical_not(is_g), g_v))
        g_ddf = _mask(jnp.logical_not(is_g) & jnp.logical_not(is_m), g_v)
        # ddf = wh(tiny, n, n + ruv): both branches pass to n
        g_n = list(g_ddf)
        for a in range(3):
            g_rf[a] += jnp.where(use_reflect, g_dglass[a], 0.0)
        g_rr = _mask(jnp.logical_not(use_reflect), g_dglass)
        # rr = par*n + pp
        g_par = _dot(n, g_rr)
        for a in range(3):
            g_n[a] += par * g_rr[a]
        g_pp = list(g_rr)
        # par = -sqrt(max(|kkw|, 1e-12))
        g_m = -0.5 / sqm * g_par
        g_kk = jnp.where(kk >= 1e-12, g_m, 0.0)
        # jnp.sign spelled as selects (identical incl. 0)
        g_kkw = jnp.where(kkw > 0.0, g_kk,
                          jnp.where(kkw < 0.0, -g_kk, 0.0))
        for a in range(3):
            g_pp[a] += -2.0 * pp[a] * g_kkw
        # pp = ri*(cth*n + d)
        g_ri = sum(g_pp[a] * (cth * n[a] + d[a]) for a in range(3))
        g_cth = ri * _dot(n, tuple(g_pp))
        for a in range(3):
            g_n[a] += ri * cth * g_pp[a]
            g_d_sc[a] += ri * g_pp[a]
        g_ddn = jnp.where(ddn <= 1.0, g_cth, 0.0)
        # rf = d - kr*n ; kr = 2*ddn
        g_kr = -_dot(n, tuple(g_rf))
        for a in range(3):
            g_d_sc[a] += g_rf[a]
            g_n[a] += -kr * g_rf[a]
        g_ddn += 2.0 * g_kr
        # ri select (+ 1/iw)
        if ref:
            g_iorinv = jnp.where(going_out, g_ri, 0.0)
            g_ior = jnp.where(going_out, 0.0, g_ri)
        else:
            g_ior = jnp.where(going_out, g_ri, 0.0)
            g_iorinv = jnp.where(going_out, 0.0, g_ri)
        g_iw = -g_iorinv * ior_inv * ior_inv
        g_ior += jnp.where(ior > 1e-12, g_iw, 0.0)
        # ddn = d.n
        for a in range(3):
            g_d_sc[a] += g_ddn * n[a]
            g_n[a] += g_ddn * d[a]

    # ---------- normal-map adjoint ----------
    grnm = z3
    g_tan = z3
    g_bitan = z3
    if has_pair:
        g_n2 = _mask(upd, tuple(g_n))
        g_n0 = list(_mask(jnp.logical_not(upd), tuple(g_n)))
        g_v2 = _norm_bwd(n2u, inv_n2, sel_n2, g_n2)
        g_nmx = _dot(tan, g_v2)
        g_nmy = _dot(bitan, g_v2)
        g_nmz = _dot(n0, g_v2)
        g_tan = _sc(nmv[0], g_v2)
        g_bitan = _sc(nmv[1], g_v2)
        for a in range(3):
            g_n0[a] += nmv[2] * g_v2[a]
        grnm = (2.0 * g_nmx, 2.0 * g_nmy, 2.0 * g_nmz)
    else:
        g_n0 = list(g_n)

    # ---------- p / n selects ----------
    g_pq = _mask(is_quad, tuple(g_p))
    g_ps = list(_mask(jnp.logical_not(is_quad), tuple(g_p)))
    g_nq = list(_mask(is_quad, tuple(g_n0)))
    g_ns = _mask(jnp.logical_not(is_quad), tuple(g_n0))

    # ---------- quad detail adjoint ----------
    g_o_q = list(g_pq)
    g_tq = _dot(g_pq, d)
    g_d_q = list(_sc(t_q, g_pq))
    g_num = g_tq / safe
    g_safe = -t_q * g_tq / safe
    g_dotRN = jnp.where(jnp.abs(dotRN) >= 1e-9, g_safe, 0.0)
    g_bl = list(_sc(g_num, n_q))
    for a in range(3):
        g_o_q[a] += -g_num * n_q[a]
        g_nq[a] += g_num * (bl[a] - o[a])
        g_d_q[a] += g_dotRN * n_q[a]
        g_nq[a] += g_dotRN * d[a]
    g_cr = _norm_bwd(n_q, inv_nq, sel_nq, tuple(g_nq))
    g_er = _cross(eu, g_cr)
    g_eu = _cross(g_cr, er)
    g_v0 = tuple(g_bl)
    g_tm = jnp.where(is_quad, _dot(tuple(g_bl), mb_q), 0.0)
    g_mbq = _sc(tm, tuple(g_bl))

    # ---------- sphere detail adjoint ----------
    g_vns = _norm_bwd(n_s, inv_ns, sel_ns, g_ns)
    for a in range(3):
        g_ps[a] += g_vns[a]
    g_tc = list(_sc(-1.0, g_vns))
    g_o_s = list(g_ps)
    g_ts = _dot(tuple(g_ps), d)
    g_d_s = list(_sc(t_s, tuple(g_ps)))
    inv2a2 = 1.0 / (2.0 * a2)
    g_b = -g_ts * inv2a2
    g_sq = -g_ts * inv2a2
    g_a2 = -t_s * g_ts / a2
    g_delta = jnp.where(delta >= 1e-12, g_sq * 0.5 / sq, 0.0)
    g_b += 2.0 * b_s * g_delta
    g_a2 += -4.0 * c_s * g_delta
    g_c = -4.0 * a2 * g_delta
    g_oc = list(_sc(2.0 * g_c, oc))
    g_r = -2.0 * radius * g_c
    for a in range(3):
        g_d_s[a] += 2.0 * g_b * oc[a]
        g_oc[a] += 2.0 * g_b * d[a]
    for a in range(3):
        g_o_s[a] += g_oc[a]
        g_tc[a] += -g_oc[a]
    g_center = tuple(g_tc)
    g_tm += jnp.where(is_sph, _dot(tuple(g_tc), mb_s), 0.0)
    g_mbs = _sc(tm, tuple(g_tc))
    for a in range(3):
        g_d_s[a] += 2.0 * g_a2 * d[a]

    # ---------- totals ----------
    go = tuple(g_o[a] + g_o_q[a] + g_o_s[a] for a in range(3))
    gd = [g_d[a] + g_d_sc[a] + g_d_q[a] + g_d_s[a] for a in range(3)]
    gd[1] += g_dy_sky
    gd = tuple(gd)

    gmrf = ([zero, zero] + list(g_c1) + list(g_c2) + list(g_base)
            + list(g_lc) + [gm14, gm15, zero, g_ior])
    gsrow = list(g_center) + [g_r] + list(g_mbs) + [zero]
    gqrow = (list(g_v0) + list(g_er) + list(g_eu) + list(g_mbq)
             + list(g_tan) + list(g_bitan) + [zero])
    return (go, gd, tuple(g_tp), g_tm, gimg, grnm, gmrf, gsrow, gqrow,
            g_dark)


# ---------------------------------------------------------------------------
# reverse-scan driver
# ---------------------------------------------------------------------------

def _onehot_accum(acc_t, idx, rows):
    """acc_t [C, K] += rows [C, N] @ onehot [N, K] — the TRANSPOSED
    accumulator layout takes the stacked [C, N] rows as they are; the
    caller transposes the small [C, K] result once at the end. Exact:
    one-hot entries are 0/1 (integrator._rows rationale)."""
    K = acc_t.shape[1]
    oh = (idx[:, None] == jnp.arange(K, dtype=idx.dtype)[None, :]
          ).astype(jnp.float32)                                  # [N, K]
    return acc_t + jnp.dot(rows, oh, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)


def _rows_t(table, idx):
    """integrator._rows with a TRANSPOSED [C, N] result: table.T [C, K]
    @ onehot_t [K, N] — the planar row-major layout the bounce adjoint
    consumes (same 0/1-exactness argument)."""
    K = table.shape[0]
    oh_t = (jnp.arange(K, dtype=idx.dtype)[:, None] == idx[None, :]
            ).astype(table.dtype)                                # [K, N]
    return jnp.dot(table.T, oh_t, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def replay_backward(scene, cfg, o, d, time, keys, rec, states, g):
    """Full hand-written backward of the replay for the phase-1 class.

    rec: (rec_scan, rec_last) from integrator._trace_record; states:
    (st_scan [B-1, 10, N], st_last 10-tuple) — each bounce's INPUT state
    (o3, d3, tp3, active), recorded by the forward. g: [N, 3] radiance
    cotangent.

    Returns (gscene, go [N,3], gd [N,3], gtime [N], gtex) where gtex
    matches the texval-cotangent format of the autodiff path (list of
    [..., 8, N] stacks per rec segment: rows 0:3 img, 3:6 rnm, 6:8 zero)
    so the caller's atlas fold is shared."""
    import dataclasses

    from tracer.render import integrator as I

    B = cfg.max_bounces
    ref = cfg.compat == "reference"
    rec_scan, rec_last = rec
    st_scan, st_last = states
    N = g.shape[0]
    S = scene.sph_center.shape[0]
    Q = scene.quad_v0.shape[0]
    sph_pack, quad_pack, matf, mati = I._geo_packs(scene)
    M = matf.shape[0]
    dark = scene.dark_sky
    no_atlas = (scene.tex_data.shape[0] <= 1
                and scene.nm_data.shape[0] <= 1)
    has_pair = not no_atlas
    eps = cfg.epsilon

    gp = tuple(g[:, a] for a in range(3))
    if ref:
        gp = tuple(x / jnp.float32(B) for x in gp)   # _finish /B quirk

    matif = mati.astype(jnp.float32)   # values < 2^24, exact in f32

    def rows_for(j_enc):
        j = jnp.maximum(j_enc, 0)
        js = jnp.clip(j, 0, S - 1)
        jq = jnp.clip(j - S, 0, Q - 1)
        srow = _rows_t(sph_pack, js)                         # [8, N]
        qrow = _rows_t(quad_pack, jq)                        # [19, N]
        mid = jnp.where(j < S, srow[7], qrow[18]).astype(jnp.int32)
        mrf = _rows_t(matf, mid)                             # [18, N]
        mri = _rows_t(matif, mid)                            # [9, N]
        return js, jq, mid, srow, qrow, mrf, mri

    def run_bounce(st10, reci, recf, b, gcar, last):
        """gcar [12, N]: go2(3), gd2(3), gtp2(3), gpix(3). Returns the
        STACKED adjoint blocks (a [11, N]: go, gd, gtp, gtm, gdark;
        bb [6, N]: gimg, grnm; cc [45, N]: gmrf, gsrow, gqrow) plus
        (js, jq, mid) — everything stays in block form so the reverse
        scan runs with no per-array packing glue."""
        j_enc = reci[0]
        bk = rng.salted(keys, b)
        js, jq, mid, srow, qrow, mrf, mri = rows_for(j_enc)
        n_rem = (B - b).astype(jnp.float32)
        o_b = (st10[0], st10[1], st10[2])
        d_b = (st10[3], st10[4], st10[5])
        tp_b = (st10[6], st10[7], st10[8])
        active = st10[9] > 0.5
        img = (recf[0], recf[1], recf[2])
        rnm = (recf[3], recf[4], recf[5])
        ptex, pnm = recf[6], recf[7]
        (go, gd, gtp, gtm_b, gimg, grnm, gmrf_b, gsr_b, gqr_b,
         gdark_b) = bounce_bwd(
            o_b, d_b, tp_b, active, time, bk, j_enc, img, rnm, ptex,
            pnm, [mrf[c] for c in range(18)],
            mri[0].astype(jnp.int32), mri[7].astype(jnp.int32),
            mri[8].astype(jnp.int32), [srow[c] for c in range(8)],
            [qrow[c] for c in range(19)],
            (gcar[0], gcar[1], gcar[2]),
            (gcar[3], gcar[4], gcar[5]),
            (gcar[6], gcar[7], gcar[8]),
            (gcar[9], gcar[10], gcar[11]), S=S, Q=Q, ref=ref,
            eps=eps, n_rem=n_rem, dark=dark, has_pair=has_pair,
            last=last)
        a = jnp.stack(list(go) + list(gd) + list(gtp)
                      + [gtm_b, gdark_b])
        bb = jnp.stack(list(gimg) + list(grnm))
        cc = jnp.stack(list(gmrf_b) + list(gsr_b) + list(gqr_b))
        return a, bb, cc, js, jq, mid

    # ---- last (unrolled) bounce: input state is the scan's final carry
    reci_l, recf_l, _ = rec_last
    gcar0 = jnp.concatenate([jnp.zeros((9, N), jnp.float32),
                             jnp.stack(gp)])
    a, _, cc, js_l, jq_l, mid_l = run_bounce(
        jnp.stack(st_last), reci_l, recf_l, jnp.int32(B - 1), gcar0,
        True)
    gmatf = _onehot_accum(jnp.zeros((18, M), jnp.float32), mid_l,
                          cc[0:18])
    gsph = _onehot_accum(jnp.zeros((8, S), jnp.float32), js_l, cc[18:26])
    gquad = _onehot_accum(jnp.zeros((19, Q), jnp.float32), jq_l,
                          cc[26:45])
    gcar = jnp.concatenate([a[0:9], gcar0[9:12]])
    gtm = a[9]
    gdark_t = jnp.sum(a[10])

    # ---- reverse sweep over bounces B-2 .. 0. UNROLLED: B is small and
    # a lax.scan's per-step xs slicing + Y stacking measured ~0.5 ms/
    # bounce of pure overhead on top of the ~0.75 ms of real work
    reci_s, recf_s, _ = rec_scan
    gtex_list = [None] * (B - 1)
    for b in range(B - 2, -1, -1):
        # one barrier per bounce: without it XLA may fuse the whole
        # unrolled chain and recompute each bounce's adjoint once per
        # consumer, a cost that grows exponentially with max_bounces
        gcar = jax.lax.optimization_barrier(gcar)
        a, bb, cc, js, jq, mid = run_bounce(
            st_scan[b], reci_s[b], recf_s[b], jnp.int32(b), gcar, False)
        gmatf = _onehot_accum(gmatf, mid, cc[0:18])
        gsph = _onehot_accum(gsph, js, cc[18:26])
        gquad = _onehot_accum(gquad, jq, cc[26:45])
        gcar = jnp.concatenate([a[0:9], gcar[9:12]])
        gtm = gtm + a[9]
        gdark_t = gdark_t + jnp.sum(a[10])
        gtex_list[b] = jnp.concatenate(
            [bb, jnp.zeros((2, N), jnp.float32)])
    gtex_rev = (jnp.stack(gtex_list) if gtex_list
                else jnp.zeros((0, 8, N), jnp.float32))   # max_bounces=1

    # ---- map table cotangents back to scene fields --------------------
    gmatf = gmatf.T                                              # [M, 18]
    gsph = gsph.T                                                # [S, 8]
    gquad = gquad.T                                              # [Q, 19]
    sph_oh = (scene.sph_mat[:, None] == jnp.arange(M)[None, :]
              ).astype(jnp.float32)                              # [S, M]
    quad_oh = (scene.quad_mat[:, None] == jnp.arange(M)[None, :]
               ).astype(jnp.float32)
    g_mat_mb = (jnp.dot(sph_oh.T, gsph[:, 4:7],
                        precision=jax.lax.Precision.HIGHEST)
                + jnp.dot(quad_oh.T, gquad[:, 9:12],
                          precision=jax.lax.Precision.HIGHEST))

    def zero_ct(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.zeros(x.shape, x.dtype)
        import numpy as np
        return np.zeros(x.shape, jax.dtypes.float0)

    gscene = jax.tree.map(zero_ct, scene)
    gscene = dataclasses.replace(
        gscene,
        sph_center=gsph[:, 0:3], sph_radius=gsph[:, 3],
        mat_mb=g_mat_mb,
        quad_v0=gquad[:, 0:3], quad_er=gquad[:, 3:6],
        quad_eu=gquad[:, 6:9], quad_tan=gquad[:, 12:15],
        quad_bitan=gquad[:, 15:18],
        mat_texscale=gmatf[:, 0:2], mat_check1=gmatf[:, 2:5],
        mat_check2=gmatf[:, 5:8], mat_diffuse=gmatf[:, 8:11],
        mat_light_color=gmatf[:, 11:14],
        mat_light_intensity=gmatf[:, 14], mat_emissive=gmatf[:, 15],
        mat_transparency=gmatf[:, 16], mat_ior=gmatf[:, 17],
        dark_sky=gdark_t.astype(scene.dark_sky.dtype).reshape(
            scene.dark_sky.shape))

    go = gcar[0:3].T
    gd = gcar[3:6].T
    # last-bounce texel record is structurally zero in this class (its
    # fetch is statically skipped: L==0, no emissive TEX_IMAGE)
    gtex = (gtex_rev, jnp.zeros((8, N), jnp.float32))
    return gscene, go, gd, gtm, gtex
