"""Scene compiler: SceneBuilder -> DeviceScene (SoA jnp pytree).

The reference keeps typed object lists and virtual-ish dispatch
(`src/Scene.h:57-65`, switch at `Scene.h:270-304`). The recast here is one
flat SoA table per primitive class plus a material parameter table indexed
by a per-primitive material id — shading becomes branchless gathers +
`jnp.where` selects, and intersection becomes elementwise tests of every
ray against the whole table at once.

Textures live in a single flat atlas (`tex_data [P,3]`) with per-texture
(offset, w, h); texel fetch is a differentiable gather, so texels are
trainable parameters. Normal maps and the skybox use the same scheme.

Triangle meshes are concatenated into one global soup with per-mesh BVHs
flattened into shared arrays (`bvh_*`), preserving the reference's per-mesh
closest-hit semantics (`Scene.h:222-228` loops meshes) while letting the
BVH walk cover a contiguous node range per mesh.

All shapes are static per scene => one XLA compilation per scene topology.
Padded rows are masked via `*_valid`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np
import jax.numpy as jnp

from tracer.accel.bvh import build_bvh, triangle_bounds, TRIANGLE_SCALING
from tracer.scene import builder as B


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    # --- spheres (padded to multiple of 8) -------------------------------
    sph_center: jnp.ndarray      # [S, 3]
    sph_radius: jnp.ndarray      # [S]
    sph_mat: jnp.ndarray         # [S] i32
    sph_valid: jnp.ndarray       # [S] f32 (1 real, 0 pad)

    # --- quads -----------------------------------------------------------
    quad_v0: jnp.ndarray         # [Q, 3] transformed vertex 0 (bottom-left)
    quad_er: jnp.ndarray         # [Q, 3] v1 - v0
    quad_eu: jnp.ndarray         # [Q, 3] v3 - v0
    quad_normal: jnp.ndarray     # [Q, 3] normalize(cross(er, eu))
    quad_tan: jnp.ndarray        # [Q, 3] setQuad m_right_vector (stale frame)
    quad_bitan: jnp.ndarray      # [Q, 3] setQuad m_up_vector
    quad_mat: jnp.ndarray        # [Q] i32
    quad_valid: jnp.ndarray      # [Q] f32

    # --- triangle soup (all meshes, pre-scaled by TRIANGLE_SCALING) ------
    # tri_a/b/c are baked per-corner copies used by the (non-differentiable)
    # BVH traversal/selection; mesh_verts + tri_v{a,b,c} are the shared
    # vertex table the differentiable hit re-evaluation gathers from, so a
    # vertex shared by many triangles accumulates ONE gradient
    # (reference: Mesh.h:111-124 — verts are a trainable parameter).
    tri_a: jnp.ndarray           # [T, 3]
    tri_b: jnp.ndarray           # [T, 3]
    tri_c: jnp.ndarray           # [T, 3]
    mesh_verts: jnp.ndarray      # [V, 3] (scaled; last row = sentinel zeros)
    tri_va: jnp.ndarray          # [T] i32 index into mesh_verts
    tri_vb: jnp.ndarray          # [T] i32
    tri_vc: jnp.ndarray          # [T] i32
    tri_mesh: jnp.ndarray        # [T] i32 mesh id
    tri_col_a: jnp.ndarray       # [T, 3] per-corner color (vertex or face)
    tri_col_b: jnp.ndarray       # [T, 3]
    tri_col_c: jnp.ndarray       # [T, 3]
    tri_has_col: jnp.ndarray     # [T] f32 (1 => interpolate cols over diffuse)
    mesh_mat: jnp.ndarray        # [Nm] i32 material id per mesh

    # --- flattened BVHs (concatenated per mesh) --------------------------
    bvh_lo: jnp.ndarray          # [Bn, 3]
    bvh_hi: jnp.ndarray          # [Bn, 3]
    bvh_leaf_start: jnp.ndarray  # [Bn] i32 (-1 inner)
    bvh_skip: jnp.ndarray        # [Bn] i32 (mesh-local, pre-offset to global)
    bvh_leaf_tris: jnp.ndarray   # [NL * LW] i32 global tri id (T => sentinel)

    # --- material table --------------------------------------------------
    mat_diffuse: jnp.ndarray     # [M, 3]
    mat_specular: jnp.ndarray    # [M, 3]
    mat_shininess: jnp.ndarray   # [M]
    mat_mb: jnp.ndarray          # [M, 3] motion_blur_translation
    mat_ior: jnp.ndarray         # [M]
    mat_transparency: jnp.ndarray  # [M]
    mat_type: jnp.ndarray        # [M] i32 (0 diffuse, 1 glass, 2 mirror)
    mat_textype: jnp.ndarray     # [M] i32 (0 none, 1 checker, 2 image)
    mat_check1: jnp.ndarray      # [M, 3]
    mat_check2: jnp.ndarray      # [M, 3]
    mat_texscale: jnp.ndarray    # [M, 2] (x, y)
    mat_emissive: jnp.ndarray    # [M] f32
    mat_light_color: jnp.ndarray  # [M, 3]
    mat_light_intensity: jnp.ndarray  # [M]
    mat_tex: jnp.ndarray         # [M] i32 texture slot (0 reserved = none)
    mat_nm: jnp.ndarray          # [M] i32 normal-map slot (0 = none)

    # --- texture atlas (slot 0 is a 0x0 "missing" entry) -----------------
    tex_data: jnp.ndarray        # [P, 3] f32 in [0,1]
    tex_off: jnp.ndarray         # [K] i32
    tex_w: jnp.ndarray           # [K] i32
    tex_h: jnp.ndarray           # [K] i32
    nm_data: jnp.ndarray         # [Pn, 3] f32 raw (decode at sample time)
    nm_off: jnp.ndarray
    nm_w: jnp.ndarray
    nm_h: jnp.ndarray
    # Pair-packed atlas: ONE row = 16 texture words (cols 0:16) + the 16
    # normal-map words of the SAME texel indices (cols 16:32), built per
    # (tex slot, nm slot) pair region. Only the hand-written backward's
    # scene-class gate reads it (replay_bwd.hand_bwd_ok, with pair_mode).
    pair_pack: jnp.ndarray       # [Rp, 32] i32

    # --- lights ----------------------------------------------------------
    light_pos: jnp.ndarray       # [L, 3]
    light_radius: jnp.ndarray    # [L]
    light_color: jnp.ndarray     # [L, 3]

    # --- skybox ----------------------------------------------------------
    sky_data: jnp.ndarray        # [Ps, 3] f32 (size 1 when absent)
    sky_w: jnp.ndarray           # i32 scalar (0 when absent)
    sky_h: jnp.ndarray           # i32 scalar
    dark_sky: jnp.ndarray        # f32 scalar (1 => black fallback sky)

    # --- STATIC metadata (hashable; part of the jit cache key) ----------
    mesh_root: Tuple[int, ...] = ()   # per-mesh BVH node range start
    mesh_end: Tuple[int, ...] = ()    # per-mesh BVH node range end
    leaf_width: int = 4
    has_sky_image: bool = False
    pair_mode: bool = False           # pair_pack covers every needed fetch
    emissive_tex_image: bool = True   # some emissive material is TEX_IMAGE
    #   (when False and a bounce's diffuse is dead — last bounce, no
    #   lights — the integrator statically skips the texture gather:
    #   emission then provably never selects the fetched texel)
    n_sph_real: int = 0   # real (non-padding) sphere count
    n_quad_real: int = 0  # real quad count (pads have valid=0)
    sphere_uv_needed: bool = False    # some sphere material has a textype
    #   (checker or image), so sphere hits need theta/phi texture coords

    # --- static helpers --------------------------------------------------
    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_quads(self) -> int:
        return self.quad_v0.shape[0]

    @property
    def n_tris(self) -> int:
        return max(self.tri_a.shape[0] - 1, 0)  # minus sentinel row

    @property
    def n_meshes(self) -> int:
        return self.mesh_mat.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_pos.shape[0]


_fields = [f.name for f in dataclasses.fields(DeviceScene)]
_meta = ["mesh_root", "mesh_end", "leaf_width", "has_sky_image", "pair_mode",
         "emissive_tex_image", "sphere_uv_needed", "n_sph_real",
         "n_quad_real"]
jax.tree_util.register_dataclass(
    DeviceScene,
    data_fields=[f for f in _fields if f not in _meta],
    meta_fields=_meta,
)


def _pad_rows(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


PACK_BLOCK = 16  # texels per pair-atlas row half


def _atlas(images) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """Pack images (uint8 [H,W,3] or None) into a flat float atlas.

    Slot 0 is always the 'missing' entry (w=h=0) so material slot 0 means
    'no texture' and missing images trigger the reference's fallbacks.
    """
    data = [np.zeros((1, 3), np.uint8)]
    off, ws, hs = [0], [0], [0]
    cursor = 1
    for img in images:
        if img is None:
            off.append(0)
            ws.append(0)
            hs.append(0)
            continue
        h, w = img.shape[:2]
        data.append(img.reshape(-1, 3).astype(np.uint8))
        off.append(cursor)
        ws.append(w)
        hs.append(h)
        cursor += h * w
    rows_u8 = np.concatenate(data, axis=0)
    return (rows_u8.astype(np.float32) * np.float32(1.0 / 255.0),
            np.asarray(off, np.int32), np.asarray(ws, np.int32),
            np.asarray(hs, np.int32))


TEX_IMAGE = 2  # builder Material.texture_type image value (shading.TEX_IMAGE)

# pair_mode is disabled when the pair atlas would exceed this many texel
# entries (product regions of huge mismatched images can blow up).
_PAIR_MAX_ENTRIES = 64 * 1024 * 1024


def _axis_pairs(Wa: int, Wb: int):
    """All f32-achievable (x_a, x_b) = (trunc(w*(Wa-1)), trunc(w*(Wb-1)))
    for f32 w in [0, 1], as arrays indexed by the sum s = x_a + x_b.

    Both staircases are monotone nondecreasing in w, so the sum strictly
    increases at every transition => each achievable sum identifies a
    UNIQUE pair; this is what lets two images of different widths share one
    fetch index (DeviceScene.pair_pack product regions). The walk samples
    ulp-neighborhoods of every exact breakpoint plus interval midpoints in
    f32 — the arithmetic of the nearest-texel staircase — so the table
    covers exactly the pairs f32 texture coordinates can produce. Returns
    (xa[s], xb[s], ok) with -1 at unachievable sums; ok=False on a
    consistency violation (caller falls back to pair_mode=False).
    """
    bps = {0.0, 1.0}
    for W in (Wa, Wb):
        for k in range(1, max(W - 1, 0) + 1):
            bps.add(k / (W - 1))
    b64 = np.array(sorted(bps), np.float64)
    mids = ((b64[:-1] + b64[1:]) / 2).astype(np.float32)
    f32b = b64.astype(np.float32)
    cands = [f32b, mids]
    lo = f32b
    hi = f32b
    for _ in range(8):  # +-8 ulps around each breakpoint
        lo = np.nextafter(lo, np.float32(-1.0), dtype=np.float32)
        hi = np.nextafter(hi, np.float32(2.0), dtype=np.float32)
        cands.append(lo)
        cands.append(hi)
    w = np.unique(np.clip(np.concatenate(cands), np.float32(0.0),
                          np.float32(1.0)))

    def stairs(W):
        x = np.trunc(w * np.float32(W - 1))
        return np.clip(x, 0, max(W - 1, 0)).astype(np.int64)

    xa = stairs(Wa)
    xb = stairs(Wb)
    s = xa + xb
    Sc = (Wa - 1) + (Wb - 1) + 1
    ta = np.full(Sc, -1, np.int64)
    tb = np.full(Sc, -1, np.int64)
    ok = True
    # vectorized "each sum -> one pair" fill + consistency check
    order = np.argsort(s, kind="stable")
    s_o, xa_o, xb_o = s[order], xa[order], xb[order]
    first = np.ones(len(s_o), bool)
    first[1:] = s_o[1:] != s_o[:-1]
    ta[s_o[first]] = xa_o[first]
    tb[s_o[first]] = xb_o[first]
    if np.any(ta[s] != xa) or np.any(tb[s] != xb):
        ok = False
    return ta, tb, ok


def _build_pair_atlas(mats, quad_rows, textures, normal_maps):
    """Pair-packed atlas (see DeviceScene.pair_pack).

    For each material that fetches texels, allocate a region keyed by its
    (texture slot, normal-map slot) pair: rows of 16 texture words (cols
    0:16) + 16 normal-map words (cols 16:32), so the per-bounce texture and
    normal-map fetches share ONE gather. A material needs the nm half only
    if it is used by a quad (the reference applies normal maps to squares
    only, Scene.h:284).

    Matched dims: the region is the tex index space and the nm texel sits
    at the same index. Mismatched dims: a PRODUCT region indexed by
    rel = (y_t+y_n)*(Wt+Wn-1) + (x_t+x_n) — monotone-staircase sums
    uniquely identify the (tex, nm) texel pair (see _axis_pairs).

    Returns (pack [Rp,32] i32, pair_mode).
    """
    empty = np.zeros((1, 2 * PACK_BLOCK), np.int32)

    def bail():
        return jnp.asarray(empty), False

    def word(img):
        v = img.reshape(-1, 3).astype(np.int32)
        return (v[:, 0] << 16) | (v[:, 1] << 8) | v[:, 2]

    regions = set()
    blocks = []
    total_entries = 0
    for mi, m in enumerate(mats):
        is_quad = mi in quad_rows
        tslot = m.texture_id if m.texture_type == TEX_IMAGE else -1
        timg = (textures[tslot] if 0 <= tslot < len(textures) else None)
        nslot = m.normal_map_id if is_quad else -1
        nimg = (normal_maps[nslot] if 0 <= nslot < len(normal_maps)
                else None)
        if timg is None and nimg is None:
            continue
        key = (tslot if timg is not None else -1,
               nslot if nimg is not None else -1)
        if key not in regions:
            if timg is not None and nimg is not None \
                    and timg.shape[:2] != nimg.shape[:2]:
                # product region
                Ht, Wt = timg.shape[:2]
                Hn, Wn = nimg.shape[:2]
                xt, xn, okx = _axis_pairs(Wt, Wn)
                yt, yn, oky = _axis_pairs(Ht, Hn)
                if not (okx and oky):
                    return bail()
                Wc = Wt + Wn - 1
                Hc = Ht + Hn - 1
                P = Wc * Hc
                total_entries += P
                if total_entries > _PAIR_MAX_ENTRIES:
                    return bail()
                tflat = word(timg)
                nflat = word(nimg)
                # entry (sy, sx): tex[yt[sy]*Wt+xt[sx]], nm[yn[sy]*Wn+xn[sx]]
                xt_s = np.where(xt < 0, 0, xt)
                xn_s = np.where(xn < 0, 0, xn)
                yt_s = np.where(yt < 0, 0, yt)
                yn_s = np.where(yn < 0, 0, yn)
                hole = (xt[None, :] < 0) | (yt[:, None] < 0)
                ti = yt_s[:, None] * Wt + xt_s[None, :]
                ni = yn_s[:, None] * Wn + xn_s[None, :]
                tw = np.where(hole, 0, tflat[ti]).reshape(-1)
                nw = np.where(hole, 0, nflat[ni]).reshape(-1)
                rows = (P + PACK_BLOCK - 1) // PACK_BLOCK
                tw = np.concatenate(
                    [tw, np.zeros(rows * PACK_BLOCK - P, np.int32)])
                nw = np.concatenate(
                    [nw, np.zeros(rows * PACK_BLOCK - P, np.int32)])
            else:
                base = timg if timg is not None else nimg
                H, W = base.shape[:2]
                P = H * W
                total_entries += P
                if total_entries > _PAIR_MAX_ENTRIES:
                    return bail()
                rows = (P + PACK_BLOCK - 1) // PACK_BLOCK
                tw = np.zeros(rows * PACK_BLOCK, np.int32)
                nw = np.zeros(rows * PACK_BLOCK, np.int32)
                if timg is not None:
                    tw[:P] = word(timg)
                if nimg is not None:
                    nw[:P] = word(nimg)
            blocks.append(np.concatenate(
                [tw.reshape(rows, PACK_BLOCK),
                 nw.reshape(rows, PACK_BLOCK)], axis=1))
            regions.add(key)
    pack = np.concatenate(blocks, axis=0) if blocks else empty
    return jnp.asarray(pack), True


def compile_scene(sb: B.SceneBuilder, leaf_width: int = 16,
                  bvh_max_depth: int = 64, pad: int = 8,
                  use_native: bool = True) -> DeviceScene:
    """Lower a SceneBuilder to a DeviceScene. `use_native` prefers the C++
    SAH BVH builder (native/bvh_builder.cpp) and falls back to numpy."""
    # ---- materials ------------------------------------------------------
    mats: list[B.Material] = []

    def mat_id(m: B.Material) -> int:
        mats.append(m)
        return len(mats) - 1

    # ---- spheres --------------------------------------------------------
    S = len(sb.spheres)
    Sp = max(_round_up(S, pad), pad)
    sph_center = np.zeros((Sp, 3), np.float32)
    sph_radius = np.zeros(Sp, np.float32)
    sph_mat = np.zeros(Sp, np.int32)
    sph_valid = np.zeros(Sp, np.float32)
    for i, s in enumerate(sb.spheres):
        sph_center[i] = s.center
        sph_radius[i] = s.radius
        sph_mat[i] = mat_id(s.material)
        sph_valid[i] = 1.0

    # ---- quads ----------------------------------------------------------
    Q = len(sb.squares)
    Qp = max(_round_up(Q, pad), pad)
    quad_v0 = np.zeros((Qp, 3), np.float32)
    quad_er = np.zeros((Qp, 3), np.float32)
    quad_eu = np.zeros((Qp, 3), np.float32)
    quad_normal = np.zeros((Qp, 3), np.float32)
    quad_tan = np.zeros((Qp, 3), np.float32)
    quad_bitan = np.zeros((Qp, 3), np.float32)
    quad_mat = np.zeros(Qp, np.int32)
    quad_valid = np.zeros(Qp, np.float32)
    quad_er[:, 0] = 1.0  # avoid zero-length pads
    quad_eu[:, 1] = 1.0
    quad_normal[:, 2] = 1.0
    for i, q in enumerate(sb.squares):
        v = q.verts
        er, eu = v[1] - v[0], v[3] - v[0]
        n = np.cross(er.astype(np.float64), eu.astype(np.float64))
        n = n / max(np.linalg.norm(n), 1e-30)
        quad_v0[i], quad_er[i], quad_eu[i] = v[0], er, eu
        quad_normal[i] = n
        quad_tan[i], quad_bitan[i] = q.tangent, q.bitangent
        quad_mat[i] = mat_id(q.material)
        quad_valid[i] = 1.0

    # ---- meshes / triangle soup ----------------------------------------
    tri_a_l, tri_b_l, tri_c_l = [], [], []
    verts_l, tri_va_l, tri_vb_l, tri_vc_l = [], [], [], []
    vert_cursor = 0
    tri_mesh_l, tca, tcb, tcc, thc = [], [], [], [], []
    mesh_mat_l = []
    bvh_lo_l, bvh_hi_l, bvh_ls_l, bvh_skip_l, leaf_tris_l = [], [], [], [], []
    mesh_root_l, mesh_end_l = [], []
    tri_cursor = 0
    node_cursor = 0
    leaf_cursor = 0
    for mi, m in enumerate(sb.meshes):
        mesh_mat_l.append(mat_id(m.material))
        v = m.verts * TRIANGLE_SCALING  # KDTree.cpp:38-40 leaf-test scaling
        t = m.tris
        tri_a_l.append(v[t[:, 0]])
        tri_b_l.append(v[t[:, 1]])
        tri_c_l.append(v[t[:, 2]])
        verts_l.append(v.astype(np.float32))
        tri_va_l.append(t[:, 0].astype(np.int32) + vert_cursor)
        tri_vb_l.append(t[:, 1].astype(np.int32) + vert_cursor)
        tri_vc_l.append(t[:, 2].astype(np.int32) + vert_cursor)
        vert_cursor += v.shape[0]
        tri_mesh_l.append(np.full(t.shape[0], mi, np.int32))
        if m.vert_colors is not None:
            tca.append(m.vert_colors[t[:, 0]])
            tcb.append(m.vert_colors[t[:, 1]])
            tcc.append(m.vert_colors[t[:, 2]])
            thc.append(np.ones(t.shape[0], np.float32))
        elif m.face_colors is not None:
            tca.append(m.face_colors)
            tcb.append(m.face_colors)
            tcc.append(m.face_colors)
            thc.append(np.ones(t.shape[0], np.float32))
        else:
            z = np.zeros((t.shape[0], 3), np.float32)
            tca.append(z)
            tcb.append(z)
            tcc.append(z)
            thc.append(np.zeros(t.shape[0], np.float32))

        lo, hi = triangle_bounds(m.verts, t)
        bvh = None
        if use_native:
            from tracer.accel.native import build_bvh_native
            bvh = build_bvh_native(lo, hi, leaf_width, bvh_max_depth)
        if bvh is None:
            bvh = build_bvh(lo, hi, leaf_width, bvh_max_depth, sentinel=-1)
        # offset mesh-local ids to global
        lt = bvh.leaf_tris.copy()
        lt[lt >= 0] += tri_cursor
        ls = bvh.node_leaf_start.copy()
        ls[ls >= 0] += leaf_cursor
        bvh_lo_l.append(bvh.node_lo)
        bvh_hi_l.append(bvh.node_hi)
        bvh_ls_l.append(ls)
        bvh_skip_l.append(bvh.node_skip + node_cursor)
        leaf_tris_l.append(lt)
        mesh_root_l.append(node_cursor)
        node_cursor += bvh.n_nodes
        mesh_end_l.append(node_cursor)
        leaf_cursor += lt.shape[0]
        tri_cursor += t.shape[0]

    # sentinel triangle (id -1 remaps to last row: degenerate, never hits)
    def cat3(lst):
        lst = lst + [np.zeros((1, 3), np.float32)]
        return np.concatenate(lst, axis=0).astype(np.float32)

    tri_a = cat3(tri_a_l)
    tri_b = cat3(tri_b_l)
    tri_c = cat3(tri_c_l)
    # shared vertex table + sentinel zeros row; the soup's sentinel triangle
    # points at it so the last tri row stays degenerate
    mesh_verts = cat3(verts_l)
    V = mesh_verts.shape[0] - 1
    sent = np.full(1, V, np.int32)
    tri_va = np.concatenate(tri_va_l + [sent]).astype(np.int32)
    tri_vb = np.concatenate(tri_vb_l + [sent]).astype(np.int32)
    tri_vc = np.concatenate(tri_vc_l + [sent]).astype(np.int32)
    tri_mesh = np.concatenate(tri_mesh_l + [np.zeros(1, np.int32)])
    tri_col_a = cat3(tca)
    tri_col_b = cat3(tcb)
    tri_col_c = cat3(tcc)
    tri_has_col = np.concatenate(thc + [np.zeros(1, np.float32)])
    T = tri_a.shape[0] - 1
    leaf_tris = (np.concatenate(leaf_tris_l) if leaf_tris_l
                 else np.zeros(0, np.int32))
    leaf_tris = np.where(leaf_tris < 0, T, leaf_tris).astype(np.int32)

    Nm = len(sb.meshes)
    if Nm == 0:
        bvh_lo = np.zeros((0, 3), np.float32)
        bvh_hi = np.zeros((0, 3), np.float32)
        bvh_ls = np.zeros(0, np.int32)
        bvh_skip = np.zeros(0, np.int32)
    else:
        bvh_lo = np.concatenate(bvh_lo_l, axis=0)
        bvh_hi = np.concatenate(bvh_hi_l, axis=0)
        bvh_ls = np.concatenate(bvh_ls_l)
        bvh_skip = np.concatenate(bvh_skip_l)

    # ---- material table -------------------------------------------------
    M = max(len(mats), 1)
    if not mats:
        mats = [B.Material()]
    mat_diffuse = np.stack([m.diffuse for m in mats])
    mat_specular = np.stack([m.specular for m in mats])
    mat_shininess = np.asarray([m.shininess for m in mats], np.float32)
    mat_mb = np.stack([m.motion_blur_translation for m in mats])
    mat_ior = np.asarray([m.index_medium for m in mats], np.float32)
    mat_transp = np.asarray([m.transparency for m in mats], np.float32)
    mat_type = np.asarray([m.mtype for m in mats], np.int32)
    mat_textype = np.asarray([m.texture_type for m in mats], np.int32)
    mat_check1 = np.stack([m.checkerboard_color1 for m in mats])
    mat_check2 = np.stack([m.checkerboard_color2 for m in mats])
    mat_texscale = np.asarray(
        [[m.texture_scale_x, m.texture_scale_y] for m in mats], np.float32)
    mat_emissive = np.asarray([float(m.emissive) for m in mats], np.float32)
    mat_light_color = np.stack([m.light_color for m in mats])
    mat_light_int = np.asarray([m.light_intensity for m in mats], np.float32)
    mat_tex = np.asarray([m.texture_id + 1 for m in mats], np.int32)
    mat_nm = np.asarray([m.normal_map_id + 1 for m in mats], np.int32)

    tex_data, tex_off, tex_w, tex_h = _atlas(sb.textures)
    nm_data, nm_off, nm_w, nm_h = _atlas(sb.normal_maps)

    quad_rows = set(int(quad_mat[i]) for i in range(Q))
    pair_pack, pair_mode = _build_pair_atlas(mats, quad_rows, sb.textures,
                                             sb.normal_maps)

    # ---- lights ---------------------------------------------------------
    L = len(sb.lights)
    light_pos = (np.stack([l.pos for l in sb.lights])
                 if L else np.zeros((0, 3), np.float32))
    light_radius = np.asarray([l.radius for l in sb.lights], np.float32)
    light_color = (np.stack([l.color for l in sb.lights])
                   if L else np.zeros((0, 3), np.float32))

    # ---- skybox ---------------------------------------------------------
    if sb.skybox is not None:
        sh, sw = sb.skybox.shape[:2]
        sky_u8 = sb.skybox.reshape(-1, 3).astype(np.uint8)
        sky_data = sky_u8.astype(np.float32) * np.float32(1.0 / 255.0)
    else:
        sh = sw = 0
        sky_data = np.zeros((1, 3), np.float32)

    jf = jnp.asarray
    return DeviceScene(
        sph_center=jf(sph_center), sph_radius=jf(sph_radius),
        sph_mat=jf(sph_mat), sph_valid=jf(sph_valid),
        quad_v0=jf(quad_v0), quad_er=jf(quad_er), quad_eu=jf(quad_eu),
        quad_normal=jf(quad_normal), quad_tan=jf(quad_tan),
        quad_bitan=jf(quad_bitan), quad_mat=jf(quad_mat),
        quad_valid=jf(quad_valid),
        tri_a=jf(tri_a), tri_b=jf(tri_b), tri_c=jf(tri_c),
        mesh_verts=jf(mesh_verts), tri_va=jf(tri_va), tri_vb=jf(tri_vb),
        tri_vc=jf(tri_vc),
        tri_mesh=jf(tri_mesh), tri_col_a=jf(tri_col_a),
        tri_col_b=jf(tri_col_b), tri_col_c=jf(tri_col_c),
        tri_has_col=jf(tri_has_col),
        mesh_mat=jf(np.asarray(mesh_mat_l, np.int32).reshape(-1)),
        bvh_lo=jf(bvh_lo), bvh_hi=jf(bvh_hi), bvh_leaf_start=jf(bvh_ls),
        bvh_skip=jf(bvh_skip), bvh_leaf_tris=jf(leaf_tris),
        mat_diffuse=jf(mat_diffuse), mat_specular=jf(mat_specular),
        mat_shininess=jf(mat_shininess), mat_mb=jf(mat_mb),
        mat_ior=jf(mat_ior), mat_transparency=jf(mat_transp),
        mat_type=jf(mat_type), mat_textype=jf(mat_textype),
        mat_check1=jf(mat_check1), mat_check2=jf(mat_check2),
        mat_texscale=jf(mat_texscale), mat_emissive=jf(mat_emissive),
        mat_light_color=jf(mat_light_color),
        mat_light_intensity=jf(mat_light_int),
        mat_tex=jf(mat_tex), mat_nm=jf(mat_nm),
        tex_data=jf(tex_data), tex_off=jf(tex_off), tex_w=jf(tex_w),
        tex_h=jf(tex_h),
        nm_data=jf(nm_data), nm_off=jf(nm_off), nm_w=jf(nm_w), nm_h=jf(nm_h),
        pair_pack=pair_pack,
        light_pos=jf(light_pos), light_radius=jf(light_radius),
        light_color=jf(light_color),
        sky_data=jf(sky_data), sky_w=jf(np.int32(sw)), sky_h=jf(np.int32(sh)),
        dark_sky=jf(np.float32(1.0 if sb.dark_sky else 0.0)),
        mesh_root=tuple(int(x) for x in mesh_root_l),
        mesh_end=tuple(int(x) for x in mesh_end_l),
        leaf_width=leaf_width,
        has_sky_image=sb.skybox is not None,
        pair_mode=pair_mode,
        emissive_tex_image=bool(
            np.any((mat_emissive > 0) & (mat_textype == 2))),
        sphere_uv_needed=bool(
            np.any((sph_valid > 0) & (mat_textype[sph_mat] != 0))),
        n_sph_real=S, n_quad_real=Q,
    )
