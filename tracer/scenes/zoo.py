"""The scene zoo — all 11 reference scenes, built with the SceneBuilder API.

Each `setup_*` mirrors the corresponding builder in
`/root/reference/src/Scene.h:358-1882` (registered at `main.cpp:421-432`):
object placement, transforms, materials, lights, textures and skyboxes are
value-for-value identical. Assets (PPM textures, OFF meshes) load from an
asset root (env `TRACER_ASSETS`, then the repository's `assets/`, then the
reference checkout if present). The Cornell box's five image maps are
generated into `assets/` on first use (tracer/scenes/maps.py). Other
missing assets degrade exactly like the reference — skyboxes fall
back to the procedural sky (`imageLoader.cpp:24-28` + `Scene.h:150-153`),
missing textures render the magenta checker (`Material.cpp:74-81`) — except
missing meshes, which are skipped instead of `exit(EXIT_FAILURE)`
(`Mesh.cpp:12-13`).
"""

from __future__ import annotations

import os

import numpy as np

from tracer.scene.builder import (
    SceneBuilder, Material, MeshObject, DIFFUSE, GLASS, MIRROR,
    TEX_NONE, TEX_CHECKERBOARD, TEX_IMAGE,
)
from tracer.scenes import maps

_REPO_ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets")
_DEFAULT_ROOTS = [
    os.environ.get("TRACER_ASSETS", ""),
    _REPO_ASSETS,
    "/root/reference",
]


def asset(path: str) -> str:
    if path in maps.MAPS:
        # procedural stand-in, written under assets/ on first use
        maps.ensure(path, _REPO_ASSETS)
    for root in _DEFAULT_ROOTS:
        if root:
            p = os.path.join(root, path)
            if os.path.exists(p):
                return p
    return path  # missing -> loaders return None / caller skips


def _mesh(sb: SceneBuilder, path: str, material=None):
    p = asset(path)
    if not os.path.exists(p):
        return None
    m = MeshObject.from_off(p, material)
    sb.add_mesh(m)
    return m


def _std_light(sb, pos, radius=1.5, power=2.0):
    return sb.add_light(pos, radius=radius, color=(1, 1, 1),
                        power_correction=power)


# --------------------------------------------------------------------------
# scenes[0] — setup_single_sphere (Scene.h:358-382)
# --------------------------------------------------------------------------

def setup_single_sphere() -> SceneBuilder:
    sb = SceneBuilder()
    sb.load_skybox(asset("img/textures/space.ppm"))
    _std_light(sb, (-5, 5, 5), radius=2.5)
    sb.add_sphere((0., 0., 0.), 1.0, Material(
        mtype=MIRROR, diffuse=(1., 1., 1.), specular=(0.2, 0.2, 0.2),
        shininess=20))
    return sb


# --------------------------------------------------------------------------
# scenes[1] — setup_single_square (Scene.h:384-419)
# --------------------------------------------------------------------------

def setup_single_square() -> SceneBuilder:
    sb = SceneBuilder()
    sb.dark_sky = False
    _std_light(sb, (-5, 5, 5), radius=2.5)
    sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 6., 2.,
                  Material(diffuse=(1., 0., 0.), specular=(0.8, 0.8, 0.8),
                           shininess=20))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0., 1., 0.), specular=(0., 1., 0.),
                               shininess=16))
    s.translate((0., 0., -2.)).scale((2., 2., 1.)).rotate_y(-90)
    return sb


# --------------------------------------------------------------------------
# scenes[2] — setup_cornell_box (Scene.h:421-619)
# --------------------------------------------------------------------------

def setup_cornell_box(aspect_ratio: float = 850.0 / 480.0) -> SceneBuilder:
    sb = SceneBuilder()
    brick_tex = sb.load_texture(asset("img/planeTextures/brickwall.ppm"))
    brick_nm = sb.load_normal_map(asset("img/normalMaps/brickwall_normal.ppm"))
    floor_nm = sb.load_normal_map(asset("img/normalMaps/n1.ppm"))
    sand_tex = sb.load_texture(asset("img/planeTextures/sand.ppm"))
    sb.load_normal_map(asset("img/normalMaps/water_normal.ppm"))  # loaded, unused

    white = Material(diffuse=(0.9, 0.9, 0.9), specular=(1., 1., 1.),
                     shininess=16)
    emissive = Material(emissive=True, light_color=(1., 1., 1.),
                        light_intensity=60.)
    # ceiling light box (Scene.h:476-491)
    sb.add_box([emissive] + [white] * 4,
               [True, False, True, True, True, True],
               pos=(0., 1.95, 0.), size=1.0)

    def brick(diffuse, specular, sx=1.0, sy=1.0):
        return Material(diffuse=diffuse, specular=specular, shininess=16,
                        texture_type=TEX_IMAGE, texture_id=brick_tex,
                        normal_map_id=brick_nm, texture_scale_x=sx,
                        texture_scale_y=sy)

    # Back wall
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      brick((1., 1., 1.), (1., 1., 1.), sx=1. * aspect_ratio))
    s.scale((2. * aspect_ratio, 2., 1.)).translate((0., 0., -2.))
    # Left wall
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      brick((1., 0., 0.), (1., 0., 0.)))
    s.rotate_x(180).scale((2., 2., 1.)).translate(
        (0., 0., 2. * aspect_ratio)).rotate_y(90)
    # Right wall
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      brick((0., 1., 0.), (0., 1., 0.)))
    s.rotate_x(180).translate((0., 0., 2. * aspect_ratio)).scale(
        (2., 2., 1.)).rotate_y(-90)
    # Floor
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(246 / 255., 204 / 255., 162 / 255.),
                               specular=(1., 1., 1.), shininess=1,
                               texture_type=TEX_IMAGE, texture_id=sand_tex,
                               normal_map_id=floor_nm))
    s.translate((0., 0., -2.)).scale((2. * aspect_ratio, 2., 1.)).rotate_x(-90)
    # Ceiling
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(1., 1., 1.), specular=(1., 1., 1.),
                               shininess=16, texture_type=TEX_CHECKERBOARD,
                               checkerboard_color1=(0.95, 0.95, 0.95),
                               checkerboard_color2=(0.5, 0.5, 0.5),
                               texture_scale_x=8. * aspect_ratio,
                               texture_scale_y=8.))
    s.translate((0., 0., -2.)).scale((2. * aspect_ratio, 2., 1.)).rotate_x(90)
    # Front wall
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      brick((1., 1., 1.), (1., 1., 1.)))
    s.translate((0., 0., -2.)).scale((2. * aspect_ratio, 2., 1.)).rotate_y(180)
    # Glass sphere
    sb.add_sphere((1.0, -1.25, 0.5), 0.75, Material(
        mtype=GLASS, diffuse=(1., 1., 1.), specular=(1., 1., 1.),
        shininess=16, transparency=1.0, index_medium=1.4))
    # Mirrored sphere
    sb.add_sphere((-1.0, -1.25, -0.5), 0.75, Material(
        mtype=MIRROR, diffuse=(0.7, 0.7, 0.7), specular=(1., 1., 1.),
        shininess=16, transparency=0., index_medium=0.))
    return sb


# --------------------------------------------------------------------------
# scenes[3] — setup_mesh (Scene.h:714-827)
# --------------------------------------------------------------------------

def setup_mesh() -> SceneBuilder:
    sb = SceneBuilder()
    sb.load_skybox(asset("img/textures/space.ppm"))
    _std_light(sb, (0.0, 3., 2.0))
    sb.add_sphere((0., 0., -16.), 2.0, Material(
        diffuse=(0.1, 0.6, 0.2), specular=(0.1, 0.6, 0.2), shininess=20))
    sb.add_sphere((4., 0., -8.), 2.0, Material(
        mtype=MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3, shininess=32))
    m = _mesh(sb, "mesh/blob-closed.off", Material(
        mtype=GLASS, index_medium=1.333, transparency=0.9,
        diffuse=(0.1, 0.2, 0.5), specular=(0.9, 0.9, 0.9), shininess=32))
    if m is not None:
        m.translate((0., 0.9, -4.)).scale((1.5, 1.5, 1.5))
        m.rotate_x(180).rotate_y(180)
    for c, r in [(((0.2, -1., -4.8)), 0.3), (((0.2, -1., -4.55)), 0.1),
                 (((-0.7, -1., -4.95)), 0.3), (((-0.7, -1., -4.7)), 0.1)]:
        col = 1.0 if r > 0.2 else 0.0
        sb.add_sphere(c, r, Material(diffuse=(col,) * 3,
                                     specular=(1., 1., 1.), shininess=20))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0.8, 0.8, 0.), specular=(1., 1., 1.),
                               shininess=16))
    s.translate((0., 0., -2.)).scale((50., 50., 1.)).rotate_x(-90)
    return sb


# --------------------------------------------------------------------------
# scenes[4] — setup_rt_in_a_weekend (Scene.h:621-712)
# --------------------------------------------------------------------------

def setup_rt_in_a_weekend() -> SceneBuilder:
    sb = SceneBuilder()
    sb.load_skybox(asset("img/textures/sky.ppm"))
    sun_tex = sb.load_texture(asset("img/sphereTextures/s2.ppm"))
    for pos in [(0.0, 3., -8.0), (-4., 3., -8.0), (4., 3., -8.0)]:
        _std_light(sb, pos)
    sb.add_sphere((-4., 0., -8.), 2.0, Material(
        mtype=GLASS, diffuse=(0.8,) * 3, specular=(0.8,) * 3,
        index_medium=1.5, shininess=20))
    sb.add_sphere((0., 0.5, -8.), 1.5, Material(
        diffuse=(0.1, 0.2, 0.5), specular=(0.2, 0.2, 0.2), shininess=20,
        texture_type=TEX_IMAGE, texture_id=sun_tex, emissive=True,
        light_intensity=15., motion_blur_translation=(0., 1., 0.)))
    sb.add_sphere((4., 0., -8.), 2.0, Material(
        mtype=MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3, shininess=32))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0.1, 0.2, 0.5), specular=(1., 1., 1.),
                               shininess=16, texture_type=TEX_CHECKERBOARD,
                               checkerboard_color1=(1., 1., 1.),
                               checkerboard_color2=(0.1, 0.2, 0.5),
                               texture_scale_x=100., texture_scale_y=100.))
    s.translate((0., 0., -2.)).scale((50., 50., 1.)).rotate_x(-90)
    return sb


# --------------------------------------------------------------------------
# scenes[5] — setup_random_spheres (Scene.h:829-924)
# --------------------------------------------------------------------------

def setup_random_spheres(seed: int = 5) -> SceneBuilder:
    sb = SceneBuilder()
    sb.dark_sky = False
    rng_ = np.random.RandomState(seed)
    _std_light(sb, (-1.0, 8., 2.0))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0.8, 0.8, 0.),
                               specular=(1., 1., 1.)))
    s.translate((0., 0., -4.)).scale((100., 100., 1.)).rotate_x(-90)
    sb.add_sphere((-3., 0., -22.), 4.0, Material(
        mtype=MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3, shininess=32))
    sb.add_sphere((4., -2., -15.), 2.0, Material(
        mtype=MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3, shininess=32))
    sb.add_sphere((-1., -2.5, -8.), 1.5, Material(
        mtype=GLASS, diffuse=(0.8,) * 3, specular=(0.8,) * 3, shininess=20))

    def rf(lo, hi):
        return float(lo + (hi - lo) * rng_.rand())

    for _ in range(79):
        height = rf(0.25, 1.)
        radius = rf(0.25, 1.5)
        mtype = rng_.randint(3)
        center = (rf(-30., 30.), -4 + radius + height, rf(-50., -2.))
        if mtype == 0:
            mat = Material(mtype=MIRROR,
                           diffuse=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           specular=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           shininess=rf(32., 100.))
        elif mtype == 1:
            g = rf(0.7, 1.)
            mat = Material(mtype=GLASS, diffuse=(g,) * 3,
                           specular=(rf(0.7, 1.),) * 3,
                           shininess=rf(32., 70.),
                           transparency=rf(0.7, 1.),
                           index_medium=rf(1., 2.))
        else:
            mat = Material(diffuse=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           specular=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           shininess=rf(0., 30.))
        mat.motion_blur_translation = np.array([0., height, 0.], np.float32)
        sb.add_sphere(center, radius, mat)
    return sb


# --------------------------------------------------------------------------
# scenes[6] — setup_debug_refraction (Scene.h:926-998)
# --------------------------------------------------------------------------

def setup_debug_refraction() -> SceneBuilder:
    sb = SceneBuilder()
    sb.dark_sky = False
    _std_light(sb, (-1.0, 8., 2.0))
    walls = [((-2., 2., -2.), (1., 0., 0.)), ((-2., -2., -2.), (0., 1., 0.)),
             ((2., 2., -2.), (0., 0., 1.)), ((2., -2., -2.), (1., 1., 1.))]
    for pos, col in walls:
        s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                          Material(diffuse=col, specular=(1., 1., 1.),
                                   shininess=16))
        s.scale((2., 2., 1.)).translate(pos)
    sb.add_sphere((0., 0., 0.), 0.75, Material(
        mtype=GLASS, diffuse=(1., 1., 1.), specular=(1., 1., 1.),
        shininess=16, transparency=1.0, index_medium=1.4))
    return sb


# --------------------------------------------------------------------------
# scenes[7] — setup_flamingo (Scene.h:1000-1078)
# --------------------------------------------------------------------------

def setup_flamingo() -> SceneBuilder:
    sb = SceneBuilder()
    sb.dark_sky = False
    _std_light(sb, (-1.0, 8., 2.0))
    _std_light(sb, (1.0, 8., 2.0))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0.8, 0.8, 0.), specular=(1., 1., 1.),
                               shininess=16, texture_type=TEX_CHECKERBOARD,
                               checkerboard_color1=(0.8, 0.8, 0.),
                               checkerboard_color2=(0.6, 0.6, 0.),
                               texture_scale_x=100., texture_scale_y=100.))
    s.translate((0., 0., -2.)).scale((50., 50., 1.)).rotate_x(-90)
    sb.add_sphere((-4., 0., -8.), 2.0, Material(
        mtype=GLASS, diffuse=(0.8,) * 3, specular=(0.8,) * 3,
        index_medium=1.5, shininess=20))
    sb.add_sphere((4., 0., -8.), 2.0, Material(
        mtype=MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3, shininess=32))
    m = _mesh(sb, "mesh/flamingo_lowpoly_colored.off", Material(
        diffuse=(0.1, 0.2, 0.5), specular=(0.9, 0.9, 0.9), shininess=6.))
    if m is not None:
        m.scale((2.5,) * 3).rotate_x(90).rotate_y(90).rotate_z(180)
        m.translate((0., 1., -8.))
    return sb


# --------------------------------------------------------------------------
# scenes[8] — setup_raccoon (Scene.h:1080-1207)
# --------------------------------------------------------------------------

def setup_raccoon() -> SceneBuilder:
    sb = SceneBuilder()
    sb.load_skybox(asset("img/textures/sky.ppm"))
    fire = sb.load_texture(asset("img/sphereTextures/s2.ppm"))
    wind = sb.load_texture(asset("img/sphereTextures/s4.ppm"))
    water = sb.load_texture(asset("img/sphereTextures/s7.ppm"))
    _std_light(sb, (-1.0, 8., 2.0))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0.5, 0., 0.5), specular=(1., 1., 1.),
                               shininess=4, texture_type=TEX_CHECKERBOARD,
                               checkerboard_color1=(0.5, 0., 0.5),
                               checkerboard_color2=(0.6, 0., 0.6),
                               texture_scale_x=16., texture_scale_y=16.))
    s.translate((0., 0., -2.)).scale((2., 4., 1.)).rotate_x(-90)
    s.translate((0., 0., -4.))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0.9, 0.2, 0.), specular=(1., 1., 1.),
                               shininess=4))
    s.translate((0., 0., -2.)).scale((2.5, 5., 1.)).rotate_x(-90)
    s.translate((0., -0.0001, -3.5))
    m = _mesh(sb, "mesh/raccoon_low_poly_colored.off", Material(
        diffuse=(0.1, 0.2, 0.5), specular=(0.9, 0.9, 0.9), shininess=6.))
    if m is not None:
        m.rotate_y(-90).scale((2.,) * 3).translate((0., -2., -5.))
    m = _mesh(sb, "mesh/magic_staff_low_poly_colored.off", Material(
        diffuse=(0.1, 0.2, 0.5), specular=(0.9, 0.9, 0.9), shininess=6.))
    if m is not None:
        m.rotate_y(-90).rotate_z(90).scale((0.15,) * 3)
        m.translate((1., 0.2, -2.7))
    sb.add_sphere((-1.85, 0.35, -2.7), 0.14, Material(
        mtype=GLASS, diffuse=(0.451, 0.6627, 0.7608), specular=(1., 1., 1.),
        index_medium=1.5, shininess=64, transparency=0.65))
    sb.add_sphere((4., 3., -8.), 1.3, Material(
        mtype=MIRROR, diffuse=(0.8, 0., 0.), specular=(0.8,) * 3,
        shininess=32, texture_type=TEX_IMAGE, texture_id=fire))
    sb.add_sphere((-4., 2., -5.), 0.9, Material(
        mtype=GLASS, diffuse=(1., 1., 1.), specular=(0.8,) * 3, shininess=32,
        transparency=0.4, texture_type=TEX_IMAGE, texture_id=wind))
    sb.add_sphere((-0.2, 3., -1.), 1.4, Material(
        mtype=GLASS, diffuse=(0.5, 0.53, 0.8), specular=(0.8,) * 3,
        shininess=32, transparency=0.8, texture_type=TEX_IMAGE,
        texture_id=water))
    return sb


# --------------------------------------------------------------------------
# scenes[9] — setup_flamingo_pond (Scene.h:1209-1262)
# --------------------------------------------------------------------------

def setup_flamingo_pond() -> SceneBuilder:
    sb = SceneBuilder()
    sb.load_skybox(asset("img/textures/sky.ppm"))
    _std_light(sb, (-1.0, 8., -19.0))
    m = _mesh(sb, "mesh/pond.off", Material(
        diffuse=(0.1, 0.2, 0.5), specular=(0.9, 0.9, 0.9), shininess=6.))
    if m is not None:
        m.scale((3.,) * 3).translate((1., -5., -3.))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(mtype=MIRROR, diffuse=(0.5, 0.53, 0.8),
                               specular=(1., 1., 1.), shininess=4))
    s.translate((0., 0., -2.)).scale((5., 3.5, 1.)).rotate_x(-90)
    s.translate((1., 0., 2.8))
    m = _mesh(sb, "mesh/flamingo_lowpoly_colored.off", Material(
        diffuse=(0.1, 0.2, 0.5), specular=(0.9, 0.9, 0.9), shininess=6.))
    if m is not None:
        m.scale((0.8,) * 3).rotate_x(90).rotate_y(115).rotate_z(180)
        m.translate((3., -1.2, -1.))
    return sb


# --------------------------------------------------------------------------
# setup_flamingo_lake (Scene.h:1264-1327 — defined but never registered in
# the reference's scene list; provided for completeness)
# --------------------------------------------------------------------------

def setup_flamingo_lake() -> SceneBuilder:
    sb = SceneBuilder()
    sb.load_skybox(asset("img/textures/sky.ppm"))
    sb.load_texture(asset("img/sphereTextures/s2.ppm"))
    water_nm = sb.load_normal_map(asset("img/normalMaps/water_normal.ppm"))
    _std_light(sb, (1.0, 2., 1.0))
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(diffuse=(0.1, 0.5, 0.1), specular=(1., 1., 1.),
                               shininess=16, texture_type=TEX_CHECKERBOARD,
                               checkerboard_color1=(1., 1., 1.),
                               checkerboard_color2=(0.1, 0.2, 0.5),
                               texture_scale_x=100., texture_scale_y=100.))
    s.translate((0., 0., -2.)).scale((50., 50., 1.)).rotate_x(-90)
    s = sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                      Material(mtype=GLASS, diffuse=(0.1, 0.2, 0.5),
                               specular=(1., 1., 1.), shininess=16,
                               texture_scale_x=10., texture_scale_y=10.,
                               normal_map_id=water_nm))
    s.translate((0., 0., -2.)).scale((50., 50., 1.)).rotate_x(-90)
    s.translate((0., 0.3, 0.))
    m = _mesh(sb, "mesh/flamingo_float.off", Material(
        diffuse=(237 / 255., 149 / 255., 218 / 255.), specular=(1., 1., 1.),
        shininess=6.))
    if m is not None:
        m.center_and_scale_to_unit().rotate_x(270)
        m.translate((0., -1.5, -1.))
    return sb


# --------------------------------------------------------------------------
# scenes[10] — setup_backrooms_pool (Scene.h:1329-1882)
# --------------------------------------------------------------------------

def setup_backrooms_pool() -> SceneBuilder:
    sb = SceneBuilder()
    sb.load_skybox(asset("img/textures/sky.ppm"))
    tiles_tex = sb.load_texture(asset("img/planeTextures/white_pool_tiles.ppm"))
    tiles_nm = sb.load_normal_map(asset("img/normalMaps/pool_tiles_normal.ppm"))
    water_nm = sb.load_normal_map(asset("img/normalMaps/water_normal.ppm"))
    li = 30.0

    def emissive_mat():
        return Material(diffuse=(1., 1., 1.), specular=(1., 1., 1.),
                        shininess=16, emissive=True, light_intensity=li,
                        light_color=(1., 1., 1.))

    def tiles(sx, sy):
        return Material(diffuse=(0.1, 0.5, 0.1), specular=(1., 1., 1.),
                        shininess=16, texture_type=TEX_IMAGE,
                        texture_id=tiles_tex, normal_map_id=tiles_nm,
                        texture_scale_x=sx, texture_scale_y=sy)

    def quad(mat):
        return sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.),
                             2., 2., mat)

    # ceiling lights 1-4 (Scene.h:1336-1399)
    for z in (-12.75, -8.75, -4.75, -0.75):
        s = quad(emissive_mat())
        s.translate((0., 0., -2.)).scale((0.5, 0.5, 1.)).rotate_x(90)
        s.translate((0., 2.95, z))
    # pool water (glass, normal-mapped)
    s = quad(Material(mtype=GLASS, diffuse=(170 / 255., 213 / 255., 219 / 255.),
                      specular=(1., 1., 1.), shininess=16, transparency=0.99,
                      normal_map_id=water_nm))
    s.translate((0., 0., -2.)).scale((4., 8., 1.)).rotate_x(-90)
    s.translate((0., -0.75, 0.))
    # pool floor
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((4., 8., 1.)).rotate_x(-90)
    s.translate((0., -1., 0.))
    # pool ceiling (untextured, diffuse 0.8)
    s = quad(Material(diffuse=(0.8,) * 3, specular=(1., 1., 1.), shininess=16))
    s.translate((0., 0., -2.)).scale((4., 8., 1.)).rotate_x(90)
    s.translate((0., 3., -12.75))
    # right lower wall
    s = quad(tiles(0.25, 2.))
    s.translate((0., 0., -2.)).scale((0.5, 8., 1.)).rotate_x(-90).rotate_z(90)
    s.translate((2., -2.5, 0.))
    # right upper wall
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((2., 8., 1.)).rotate_x(-90).rotate_z(90)
    s.translate((2., 4., 0.))
    # left upper wall
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((2., 8., 1.)).rotate_x(-90).rotate_z(-90)
    s.translate((-2., 4., 0.))
    # left lower wall
    s = quad(tiles(0.25, 2.))
    s.translate((0., 0., -2.)).scale((0.5, 8., 1.)).rotate_x(-90).rotate_z(-90)
    s.translate((-2., -2.5, 0.))
    # right upper floor
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((1., 8., 1.)).rotate_x(-90)
    s.translate((5., 0., 0.))
    # right upper ceil
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((1., 8., 1.)).rotate_x(90)
    s.translate((5., 0., -12.75))
    # left upper floor
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((1., 8., 1.)).rotate_x(-90)
    s.translate((-5., 0., 0.))
    # right upper ceil (duplicate in reference, Scene.h:1581-1598)
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((1., 8., 1.)).rotate_x(90)
    s.translate((5., 0., -12.75))
    # left upper ceil
    s = quad(tiles(1., 2.))
    s.translate((0., 0., -2.)).scale((1., 8., 1.)).rotate_x(90)
    s.translate((-5., 0., -12.75))
    # right middle wall
    s = quad(tiles(2., 1.))
    s.translate((0., 0., -2.)).scale((8., 2., 1.)).rotate_y(-90)
    s.translate((4., -1.6, -6.4))
    # right middle wall lights
    for z in (-0.75, -4.75, -8.75, -12.75):
        s = quad(emissive_mat())
        s.translate((0., 0., -2.)).scale((0.5, 0.5, 1.)).rotate_y(-90)
        s.translate((3.95, 0.9, z))
    # left middle wall
    s = quad(tiles(2., 1.))
    s.translate((0., 0., -2.)).scale((8., 2., 1.)).rotate_y(90)
    s.translate((-4., -1.6, -6.4))
    # left middle wall lights
    for z in (-0.75, -4.75, -8.75, -12.75):
        s = quad(emissive_mat())
        s.translate((0., 0., -2.)).scale((0.5, 0.5, 1.)).rotate_y(90)
        s.translate((-3.95, 0.8, z))
    # pool front
    s = quad(tiles(2., 2.))
    s.translate((0., 0., -2.)).scale((8., 8., 1.)).rotate_x(-180)
    s.translate((0., 4., 0.))
    # pool back
    s = quad(tiles(2., 2.))
    s.translate((0., 0., -2.)).scale((8., 8., 1.))
    s.translate((0., -3., -12.))
    # flamingo float (colored mesh, missing in this checkout -> fall back to
    # the uncolored flamingo_float.off so the scene still has its centerpiece)
    mat = Material(diffuse=(237 / 255., 149 / 255., 218 / 255.),
                   specular=(1., 1., 1.), shininess=6.)
    m = _mesh(sb, "mesh/flamingo_float_colored.off", mat)
    if m is None:
        m = _mesh(sb, "mesh/flamingo_float.off", mat)
    if m is not None:
        m.center_and_scale_to_unit().rotate_x(0).rotate_y(225)
        m.translate((-0.5, -1.35, -2.)).scale((1.8,) * 3)
    # flamingo eye + pupil
    sb.add_sphere((0.05, -1.4, -3.1), 0.05, Material(
        diffuse=(1., 1., 1.), specular=(1., 1., 1.), shininess=16))
    sb.add_sphere((0.05, -1.4, -3.05), 0.01, Material(
        diffuse=(0., 0., 0.), specular=(0., 0., 0.), shininess=16))
    # rubber duck
    m = _mesh(sb, "mesh/rubber_duck_colored.off", Material(
        diffuse=(1., 1., 0.), specular=(1., 1., 1.), shininess=6.))
    if m is not None:
        m.center_and_scale_to_unit().rotate_y(-35)
        m.translate((2., -1.65, -2.)).scale((1.3,) * 3)
    # pool ladder (mirror)
    m = _mesh(sb, "mesh/pool_ladder.off", Material(
        mtype=MIRROR, diffuse=(0.5, 0.5, 0.5), specular=(1., 1., 1.),
        shininess=6.))
    if m is not None:
        m.center_and_scale_to_unit().rotate_y(90)
        m.translate((-3., -1.445, -3.)).scale((1.3,) * 3)
    return sb


# Registration order matches main.cpp:421-432.
SCENES = {
    0: ("single_sphere", setup_single_sphere),
    1: ("single_square", setup_single_square),
    2: ("cornell_box", setup_cornell_box),
    3: ("mesh", setup_mesh),
    4: ("rt_in_a_weekend", setup_rt_in_a_weekend),
    5: ("random_spheres", setup_random_spheres),
    6: ("debug_refraction", setup_debug_refraction),
    7: ("flamingo", setup_flamingo),
    8: ("raccoon", setup_raccoon),
    9: ("flamingo_pond", setup_flamingo_pond),
    10: ("backrooms_pool", setup_backrooms_pool),
}

BY_NAME = {name: fn for _, (name, fn) in SCENES.items()}
BY_NAME["flamingo_lake"] = setup_flamingo_lake
