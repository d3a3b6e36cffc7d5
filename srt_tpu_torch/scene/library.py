"""The port's scene library (counterpart of ``srt_tpu/scene/library.py``).

Holds every scene of the JAX library, each drawing the same numpy
sequences as its JAX counterpart: ``ball_scenes``, the reference's default
(``Raytracing_n.cpp:379-425``, ``sceneid = 2``), ``ball_orennayar_scenes``,
``cornell_box`` (with its bunny), ``cornell_boxes``, the asset-free
triangle scene, ``teapot_scene``, the reference's scene 1
(``Raytracing_n.cpp:306-377``, with its bunny and dragon), the scanned
meshes' ``jadebunny_scene``, ``soldier_scene`` and ``flatnormal_bunny``,
``random_scene`` (the RTiOW cover), ``final`` and ``final1`` (*The Next
Week*), and the reference's fixtures ``two_spheres``,
``two_perlin_spheres``, ``earth_sphere`` and ``simple_light``. Mesh and
image assets are found under ``$SRT_ASSETS`` (:mod:`io.assets`); an absent
one is skipped, or an image replaced by its stand-in, and named in
``info["skipped"]``, as in the JAX library. Every function returns
``(scene, camera, info)``.
"""
from __future__ import annotations

import time
import warnings

import numpy as np

from srt_tpu_torch.io.assets import find_asset, load_image_asset
from srt_tpu_torch.io.mesh import load_mesh
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.scene.build import SceneBuilder, rotation_x, rotation_y

SCENES = {}


def _register(fn):
    SCENES[fn.__name__] = fn
    return fn


#: the JAX library's aliases (``srt_tpu/scene/library.py:57-60``)
ALIASES = {"cornell": "cornell_box", "teapot": "teapot_scene",
           "balls": "ball_scenes", "orennayar": "ball_orennayar_scenes",
           "jade": "jadebunny_scene", "soldier": "soldier_scene",
           "flatnormal": "flatnormal_bunny", "boxes": "cornell_boxes"}


def list_scenes() -> list[str]:
    """All registered scene names (library order)."""
    return list(SCENES)


def get_scene(name: str, aspect: float = 1.0, device="cuda", **kw):
    """Build a scene by name or alias (:data:`ALIASES`) on ``device`` (the
    card unless the caller asks for another); an unknown name raises
    ``KeyError``, as in the JAX library. ``max_tex`` downsamples image
    textures; ``first_mesh_only``, which the golden tool passes under
    parity, keeps the first mesh of the soldier's FBX file, as the
    reference's loader does (``model.h:90,101``); other scenes ignore
    it."""
    key = ALIASES.get(name, name)
    if key not in SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    return SCENES[key](aspect=aspect, device=device, **kw)


def _mesh_asset(rel: str, info: dict, first_mesh_only: bool = False):
    """A scanned mesh the reference loads, as a
    :class:`~srt_tpu_torch.io.mesh.TriMesh`; absent, None, and it is
    skipped and named in ``info["skipped"]``, as the JAX library does.
    ``info["mesh_s"]`` adds up the seconds spent reading mesh files."""
    path = find_asset(rel)
    if path is None:
        info.setdefault("skipped", []).append(rel)
        return None
    t0 = time.perf_counter()
    mesh = load_mesh(path, first_mesh_only=first_mesh_only)
    info["mesh_s"] = info.get("mesh_s", 0.0) + time.perf_counter() - t0
    return mesh


def _maybe_downsample(img: np.ndarray, max_tex: int | None) -> np.ndarray:
    """Stride-downsample an image texture to at most ``max_tex`` pixels a
    side (``srt_tpu/scene/library.py:67-73``)."""
    if max_tex is None:
        return img
    step = max(1, int(np.ceil(max(img.shape[:2]) / max_tex)))
    return img[::step, ::step]


def _image(b: SceneBuilder, rel: str, info: dict, fallback,
           max_tex: int | None = None) -> int:
    """An image texture from asset ``rel``, its stand-in when absent (named
    in ``info["skipped"]``)."""
    if find_asset(rel) is None:
        info.setdefault("skipped", []).append(rel)
    return b.image(_maybe_downsample(
        load_image_asset(rel, fallback_color=fallback), max_tex))


def _env_dome(b: SceneBuilder, lookfrom, image_rel: str, info: dict,
              max_tex: int | None = None, fallback=(0.6, 0.7, 0.9)) -> None:
    """The reference's IBL dome: ``flip_normals(sphere(lookfrom, 10000,
    diffuse_light(image)))`` (e.g. ``Raytracing_n.cpp:269-270``)."""
    b.sphere(lookfrom, 10000.0, b.diffuse_light(
        _image(b, image_rel, info, fallback, max_tex)), flip=True)


@_register
def ball_scenes(aspect: float = 1.0, max_tex: int | None = None,
                device="cuda", **_kw):
    """Reference scene 2, the default (``Raytracing_n.cpp:379-425``):
    11x11 spheres sweeping anisotropic Beckmann roughness."""
    lookfrom = (300.0, 600.0, -100.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((20.0, 20.0, 20.0)))
    on_brown = b.oren_nayar(b.constant((0.426, 0.3, 0.254)), 0.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :396
    b.xz_rect(-100, 655, -100, 655, 0, on_brown)                 # :397
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    white = b.constant((1.0, 1.0, 1.0))
    for j in range(121):                                          # :404-411
        mat = b.beckmann(white, (j % 11) / 11.0, (j // 11) / 11.0)
        b.sphere((550.0 - (j % 11) * 50.0, 20.0, 450.0 - 50.0 * (j // 11)),
                 20.0, mat)
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 20, 250), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 1
    return b.build(device), cam, info


@_register
def cornell_boxes(aspect: float = 1.0, device="cuda", **_kw):
    """The classic Cornell box (green and red walls, two white boxes as 24
    BVH triangles, a rect light; ``srt_tpu/scene/library.py:234-260``).
    Asset-free: the *Rest of Your Life* Cornell the reference's
    ``cornell_box`` evolved from (``Raytracing_n.cpp:258-265``)."""
    b = SceneBuilder()
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    green = b.lambertian(b.constant((0.12, 0.45, 0.15)))
    light = b.diffuse_light(b.constant((15.0, 15.0, 15.0)))

    b.yz_rect(0, 555, 0, 555, 555, green, flip=True)
    b.yz_rect(0, 555, 0, 555, 0, red)
    lid = b.xz_rect(213, 343, 227, 332, 554, light, flip=True)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xz_rect(0, 555, 0, 555, 555, white, flip=True)
    b.xy_rect(0, 555, 0, 555, 555, white, flip=True)
    b.box((130, 0, 65), (295, 165, 230), white, as_tris=True)
    b.box((265, 0, 295), (430, 330, 460), white, as_tris=True)
    b.light_rect(lid)

    cam = Camera.look_at((278, 278, -800), (278, 278, 0), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    return b.build(device), cam, {"lights": 1}


@_register
def teapot_scene(aspect: float = 1.0, divs: int = 100,
                 max_tex: int | None = None, device="cuda", **_kw):
    """Reference scene 1 (``Raytracing_n.cpp:306-377``), line for line as
    ``srt_tpu/scene/library.py:296-349``: a mirror teapot and a gold
    Beckmann teapot (``divs`` sets the tessellation, ``teapot.h:77``; 100
    gives 640k triangles a teapot), a glass sphere holding a blue isotropic
    medium, a Lambertian floor, a rect light, the environment dome, and the
    bunny and the dragon where their assets are present (else skipped and
    named in ``info["skipped"]``). ``info["host_s"]`` holds the host
    build's seconds a step: the tessellation, then
    ``SceneBuilder.seconds``; ``info["mesh_s"]`` the mesh files'
    reading."""
    from srt_tpu_torch.scene.teapot import create_teapot

    lookfrom = (100.0, 800.0, -400.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((40.0, 40.0, 40.0)))
    lam_brown = b.lambertian(b.constant((0.426, 0.3, 0.254)))
    on_white = b.oren_nayar(b.constant((1.0, 1.0, 1.0)), 10.0)
    beck_gold = b.beckmann(b.constant((0.945, 0.75, 0.336)), 0.01, 0.05)
    beck_silver = b.beckmann(b.constant((0.8, 0.85, 0.88)), 0.1, 0.1)
    mirror = b.metal((0.9, 0.9, 0.9), 0.0)

    lid = b.xz_rect(3, 153, 217, 343, 800, light, flip=True)     # :336
    b.xz_rect(0, 555, 0, 555, 0, lam_brown)                      # :338
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    t0 = time.perf_counter()
    pot = create_teapot(scale=40.0, divs=divs)                   # :348-354
    tessellation = time.perf_counter() - t0
    b.trimesh(pot, mirror, rotate=rotation_x(90.0), translate=(200, 0, 250))
    b.trimesh(pot, beck_gold, rotate=rotation_x(90.0), translate=(360, 0, 150))
    bunny = _mesh_asset("models/bunny.ply", info)
    if bunny is not None:
        b.trimesh(bunny, on_white, scale=2000.0, rotate=rotation_y(180.0),
                  translate=(180, -70, 450), flip_winding=True)  # :356-357

    b.sphere((280, 30, 70), 30.0, b.dielectric(1.5))              # :360
    b.medium_sphere((280, 30, 70), 30.0, 0.2,
                    b.constant((0.2, 0.4, 0.9)))                  # :362
    dragon = _mesh_asset("models/dragon.ply", info)               # :364-366
    if dragon is None:
        warnings.warn("dragon.ply is absent; teapot_scene renders without "
                      "it")
    else:
        b.trimesh(dragon, beck_silver, scale=500.0, rotate=rotation_y(180.0),
                  translate=(140, -20, 120), flip_winding=True)
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 1
    scene = b.build(device)
    info["host_s"] = dict(tessellation=tessellation, **b.seconds)
    return scene, cam, info


@_register
def ball_orennayar_scenes(aspect: float = 1.0, max_tex: int | None = None,
                          device="cuda", **_kw):
    """Reference scene 3 (``Raytracing_n.cpp:427-473``): an Oren–Nayar
    sigma sweep of 0 to 20 degrees over 21 spheres."""
    lookfrom = (300.0, 800.0, -100.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((20.0, 20.0, 20.0)))
    on_brown = b.oren_nayar(b.constant((0.426, 0.3, 0.254)), 0.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :444
    b.xz_rect(-100, 655, -100, 655, 0, on_brown)                 # :445
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    white = b.constant((1.0, 1.0, 1.0))
    for j in range(21):                                           # :452-459
        mat = b.oren_nayar(white, float(j))
        b.sphere((550.0 - (j % 7) * 70.0, 30.0, 450.0 - 70.0 * (j // 7)),
                 30.0, mat)
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 20, 450), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 1
    return b.build(device), cam, info


@_register
def cornell_box(aspect: float = 1.0, max_tex: int | None = None,
                bunny_scale: float = 2000.0, device="cuda", **_kw):
    """Reference scene 0 (``Raytracing_n.cpp:216-304``): an Oren–Nayar
    floor, a rect light, the sky_2 dome and the bunny (``models/
    bunny.ply``; absent, it is skipped and named in ``info["skipped"]``
    as the JAX library skips it, and the scene is rects and the dome)."""
    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((45.0, 45.0, 45.0)))
    on_white_0 = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 0.0)
    on_white_10 = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 10.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :261
    b.xz_rect(0, 555, 0, 555, 0, on_white_0)                     # :264
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)
    bunny = _mesh_asset("models/bunny.ply", info)
    if bunny is not None:
        b.trimesh(bunny, on_white_10, scale=bunny_scale,
                  rotate=rotation_y(180.0), translate=(250, -70, 400),
                  flip_winding=True)                              # :273-274
    b.light_rect(lid)                                             # :285,303

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 1
    return b.build(device), cam, info


@_register
def random_scene(aspect: float = 1.0, n_grid: int = 11, seed: int = 7,
                 max_tex: int | None = None, device="cuda", **_kw):
    """The reference's ``random_scene`` (``Raytracing_n.cpp:108-176``), the
    RTiOW cover, as ``srt_tpu/scene/library.py:88-159`` builds it: a
    checker ground, a 22x22 grid of drifting Lambertian, metal and
    dielectric spheres drawn from ``default_rng(seed)``, three hero
    spheres, inside a six-face cube environment of inward image-textured
    rect lights (sky_1, stand-ins when absent), all six NEE lights."""
    b = SceneBuilder()
    info: dict = {}
    rng = np.random.default_rng(seed)

    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))

    gray = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    glass = b.dielectric(1.5)
    for a in range(-n_grid, n_grid):
        for c in range(-n_grid, n_grid):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2,
                               c + 0.9 * rng.uniform()], np.float32)
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:  # a drifting grey Lambertian (moving_sphere)
                b.sphere(center, 0.2, gray,
                         center1=center + np.array([0, 0.5 * rng.uniform(),
                                                    0], np.float32))
            elif choose < 0.95:
                metal = b.metal((0.5 * (1 + rng.uniform()),
                                 0.5 * (1 + rng.uniform()),
                                 0.5 * (1 + rng.uniform())),
                                0.5 * rng.uniform())
                b.sphere(center, 0.2, metal)
            else:
                b.sphere(center, 0.2, glass)

    b.sphere((0, 1, 0), 1.0, glass)
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.constant((0.4, 0.2, 0.1))))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))

    # the cube environment, every face emitting inward (the reference's
    # Left and Right faces face outward, :156-161, a bug the JAX library
    # does not keep)
    def face(rel, add):
        path = f"environment_map/sky_1/{rel}.jpg"
        if find_asset(path) is None:
            info.setdefault("skipped", []).append(f"sky_1/{rel}")
        tex = b.image(_maybe_downsample(
            load_image_asset(path, fallback_color=(0.6, 0.7, 0.9)), max_tex))
        b.light_rect(add(b.diffuse_light(tex)))

    e = 100.0
    face("Front", lambda m: b.xy_rect(-e, e, -e, e, -e, m))
    face("Back", lambda m: b.xy_rect(-e, e, -e, e, e, m, flip=True))
    face("Left", lambda m: b.yz_rect(-e, e, -e, e, e, m, flip=True))
    face("Right", lambda m: b.yz_rect(-e, e, -e, e, -e, m))
    face("Top", lambda m: b.xz_rect(-e, e, -e, e, e, m, flip=True))
    face("Bottom", lambda m: b.xz_rect(-e, e, -e, e, -e, m))

    cam = Camera.look_at((-10.0, 6.0, -15.0), (0.0, 0.0, 0.0), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 6
    return b.build(device), cam, info


def _rtiow_cam(aspect: float, device) -> Camera:
    """The RTiOW camera the reference's fixtures were written for."""
    return Camera.look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=aspect, aperture=0.0, focus_dist=10.0,
                          device=device)


@_register
def two_spheres(aspect: float = 1.0, ambient: float = 1.0, device="cuda",
                **_kw):
    """The reference's fixture ``two_spheres`` (``Raytracing_n.cpp:178-187``):
    two giant checker spheres, lit as the JAX library lights them by a dim
    white env dome registered as a sphere light (``ambient=0`` drops it);
    every lane sits inside that light."""
    b = SceneBuilder()
    checker = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0, -10, 0), 10.0, checker)
    b.sphere((0, 10, 0), 10.0, checker)
    if ambient > 0:
        dome = b.sphere((0, 0, 0), 1000.0,
                        b.diffuse_light(b.constant((ambient,) * 3)), env=True)
        b.light_sphere(dome)
    return (b.build(device), _rtiow_cam(aspect, device),
            {"lights": 1 if ambient > 0 else 0})


@_register
def two_perlin_spheres(aspect: float = 1.0, ambient: float = 1.0,
                       device="cuda", **_kw):
    """The reference's fixture (``Raytracing_n.cpp:188-195``): a marble
    ground and sphere (noise scale 1), camera and dome as
    :func:`two_spheres`."""
    b = SceneBuilder()
    per = b.lambertian(b.noise(1.0))
    b.sphere((0, -1000, 0), 1000.0, per)
    b.sphere((0, 2, 0), 2.0, per)
    if ambient > 0:
        dome = b.sphere((0, 0, 0), 5000.0,
                        b.diffuse_light(b.constant((ambient,) * 3)), env=True)
        b.light_sphere(dome)
    return (b.build(device), _rtiow_cam(aspect, device),
            {"lights": 1 if ambient > 0 else 0})


@_register
def earth_sphere(aspect: float = 1.0, max_tex: int | None = None,
                 device="cuda", **_kw):
    """The reference's fixture ``earth_shpere`` (``Raytracing_n.cpp:196-205``):
    an emissive earth-map sphere, the scene's light, over a white
    ground."""
    b = SceneBuilder()
    info: dict = {"lights": 1}
    earth = _image(b, "textures/earthmap.jpg", info, (0.2, 0.4, 0.8),
                   max_tex)
    b.sphere((0, -1000, 0), 1000.0,
             b.lambertian(b.constant((0.9, 0.9, 0.9))))
    b.light_sphere(b.sphere((0, 2, 0), 2.0, b.diffuse_light(earth)))
    return b.build(device), _rtiow_cam(aspect, device), info


@_register
def simple_light(aspect: float = 1.0, device="cuda", **_kw):
    """The reference's fixture (``Raytracing_n.cpp:206-215``): a marble
    ground and sphere (noise scale 4) lit by a small xy rect."""
    b = SceneBuilder()
    per = b.lambertian(b.noise(4.0))
    b.sphere((0, -1000, 0), 1000.0, per)
    b.sphere((0, 2, 0), 2.0, per)
    lid = b.xy_rect(3, 5, 1, 3, -2, b.diffuse_light(b.constant((4, 4, 4))))
    b.light_rect(lid)
    cam = Camera.look_at((26.0, 4.0, 6.0), (0.0, 2.0, 0.0), vfov=20.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    return b.build(device), cam, {"lights": 1}


def _sphere_cube(b: SceneBuilder, rng, n_cluster: int, mat: int) -> None:
    """*The Next Week*'s cube of ``n_cluster`` 10-radius spheres at seeded
    places, rotated 15 degrees about y (``Raytracing_n.cpp:514-518``)."""
    centers = rng.random((n_cluster, 3)).astype(np.float32) * 165.0
    centers = centers @ rotation_y(15.0).T + np.array([-100, 270, 395],
                                                      np.float32)
    for c in centers:
        b.sphere(c, 10.0, mat)


def _tnw_cam(aspect: float, device) -> Camera:
    return Camera.look_at((478, 278, -600), (278, 278, 0), vfov=40.0,
                          aspect=aspect, aperture=0.0, focus_dist=10.0,
                          device=device)


@_register
def final(aspect: float = 1.0, seed: int = 1, n_cluster: int = 1000,
          max_tex: int | None = None, device="cuda", **_kw):
    """Reference scene 5 (``Raytracing_n.cpp:475-533``), *The Next Week*'s
    final scene: 400 ground boxes of seeded heights as 4,800 BVH
    triangles, a rect light, a moving sphere, glass and metal spheres, a
    glass sphere filled with a blue medium, a thin medium over the whole
    scene, an earth-textured sphere (a stand-in when absent), a marble
    sphere and the 1,000-sphere cube."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    info: dict = {}

    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    ground = b.lambertian(b.constant((0.48, 0.83, 0.53)))
    for i in range(20):                                           # :483-494
        for j in range(20):
            x0, z0 = -1000.0 + i * 100.0, -1000.0 + j * 100.0
            y1 = 100.0 * (rng.random() + 0.01)
            b.box((x0, 0.0, z0), (x0 + 100.0, y1, z0 + 100.0), ground,
                  as_tris=True)

    light = b.diffuse_light(b.constant((7.0, 7.0, 7.0)))
    lid = b.xz_rect(123, 423, 147, 412, 554, light, flip=True)    # :498

    b.sphere((400, 400, 200), 50.0,
             b.lambertian(b.constant((0.7, 0.3, 0.1))),
             center1=(430, 400, 200), t0=0.0, t1=1.0)             # :500
    b.sphere((260, 150, 45), 50.0, b.dielectric(1.5))             # :501
    b.sphere((0, 150, 145), 50.0, b.metal((0.8, 0.8, 0.9), 1.0))  # :502
    b.sphere((360, 150, 145), 70.0, b.dielectric(1.5))            # :503
    b.medium_sphere((360, 150, 145), 70.0, 0.2,
                    b.constant((0.2, 0.4, 0.9)))                  # :505
    b.medium_sphere((0, 0, 0), 5000.0, 0.0001,
                    b.constant((1.0, 1.0, 1.0)))                  # :506-507

    earth = _image(b, "textures/earthmap.jpg", info, (0.2, 0.4, 0.8),
                   max_tex)
    b.sphere((400, 200, 400), 100.0, b.lambertian(earth))         # :511
    b.sphere((220, 280, 300), 80.0, b.lambertian(b.noise(0.1)))   # :512-513
    _sphere_cube(b, rng, n_cluster, white)                        # :514-518
    b.light_rect(lid)
    info["lights"] = 1
    return b.build(device), _tnw_cam(aspect, device), info


@_register
def final1(aspect: float = 1.0, seed: int = 1, n_cluster: int = 1000,
           device="cuda", **_kw):
    """The reference's fixture ``final1`` (``Raytracing_n.cpp:693-711``):
    *The Next Week*'s area light and its 1,000-sphere cube, with
    :func:`final`'s camera and its light flipped to face down, as the JAX
    library builds it."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    light = b.diffuse_light(b.constant((7.0, 7.0, 7.0)))
    lid = b.xz_rect(123, 423, 147, 412, 554, light, flip=True)    # :702
    _sphere_cube(b, rng, n_cluster, white)                        # :704-709
    b.light_rect(lid)
    return b.build(device), _tnw_cam(aspect, device), {"lights": 1}


@_register
def jadebunny_scene(aspect: float = 1.0, max_tex: int | None = None,
                    device="cuda", **_kw):
    """Reference scene 4 (``Raytracing_n.cpp:535-583``), as
    ``srt_tpu/scene/library.py:500-533`` builds it: a glass bunny shell
    over a slightly smaller Oren–Nayar blue bunny."""
    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((45.0, 45.0, 45.0)))
    glass = b.dielectric(1.2)
    on_white_0 = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 0.0)
    on_blue = b.oren_nayar(b.constant((0.2, 0.4, 0.9)), 0.0)

    lid = b.xz_rect(203, 353, 17, 543, 800, light, flip=True)     # :555
    b.xz_rect(0, 555, 0, 555, 0, on_white_0)                      # :556
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    bunny = _mesh_asset("models/bunny.ply", info)
    if bunny is not None:
        b.trimesh(bunny, glass, scale=2000.0, rotate=rotation_y(180.0),
                  translate=(250, -70, 400))                      # :563-565
        b.trimesh(bunny, on_blue, scale=1990.0, rotate=rotation_y(180.0),
                  translate=(250, -70, 400), flip_winding=True)   # :568-570
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 1
    return b.build(device), cam, info


@_register
def soldier_scene(aspect: float = 1.0, max_tex: int | None = None,
                  first_mesh_only: bool = False,
                  floor_variant: str = "ref", no_soldier: bool = False,
                  device="cuda", **_kw):
    """Reference scene 6 (``Raytracing_n.cpp:585-657``), as
    ``srt_tpu/scene/library.py:536-597`` builds it: the FBX soldier over a
    glass-coated wood floor, the sky4 dome, thin-lens bokeh (aperture 10).
    ``first_mesh_only`` keeps the FBX file's first mesh (the reference's
    truncation, which its golden renders show). ``floor_variant`` and
    ``no_soldier`` are the JAX library's golden-debugging knobs: "ref" is
    the wood box and the glass coat box as the reference builds them,
    "nocoat" drops the glass box, "lambert" makes the wood Lambertian,
    "rect" a single xz rect floor."""
    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light1 = b.diffuse_light(b.constant((35.0, 35.0, 35.0)))
    lid = b.xz_rect(203, 353, 17, 167, 800, light1, flip=True)    # :623

    wood_rel = "textures/TexturesCom_Wood_Wenge_1K_albedo.png"
    if find_asset(wood_rel) is None:
        info.setdefault("skipped", []).append("wood albedo")
    wood = b.image(_maybe_downsample(load_image_asset(
        wood_rel, (0.3, 0.2, 0.1)), max_tex))
    if floor_variant == "lambert":
        floor_mat = b.lambertian(wood)
    else:
        floor_mat = b.oren_nayar(wood, 0.5)                       # :619
    if floor_variant == "rect":
        b.xz_rect(0, 600, 0, 600, 0.1, floor_mat)
    else:
        b.box((0, -0.1, 0), (600, 0.1, 600), floor_mat)           # :626
    if floor_variant not in ("nocoat", "rect"):
        b.box((0, -1, 0), (600, 1, 600), b.dielectric(1.4))       # :628

    _env_dome(b, lookfrom, "environment_map/sky4.jpg", info, max_tex)

    soldier = None
    if not no_soldier:
        soldier = _mesh_asset("models/Soilder.FBX", info, first_mesh_only)
    if soldier is not None:
        if find_asset("textures/NPC_YuanChengBing_A.png") is None:
            info.setdefault("skipped", []).append("soldier texture")
        skin = b.image(_maybe_downsample(load_image_asset(
            "textures/NPC_YuanChengBing_A.png", (0.5, 0.4, 0.3)), max_tex))
        beck_tex = b.beckmann(skin, 0.9, 0.85)                    # :604,638
        b.trimesh(soldier, beck_tex, scale=8.0, rotate=rotation_y(180.0),
                  translate=(250, 0, 300), flip_winding=True)     # :640-642
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=10.0,
                         focus_dist=1000.0, device=device)        # :589-592
    info["lights"] = 1
    return b.build(device), cam, info


@_register
def flatnormal_bunny(aspect: float = 1.0, max_tex: int | None = None,
                     device="cuda", **_kw):
    """Reference scene 7 (``Raytracing_n.cpp:659-691``), as
    ``srt_tpu/scene/library.py:600-633`` builds it: a gold Beckmann bunny
    with flat normals (its PLY stores none). The reference builds the
    bunny but never appends it (``:683-686``); the JAX library adds it and
    registers the light rect, and so does this one."""
    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((45.0, 45.0, 45.0)))
    on_white = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 0.1)
    beck_gold = b.beckmann(b.constant((0.945, 0.75, 0.336)), 0.85, 0.85)

    lid = b.xz_rect(203, 353, 17, 167, 800, light, flip=True)     # :675
    b.xz_rect(0, 600, 0, 600, 0, on_white)                        # :676
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    bunny = _mesh_asset("models/bunny.ply", info)
    if bunny is not None:
        b.trimesh(bunny, beck_gold, scale=2000.0, rotate=rotation_y(180.0),
                  translate=(250, -70, 400))
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 1
    return b.build(device), cam, info
