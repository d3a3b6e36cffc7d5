"""The port's scene library (counterpart of ``srt_tpu/scene/library.py``).

Holds the scenes the port covers: ``ball_scenes``, the reference's
default (``Raytracing_n.cpp:379-425``, ``sceneid = 2``),
``cornell_boxes``, the asset-free triangle scene, and ``teapot_scene``,
the reference's scene 1 (``Raytracing_n.cpp:306-377``). Every function
returns ``(scene, camera, info)``.
"""
from __future__ import annotations

import time
import warnings

from srt_tpu_torch.io.assets import find_asset, load_image_asset
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.scene.build import SceneBuilder, rotation_x

SCENES = {}


def _register(fn):
    SCENES[fn.__name__] = fn
    return fn


def get_scene(name: str, aspect: float = 1.0, device="cuda", **kw):
    """Build a scene by name (alias ``balls``) on ``device`` (the card
    unless the caller asks for another). Scenes of the JAX library that
    the port does not hold yet raise ``NotImplementedError``."""
    key = {"balls": "ball_scenes"}.get(name, name)
    if key not in SCENES:
        raise NotImplementedError(
            f"scene {name!r} is not in srt_tpu_torch yet (have "
            f"{sorted(SCENES)}; ROADMAP queue A, items A7-A8)")
    return SCENES[key](aspect=aspect, device=device, **kw)


def _mesh_asset(rel: str, info: dict) -> None:
    """A scanned mesh the reference loads: absent here, it is skipped and
    named in ``info``, as the JAX library does; present, it needs the
    mesh loaders, which the port does not hold yet."""
    if find_asset(rel) is None:
        info.setdefault("skipped", []).append(rel)
        return
    raise NotImplementedError(
        f"srt_tpu_torch cannot load mesh assets ({rel}) yet (ROADMAP A8)")


def _env_dome(b: SceneBuilder, lookfrom, image_rel: str, info: dict,
              fallback=(0.6, 0.7, 0.9)) -> None:
    """The reference's IBL dome: ``flip_normals(sphere(lookfrom, 10000,
    diffuse_light(image)))`` (e.g. ``Raytracing_n.cpp:269-270``)."""
    if find_asset(image_rel) is None:
        info.setdefault("skipped", []).append(image_rel)
    tex = b.image(load_image_asset(image_rel, fallback_color=fallback))
    b.sphere(lookfrom, 10000.0, b.diffuse_light(tex), flip=True)


@_register
def ball_scenes(aspect: float = 1.0, device="cuda", **_kw):
    """Reference scene 2, the default (``Raytracing_n.cpp:379-425``):
    11x11 spheres sweeping anisotropic Beckmann roughness."""
    lookfrom = (300.0, 600.0, -100.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((20.0, 20.0, 20.0)))
    on_brown = b.oren_nayar(b.constant((0.426, 0.3, 0.254)), 0.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :396
    b.xz_rect(-100, 655, -100, 655, 0, on_brown)                 # :397
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info)

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
def teapot_scene(aspect: float = 1.0, divs: int = 100, device="cuda",
                 **_kw):
    """Reference scene 1 (``Raytracing_n.cpp:306-377``), line for line as
    ``srt_tpu/scene/library.py:296-349``: a mirror teapot and a gold
    Beckmann teapot (``divs`` sets the tessellation, ``teapot.h:77``; 100
    gives 640k triangles a teapot), a glass sphere holding a blue isotropic
    medium, a Lambertian floor, a rect light and the environment dome. The
    bunny and the dragon are absent assets, skipped and named in
    ``info["skipped"]``. ``info["host_s"]`` holds the host build's seconds
    a step: the tessellation, then ``SceneBuilder.seconds``."""
    from srt_tpu_torch.scene.teapot import create_teapot

    lookfrom = (100.0, 800.0, -400.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((40.0, 40.0, 40.0)))
    lam_brown = b.lambertian(b.constant((0.426, 0.3, 0.254)))
    b.oren_nayar(b.constant((1.0, 1.0, 1.0)), 10.0)     # the bunny's
    beck_gold = b.beckmann(b.constant((0.945, 0.75, 0.336)), 0.01, 0.05)
    b.beckmann(b.constant((0.8, 0.85, 0.88)), 0.1, 0.1)  # the dragon's
    mirror = b.metal((0.9, 0.9, 0.9), 0.0)

    lid = b.xz_rect(3, 153, 217, 343, 800, light, flip=True)     # :336
    b.xz_rect(0, 555, 0, 555, 0, lam_brown)                      # :338
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info)

    t0 = time.perf_counter()
    pot = create_teapot(scale=40.0, divs=divs)                   # :348-354
    tessellation = time.perf_counter() - t0
    b.trimesh(pot, mirror, rotate=rotation_x(90.0), translate=(200, 0, 250))
    b.trimesh(pot, beck_gold, rotate=rotation_x(90.0), translate=(360, 0, 150))
    _mesh_asset("models/bunny.ply", info)                        # :356-357

    b.sphere((280, 30, 70), 30.0, b.dielectric(1.5))              # :360
    b.medium_sphere((280, 30, 70), 30.0, 0.2,
                    b.constant((0.2, 0.4, 0.9)))                  # :362
    _mesh_asset("models/dragon.ply", info)                       # :364-366
    if "models/dragon.ply" in info["skipped"]:
        warnings.warn("dragon.ply is absent; teapot_scene renders without "
                      "it")
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0,
                         device=device)
    info["lights"] = 1
    scene = b.build(device)
    info["host_s"] = dict(tessellation=tessellation, **b.seconds)
    return scene, cam, info
