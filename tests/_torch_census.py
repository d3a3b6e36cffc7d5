"""What one bounce of a wavefront shades, counted by family: a diagnostic
of the port's tests and of ``chip_smoke.py``, which check that a state
really reaches the branches a kernel is held against there, and count the
operations of a kernel's bound from it."""
from __future__ import annotations


def bounce_census(scene, o, d, time, salt, depth, alive, tri=None) -> dict:
    """What one bounce of these rays shades, from the plain hit after the
    media sweep: the lanes by family, and the lanes whose light sample
    picked a sphere light (the bounce's own uniform of dimension 13).
    ``salt`` and ``depth`` are the lanes' words before the bounce combines
    them; ``tri`` the triangles' closest hit on a triangle scene."""
    import torch

    from srt_tpu_torch.core import rng
    from srt_tpu_torch.materials.materials import is_specular
    from srt_tpu_torch.render.integrator import DIM_LIGHT_PICK, apply_media
    from srt_tpu_torch.render.intersect import intersect_scene
    from srt_tpu_torch.scene.ir import LightKind, MaterialType, TextureType

    word = rng.hash_combine(rng.as_word(salt), rng.as_word(depth))
    hit = intersect_scene(scene, o, d, time=time, tri=tri)
    if scene.n_media:
        hit = apply_media(scene, o, d, word, hit)
    on = alive & hit.hit
    mt = scene.mat_type[hit.mat]
    tt = scene.tex_type[scene.mat_tex[hit.mat]]
    light = mt == int(MaterialType.DIFFUSE_LIGHT)
    spec = on & is_specular(scene, hit.mat)
    diffuse = on & ~spec & ~light
    n_lights = scene.n_lights
    sph_pick = torch.zeros_like(on)
    if n_lights:
        pick = torch.clamp((rng.uniform(word, DIM_LIGHT_PICK)
                            * n_lights).long(), max=n_lights - 1)
        sph_pick = diffuse & (scene.light_kind.long()[pick]
                              == int(LightKind.SPHERE))
    medium = on & torch.isin(hit.mat, scene.med_mat.long())
    return {k: int(v.sum()) for k, v in dict(
        live=alive, specular=spec, diffuse=diffuse, emitter=on & light,
        medium=medium, checker=on & (tt == int(TextureType.CHECKER)),
        marble=on & (tt == int(TextureType.NOISE)),
        image=on & (tt == int(TextureType.IMAGE)),
        sphere_light_sample=sph_pick).items()}
