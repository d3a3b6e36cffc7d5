"""Texture table evaluation: constant, checker, Perlin marble and image
(counterpart of ``srt_tpu/materials/textures.py``). Every family present in
the scene is evaluated on all lanes and selected by tag, as there; the
Perlin tables are read by plain indexing (the JAX package's ``_lut256``
one-hot products are a TPU workaround for its serial gathers)."""
from __future__ import annotations

import torch

from srt_tpu_torch.scene.ir import SceneFlags, TextureType, TorchScene


def image_value(scene: TorchScene, tex_id, u, v):
    """Nearest-neighbor lookup with y-flip (``texture.h:58-70``,
    ``textures.py:_image_value``): in the packed rgb8 atlas ``atlas_u32``
    where the scene has one (``int(c) / 255`` in float32 gives back the
    build-time ``u8 / 255`` values exactly), else in the float atlas,
    three gathers whose cotangents reach the texels (an optimised atlas,
    :func:`diff.inverse.splice`, drops the packed twin)."""
    meta = scene.tex_img[tex_id]              # (N, 3) offset, nx, ny
    off, nx, ny = meta[:, 0], meta[:, 1], meta[:, 2]
    i = torch.minimum(torch.clamp((u * nx.to(u.dtype)).to(torch.int32),
                                  min=0), nx - 1)
    j = torch.minimum(torch.clamp(((1.0 - v) * ny.to(v.dtype) - 0.001)
                                  .to(torch.int32), min=0), ny - 1)
    if scene.atlas.shape[0] == 0:
        return torch.ones((u.shape[0], 3), dtype=torch.float32,
                          device=u.device)
    if scene.atlas_u32 is None:
        base = torch.clamp(off + 3 * (i + nx * j), 0,
                           scene.atlas.shape[0] - 3).long()
        return torch.stack([scene.atlas[base], scene.atlas[base + 1],
                            scene.atlas[base + 2]], -1)
    base3 = torch.clamp(off // 3 + i + nx * j, 0,
                        scene.atlas_u32.shape[0] - 1)
    bits = scene.atlas_u32[base3.long()]
    return torch.stack([((bits >> 16) & 255).to(torch.float32) / 255.0,
                        ((bits >> 8) & 255).to(torch.float32) / 255.0,
                        (bits & 255).to(torch.float32) / 255.0], -1)


def checker(p):
    """The checker's parity: True where the product of ``sin(10 x)`` over
    the three axes is negative, the odd colour (``texture.h:13-19``)."""
    s = torch.sin(10.0 * p)
    return s[:, 0] * s[:, 1] * s[:, 2] < 0.0


def perlin_noise(scene: TorchScene, p):
    """Gradient noise with hermite smoothing (``perlin.h:7-46``): the
    three permutation tables xor-combined index the unit gradients, the
    corner dots blended trilinearly. ``p`` (N, 3) -> (N,). The lattice
    index is ``floor`` then int32, wrapped by ``& 255`` (two's complement,
    as numpy and XLA wrap negative coordinates)."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int32)
    s = uvw * uvw * (3.0 - 2.0 * uvw)
    perm = scene.perlin_perm
    h = [[perm[a][((ijk[:, a] + d) & 255).long()] for d in (0, 1)]
         for a in range(3)]
    acc = torch.zeros_like(p[:, 0])
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                g = scene.perlin_vec[(h[0][di] ^ h[1][dj] ^ h[2][dk]).long()]
                corner = (g[:, 0] * (uvw[:, 0] - di)
                          + g[:, 1] * (uvw[:, 1] - dj)
                          + g[:, 2] * (uvw[:, 2] - dk))
                wx = s[:, 0] if di else 1.0 - s[:, 0]
                wy = s[:, 1] if dj else 1.0 - s[:, 1]
                wz = s[:, 2] if dk else 1.0 - s[:, 2]
                acc = acc + wx * wy * wz * corner
    return acc


def perlin_turb(scene: TorchScene, p, depth: int = 7):
    """fbm turbulence, ``depth`` octaves (``perlin.h:48-58``)."""
    acc = torch.zeros_like(p[:, 0])
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * perlin_noise(scene, p)
        weight *= 0.5
        p = p * 2.0
    return torch.abs(acc)


def marble(scene: TorchScene, tex_id, p):
    """Marble intensity ``0.5 (1 + sin(scale z + 5 turb(scale p)))``
    (``texture.h:42``), (N,)."""
    scale = scene.tex_scale[tex_id]
    turb = perlin_turb(scene, scale[:, None] * p)
    return 0.5 * (1.0 + torch.sin(scale * p[:, 2] + 5.0 * turb))


def texture_value(scene: TorchScene, tex_id, uv, p, flags: SceneFlags):
    """Colour of texture ``tex_id`` (N,) at hit uv (N, 2) and hit point
    ``p`` (N, 3) -> (N, 3). Families the scene lacks are skipped."""
    ttype = scene.tex_type[tex_id]
    color = scene.tex_color[tex_id]
    out = color
    kinds = flags.tex_kinds
    if int(TextureType.CHECKER) in kinds:
        odd = checker(p)
        chk = torch.where(odd[:, None], scene.tex_color2[tex_id], color)
        out = torch.where((ttype == int(TextureType.CHECKER))[:, None], chk,
                          out)
    if int(TextureType.NOISE) in kinds:
        m = marble(scene, tex_id, p)[:, None].expand(-1, 3)
        out = torch.where((ttype == int(TextureType.NOISE))[:, None], m, out)
    if int(TextureType.IMAGE) in kinds:
        image = image_value(scene, tex_id, uv[:, 0], uv[:, 1])
        out = torch.where((ttype == int(TextureType.IMAGE))[:, None], image,
                          out)
    return out
