"""The plain reference's triangle family and media, and the scene builder's
meshes and media: the block sweep against brute force on rays into the
teapot scene, shared edges and corners among their targets; the builder's
rows against the port's ``SceneBuilder`` with the BVH order undone; the
scenes the reference still refuses. (The test imports both; the reference
imports nothing of the port.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import triangles
from benchmark.reference.scene import Scene
from benchmark.scenes import builder
from benchmark.tests._library import library_arrays
from srt_tpu_torch.accel.bvh import build_bvh
from srt_tpu_torch.scene import build as port_build
from srt_tpu_torch.scene.teapot import create_teapot

SEED = 3_000_000_019


def target_rays(soup, n: int, seed: int):
    """``n`` rays from points around and inside the teapot scene, each
    aimed at a point of a triangle drawn from the seed: a quarter at
    inner points, a quarter at the middle of an edge (each shared with a
    neighbour), a quarter at a point along an edge, a quarter at a
    corner."""
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.integers(0, soup.count, n))
    p0 = soup.p0[k]
    p1, p2 = p0 + soup.e1[k], p0 + soup.e2[k]
    a, b = (torch.from_numpy(rng.random(n).astype(np.float32))
            for _ in range(2))
    inner = torch.where((a + b > 1)[:, None],
                        p0 + (1 - a)[:, None] * (p1 - p0)
                        + (1 - b)[:, None] * (p2 - p0),
                        p0 + a[:, None] * (p1 - p0) + b[:, None] * (p2 - p0))
    kind = torch.arange(n) % 4
    target = torch.where((kind == 0)[:, None], inner, torch.where(
        (kind == 1)[:, None], 0.5 * (p1 + p2), torch.where(
            (kind == 2)[:, None], p0 + a[:, None] * (p1 - p0), p0)))
    centre = torch.tensor([280.0, 60.0, 200.0])
    reach = torch.from_numpy(rng.uniform(30.0, 900.0, n).astype(np.float32))
    off = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    o = centre + off / off.norm(dim=1, keepdim=True) * reach[:, None]
    d = target - o
    return o, d / d.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("leaf", [4, 8, triangles.LEAF])
def test_block_sweep_is_brute_force(leaf):
    arrays, _ = library_arrays("teapot_scene", divs=4)
    scene = Scene(arrays, "cpu")
    soup = triangles.Soup(scene.tri_p0, scene.tri_p1, scene.tri_p2,
                          scene.tri_uv, scene.tri_n, scene.tri_mat, leaf=leaf)
    o, d = target_rays(soup, 4096, SEED + leaf)
    t, u, v, idx = triangles.closest(soup, o, d, 1e-3)
    tb, ub, vb, ib = triangles.brute_force(soup, o, d, 1e-3)
    assert (ib >= 0).float().mean() > 0.9
    assert torch.equal(t, tb) and torch.equal(idx, ib)
    assert torch.equal(u, ub) and torch.equal(v, vb)
    # with a bound from another family: every triangle nearer than it
    rng = np.random.default_rng(SEED)
    bound = tb * torch.from_numpy(rng.uniform(0.5, 1.5, len(tb))
                                  .astype(np.float32))
    t, _, _, idx = triangles.closest(soup, o, d, 1e-3, bound)
    near = tb < bound
    assert torch.equal(near, t < bound)
    assert torch.equal(t[near], tb[near]) and torch.equal(idx[near],
                                                          ib[near])


def test_ties_go_to_the_lowest_index():
    p0 = torch.tensor([[0.0, 0.0, 0.0]]).repeat(5, 1)
    p1 = torch.tensor([[1.0, 0.0, 0.0]]).repeat(5, 1)
    p2 = torch.tensor([[0.0, 1.0, 0.0]]).repeat(5, 1)
    p0[0, 2] = 5.0          # triangle 0 lies behind the other four
    p1[0, 2] = p2[0, 2] = 5.0
    soup = triangles.Soup(p0, p1, p2, torch.zeros(5, 3, 2),
                          torch.zeros(5, 3, 3), torch.arange(5), leaf=2)
    o = torch.tensor([[0.2, 0.2, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    for fn in (triangles.closest, triangles.brute_force):
        t, _, _, idx = fn(soup, o, d, 1e-3)
        assert float(t) == 3.0 and int(idx) == 1


def build_both(teapot, smooth_teapot):
    """One scene of meshes, boxes and media from both builders."""
    out = []
    for b, rot_x, rot_y in (
            (builder.SceneArrays(), builder.rotation_x, builder.rotation_y),
            (port_build.SceneBuilder(), port_build.rotation_x,
             port_build.rotation_y)):
        white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
        gold = b.beckmann(b.constant((0.945, 0.75, 0.336)), 0.01, 0.05)
        b.xz_rect(0, 555, 0, 555, 0, white)
        b.box((130, 0, 65), (295, 165, 230), white, as_tris=True)
        b.box((265, 0, 295), (430, 330, 460), gold)
        b.trimesh(teapot, gold, rotate=rot_x(90.0), translate=(200, 0, 250))
        b.trimesh(smooth_teapot, white, scale=2.0, rotate=rot_y(180.0),
                  translate=(180, -70, 450), flip_winding=True,
                  flip_uvs=True)
        b.medium_sphere((280, 30, 70), 30.0, 0.2, b.constant((0.2, 0.4, 0.9)))
        b.medium_box((0, 0, 0), (10, 20, 30), 0.01, b.constant((1, 1, 1)))
        out.append(b.build() if isinstance(b, builder.SceneArrays)
                   else b.build(device="cpu"))
    return out


def test_builder_meshes_and_media_are_the_ports_rows():
    arrays, scene = build_both(create_teapot(scale=40.0, divs=2),
                               create_teapot(scale=40.0, divs=2,
                                             smooth=True))
    assert not any(k.startswith("bvh_") for k in arrays)
    soup = np.stack([arrays["tri_p0"], arrays["tri_p1"], arrays["tri_p2"]],
                    1)
    _, order = build_bvh(soup, leaf_size=4)
    for k, v in arrays.items():
        w = getattr(scene, k)
        if v is None:
            assert w is None, k
            continue
        v = v[order] if k.startswith("tri_") else v
        w = w.numpy()
        assert v.dtype == w.dtype and v.shape == w.shape, k
        assert np.array_equal(v, w), k
    assert arrays["med_kind"].tolist() == [0, 1]


def test_the_reference_refuses_what_it_does_not_cover():
    arrays, _ = build_both(create_teapot(divs=1), create_teapot(divs=1))
    Scene(arrays, "cpu")
    mesh_medium = dict(arrays, med_kind=np.array([0, 2], np.int32))
    with pytest.raises(NotImplementedError, match="mesh"):
        Scene(mesh_medium, "cpu")
    merl = dict(arrays, mat_type=np.append(arrays["mat_type"], 7)
                .astype(np.int32))
    with pytest.raises(NotImplementedError, match="materials"):
        Scene(merl, "cpu")
