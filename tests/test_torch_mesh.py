"""The mesh loaders and the scenes of scanned meshes against the JAX
package's: each loader of ``srt_tpu_torch/io/mesh.py`` gives the soup of
``srt_tpu/io/mesh.py`` bit for bit on files this test writes (PLY in
ASCII and binary, quads among its faces; OBJ with uv, normals and negative
indices; VRML; a minimal binary FBX with a zlib-encoded array and two
geometries for ``first_mesh_only``), and each library scene that loads a
mesh gives JAX's tables and ``info`` bit for bit, with the assets present
under a temporary asset root and with them absent. No asset ships with
the repository: the meshes are seeded blobs
(``_torch_scenes.write_blob_ply``)."""
from __future__ import annotations

import dataclasses
import struct
import warnings
import zlib

import numpy as np
import pytest
import torch
from _torch_scenes import write_blob_ply

import srt_tpu.io.assets as jassets
from srt_tpu.io import mesh as jmesh
from srt_tpu.scene import library as jlib
from srt_tpu_torch import convert, get_scene
from srt_tpu_torch.io import mesh
from srt_tpu_torch.scene.ir import TorchScene

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:asset .* missing",
                                        "ignore:dragon.ply")


def _same_soup(a, b) -> None:
    for k in ("positions", "uvs", "normals"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k


def _ply_with_attributes(path: str) -> None:
    """An ASCII PLY whose vertices carry normals and uv, with a quad."""
    r = np.random.default_rng(3)
    v = r.uniform(-1, 1, (6, 8)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 0, 1]]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 6\n"
                + "".join(f"property float {p}\n"
                          for p in ("x", "y", "z", "nx", "ny", "nz", "u",
                                    "v"))
                + "element face 3\nproperty list uchar int vertex_indices\n"
                "end_header\n")
        for row in v:
            f.write(" ".join(repr(float(x)) for x in row) + "\n")
        for face in faces:
            f.write(f"{len(face)} " + " ".join(map(str, face)) + "\n")


@pytest.mark.parametrize("kind", ["binary", "ascii", "quads", "attributes"])
def test_ply_matches_jax(tmp_path, kind):
    path = str(tmp_path / "m.ply")
    if kind == "attributes":
        _ply_with_attributes(path)
    else:
        write_blob_ply(path, 7, 9, seed=2, binary=kind != "ascii",
                       quads=kind == "quads")
    got, want = mesh.load_ply(path), jmesh.load_ply(path)
    _same_soup(got, want)
    assert got.n_tris == (4 if kind == "attributes" else 2 * 9 * 6)
    _same_soup(mesh.load_mesh(path), got)


def test_obj_matches_jax(tmp_path):
    """``v``/``vt``/``vn`` records, a quad, negative (relative) indices and
    a corner without a uv."""
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write("# seeded\n")
        r = np.random.default_rng(4)
        for p in r.uniform(-1, 1, (5, 3)):
            f.write("v " + " ".join(f"{x:.6f}" for x in p) + "\n")
        for t in r.uniform(0, 1, (4, 2)):
            f.write("vt " + " ".join(f"{x:.6f}" for x in t) + "\n")
        for n in r.uniform(-1, 1, (3, 3)):
            f.write("vn " + " ".join(f"{x:.6f}" for x in n) + "\n")
        f.write("f 1/1/1 2/2/2 3/3/3\n")
        f.write("f -4/-3/-2 -3/-2/-1 -2/-1/-3 -1/1/1\n")
        f.write("f 1//1 3//2 5//3\n")
    got, want = mesh.load_obj(path), jmesh.load_obj(path)
    _same_soup(got, want)
    assert got.n_tris == 4 and got.uvs is not None
    _same_soup(mesh.load_mesh(path), got)


def test_wrl_matches_jax(tmp_path):
    """Two IndexedFaceSets, a quad and a face that ends the list without
    its ``-1``."""
    path = str(tmp_path / "m.wrl")
    with open(path, "w") as f:
        f.write("#VRML V2.0 utf8\nShape { geometry IndexedFaceSet {\n"
                " coord Coordinate { point [ 0 0 0, 1 0 0, 1 1 0, 0 1 0 ] }\n"
                " coordIndex [ 0, 1, 2, 3, -1 ] } }\n"
                "Shape { geometry IndexedFaceSet {\n"
                " coord Coordinate { point [ 0 0 1, 1 0 1, 0 1 1.5 ] }\n"
                " coordIndex [ 0 1 2 ] } }\n")
    got, want = mesh.load_wrl(path), jmesh.load_wrl(path)
    _same_soup(got, want)
    assert got.n_tris == 3
    _same_soup(mesh.load_mesh(path), got)


# --- a minimal binary FBX 7.x --------------------------------------------
_ARRAY = {b"d": "<f8", b"i": "<i4", b"f": "<f4", b"l": "<i8"}


def _fbx_prop(v) -> bytes:
    if isinstance(v, str):
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    code, arr, zipped = v                 # an array property
    raw = np.asarray(arr, _ARRAY[code]).tobytes()
    data = zlib.compress(raw) if zipped else raw
    return code + struct.pack("<III", len(arr), int(zipped), len(data)) + data


def _fbx_bytes(nodes, version: int) -> bytes:
    """The FBX binary layout: the 27-byte header, node records (end
    offset, property count, property bytes, name) with children closed by
    a null record, then a null record; offsets 64-bit from 7.5."""
    word, null = ("<QQQ", 25) if version >= 7500 else ("<III", 13)
    out = bytearray(b"Kaydara FBX Binary  \x00\x1a\x00"
                    + struct.pack("<I", version))

    def emit(node):
        name, props, children = node
        start = len(out)
        body = b"".join(_fbx_prop(p) for p in props)
        out.extend(b"\0" * struct.calcsize(word))
        out.append(len(name))
        out.extend(name.encode() + body)
        for child in children:
            emit(child)
        if children:
            out.extend(b"\0" * null)
        struct.pack_into(word, out, start, len(out), len(props), len(body))

    for node in nodes:
        emit(node)
    out.extend(b"\0" * null)
    return bytes(out)


def _geometry(seed: int, layers: bool):
    """A Geometry node: a seeded quad and triangle (polygon ends marked
    ``~index``), with per-corner normals (Direct, zlib-encoded) and uv
    (IndexToDirect) when ``layers``."""
    r = np.random.default_rng(seed)
    verts = r.uniform(-1, 1, (5, 3))
    pvi = [0, 1, 2, ~3, 1, 4, ~2]
    children = [("Vertices", [(b"d", verts.reshape(-1), False)], []),
                ("PolygonVertexIndex", [(b"i", pvi, True)], [])]
    if layers:
        normals = r.uniform(-1, 1, (len(pvi), 3))
        uv = r.uniform(0, 1, (4, 2))
        children += [
            ("LayerElementNormal", [0], [
                ("MappingInformationType", ["ByPolygonVertex"], []),
                ("ReferenceInformationType", ["Direct"], []),
                ("Normals", [(b"d", normals.reshape(-1), True)], [])]),
            ("LayerElementUV", [0], [
                ("MappingInformationType", ["ByPolygonVertex"], []),
                ("ReferenceInformationType", ["IndexToDirect"], []),
                ("UV", [(b"d", uv.reshape(-1), False)], []),
                ("UVIndex", [(b"i", r.integers(0, 4, len(pvi)), False)],
                 [])])]
    return ("Geometry", [seed, "Geometry::mesh", "Mesh"], children)


def write_fbx(path: str, version: int = 7400) -> None:
    """Two geometries: the first with normals and uv, the second without
    (so the merged soup has neither)."""
    nodes = [("FBXHeaderExtension", [], [("FBXVersion", [version], [])]),
             ("Objects", [], [_geometry(11, True), _geometry(12, False)])]
    with open(path, "wb") as f:
        f.write(_fbx_bytes(nodes, version))


@pytest.mark.parametrize("version", [7400, 7500])
@pytest.mark.parametrize("first", [False, True])
def test_fbx_matches_jax(tmp_path, version, first):
    path = str(tmp_path / "m.FBX")
    write_fbx(path, version)
    got = mesh.load_fbx(path, first_mesh_only=first)
    _same_soup(got, jmesh.load_fbx(path, first_mesh_only=first))
    assert got.n_tris == (3 if first else 6)
    assert (got.normals is not None) == first == (got.uvs is not None)
    _same_soup(mesh.load_mesh(path, first_mesh_only=first), got)
    with open(path, "rb") as f:
        roots, ver = mesh._parse_fbx(f.read())
    assert ver == version and [n.name for n in roots] == [
        "FBXHeaderExtension", "Objects"]


def test_load_mesh_refuses_other_formats(tmp_path):
    for name in ("m.stl", "m.3ds"):
        with pytest.raises(ValueError, match="unsupported"):
            mesh.load_mesh(str(tmp_path / name))
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply")
    with pytest.raises(ValueError, match="not a PLY"):
        mesh.load_ply(str(bad))
    with pytest.raises(ValueError, match="binary FBX"):
        mesh._parse_fbx(b"; FBX 7.4.0 project file")


# --- the library's scenes of scanned meshes -------------------------------
def _assets(tmp_path, monkeypatch, present: bool) -> None:
    """Both packages' asset roots at ``tmp_path`` (JAX's module list,
    the port's ``$SRT_ASSETS``), holding the mesh assets when
    ``present``."""
    root = tmp_path / "contents"
    (root / "models").mkdir(parents=True)
    if present:
        write_blob_ply(str(root / "models" / "bunny.ply"), 8, 10, seed=0)
        write_blob_ply(str(root / "models" / "dragon.ply"), 6, 8, seed=1,
                       radius=0.09)
        write_fbx(str(root / "models" / "Soilder.FBX"))
    monkeypatch.setenv("SRT_ASSETS", str(root))
    monkeypatch.setattr(jassets, "ASSET_ROOTS", [str(root)])


SCENES = [("cornell_box", {}), ("teapot_scene", {"divs": 3}),
          ("jadebunny_scene", {}), ("flatnormal_bunny", {}),
          ("soldier_scene", {}), ("soldier_scene", {"first_mesh_only": True}),
          ("soldier_scene", {"floor_variant": "rect", "no_soldier": True})]


@pytest.mark.parametrize("present", [True, False], ids=["present", "absent"])
@pytest.mark.parametrize("name,kw", SCENES,
                         ids=[f"{n}-{'-'.join(kw) or 'default'}"
                              for n, kw in SCENES])
def test_mesh_scene_tables_match_jax(tmp_path, monkeypatch, name, kw,
                                     present):
    """Every table equal to the bit, and ``info`` equal but for the port's
    host seconds (``host_s``, ``mesh_s``)."""
    _assets(tmp_path, monkeypatch, present)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene_j, cam_j, info_j = jlib.get_scene(name, **kw)
        got, cam, info = get_scene(name, device="cpu", **kw)
    want = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    for f in dataclasses.fields(TorchScene):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
    assert {k: v for k, v in info.items() if k not in ("host_s", "mesh_s")} \
        == info_j
    meshes = {"models/bunny.ply", "models/dragon.ply", "models/Soilder.FBX"}
    loads = present and not kw.get("no_soldier")
    assert bool(meshes & set(info.get("skipped", []))) == (
        not present and not kw.get("no_soldier"))
    if name != "teapot_scene":
        assert bool(got.n_tris) == loads, got.n_tris
    rec = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()},
        device="cpu").record()
    np.testing.assert_allclose(cam.record().numpy(), rec.numpy(), rtol=1e-6,
                               atol=1e-6)
