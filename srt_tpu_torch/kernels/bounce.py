"""One bounce of a wavefront, in the two forms the engines launch.

**The regeneration bounce** (kernel B1): regenerate dead lanes from the
work queue, then trace and shade every live lane. Replaces
``srt_tpu/pallas/bounce.py:_kernel`` in its ``regen=True`` mode (launched
by ``fused_regen_bounce``, ``bounce.py:1621-1724``). Two versions of the
same step live here:

* :func:`regen_bounce_reference`, the plain PyTorch version, written with
  the port's modules (``torch.cumsum`` work-queue ranks, the camera,
  :func:`srt_tpu_torch.render.integrator.bounce_step`, the depth cap). It
  evaluates the environment dome's image texture inside the bounce's
  emission term, which is the math of the JAX package's deferred-texture
  epilogue (``bounce.py:1555-1595``, ``textures._image_value``).
* ``csrc/regen_bounce.cu``, hand-written CUDA for ``sm_90a``: one thread
  per lane, scene tables staged in shared memory, the image lookup folded
  in, so a bounce is one launch.

:func:`regen_bounce` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back.

What bounds the kernel on an H100: not bytes (a lane reads and writes
about 80 bytes of state per bounce) but registers and divergence in the
shading chain: Beckmann VNDF sampling runs up to nine Newton–bisection
rounds of ``erfinv`` next to Oren–Nayar and emitter lanes in the same
warp, and the 122-sphere sweep keeps a dozen winner registers live. The
simple design takes that as it is: one thread per lane, no splitting of
the shading core, emitter and dead lanes skip the shading work.

The wavefront is updated in place so one copy of it lives on the device.

**The per-bounce step** (kernel B2), the forward of the train step and
the bounce of the regeneration engine on triangle scenes: one bounce of an
explicit state, out of place, no regeneration and no depth cap. Replaces
``_kernel`` in its per-bounce mode (launched by ``fused_bounce``,
``bounce.py:1425-1552``) without the parity plane. On a triangle scene it
takes each lane's closest triangle ``(t, u, v, idx)`` from kernel B3
(``kernels/intersect.py``), or from B4 on a mesh beyond the single-level
budget, and assembles the hit itself (the external-hit mode, ``has_ext``);
in that mode it also runs the media sweep and the specular branch of
metal, dielectric and isotropic materials. :func:`bounce_step_ref` is its
plain version and :func:`bounce_fwd` the wrapper; ``csrc/bounce.cu`` runs the same
``bounce()`` of ``csrc/bounce_core.cuh`` as B1.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from srt_tpu_torch.core import rng
from srt_tpu_torch.kernels.build import launch
from srt_tpu_torch.render.integrator import bounce_step
from srt_tpu_torch.render.intersect import RECT_NAXIS, RECT_UAXIS, RECT_VAXIS
from srt_tpu_torch.scene.ir import SceneFlags, TorchScene

#: Kernel launches made by :func:`regen_bounce` (the CUDA path only).
LAUNCHES = 0
#: Kernel launches made by :func:`bounce_fwd` (the CUDA path only).
LAUNCHES_FWD = 0

BLOCK = 256                      # threads (lanes) per CUDA block
DIM_LENS = 32                    # camera sampler dimensions (api.py)
DIM_TIME = 34

_F32, _I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class RegenSpec:
    """Static parameters of one render's wavefront loop."""
    width: int
    height: int
    spp: int
    max_depth: int
    rr_start: int
    pdf_floor: float
    seed: int

    @property
    def total_work(self) -> int:
        return self.width * self.height * self.spp


def build_tables(scene: TorchScene, flags: SceneFlags) -> dict:
    """Scene records the kernels read (``bounce.py:_build_tables``),
    entries-major so one record is contiguous: spheres (S, 12), rects
    (R, 10), materials (M, 14), rect lights (L, 8), all float32 (lights
    are rects: the coverage gate refuses sphere lights); for B2's
    external hit the triangles' normals (T, 9), uv (T, 6) and materials
    (T,) int32; and the media (M, 10): kind, center, radius, half extents,
    density, material (``bounce.py:1402``)."""
    f = _F32
    dev = scene.device
    S, R = scene.n_spheres, scene.n_rects
    flip_sign = torch.where(scene.sph_flip ^ scene.sph_env, -1.0, 1.0)
    dt = torch.clamp(scene.sph_times[:, 1] - scene.sph_times[:, 0], min=1e-20)
    sph = torch.cat([
        scene.sph_center0, scene.sph_center1 - scene.sph_center0,
        scene.sph_times[:, 0:1], (1.0 / dt)[:, None],
        scene.sph_radius[:, None], scene.sph_mat[:, None].to(f),
        flip_sign[:, None].to(f), scene.sph_env[:, None].to(f)], 1)
    axes = [torch.tensor(a, dtype=f, device=dev)
            for a in (RECT_NAXIS, RECT_UAXIS, RECT_VAXIS)]
    ax = scene.rect_axis.long()
    rect_geo = torch.stack([axes[0][ax], axes[1][ax], axes[2][ax],
                            scene.rect_k, scene.rect_bounds[:, 0],
                            scene.rect_bounds[:, 1], scene.rect_bounds[:, 2],
                            scene.rect_bounds[:, 3]], 1)
    rect = torch.cat([rect_geo, scene.rect_mat[:, None].to(f),
                      torch.where(scene.rect_flip, -1.0, 1.0)[:, None]], 1)
    tex = scene.mat_tex.long()
    mat = torch.cat([
        scene.mat_type[:, None].to(f), scene.mat_params,
        scene.tex_type[tex][:, None].to(f), scene.tex_color[tex],
        scene.tex_color2[tex],
        torch.zeros((scene.mat_type.shape[0], 1), dtype=f, device=dev),
        tex[:, None].to(f)], 1)
    light = rect_geo[scene.light_index.long().clamp(0, max(R - 1, 0))]
    atlas = (scene.atlas_u32 if scene.atlas_u32 is not None
             else torch.zeros((1,), dtype=_I32, device=dev))
    T = scene.n_tris
    med = torch.cat([scene.med_kind[:, None].to(f), scene.med_center,
                     scene.med_radius[:, None], scene.med_half,
                     scene.med_density[:, None],
                     scene.med_mat[:, None].to(f)], 1)
    return dict(sph=sph.reshape(S, 12).contiguous(),
                rect=rect.reshape(R, 10).contiguous(),
                mat=mat.contiguous(), light=light.reshape(-1, 8).contiguous(),
                tex_img=scene.tex_img.to(_I32).contiguous(),
                atlas_u32=atlas.to(_I32).contiguous(),
                tri_n=scene.tri_n.reshape(T, 9).contiguous(),
                tri_uv=scene.tri_uv.reshape(T, 6).contiguous(),
                tri_mat=scene.tri_mat.to(_I32).contiguous(),
                med=med.reshape(-1, 10).contiguous())


class RegenInputs:
    """What a launch reads besides the wavefront: the scene, its kernel
    tables, the camera record and the (spp, 2) Sobol jitter table."""

    def __init__(self, scene: TorchScene, flags: SceneFlags, camera,
                 jitter: torch.Tensor):
        self.scene, self.flags, self.camera = scene, flags, camera
        self.jitter = jitter.to(device=scene.device, dtype=_F32).contiguous()
        self.cam_record = camera.record().contiguous()
        self.tables = build_tables(scene, flags)


def new_wavefront(n: int, device) -> dict:
    """An all-dead wavefront of ``n`` lanes with the work cursor at 0.

    Vectors are (3, n) planes; ``salt`` holds 32-bit words as int32 bit
    patterns. ``dead[b]`` counts block ``b``'s dead lanes (the kernel's
    work-queue ranks, see ``csrc/regen_bounce.cu``); ``dead_next`` and
    ``cursor_next`` are the kernel's output buffers, swapped in after a
    launch."""
    z3 = torch.zeros((3, n), dtype=_F32, device=device)
    d = z3.clone()
    d[2] = 1.0
    zi = torch.zeros((n,), dtype=_I32, device=device)
    dead = count_dead(zi)
    return dict(o=z3.clone(), d=d, time=torch.zeros((n,), dtype=_F32,
                                                     device=device),
                beta=z3.clone(), radiance=z3.clone(), salt=zi.clone(),
                depth=zi.clone(), alive=zi.clone(), pix=zi.clone(),
                fin=zi.clone(), dead=dead, dead_next=dead.clone(),
                cursor=torch.zeros((1,), dtype=_I32, device=device),
                cursor_next=torch.zeros((1,), dtype=_I32, device=device))


def regenerate(inp: RegenInputs, spec: RegenSpec, st: dict,
               cursor: torch.Tensor) -> tuple[dict, torch.Tensor,
                                               torch.Tensor]:
    """Dead lanes take the next ``(pixel, sample)`` work items from the
    queue at ``cursor`` (row-major ``cumsum`` ranks, sample-minor) and
    become fresh camera rays (``regen.py:183-209``). ``st``: ``o d beta
    radiance`` (N, 3), ``time``, ``salt`` (32-bit words, any int dtype),
    ``depth``, ``alive`` (bool), ``pix``. Returns the bounce's input state
    (``salt`` as int64 words), the mask of lanes that took work, and each
    lane's pixel (int64)."""
    alive = st["alive"]
    need = ~alive
    wid = cursor.long() + torch.cumsum(need.long(), 0) - 1
    take = need & (wid < spec.total_work)
    pixn = wid // spec.spp
    sampn = wid % spec.spp
    jit = inp.jitter[sampn]
    col = (pixn % spec.width).to(_F32)
    row = (pixn // spec.width).to(_F32)
    s = (col + jit[:, 0]) / spec.width
    t = (spec.height - 1.0 - row + jit[:, 1]) / spec.height
    salt_new = rng.create_salt(spec.seed, pixn, sampn)
    o_new, d_new, time_new = inp.camera.rays(
        s, t, rng.uniform(salt_new, DIM_LENS),
        rng.uniform(salt_new, DIM_LENS + 1), rng.uniform(salt_new, DIM_TIME))
    t3 = take[:, None]
    state = dict(
        o=torch.where(t3, o_new, st["o"]), d=torch.where(t3, d_new, st["d"]),
        time=torch.where(take, time_new, st["time"]),
        beta=torch.where(t3, 1.0, st["beta"]),
        radiance=torch.where(t3, 0.0, st["radiance"]),
        alive=alive | take,
        salt=torch.where(take, salt_new, rng.as_word(st["salt"])),
        depth=torch.where(take, 0, st["depth"]))
    return state, take, torch.where(take, pixn, st["pix"].long())


def regen_bounce_reference(inp: RegenInputs, st: dict,
                           spec: RegenSpec) -> None:
    """The plain PyTorch version of one launch; updates ``st`` in place."""
    rows = {k: st[k].T for k in ("o", "d", "beta", "radiance")}
    state, take, pix = regenerate(
        inp, spec, dict(st, **rows, alive=st["alive"] != 0), st["cursor"])
    nxt = bounce_step(inp.scene, state, spec.max_depth, spec.rr_start,
                      inp.flags, spec.pdf_floor)
    # the depth cap folds into alive (bounce.py:1314-1318)
    alive_fin = nxt["alive"] & (nxt["depth"] < spec.max_depth)
    for k in ("o", "d", "beta", "radiance"):
        st[k].copy_(nxt[k].T)
    st["time"].copy_(state["time"])
    st["salt"].copy_(state["salt"].to(_I32))     # wraps to the bit pattern
    st["depth"].copy_(nxt["depth"])
    st["pix"].copy_(pix)
    st["alive"].copy_(alive_fin)
    st["fin"].copy_(state["alive"] & ~alive_fin)
    st["cursor"] += take.sum().to(_I32)
    st["dead"].copy_(count_dead(st["alive"]))


def count_dead(alive: torch.Tensor) -> torch.Tensor:
    """Dead lanes per block of ``BLOCK`` lanes, as the kernel counts them."""
    pad = -alive.shape[0] % BLOCK
    dead = torch.nn.functional.pad((alive == 0).to(_I32), (0, pad))
    return dead.view(-1, BLOCK).sum(1, dtype=_I32)


class _Args(ctypes.Structure):
    """``RegenArgs`` of ``csrc/regen_bounce.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "time", "beta", "rad", "salt", "depth", "alive", "pix",
        "fin", "dead_in", "dead_out", "cursor_in", "cursor_out", "sph",
        "rect", "mat", "light", "tex_img", "atlas_u32", "cam", "jitter")]
        + [(name, ctypes.c_int) for name in (
            "n", "n_sph", "n_rect", "n_mat", "n_light", "n_atlas", "width",
            "height", "spp", "total_work", "max_depth", "rr_start")]
        + [("pdf_floor", ctypes.c_float), ("seed", ctypes.c_uint32)])


_STATE_F32 = {"o": 3, "d": 3, "time": 1, "beta": 3, "radiance": 3}
_STATE_I32 = ("salt", "depth", "alive", "pix", "fin", "dead", "dead_next",
              "cursor", "cursor_next")


def _check_state(st: dict, n: int, device) -> None:
    for k, rows in _STATE_F32.items():
        shape = (rows, n) if rows > 1 else (n,)
        t = st[k]
        if (t.dtype != _F32 or tuple(t.shape) != shape
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"wavefront {k!r}: want contiguous float32 "
                             f"{shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for k in _STATE_I32:
        t = st[k]
        if t.dtype != _I32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"wavefront {k!r}: want contiguous int32 on "
                             f"{device}, got {t.dtype} on {t.device}")
    if st["dead"].shape[0] != -(-n // BLOCK):
        raise ValueError("wavefront 'dead' must hold one count per block")


def _launch(inp: RegenInputs, st: dict, spec: RegenSpec) -> None:
    """Launch ``csrc/regen_bounce.cu`` on the current stream."""
    global LAUNCHES
    n = st["alive"].shape[0]
    dev = st["alive"].device
    _check_state(st, n, dev)
    if spec.total_work >= 2 ** 31 - n:
        raise ValueError("work queue beyond int32 ranks")
    tb = inp.tables
    for k, t in (*tb.items(), ("cam", inp.cam_record),
                 ("jitter", inp.jitter)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"table {k!r} must be contiguous on {dev}")
    ptr = {k: st[k].data_ptr() for k in
           ("o", "d", "time", "beta", "salt", "depth", "alive", "pix",
            "fin")}
    args = _Args(
        **ptr, rad=st["radiance"].data_ptr(),
        dead_in=st["dead"].data_ptr(), dead_out=st["dead_next"].data_ptr(),
        cursor_in=st["cursor"].data_ptr(),
        cursor_out=st["cursor_next"].data_ptr(),
        **{k: tb[k].data_ptr() for k in
           ("sph", "rect", "mat", "light", "tex_img", "atlas_u32")},
        cam=inp.cam_record.data_ptr(), jitter=inp.jitter.data_ptr(),
        n=n, n_sph=tb["sph"].shape[0], n_rect=tb["rect"].shape[0],
        n_mat=tb["mat"].shape[0], n_light=tb["light"].shape[0],
        n_atlas=(tb["atlas_u32"].shape[0]
                 if inp.scene.atlas_u32 is not None else 0),
        width=spec.width, height=spec.height, spp=spec.spp,
        total_work=spec.total_work, max_depth=spec.max_depth,
        rr_start=min(spec.rr_start, 2 ** 31 - 1), pdf_floor=spec.pdf_floor,
        seed=spec.seed & rng.MASK32)
    launch("srt_regen_bounce", args, dev)
    LAUNCHES += 1
    st["dead"], st["dead_next"] = st["dead_next"], st["dead"]
    st["cursor"], st["cursor_next"] = st["cursor_next"], st["cursor"]


def regen_bounce(inp: RegenInputs, st: dict, spec: RegenSpec) -> None:
    """One bounce of the wavefront ``st``, in place: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if st["alive"].device.type == "cpu":
        regen_bounce_reference(inp, st, spec)
    elif st["alive"].device.type == "cuda":
        _launch(inp, st, spec)
    else:
        raise ValueError(f"no regen_bounce for {st['alive'].device}")


# --- the per-bounce step (B2) -------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Static parameters of one bounce."""
    max_depth: int
    rr_start: int = 1 << 30
    pdf_floor: float = 1e-9


#: columns of the (M, 14) material table that the backward differentiates
#: (parameters 0-3, colour, second colour), in the backward kernel's order
MAT_GRAD_COLS = (1, 2, 3, 4, 6, 7, 8, 9, 10, 11)


def material_view(scene: TorchScene, mat: torch.Tensor) -> TorchScene:
    """``scene`` with its material fields read from the kernel's (M, 14)
    table ``mat``, one texture per material. The values are the scene's,
    bit for bit; autograd of a bounce on this view gives ``mat``'s
    cotangent, which :func:`build_tables` carries back to ``mat_params``,
    ``tex_color`` and ``tex_color2``."""
    tex = scene.mat_tex.long()
    return dataclasses.replace(
        scene, mat_params=mat[:, 1:5],
        mat_tex=torch.arange(mat.shape[0], dtype=scene.mat_tex.dtype,
                             device=mat.device),
        tex_type=scene.tex_type[tex], tex_color=mat[:, 6:9],
        tex_color2=mat[:, 9:12], tex_img=scene.tex_img[tex])


def bounce_step_ref(scene: TorchScene, flags: SceneFlags,
                    mat: torch.Tensor, state: dict, spec: StepSpec,
                    tri=None) -> dict:
    """The plain version of B2: ``render.integrator.bounce_step`` on the
    material view of ``mat`` (the image emission of the environment dome is
    evaluated inside its emission term, as the kernel does). ``state``:
    ``o d beta radiance`` (N, 3) float32, ``time`` (N,), ``salt`` (N,)
    int32 bit patterns, ``depth`` (N,) int32, ``alive`` (N,) bool. ``tri``:
    on a triangle scene, each lane's closest triangle ``(t, u, v, idx)``
    as kernel B3 gives it (the plain walk computes it when None). Returns
    the next state with ``depth + 1`` and ``alive`` not yet capped by
    depth."""
    return bounce_step(material_view(scene, mat), state, spec.max_depth,
                       spec.rr_start, flags, spec.pdf_floor, tri)


_ROWS = ("o", "d", "beta", "radiance")
_TABLES = ("sph", "rect", "mat", "light", "tex_img", "atlas_u32")


class _BounceArgs(ctypes.Structure):
    """``BounceArgs`` of ``csrc/bounce.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "beta", "rad", "salt", "depth", "alive", "o_out", "d_out",
        "beta_out", "rad_out", "depth_out", "alive_out", *_TABLES)]
        + [(name, ctypes.c_int) for name in (
            "n", "n_sph", "n_rect", "n_mat", "n_light", "n_atlas",
            "max_depth", "rr_start")]
        + [("pdf_floor", ctypes.c_float)]
        + [(name, ctypes.c_void_p) for name in (
            "tri_t", "tri_u", "tri_v", "tri_idx", "tri_n", "tri_uv",
            "tri_mat")]
        + [("n_tris", ctypes.c_int), ("med", ctypes.c_void_p),
           ("n_med", ctypes.c_int)])


def check_state(state: dict, tables: dict, device) -> int:
    """Raise unless ``state`` and ``tables`` are what the train kernels
    read on ``device``; returns the lane count."""
    n = state["alive"].shape[0]
    want = {**{k: (torch.float32, (n, 3)) for k in _ROWS},
            "salt": (_I32, (n,)), "depth": (_I32, (n,)),
            "alive": (torch.bool, (n,))}
    for k, (dtype, shape) in want.items():
        t = state[k]
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"state {k!r}: want contiguous {dtype} {shape} "
                             f"on {device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    for k in _TABLES:
        if tables[k].device != device or not tables[k].is_contiguous():
            raise ValueError(f"table {k!r} must be contiguous on {device}")
    if tables["mat"].dtype != torch.float32:
        raise ValueError("table 'mat' must be float32")
    return n


def table_args(scene: TorchScene, tables: dict) -> dict:
    """The table pointers and counts of a train kernel's arguments."""
    return dict(**{k: tables[k].data_ptr() for k in _TABLES},
                n_sph=tables["sph"].shape[0], n_rect=tables["rect"].shape[0],
                n_mat=tables["mat"].shape[0],
                n_light=tables["light"].shape[0],
                n_atlas=(tables["atlas_u32"].shape[0]
                         if scene.atlas_u32 is not None else 0))


def _tri_args(scene: TorchScene, tables: dict, tri, n: int, dev) -> dict:
    """The external-hit fields of B2's arguments: none on a scene without
    triangles, else B3's or B4's ``(t, u, v, idx)``, the triangle tables
    and the media."""
    if not scene.n_tris:
        return {}
    if tri is None:
        raise ValueError("a triangle scene's bounce takes the triangles' "
                         "closest hit (kernels.intersect.intersect_tris)")
    for k, x, dtype in zip("tuv", tri[:3], (torch.float32,) * 3):
        if (x.dtype != dtype or tuple(x.shape) != (n,) or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"triangle hit {k!r}: want contiguous {dtype} "
                             f"({n},) on {dev}")
    idx = tri[3]
    if (idx.dtype != _I32 or tuple(idx.shape) != (n,) or idx.device != dev
            or not idx.is_contiguous()):
        raise ValueError(f"triangle hit 'idx': want contiguous int32 ({n},) "
                         f"on {dev}")
    for k in ("tri_n", "tri_uv", "tri_mat", "med"):
        if tables[k].device != dev or not tables[k].is_contiguous():
            raise ValueError(f"table {k!r} must be contiguous on {dev}")
    return dict(tri_t=tri[0].data_ptr(), tri_u=tri[1].data_ptr(),
                tri_v=tri[2].data_ptr(), tri_idx=idx.data_ptr(),
                **{k: tables[k].data_ptr() for k in ("tri_n", "tri_uv",
                                                     "tri_mat", "med")},
                n_tris=scene.n_tris, n_med=tables["med"].shape[0])


def fwd_args(scene: TorchScene, tables: dict, state: dict,
             spec: StepSpec, tri=None) -> tuple[_BounceArgs, dict]:
    """The checked arguments of one ``csrc/bounce.cu`` launch and the
    output tensors it writes; ``tri`` as in :func:`bounce_fwd`."""
    dev = state["alive"].device
    n = check_state(state, tables, dev)
    ext = _tri_args(scene, tables, tri, n, dev)
    out = {k: torch.empty_like(state[k]) for k in _ROWS + ("depth", "alive")}
    args = _BounceArgs(
        **{k: state[k].data_ptr() for k in ("o", "d", "beta", "salt", "depth",
                                            "alive")},
        rad=state["radiance"].data_ptr(),
        **{f"{k}_out": out[k].data_ptr() for k in ("o", "d", "beta", "depth",
                                                   "alive")},
        rad_out=out["radiance"].data_ptr(), **table_args(scene, tables),
        n=n, max_depth=spec.max_depth,
        rr_start=min(spec.rr_start, 2 ** 31 - 1), pdf_floor=spec.pdf_floor,
        **ext)
    return args, out


def _launch_fwd(scene: TorchScene, tables: dict, state: dict,
                spec: StepSpec, tri) -> dict:
    global LAUNCHES_FWD
    args, out = fwd_args(scene, tables, state, spec, tri)
    launch("srt_bounce", args, state["alive"].device)
    LAUNCHES_FWD += 1
    return dict(out, time=state["time"], salt=state["salt"])


def bounce_fwd(scene: TorchScene, flags: SceneFlags, tables: dict,
               state: dict, spec: StepSpec, tri=None) -> dict:
    """One bounce of ``state`` (see :func:`bounce_step_ref`), out of
    place: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors. On a triangle scene ``tri`` is each lane's closest triangle
    ``(t, u, v, idx)`` from :func:`kernels.intersect.intersect_tris`, which
    the kernel requires. No autograd: :class:`kernels.bounce_vjp.BounceCore`
    wraps this."""
    dev = state["alive"].device
    if dev.type == "cpu":
        with torch.no_grad():
            return bounce_step_ref(scene, flags, tables["mat"], state, spec,
                                   tri)
    if dev.type == "cuda":
        return _launch_fwd(scene, tables, state, spec, tri)
    raise ValueError(f"no bounce kernel for {dev}")
