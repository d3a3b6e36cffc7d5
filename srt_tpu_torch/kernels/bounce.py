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
* ``csrc/regen_bounce.cu``, hand-written CUDA for ``sm_90a``: blocks of
  ``BLOCK`` lanes, each lane's sphere sweep split over G threads (its
  shares, :func:`sweep_shares`), scene tables staged in shared memory, the
  image lookup folded in, so a bounce is one launch.

:func:`regen_bounce` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back.

What bounds the kernel on an H100: not bytes (a lane reads and writes
about 80 bytes of state per bounce) but instructions and latency. The
sphere sweep is most of a lane's operations (122 spheres on ball_scenes,
484 on random_scene), one dependent chain a lane: G threads a lane split
it, so the card holds G times the warps while it runs. The shading chain that
follows runs on one thread a lane (full warps): Beckmann VNDF sampling
runs up to nine Newton–bisection rounds of ``erfinv`` next to Oren–Nayar
and emitter lanes in the same warp; emitter and dead lanes skip it.

The wavefront is updated in place so one copy of it lives on the device.

**The per-bounce step** (kernel B2), the forward of the train step and
the bounce of the regeneration engine on triangle scenes: one bounce of an
explicit state, out of place, no regeneration and no depth cap. Replaces
``_kernel`` in its per-bounce mode (launched by ``fused_bounce``,
``bounce.py:1425-1552``). On a triangle scene it
takes each lane's closest triangle ``(t, u, v, idx)`` from kernel B3
(``kernels/intersect.py``), or from B4 on a mesh beyond the single-level
budget, and assembles the hit itself (the external-hit mode, ``has_ext``).
:func:`bounce_step_ref` is its plain version and :func:`bounce_fwd` the
wrapper; ``csrc/bounce.cu`` runs the same ``bounce()`` of
``csrc/bounce_core.cuh`` as B1.

Under the reference-parity estimator (``SceneFlags.ref_parity``) B2 takes
its ``kParity`` instantiation, which draws as
:func:`render.integrator.parity_draw` and writes the ``stale`` plane, the
heap slot after the bounce (the incoming plane is not read). B1 refuses
parity, as ``fused_regen_available`` does (``bounce.py:1614-1615``): the
regeneration engine runs it on the per-bounce loop.

On a scene whose spheres move (``SceneFlags.moving``) both kernels take
their ``kMoving`` instantiation, which puts each sphere at its centre at
the lane's time, as the JAX kernels' ``moving`` static does; the plain
versions always do (a static sphere's lerp leaves its centre as it is).

A scene with any family of :func:`scene.ir.rich_families` (the specular
branch, media, checker and noise textures, image albedo, sphere lights)
takes the kernels' ``kRich`` instantiation, which holds them all, with or
without triangles. Image albedo is multiplied into the
throughput before roulette, as JAX's XLA ``bounce_step`` does (its
kernel multiplies it in afterwards, the same thing without roulette).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from srt_tpu_torch.core import rng
from srt_tpu_torch.kernels.build import launch
from srt_tpu_torch.render.integrator import bounce_step
from srt_tpu_torch.render.intersect import RECT_NAXIS, RECT_UAXIS, RECT_VAXIS
from srt_tpu_torch.scene.ir import (LightKind, SceneFlags, TextureType,
                                    TorchScene, rich_families)

#: Kernel launches made by :func:`regen_bounce` (the CUDA path only).
LAUNCHES = 0
#: Kernel launches made by :func:`bounce_fwd` (the CUDA path only).
LAUNCHES_FWD = 0
#: of which the parity instantiation's (``kParity``)
LAUNCHES_PARITY = 0

BLOCK = 128                      # lanes per B1 block (csrc kLanes)
#: the threads a lane may take for its sphere sweep (the kernels' template
#: G); :func:`sweep_shares` picks one
SHARES = (1, 2, 4, 8)
#: threads that about fill an H100 at the bounce kernels' 56-64 registers
#: (132 SMs of 32 resident warps: 135,168)
FULL_THREADS = 1 << 17
#: spheres past which a longer sweep is worth more threads than fill the
#: card (the sweep then outweighs the shading)
LONG_SWEEP = 256
#: the threads B2's parity instantiation holds resident at its 86-92
#: registers, about half of FULL_THREADS: past them a launch takes a
#: second wave
PARITY_THREADS = FULL_THREADS // 2
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
    (R, 10), materials (M, 14), lights (L, 8), all float32; for B2's
    external hit the triangles' normals (T, 9), uv (T, 6) and materials
    (T,) int32; the media (M, 10): kind, center, radius, half extents,
    density, material (``bounce.py:1402``); and for the rich
    instantiation the lights' kinds and the Perlin tables.

    A rect light's row is its rect's first eight columns, a sphere light's
    its centre, radius and four zeros (``bounce.py:1394-1400``). The JAX
    kernel knows each row's kind statically; here the kind is a separate
    int32 array ``light_kind`` (L,), read at run time, so the lean
    instantiation's table stays as it was. A material's column 12, which
    the JAX table reserves for the noise scale, holds its texture's
    ``tex_scale``."""
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
        scene.tex_color2[tex], scene.tex_scale[tex][:, None],
        tex[:, None].to(f)], 1)
    sph_light = torch.cat([scene.sph_center0, scene.sph_radius[:, None],
                           torch.zeros((S, 4), dtype=f, device=dev)], 1)
    rows = [(rect_geo if kind == int(LightKind.RECT) else sph_light)[idx]
            for kind, idx in zip(scene.light_kind.tolist(),
                                 scene.light_index.tolist())]
    light = (torch.stack(rows) if rows
             else torch.zeros((0, 8), dtype=f, device=dev))
    if scene.atlas_u32 is not None:
        atlas = scene.atlas_u32.to(_I32)
    elif scene.atlas.shape[0]:
        atlas = scene.atlas.detach().to(f)
    else:
        atlas = torch.zeros((1,), dtype=_I32, device=dev)
    T = scene.n_tris
    med = torch.cat([scene.med_kind[:, None].to(f), scene.med_center,
                     scene.med_radius[:, None], scene.med_half,
                     scene.med_density[:, None],
                     scene.med_mat[:, None].to(f)], 1)
    return dict(sph=sph.reshape(S, 12).contiguous(),
                rect=rect.reshape(R, 10).contiguous(),
                mat=mat.contiguous(), light=light.reshape(-1, 8).contiguous(),
                tex_img=scene.tex_img.to(_I32).contiguous(),
                atlas=atlas.contiguous(),
                tri_n=scene.tri_n.reshape(T, 9).contiguous(),
                tri_uv=scene.tri_uv.reshape(T, 6).contiguous(),
                tri_mat=scene.tri_mat.to(_I32).contiguous(),
                med=med.reshape(-1, 10).contiguous(),
                light_kind=scene.light_kind.to(_I32).contiguous(),
                perlin_vec=scene.perlin_vec.to(f).contiguous(),
                perlin_perm=scene.perlin_perm.to(_I32).contiguous())


_RICH_TABLES = ("med", "light_kind", "perlin_vec", "perlin_perm")


def atlas_args(scene: TorchScene, tables: dict) -> dict:
    """The image atlas's fields of a bounce kernel's arguments: its
    pointer, its texel count ``n_atlas`` and ``atlas_f32``, set when the
    table holds three floats a texel (a scene without the packed rgb8
    twin, :func:`diff.inverse.splice` of ``"atlas"``) rather than one
    packed int. ``n_atlas`` is 0 only when the scene has no image, which
    the kernels read as white."""
    atlas = tables["atlas"]
    f32 = atlas.dtype == _F32
    packed = scene.atlas_u32 is not None
    texels = scene.atlas.shape[0] // 3 if f32 or packed else 0
    if atlas.shape[0] != (3 * texels if f32 else max(texels, 1)):
        raise ValueError(f"atlas table of {atlas.shape[0]} {atlas.dtype} "
                         f"entries for a scene atlas of "
                         f"{scene.atlas.shape[0]} floats")
    return dict(atlas=atlas.data_ptr(), n_atlas=texels, atlas_f32=int(f32))


def _check_tables(tables: dict, keys, device) -> None:
    for k in keys:
        if tables[k].device != device or not tables[k].is_contiguous():
            raise ValueError(f"table {k!r} must be contiguous on {device}")


def rich_args(scene: TorchScene, flags: SceneFlags, tables: dict) -> dict:
    """The rich instantiation's fields of a bounce kernel's arguments:
    ``rich``, the media, the lights' kinds, and the Perlin tables, which
    the kernel stages in shared memory only when a texture is noise. None
    on a lean scene (no :func:`scene.ir.rich_families`), whose kernel
    reads none of them: the structure's zeros select the lean
    instantiation. Decided on the host from ``flags``."""
    if not rich_families(scene, flags):
        return {}
    _check_tables(tables, _RICH_TABLES, scene.device)
    return dict(rich=1, med=tables["med"].data_ptr(),
                n_med=tables["med"].shape[0],
                light_kind=tables["light_kind"].data_ptr(),
                perlin_vec=tables["perlin_vec"].data_ptr(),
                perlin_perm=tables["perlin_perm"].data_ptr(),
                perlin=int(int(TextureType.NOISE) in flags.tex_kinds))


class RegenInputs:
    """What a launch reads besides the wavefront: the scene, its kernel
    tables, the camera record and the (spp, 2) Sobol jitter table.
    ``fields`` holds the launch arguments these fix for a whole render
    (pointers and counts of the tables, the instantiation), checked
    once; ``rich`` says whether B1 takes its rich instantiation."""

    def __init__(self, scene: TorchScene, flags: SceneFlags, camera,
                 jitter: torch.Tensor):
        self.scene, self.flags, self.camera = scene, flags, camera
        self.jitter = jitter.to(device=scene.device, dtype=_F32).contiguous()
        self.cam_record = camera.record().contiguous()
        self.rich = bool(rich_families(scene, flags))
        tb = self.tables = build_tables(scene, flags)
        dev = scene.device
        _check_tables(dict(tb, cam=self.cam_record, jitter=self.jitter),
                      (*tb, "cam", "jitter"), dev)
        self.fields = dict(
            **{k: tb[k].data_ptr() for k in
               ("sph", "rect", "mat", "light", "tex_img")},
            cam=self.cam_record.data_ptr(), jitter=self.jitter.data_ptr(),
            n_sph=tb["sph"].shape[0], n_rect=tb["rect"].shape[0],
            n_mat=tb["mat"].shape[0], n_light=tb["light"].shape[0],
            **atlas_args(scene, tb), moving=int(flags.moving),
            **rich_args(scene, flags, tb))


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


def _refuse_parity(flags: SceneFlags) -> None:
    if flags.ref_parity:
        raise ValueError("the regeneration kernel does not run the parity "
                         "estimator (fused_regen_available refuses it); "
                         "render_regen runs parity on the per-bounce loop")


def regen_bounce_reference(inp: RegenInputs, st: dict,
                           spec: RegenSpec) -> None:
    """The plain PyTorch version of one launch; updates ``st`` in place."""
    _refuse_parity(inp.flags)
    rows = {k: st[k].T for k in ("o", "d", "beta", "radiance")}
    state, take, pix = regenerate(
        inp, spec, dict(st, **rows, alive=st["alive"] != 0), st["cursor"])
    # B1 sweeps the spheres whatever ``flags.sphere_bvh`` says
    nxt = bounce_step(inp.scene, state, spec.max_depth, spec.rr_start,
                      inp.flags._replace(sphere_bvh=False), spec.pdf_floor)
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


def sweep_shares(n_lanes: int, n_sph: int,
                 threads: int = FULL_THREADS) -> int:
    """G, the threads each lane's sphere sweep is split over in B1 and B2:
    the most of :data:`SHARES` with ``n_lanes * G`` within ``threads``
    (scaled up by ``n_sph / LONG_SWEEP`` past :data:`LONG_SWEEP` spheres)
    and a sphere for each share. The winner, and so every output, is the
    same for every G; this rule follows the times ``chip_smoke.py``
    measures at each G (PERF.md §6)."""
    want = threads * max(1.0, n_sph / LONG_SWEEP)
    g = 1
    while g * 2 in SHARES and n_lanes * g * 2 <= want and n_sph >= g * 2:
        g *= 2
    return g


def count_dead(alive: torch.Tensor) -> torch.Tensor:
    """Dead lanes per block of ``BLOCK`` lanes, as the kernel counts them."""
    pad = -alive.shape[0] % BLOCK
    dead = torch.nn.functional.pad((alive == 0).to(_I32), (0, pad))
    return dead.view(-1, BLOCK).sum(1, dtype=_I32)


#: the rich instantiation's fields, the same tail of ``RegenArgs`` and
#: ``BounceArgs`` (``csrc/regen_bounce.cu``, ``csrc/bounce.cu``)
_RICH_FIELDS = [("rich", ctypes.c_int), ("light_kind", ctypes.c_void_p),
                ("perlin_vec", ctypes.c_void_p),
                ("perlin_perm", ctypes.c_void_p), ("perlin", ctypes.c_int)]


class _Args(ctypes.Structure):
    """``RegenArgs`` of ``csrc/regen_bounce.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "time", "beta", "rad", "salt", "depth", "alive", "pix",
        "fin", "dead_in", "dead_out", "cursor_in", "cursor_out", "sph",
        "rect", "mat", "light", "tex_img", "atlas", "cam", "jitter")]
        + [(name, ctypes.c_int) for name in (
            "n", "n_sph", "n_rect", "n_mat", "n_light", "n_atlas",
            "atlas_f32", "width",
            "height", "spp", "total_work", "max_depth", "rr_start")]
        + [("pdf_floor", ctypes.c_float), ("seed", ctypes.c_uint32),
           ("moving", ctypes.c_int), ("med", ctypes.c_void_p),
           ("n_med", ctypes.c_int)]
        + _RICH_FIELDS + [("shares", ctypes.c_int)])


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


def regen_args(inp: RegenInputs, st: dict, spec: RegenSpec) -> _Args:
    """The checked arguments of one ``csrc/regen_bounce.cu`` launch on
    the wavefront ``st`` (its ``dead``/``cursor`` in, ``dead_next``/
    ``cursor_next`` out)."""
    _refuse_parity(inp.flags)
    n = st["alive"].shape[0]
    dev = st["alive"].device
    _check_state(st, n, dev)
    if inp.scene.device != dev:
        raise ValueError(f"the scene's tables are on {inp.scene.device}, "
                         f"the wavefront on {dev}")
    if spec.total_work >= 2 ** 31 - n:
        raise ValueError("work queue beyond int32 ranks")
    ptr = {k: st[k].data_ptr() for k in
           ("o", "d", "time", "beta", "salt", "depth", "alive", "pix",
            "fin")}
    return _Args(
        **ptr, rad=st["radiance"].data_ptr(),
        dead_in=st["dead"].data_ptr(), dead_out=st["dead_next"].data_ptr(),
        cursor_in=st["cursor"].data_ptr(),
        cursor_out=st["cursor_next"].data_ptr(), **inp.fields, n=n,
        width=spec.width, height=spec.height, spp=spec.spp,
        total_work=spec.total_work, max_depth=spec.max_depth,
        rr_start=min(spec.rr_start, 2 ** 31 - 1), pdf_floor=spec.pdf_floor,
        seed=spec.seed & rng.MASK32, shares=sweep_shares(n, inp.fields[
            "n_sph"]))


def _launch(inp: RegenInputs, st: dict, spec: RegenSpec) -> None:
    """Launch ``csrc/regen_bounce.cu`` on the current stream."""
    global LAUNCHES
    launch("srt_regen_bounce", regen_args(inp, st, spec), st["alive"].device)
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
        tex_color2=mat[:, 9:12], tex_scale=scene.tex_scale[tex],
        tex_img=scene.tex_img[tex])


def bounce_step_ref(scene: TorchScene, flags: SceneFlags,
                    mat: torch.Tensor, state: dict, spec: StepSpec,
                    tri=None, sph=None) -> dict:
    """The plain version of B2: ``render.integrator.bounce_step`` on the
    material view of ``mat`` (the image emission of the environment dome is
    evaluated inside its emission term, as the kernel does). ``state``:
    ``o d beta radiance`` (N, 3) float32, ``time`` (N,), ``salt`` (N,)
    int32 bit patterns, ``depth`` (N,) int32, ``alive`` (N,) bool. ``tri``:
    on a triangle scene, each lane's closest triangle ``(t, u, v, idx)``
    as kernel B3 gives it (the plain walk computes it when None). ``sph``:
    each lane's winning sphere ``(t, idx)`` as kernel B6 gives it, whose
    hit is then assembled differentiably; the plain sweep runs when None.
    Returns the next state with ``depth + 1`` and ``alive`` not yet capped
    by depth, and under parity the ``stale`` plane (an incoming one is not
    read)."""
    return bounce_step(material_view(scene, mat), state, spec.max_depth,
                       spec.rr_start, flags, spec.pdf_floor, tri, sph)


_ROWS = ("o", "d", "beta", "radiance")
_TABLES = ("sph", "rect", "mat", "light", "tex_img", "atlas")


class _BounceArgs(ctypes.Structure):
    """``BounceArgs`` of ``csrc/bounce.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "beta", "rad", "salt", "depth", "alive", "o_out", "d_out",
        "beta_out", "rad_out", "depth_out", "alive_out", *_TABLES)]
        + [(name, ctypes.c_int) for name in (
            "n", "n_sph", "n_rect", "n_mat", "n_light", "n_atlas",
            "atlas_f32", "max_depth", "rr_start")]
        + [("pdf_floor", ctypes.c_float)]
        + [(name, ctypes.c_void_p) for name in (
            "tri_t", "tri_u", "tri_v", "tri_idx", "tri_n", "tri_uv",
            "tri_mat")]
        + [("n_tris", ctypes.c_int), ("med", ctypes.c_void_p),
           ("n_med", ctypes.c_int), ("time", ctypes.c_void_p),
           ("moving", ctypes.c_int)]
        + _RICH_FIELDS
        + [("stale_out", ctypes.c_void_p), ("parity", ctypes.c_int),
           ("parity_no_stale", ctypes.c_int), ("shares", ctypes.c_int)])


def check_state(state: dict, tables: dict, device) -> int:
    """Raise unless ``state`` and ``tables`` are what the train kernels
    read on ``device``; returns the lane count."""
    n = state["alive"].shape[0]
    want = {**{k: (torch.float32, (n, 3)) for k in _ROWS},
            "time": (torch.float32, (n,)),
            "salt": (_I32, (n,)), "depth": (_I32, (n,)),
            "alive": (torch.bool, (n,))}
    for k, (dtype, shape) in want.items():
        t = state[k]
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"state {k!r}: want contiguous {dtype} {shape} "
                             f"on {device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    _check_tables(tables, _TABLES, device)
    if tables["mat"].dtype != torch.float32:
        raise ValueError("table 'mat' must be float32")
    return n


def table_args(scene: TorchScene, tables: dict) -> dict:
    """The table pointers and counts of a train kernel's arguments."""
    return dict(**{k: tables[k].data_ptr() for k in _TABLES if k != "atlas"},
                n_sph=tables["sph"].shape[0], n_rect=tables["rect"].shape[0],
                n_mat=tables["mat"].shape[0],
                n_light=tables["light"].shape[0], **atlas_args(scene, tables))


def _tri_args(scene: TorchScene, tables: dict, tri, n: int, dev) -> dict:
    """The external-hit fields of B2's arguments: none on a scene without
    triangles, else B3's or B4's ``(t, u, v, idx)`` and the triangle
    tables."""
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
    _check_tables(tables, ("tri_n", "tri_uv", "tri_mat"), dev)
    return dict(tri_t=tri[0].data_ptr(), tri_u=tri[1].data_ptr(),
                tri_v=tri[2].data_ptr(), tri_idx=idx.data_ptr(),
                **{k: tables[k].data_ptr() for k in ("tri_n", "tri_uv",
                                                     "tri_mat")},
                n_tris=scene.n_tris)


def fwd_args(scene: TorchScene, flags: SceneFlags, tables: dict,
             state: dict, spec: StepSpec,
             tri=None) -> tuple[_BounceArgs, dict]:
    """The checked arguments of one ``csrc/bounce.cu`` launch and the
    output tensors it writes; ``tri`` as in :func:`bounce_fwd`.
    ``flags`` picks the instantiation (``kMoving``, ``kRich``,
    ``kParity``)."""
    dev = state["alive"].device
    n = check_state(state, tables, dev)
    ext = _tri_args(scene, tables, tri, n, dev)
    out = {k: torch.empty_like(state[k]) for k in _ROWS + ("depth", "alive")}
    parity = {}
    if flags.ref_parity:
        out["stale"] = torch.empty((n,), dtype=_F32, device=dev)
        parity = dict(stale_out=out["stale"].data_ptr(), parity=1,
                      parity_no_stale=int(flags.parity_no_stale))
    args = _BounceArgs(
        **{k: state[k].data_ptr() for k in ("o", "d", "beta", "salt", "depth",
                                            "alive")},
        rad=state["radiance"].data_ptr(),
        **{f"{k}_out": out[k].data_ptr() for k in ("o", "d", "beta", "depth",
                                                   "alive")},
        rad_out=out["radiance"].data_ptr(), **table_args(scene, tables),
        n=n, max_depth=spec.max_depth,
        rr_start=min(spec.rr_start, 2 ** 31 - 1), pdf_floor=spec.pdf_floor,
        **ext, time=state["time"].data_ptr(), moving=int(flags.moving),
        **rich_args(scene, flags, tables), **parity,
        shares=sweep_shares(n, tables["sph"].shape[0], PARITY_THREADS
                            if flags.ref_parity else FULL_THREADS))
    return args, out


def _launch_fwd(scene: TorchScene, flags: SceneFlags, tables: dict,
                state: dict, spec: StepSpec, tri) -> dict:
    global LAUNCHES_FWD, LAUNCHES_PARITY
    args, out = fwd_args(scene, flags, tables, state, spec, tri)
    launch("srt_bounce", args, state["alive"].device)
    LAUNCHES_FWD += 1
    LAUNCHES_PARITY += int(flags.ref_parity)
    return dict(out, time=state["time"], salt=state["salt"])


def bounce_fwd(scene: TorchScene, flags: SceneFlags, tables: dict,
               state: dict, spec: StepSpec, tri=None) -> dict:
    """One bounce of ``state`` (see :func:`bounce_step_ref`), out of
    place: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors. On a triangle scene ``tri`` is each lane's closest triangle
    ``(t, u, v, idx)`` from :func:`kernels.intersect.intersect_tris`, which
    the kernel requires. Under parity the next state carries ``stale``.
    No autograd: :class:`kernels.bounce_vjp.BounceCore` and
    :class:`kernels.bounce_vjp.BounceHybrid` wrap this."""
    dev = state["alive"].device
    if dev.type == "cpu":
        # B2 sweeps the spheres whatever ``flags.sphere_bvh`` says
        with torch.no_grad():
            return bounce_step_ref(scene, flags._replace(sphere_bvh=False),
                                   tables["mat"], state, spec, tri)
    if dev.type == "cuda":
        return _launch_fwd(scene, flags, tables, state, spec, tri)
    raise ValueError(f"no bounce kernel for {dev}")
