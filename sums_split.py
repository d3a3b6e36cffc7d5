"""Where the film sum's and the material sum's time goes, on one NVIDIA GPU.

Usage, from the root of a checkout (or with a checkout as the working
directory, the script given by its path)::

    python3 sums_split.py [--out FILE.json]

It measures the package found in the working directory. Each of
``srt_tpu_torch/csrc/film_sum.cu`` and ``segment_sum.cu`` is built several
times into a library of its own, each build a variant that stops after a
phase of the kernel (an early ``return`` put in at a line of the source,
:data:`FILM_STOPS` and :data:`SEGMENT_STOPS`; a source with no such line
skips that variant). Every variant is timed on the inputs the main paths
give the kernel: the film on the ball_scenes render's flush 40, a
cornell_boxes flush 40 and the 1,024-spp render's flushes 1 and 40
(``chip_smoke.py:record_flush``), the material sum on B5's outputs at the
regen-scan train state's 16,384 lanes and the scan train step's 262,144
(``chip_smoke.py:material_sum_inputs``). Three timers
(``chip_smoke.py:three_timers``): CUDA events over a Python loop of bare
launches (``loop``, which reads the host's issue rate below about 0.01
ms), events over the replay of a CUDA graph of the same launches
(``graph``, or the capture's error), and ``torch.profiler``'s device rows
(``device``). The differences between consecutive variants are the
phases' shares. Also
timed: each wrapper as the paths call it, and ``index_add_`` on the same
inputs. A variant's early return leaves the film's chains or the material
sum's counter as they are, so each variant gets scratch of its own.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: (variant, alternatives), in the order the kernel runs: each
#: alternative a list of (lines of the source, what replaces them), the
#: first that applies to the source is built; "full" is the source as it
#: is. The alternatives fit the film's first design (its pixels' records
#: chained and walked after the barrier) and the present one.
_TOP = "    const FilmSumArgs a) {"
_BARRIER = "  grid_barrier(a.barrier);"
FILM_STOPS = (
    ("empty, plain launch", [[
        (_TOP, _TOP + "\n  return;"),
        ("  return (int)cudaLaunchCooperativeKernel(",
         "  return (int)cudaLaunchKernel(")]]),
    ("empty", [[(_TOP, _TOP + "\n  return;")]]),
    ("loads and counts", [
        [("    s_pix[t_id] = p;", "    s_pix[t_id] = p;\n    continue;"),
         (_BARRIER, "  return;")],
        [("    const unsigned same = __match_any_sync(kAll, fin ? p : -1);",
          "    continue;\n"
          "    const unsigned same = __match_any_sync(kAll, fin ? p : -1);"),
         (_BARRIER, "  return;")]]),
    ("phase 1", [[(_BARRIER, "  return;")]]),
    ("phase 1, barrier", [[(_BARRIER, _BARRIER + "\n  return;")]]),
    ("full", [[]]),
)

#: the same for ``segment_sum.cu`` (its first design, with the last block
#: folding every block's sums, then the present one)
_SEG_TOP = "    const SegmentSumArgs a, const int chunks) {"
_ARRIVE = ("  if (threadIdx.x == 0) s_last = atomicAdd(a.done, 1u) == "
           "gridDim.x - 1;")
_ARRIVE17 = "  const unsigned blocks = gridDim.x;"
SEGMENT_STOPS = (
    ("empty", [[(_SEG_TOP, _SEG_TOP + "\n  return;")]]),
    ("zero, block sums", [
        [("  for (int ch = 0; ch < chunks; ++ch) {",
          "  for (int ch = 0; ch < 0; ++ch) {"), (_ARRIVE, "  return;")],
        [("    if (q >= chunks) break;", "    break;"),
         (_ARRIVE17, "  return;\n" + _ARRIVE17)]]),
    ("zero, chunks, block sums", [[(_ARRIVE, "  return;")],
                                  [(_ARRIVE17, "  return;\n" + _ARRIVE17)]]),
    ("all but the last block's pass", [
        [("  if (!s_last) return;",
          "  if (!s_last) return;\n  if (threadIdx.x == 0) "
          "atomicExch(a.done, 0u);\n  return;")],
        [("  if (f < 0) return;", "  return;")]]),
    ("full", [[]]),
)

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def patched(src: str, alternatives) -> str | None:
    """``src`` with the first alternative whose lines are each in it
    exactly once applied, or None."""
    for edits in alternatives:
        if all(src.count(line + "\n") == 1 for line, _ in edits):
            for line, new in edits:
                src = src.replace(line + "\n", new + "\n")
            return src
    return None


def build_variants(name: str, stops, work: str) -> dict:
    """Each variant of ``csrc/<name>.cu`` built into a library of its own,
    all ``nvcc`` runs at once: {variant: CDLL, or the reason it has none}."""
    from srt_tpu_torch.kernels import build

    with open(os.path.join(build._PKG, "csrc", f"{name}.cu")) as f:
        src = f.read()
    procs, out = {}, {}
    for i, (variant, edits) in enumerate(stops):
        text = patched(src, edits)
        if text is None:
            out[variant] = "no such line in this source"
            continue
        cu = os.path.join(work, f"{name}_{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[variant] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for variant, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {variant}: nvcc failed\n{report}")
        lib = ctypes.CDLL(so)
        for entry in ("srt_film_sum", "srt_segment_sum"):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = [ctypes.c_void_p,
                                                ctypes.c_void_p]
                getattr(lib, entry).restype = ctypes.c_int
        out[variant] = lib
    return out


def timers(fn) -> dict:
    import chip_smoke as cs
    return cs.three_timers(fn)


def bare(lib, entry: str, args):
    """One bare launch of ``entry`` of ``lib`` on ``args``, on the current
    stream (read at each call, so that a graph's capture takes it)."""
    import torch
    fn, addr = getattr(lib, entry), ctypes.addressof(args)

    def one():
        if fn(addr, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"{entry} launch failed ({args})")
    return one


def film_split(flushes: dict, variants: dict) -> dict:
    import torch

    import chip_smoke as cs
    from srt_tpu_torch.kernels import film as kfilm

    out = {}
    for label, rec in flushes.items():
        acc, n_vert, n_nan, pix, rad, fin, alive = rec
        n = pix.shape[0]
        row = {}
        for variant, lib in variants.items():
            if isinstance(lib, str):
                row[variant] = lib
                continue
            film = kfilm.Film(acc.shape[1], n, acc.device)
            film.acc.copy_(acc)
            args = film.kernel_args(pix, rad, fin, alive)
            row[variant] = timers(bare(lib, "srt_film_sum", args))
            if variant == "full":      # its sums, as a check of the build
                film = kfilm.Film(acc.shape[1], n, acc.device)
                for t, src in zip((film.acc, film.n_vertices,
                                   film.nan_scrubbed), (acc, n_vert, n_nan)):
                    t.copy_(src)
                bare(lib, "srt_film_sum", film.kernel_args(pix, rad, fin,
                                                          alive))()
                plain = [t.cpu().clone() for t in (acc, n_vert, n_nan)]
                kfilm.film_sum_reference(*plain, pix.cpu(), rad.cpu(),
                                         fin.cpu(), alive.cpu())
                row["full_equal_to_plain"] = cs.same_tensor_bits(
                    film.acc, plain[0])
        film = kfilm.Film(acc.shape[1], n, acc.device)
        film.acc.copy_(acc)
        row["wrapper"] = timers(lambda: film.flush(pix, rad, fin, alive))
        done = fin != 0
        contrib = torch.where(done, rad, 0.0).nan_to_num(0.0, float("inf"),
                                                         float("-inf"))
        g = acc.clone()
        row["index_add_"] = timers(lambda: g.index_add_(1, pix, contrib))
        row["shape"] = (f"{n} lanes, {int(done.sum())} finished into "
                        f"{int(torch.unique(pix[done]).numel())} pixels")
        out[label] = row
        log(f"[split] film {label}: {json.dumps(row)}")
    return out


def segment_split(inputs: dict, variants: dict) -> dict:
    import torch

    from srt_tpu_torch.kernels import segment as kseg

    out = {}
    for lanes, (g_mat, wmat, n_mat) in inputs.items():
        row = {}
        for variant, lib in variants.items():
            if isinstance(lib, str):
                row[variant] = lib
                continue
            held = kseg.kernel_args(g_mat, wmat, n_mat)   # args, out[, part]
            done = torch.zeros((1,), dtype=torch.int32, device=g_mat.device)
            held[0].done = done.data_ptr()   # a counter of its own a variant
            row[variant] = timers(bare(lib, "srt_segment_sum", held[0]))
            del held, done
        row["wrapper"] = timers(lambda: kseg.material_sum(g_mat, wmat, n_mat))
        per = torch.zeros((n_mat, g_mat.shape[1]), device=g_mat.device)
        idx = wmat.long()
        row["index_add_"] = timers(lambda: per.index_add_(0, idx, g_mat))
        out[str(lanes)] = row
        log(f"[split] segment_sum {lanes} lanes: {json.dumps(row)}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sums_split: no CUDA device")
    sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests"), ROOT]

    import chip_smoke as cs
    from srt_tpu_torch import RenderConfig, get_scene, render_regen
    from srt_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[split] {smi}; the package in {os.getcwd()}")
    dev = torch.device("cuda", 0)
    t0 = time.time()
    build.load_library()
    log(f"[split] build {time.time() - t0:.1f} s")
    work = tempfile.mkdtemp(prefix="sums_split_")
    film_v = build_variants("film_sum", FILM_STOPS, work)
    seg_v = build_variants("segment_sum", SEGMENT_STOPS, work)
    scene, cam, _ = get_scene("ball_scenes", device=dev)
    tri, tri_cam, _ = get_scene("cornell_boxes", device=dev)
    cfg = RenderConfig(**cs.MAIN)
    deep = RenderConfig(**dict(cs.MAIN, spp=cs.DEEP_SPP))
    flushes = {
        "ball_scenes flush 40": cs.record_flush(
            lambda: render_regen(scene, cam, cfg), cs.FLUSH_AT),
        "cornell_boxes flush 40": cs.record_flush(
            lambda: render_regen(tri, tri_cam, cfg), cs.FLUSH_AT),
        "1,024 spp flush 1": cs.record_flush(
            lambda: render_regen(scene, cam, deep), 1),
        "1,024 spp flush 40": cs.record_flush(
            lambda: render_regen(scene, cam, deep), cs.FLUSH_AT)}
    inputs = {n: cs.material_sum_inputs(scene, cam, dev, n)
              for n in cs.SUM_LANES}
    res = {"device": smi, "film_sum": film_split(flushes, film_v),
           "segment_sum": segment_split(inputs, seg_v)}
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
