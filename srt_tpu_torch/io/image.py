"""Image I/O (counterpart of ``srt_tpu/io/image.py``): decode textures
with Pillow, imported only when a texture file is decoded; write the
reference's ASCII PPM and 8-bit RGB PNGs (:func:`write_png`); read the
goldens, ASCII PPMs and 8-bit RGB PNGs (:func:`read_png`). PNGs are
written and read with numpy, ``zlib`` and ``struct`` alone, so the
command line and the golden tool run where Pillow is not installed."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def load_image(path: str) -> np.ndarray:
    """Decode an image to (ny, nx, 3) uint8 (alpha dropped)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def write_ppm(path: str, img01) -> None:
    """ASCII ``P3`` PPM (``Raytracing_n.cpp:886`` header, 255.99 scale)."""
    q = _quantize(img01)
    h, w, _ = q.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write("\n".join(f"{r} {g} {b}" for r, g, b in q.reshape(-1, 3)))
        f.write("\n")


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII ``P3`` PPM -> (h, w, 3) uint8."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{path}: only ASCII P3 PPMs are read")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.asarray(tokens[4:4 + w * h * 3], np.int32).reshape(h, w, 3)
    return np.clip(data * 255 // maxv, 0, 255).astype(np.uint8)


def _quantize(img01) -> np.ndarray:
    """The reference's 8-bit values of an image in [0, 1]: ``255.99 x``
    clipped to [0, 255] and truncated (``Raytracing_n.cpp:853-855``)."""
    return np.clip(255.99 * np.asarray(img01), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img01) -> None:
    """An 8-bit RGB, non-interlaced PNG of an (h, w, 3) image in [0, 1],
    with the values JAX's ``write_png`` gives (``srt_tpu/io/image.py:
    45-48``); every scanline unfiltered."""
    q = _quantize(img01)
    h, w, _ = q.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), q.reshape(h, 3 * w)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, w: int) -> np.ndarray:
    """Undo the PNG scanline filters of 3-byte pixels. A pixel depends on
    its left, upper and upper-left neighbours, so the anti-diagonals
    ``x + y = t`` are reconstructed in turn, each in one vector step."""
    rows = data.reshape(h, 1 + 3 * w)
    kind = rows[:, 0].astype(np.int32)
    if (kind > 4).any():
        raise ValueError("PNG: unknown scanline filter")
    filt = rows[:, 1:].reshape(h, w, 3).astype(np.int32)
    out = np.zeros((h + 1, w + 1, 3), np.int32)     # a zero row and column
    ys = np.arange(h)
    for t in range(h + w - 1):
        y = ys[max(0, t - w + 1):min(h, t + 1)]
        x = t - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kind[y][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB, non-interlaced PNG -> (h, w, 3) uint8 (every
    golden in ``goldens/`` is one); other PNGs raise ``ValueError``."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are "
                         f"read (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(data, h, w)


def read_image(path: str) -> np.ndarray:
    """A golden as (h, w, 3) uint8: :func:`read_png` for a PNG file,
    :func:`read_ppm` otherwise."""
    with open(path, "rb") as f:
        png = f.read(8) == _PNG_SIGNATURE
    return read_png(path) if png else read_ppm(path)
