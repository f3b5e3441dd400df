"""A small PNG codec for 8-bit RGB images, on the standard library's zlib.

The port reads and writes its frames and panels with this module instead of
PIL (``freesurgs_tpu/data/scared.py`` and ``utils/image.py`` use PIL there),
so it needs no imaging package on the card's machine.

- ``write_png``: 8-bit RGB, non-interlaced, one IDAT at zlib level 6. Each
  row takes the filter (None, Sub, Up, Average, Paeth) whose filtered bytes
  have the least sum of absolute values as signed bytes, libpng's
  heuristic; a tie goes to the lower type. Filters encode from the raw
  bytes only, so all five are computed for the whole image at once.
- ``read_png``: checks every chunk's CRC, joins the IDATs, inflates, and
  undoes the filters with ``fsio_png_unfilter`` in the port's C++ library
  (``io/native.py``): each byte depends on its decoded left neighbour, a
  serial loop. It accepts 8-bit RGB, non-interlaced images (what SCARED
  frames are) and raises a ``ValueError`` naming the colour type, bit
  depth or interlace of anything else.
- ``unfilter_plain``: the same un-filter in numpy, a row loop with Average
  and Paeth byte by byte; the tests hold the native one to it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {0: "greyscale", 2: "RGB", 3: "palette",
                4: "greyscale + alpha", 6: "RGBA"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


# |v| of each byte v read as a signed byte: the per-byte filter cost
_ABS_SIGNED = np.abs(np.arange(256, dtype=np.uint8).view(np.int8)
                     .astype(np.int16)).astype(np.uint8)


def filter_candidates(img: np.ndarray) -> np.ndarray:
    """(5, H, W * 3) uint8: every row of an (H, W, 3) uint8 image filtered
    with each of the five filter types (None, Sub, Up, Average, Paeth), in
    wrapping uint8 arithmetic as PNG defines them."""
    h, w, ch = img.shape
    x = np.ascontiguousarray(img).reshape(h, w * ch)
    a = np.zeros_like(x)
    a[:, ch:] = x[:, :-ch]                      # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                              # up
    c = np.zeros_like(x)
    c[1:, ch:] = x[:-1, :-ch]                   # up-left
    avg = (a >> 1) + (b >> 1) + (a & b & 1)     # floor((a + b) / 2)
    a16, b16, c16 = (v.astype(np.int16) for v in (a, b, c))
    pa = np.abs(b16 - c16)                      # |p - a|, p = a + b - c
    pb = np.abs(a16 - c16)                      # |p - b|
    pc = np.abs(a16 + b16 - 2 * c16)            # |p - c|
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out = np.empty((5, h, w * ch), np.uint8)
    out[0] = x
    for k, pred in enumerate((a, b, avg, paeth), start=1):
        np.subtract(x, pred, out=out[k])
    return out


def filter_rows(img: np.ndarray) -> np.ndarray:
    """(H, 1 + W * 3) uint8: each row's chosen filter type and its filtered
    bytes (the stream ``write_png`` deflates)."""
    cands = filter_candidates(img)
    cost = _ABS_SIGNED[cands].sum(axis=2, dtype=np.uint32)
    ftype = np.argmin(cost, axis=0)             # first of equal costs
    rows = cands[ftype, np.arange(img.shape[0])]
    return np.concatenate([ftype.astype(np.uint8)[:, None], rows], axis=1)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = zlib.compress(filter_rows(img).tobytes(), 6)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
                + _chunk(b"IEND", b""))


def read_chunks(path: str) -> tuple[tuple, bytes]:
    """(IHDR fields, the inflated image stream) of a PNG file, with every
    chunk's CRC checked."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 8 > len(buf):
            raise ValueError(f"{path}: truncated before IEND")
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        crc_at = pos + 8 + n
        if len(data) != n or crc_at + 4 > len(buf):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", buf[crc_at:crc_at + 4])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        pos = crc_at + 4
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    return ihdr, zlib.decompress(b"".join(idat))


def _check_rgb8(path: str, ihdr: tuple) -> tuple[int, int]:
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype != 2 or depth != 8 or interlace != 0 or comp or filt:
        raise ValueError(
            f"{path}: colour type {ctype} "
            f"({_COLOR_TYPES.get(ctype, 'unknown')}), bit depth {depth}, "
            f"interlace {interlace} ({'Adam7' if interlace else 'none'}); "
            "only 8-bit RGB without interlace is read")
    return h, w


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an 8-bit RGB, non-interlaced PNG."""
    ihdr, raw = read_chunks(path)
    h, w = _check_rgb8(path, ihdr)
    return native.png_unfilter(np.frombuffer(raw, np.uint8), h, w,
                               3).reshape(h, w, 3)


def unfilter_plain(raw: np.ndarray, h: int, w: int,
                   bpp: int = 3) -> np.ndarray:
    """``native.png_unfilter`` in numpy: (h, w * bpp) uint8 from h rows of
    a filter-type byte and w * bpp filtered bytes."""
    rows = np.asarray(raw, np.uint8).reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        ftype, src = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = src
        elif ftype == 1:                        # a running sum per channel
            cur = np.cumsum(src.reshape(w, bpp), axis=0).ravel() % 256
        elif ftype == 2:
            cur = (src + prior) % 256
        elif ftype in (3, 4):
            s, up, cur = src.tolist(), prior.tolist(), [0] * (w * bpp)
            for i in range(w * bpp):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    b, c = up[i], (up[i - bpp] if i >= bpp else 0)
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (s[i] + pred) & 255
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype} "
                             "(0-4 expected)")
        out[y] = cur
        prior = cur
    return out
