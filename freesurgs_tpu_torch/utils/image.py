"""Image panels: depth / flow colorization, layout, labels, saving
(port of ``freesurgs_tpu/utils/image.py``).

Pure numpy, the JAX package's functions copied: a viridis-like depth
colormap, the Middlebury flow color wheel, ``hcat`` / ``vcat`` /
``add_border`` layout and ``add_label`` with a built-in 5x7 bitmap font (no
font files). ``save_image`` writes through the port's PNG codec
(``io/png.py``), not PIL.
"""

from __future__ import annotations

import numpy as np

from ..io.png import write_png

# ------------------------------------------------------------- colormaps


def colorize_depth(depth: np.ndarray, lo: float | None = None,
                   hi: float | None = None) -> np.ndarray:
    """(H, W) depth -> (3, H, W) viridis-like colorized float [0, 1]."""
    d = np.asarray(depth, np.float32)
    lo = np.percentile(d, 1) if lo is None else lo
    hi = np.percentile(d, 99) if hi is None else hi
    x = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    # compact viridis polynomial fit
    r = np.clip(0.28 + x * (-0.35 + x * (2.18 - 1.17 * x)), 0, 1)
    g = np.clip(0.0 + x * (1.4 - 0.5 * x), 0, 1)
    b = np.clip(0.33 + x * (1.34 + x * (-3.02 + 1.5 * x)), 0, 1)
    return np.stack([r, g, b])


def _flow_colorwheel():
    """Middlebury flow color wheel (55 colors)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    cols = []
    for i in range(ry):
        cols.append([255, 255 * i / ry, 0])
    for i in range(yg):
        cols.append([255 - 255 * i / yg, 255, 0])
    for i in range(gc):
        cols.append([0, 255, 255 * i / gc])
    for i in range(cb):
        cols.append([0, 255 - 255 * i / cb, 255])
    for i in range(bm):
        cols.append([255 * i / bm, 0, 255])
    for i in range(mr):
        cols.append([255, 0, 255 - 255 * i / mr])
    return np.array(cols, np.float32) / 255.0


def colorize_flow(flow: np.ndarray, max_mag: float | None = None):
    """(2, H, W) flow -> (3, H, W) Middlebury-style colorization."""
    u, v = np.asarray(flow[0]), np.asarray(flow[1])
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = max(mag.max(), 1e-6)
    u, v = u / max_mag, v / max_mag
    wheel = _flow_colorwheel()
    ncols = len(wheel)
    ang = np.arctan2(-v, -u) / np.pi
    fk = (ang + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    col = (1 - f[..., None]) * wheel[k0] + f[..., None] * wheel[k1]
    rad = np.clip(np.sqrt(u * u + v * v), 0, 1)[..., None]
    col = 1 - rad * (1 - col)
    return np.transpose(col, (2, 0, 1)).astype(np.float32)


# ---------------------------------------------------------------- layout

def _to_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    elif img.shape[0] in (1, 3) and img.ndim == 3:
        img = np.transpose(img, (1, 2, 0))
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
    return np.clip(img, 0, 1)


def hcat(*imgs, gap: int = 2, bg: float = 1.0) -> np.ndarray:
    parts = [_to_hwc(i) for i in imgs]
    h = max(p.shape[0] for p in parts)
    out = []
    for i, p in enumerate(parts):
        if p.shape[0] < h:
            pad = np.full((h - p.shape[0], p.shape[1], 3), bg, np.float32)
            p = np.concatenate([p, pad], 0)
        out.append(p)
        if i < len(parts) - 1:
            out.append(np.full((h, gap, 3), bg, np.float32))
    return np.concatenate(out, 1)


def vcat(*imgs, gap: int = 2, bg: float = 1.0) -> np.ndarray:
    parts = [_to_hwc(i) for i in imgs]
    w = max(p.shape[1] for p in parts)
    out = []
    for i, p in enumerate(parts):
        if p.shape[1] < w:
            pad = np.full((p.shape[0], w - p.shape[1], 3), bg, np.float32)
            p = np.concatenate([p, pad], 1)
        out.append(p)
        if i < len(parts) - 1:
            out.append(np.full((gap, w, 3), bg, np.float32))
    return np.concatenate(out, 0)


def add_border(img: np.ndarray, width: int = 4, value: float = 1.0):
    img = _to_hwc(img)
    h, w, _ = img.shape
    out = np.full((h + 2 * width, w + 2 * width, 3), value, np.float32)
    out[width:width + h, width:width + w] = img
    return out


# ------------------------------------------------------------ tiny font

_FONT = {
    "A": "0E 11 11 1F 11 11 11", "B": "0F 11 11 0F 11 11 0F",
    "C": "0E 11 01 01 01 11 0E", "D": "0F 11 11 11 11 11 0F",
    "E": "1F 01 01 0F 01 01 1F", "F": "1F 01 01 0F 01 01 01",
    "G": "0E 11 01 19 11 11 0E", "H": "11 11 11 1F 11 11 11",
    "I": "0E 04 04 04 04 04 0E", "L": "01 01 01 01 01 01 1F",
    "M": "11 1B 15 15 11 11 11", "N": "11 13 15 19 11 11 11",
    "O": "0E 11 11 11 11 11 0E", "P": "0F 11 11 0F 01 01 01",
    "R": "0F 11 11 0F 05 09 11", "S": "0E 11 01 0E 10 11 0E",
    "T": "1F 04 04 04 04 04 04", "U": "11 11 11 11 11 11 0E",
    "V": "11 11 11 11 11 0A 04", "W": "11 11 11 15 15 1B 11",
    "d": "10 10 1E 11 11 11 1E", "e": "00 0E 11 1F 01 11 0E",
    "g": "0E 11 11 1E 10 11 0E", "h": "01 01 0F 11 11 11 11",
    "n": "00 00 0F 11 11 11 11", "p": "00 0F 11 11 0F 01 01",
    "r": "00 00 0D 13 01 01 01", "t": "04 04 1F 04 04 04 18",
    "b": "01 01 0F 11 11 11 0F", " ": "00 00 00 00 00 00 00",
}


def add_label(img: np.ndarray, text: str, scale: int = 1):
    """Put a text strip above the image (reference ``add_label``)."""
    img = _to_hwc(img)
    strip_h = 9 * scale
    strip = np.ones((strip_h, img.shape[1], 3), np.float32)
    x = 2
    for ch in text:
        glyph = _FONT.get(ch, _FONT.get(ch.upper(), _FONT[" "]))
        rows = [int(r, 16) for r in glyph.split()]
        for gy, bits in enumerate(rows):
            for gx in range(5):
                if bits >> gx & 1:
                    y0, x0 = (1 + gy) * scale, x + gx * scale
                    if x0 + scale <= strip.shape[1]:
                        strip[y0:y0 + scale, x0:x0 + scale] = 0.0
        x += 6 * scale
    return np.concatenate([strip, img], 0)


def save_image(img: np.ndarray, path: str):
    write_png(path, (np.clip(_to_hwc(img), 0, 1) * 255).astype(np.uint8))
