"""ctypes bindings for the port's libfsio (``csrc/fsio.cpp``; port of
``freesurgs_tpu/io/native.py``).

The library is built with g++ at first use into
``_build/fsio-<source hash>.so`` (a temporary file, then ``os.replace``,
so parallel processes do not race). A failed build raises with the
compiler's output: the PNG decoder needs the library, so there is no path
without it.

Entry points: the FSC1 dataset cache (``CacheWriter`` / ``CacheReader``,
``write_sequence_cache`` / ``read_sequence_cache``, byte-compatible with
the JAX package's), the PLY codec (``ply_write`` / ``ply_read``) and the
PNG row un-filter (``png_unfilter``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fsio.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"

_DTYPES = {0: np.float32, 1: np.uint8, 2: np.int32}
_DTYPE_IDS = {np.dtype(np.float32): 0, np.dtype(np.uint8): 1,
              np.dtype(np.int32): 2}
_LIB: list = []                       # the loaded library, once built


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"fsio-{digest}.so"


def build() -> Path:
    """Compile ``csrc/fsio.cpp`` unless this source's library exists."""
    dst = lib_path()
    if dst.exists():
        return dst
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-shared",
           "-fPIC", "-pthread", "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {cmd[0]} to build {SOURCE.name}: "
                           f"{e}") from e
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed for {SOURCE.name}:\n"
                           f"{res.stderr}")
    os.replace(tmp, dst)
    return dst


def _lib():
    if _LIB:
        return _LIB[0]
    lib = ctypes.CDLL(str(build()))
    u64, u32, vp = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
    p64, p32 = ctypes.POINTER(u64), ctypes.POINTER(u32)
    pf = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "fsio_writer_open": (vp, [ctypes.c_char_p]),
        "fsio_writer_add": (ctypes.c_int, [vp, ctypes.c_char_p, vp, u64, u32,
                                           u32, p64]),
        "fsio_writer_close": (ctypes.c_int, [vp]),
        "fsio_open": (vp, [ctypes.c_char_p, ctypes.c_int]),
        "fsio_close": (None, [vp]),
        "fsio_stat": (ctypes.c_int, [vp, ctypes.c_char_p, p64, p32, p32,
                                     p64]),
        "fsio_read": (ctypes.c_int, [vp, ctypes.c_char_p, vp]),
        "fsio_prefetch": (ctypes.c_int, [vp, ctypes.c_char_p]),
        "fsio_ply_write": (ctypes.c_int, [ctypes.c_char_p, pf, u64, u32,
                                          ctypes.c_char_p]),
        "fsio_ply_header": (ctypes.c_long, [ctypes.c_char_p, p64, p32,
                                            ctypes.c_char_p, u64]),
        "fsio_ply_read": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_long, pf,
                                         u64, u32]),
        "fsio_png_unfilter": (ctypes.c_int, [vp, vp, u64, u64, u32]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _LIB.append(lib)
    return lib


def available() -> bool:
    """Whether the native library builds and loads here: a probe only; no
    path of the port falls back when it does not (each raises)."""
    try:
        _lib()
        return True
    except Exception:
        return False


# ------------------------------------------------------------ PNG un-filter

def png_unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """(h, w * bpp) uint8 image bytes from the inflated PNG stream ``raw``
    (h rows of a filter-type byte then w * bpp filtered bytes)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, {h} rows of "
                         f"{1 + w * bpp} expected")
    out = np.empty((h, w * bpp), np.uint8)
    rc = _lib().fsio_png_unfilter(raw.ctypes.data, out.ctypes.data, h, w,
                                  bpp)
    if rc != 0:
        row = -1 - rc
        raise ValueError(f"PNG row {row} has filter type "
                         f"{int(raw[row * (1 + w * bpp)])} (0-4 expected)")
    return out


# ------------------------------------------------------------ cache writer

class CacheWriter:
    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.fsio_writer_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def add(self, name: str, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        if arr.ndim > 4 or len(name.encode()) > 47:
            raise ValueError(f"{name}: at most 4 dims and a 47-byte name")
        shape = (ctypes.c_uint64 * 4)(*([*arr.shape, 0, 0, 0, 0][:4]))
        rc = self._lib.fsio_writer_add(
            self._h, name.encode(), arr.ctypes.data, arr.nbytes,
            _DTYPE_IDS[arr.dtype], arr.ndim, shape)
        if rc != 0:
            raise OSError(f"write failed for {name}")

    def close(self):
        if self._h:
            self._lib.fsio_writer_close(self._h)
            self._h = None


class CacheReader:
    """mmap-backed reader with background page prefetching."""

    def __init__(self, path: str, prefetch_threads: int = 2):
        self._lib = _lib()
        self._h = self._lib.fsio_open(path.encode(), prefetch_threads)
        if not self._h:
            raise OSError(f"cannot open cache {path}")

    def stat(self, name: str):
        shape = (ctypes.c_uint64 * 4)()
        ndim, dtype = ctypes.c_uint32(), ctypes.c_uint32()
        nbytes = ctypes.c_uint64()
        rc = self._lib.fsio_stat(self._h, name.encode(), shape,
                                 ctypes.byref(ndim), ctypes.byref(dtype),
                                 ctypes.byref(nbytes))
        if rc != 0:
            raise KeyError(name)
        return (tuple(shape[i] for i in range(ndim.value)),
                _DTYPES[dtype.value], nbytes.value)

    def read(self, name: str) -> np.ndarray:
        shape, dtype, nbytes = self.stat(name)
        out = np.empty(shape, dtype)
        if out.nbytes != nbytes:
            raise OSError(f"cache entry {name}: {nbytes} bytes for shape "
                          f"{shape}")
        if self._lib.fsio_read(self._h, name.encode(), out.ctypes.data):
            raise KeyError(name)
        return out

    def prefetch(self, name: str):
        self._lib.fsio_prefetch(self._h, name.encode())

    def close(self):
        if self._h:
            self._lib.fsio_close(self._h)
            self._h = None


# --------------------------------------------------------------- PLY codec

def ply_write(path: str, data: np.ndarray, names: list[str]):
    data = np.ascontiguousarray(data, np.float32)
    n, p = data.shape
    if len(names) != p:
        raise ValueError(f"{len(names)} names for {p} columns")
    rc = _lib().fsio_ply_write(
        path.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, p, "\n".join(names).encode())
    if rc != 0:
        raise OSError(f"ply write failed: {path}")


def ply_read(path: str):
    """Returns (data (N, P) f32, names list)."""
    lib = _lib()
    n, p = ctypes.c_uint64(), ctypes.c_uint32()
    buf = ctypes.create_string_buffer(1 << 16)
    hdr = lib.fsio_ply_header(path.encode(), ctypes.byref(n),
                              ctypes.byref(p), buf, len(buf))
    if hdr < 0:
        raise OSError(f"bad ply header: {path}")
    out = np.empty((n.value, p.value), np.float32)
    rc = lib.fsio_ply_read(path.encode(), hdr,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           n.value, p.value)
    if rc != 0:
        raise OSError(f"ply read failed: {path}")
    return out, buf.value.decode().split("\n")


# ------------------------------------------------- sequence cache helpers

def write_sequence_cache(path: str, seq):
    """Pack a VideoSequence into the FSC1 cache: per-frame entries
    (``color/``, ``monodep/``, ``flowfw/``, ``flowbw/`` + 6-digit index) and
    the metadata ``load_scared`` needs (``meta/num_frames``, ``meta/hw``,
    f32 ``meta/intrinsic``, ``meta/i_train`` / ``meta/i_test``,
    ``meta/boundaries``, ``meta/gtpose_keys`` + f32 ``gtpose/<key>``,
    ``meta/image_names``), in the JAX package's order and formats."""
    w = CacheWriter(path)
    try:
        t = seq.colors.shape[0]
        for i in range(t):
            w.add(f"color/{i:06d}", np.asarray(seq.colors[i], np.float32))
            w.add(f"monodep/{i:06d}", np.asarray(seq.monodeps[i],
                                                 np.float32))
            if i < t - 1:
                w.add(f"flowfw/{i:06d}", np.asarray(seq.flows_fw[i],
                                                    np.float32))
                if len(seq.flows_bw) > i:
                    w.add(f"flowbw/{i:06d}", np.asarray(seq.flows_bw[i],
                                                        np.float32))
        w.add("meta/num_frames", np.asarray([t], np.int32))
        w.add("meta/intrinsic",
              np.asarray(seq.cam.intrinsic_matrix(), np.float32))
        w.add("meta/hw", np.asarray([seq.cam.height, seq.cam.width],
                                    np.int32))
        w.add("meta/i_train", np.asarray(seq.i_train, np.int32))
        w.add("meta/i_test", np.asarray(seq.i_test, np.int32))
        if seq.boundaries:
            w.add("meta/boundaries", np.asarray(seq.boundaries, np.int32))
        if seq.gt_poses:
            w.add("meta/gtpose_keys", np.frombuffer(
                "\n".join(seq.gt_poses).encode(), np.uint8).copy())
            for key, poses in seq.gt_poses.items():
                w.add(f"gtpose/{key}", np.asarray(poses, np.float32))
        if seq.image_names:
            w.add("meta/image_names", np.frombuffer(
                "\n".join(seq.image_names).encode(), np.uint8).copy())
    finally:
        w.close()


def read_sequence_cache(path: str, prefetch_threads: int = 2):
    """A ``data/scared.VideoSequence`` from an FSC1 cache (mmap reads with
    one-frame-ahead prefetch)."""
    from ..core.camera import Camera
    from ..data.scared import VideoSequence

    r = CacheReader(path, prefetch_threads)
    try:
        t = int(r.read("meta/num_frames")[0])
        h, w_ = (int(x) for x in r.read("meta/hw"))
        K = r.read("meta/intrinsic").astype(np.float64)

        def read_stack(prefix, count):
            out = []
            for i in range(count):
                if i + 1 < count:
                    r.prefetch(f"{prefix}/{i + 1:06d}")
                out.append(r.read(f"{prefix}/{i:06d}"))
            return (np.stack(out) if out
                    else np.zeros((0, 2, h, w_), np.float32))

        colors = read_stack("color", t)
        monodeps = read_stack("monodep", t)
        flows_fw = read_stack("flowfw", t - 1)
        try:
            flows_bw = read_stack("flowbw", t - 1)
        except KeyError:
            flows_bw = -flows_fw
        try:
            boundaries = r.read("meta/boundaries").tolist()
        except KeyError:
            boundaries = [0]
        try:
            keys = r.read("meta/gtpose_keys").tobytes().decode().split("\n")
        except KeyError:
            keys = []
        gt_poses = {k: r.read(f"gtpose/{k}").astype(np.float64)
                    for k in keys}
        try:
            image_names = (r.read("meta/image_names").tobytes().decode()
                           .split("\n"))
        except KeyError:
            image_names = [f"frame_{i:06d}" for i in range(t)]
        return VideoSequence(
            cam=Camera.from_K(K, height=h, width=w_),
            colors=colors, flows_fw=flows_fw, flows_bw=flows_bw,
            monodeps=monodeps, gt_poses=gt_poses, boundaries=boundaries,
            i_train=r.read("meta/i_train"), i_test=r.read("meta/i_test"),
            image_names=image_names)
    finally:
        r.close()
