"""The port's I/O against the JAX package and the imaging libraries: the PNG
codec (``io/png.py``: decoded bitwise as PIL and cv2 decode, encoded so PIL
decodes it bitwise, the native un-filter bitwise its numpy version), the
FSC1 cache (``io/native.py``: either package reads the other's file, and
both write the same bytes), the PLY export (the JAX function's bytes),
cameras.json (1e-6), the panel helpers of ``utils/image.py`` (bitwise) and
``MetricsLogger.log_image`` (the JAX path). Inputs are made from seeds
with numpy.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from freesurgs_tpu.io import cameras_json as jcj
from freesurgs_tpu.io import native as jnative
from freesurgs_tpu.io import ply as jply
from freesurgs_tpu.models.gaussians import GaussianField as JField
from freesurgs_tpu.utils import image as jimg
from freesurgs_tpu.utils.logging import MetricsLogger as JLogger
from freesurgs_tpu_torch.convert import field_from_numpy
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.io import cameras_json as tcj
from freesurgs_tpu_torch.io import native as tnative
from freesurgs_tpu_torch.io import ply as tply
from freesurgs_tpu_torch.io import png
from freesurgs_tpu_torch.utils import image as timg
from freesurgs_tpu_torch.utils.logging import MetricsLogger as TLogger

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

SIZES = [(1, 1), (37, 53), (64, 80)]


def _image(h, w, kind, seed=0):
    """uint8 (h, w, 3): uniform noise, or a smooth ramp with a little noise
    (where the predicting filters win)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3, yy * 2, xx + yy], -1).astype(np.float64)
    return ((base + rng.integers(0, 4, (h, w, 3))) % 256).astype(np.uint8)


@pytest.mark.parametrize("writer", ["pil", "cv2"])
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_read_png_matches_pil(tmp_path, writer, hw, kind):
    img = _image(*hw, kind)
    path = str(tmp_path / "a.png")
    if writer == "pil":
        Image.fromarray(img).save(path)
    else:
        assert cv2.imwrite(path, img[..., ::-1])
    ref = np.asarray(Image.open(path))
    out = png.read_png(path)
    assert out.dtype == np.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_write_png_decodes_in_pil(tmp_path, hw, kind):
    img = _image(*hw, kind, seed=1)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    pil = Image.open(path)
    assert pil.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(pil), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def _filtered(img, ftype):
    """Hand-built PNG stream: every row filtered with ``ftype`` by the PNG
    definition, written byte by byte."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int64)
    rows = []
    for y in range(h):
        row = [ftype]
        for i in range(w * 3):
            a = x[y, i - 3] if i >= 3 else 0
            b = x[y - 1, i] if y else 0
            c = x[y - 1, i - 3] if y and i >= 3 else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row.append((x[y, i] - pred) % 256)
        rows.append(row)
    return np.asarray(rows, np.uint8)


def _png_bytes(raw: bytes, w, h, depth=8, ctype=2, interlace=0) -> bytes:
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(raw))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_unfilter_each_filter_type(tmp_path, ftype):
    """One filter type on every row: the native un-filter, its numpy
    version and PIL give the image back, bitwise."""
    img = _image(13, 17, "smooth", seed=ftype)
    raw = _filtered(img, ftype)
    h, w = img.shape[:2]
    nat = tnative.png_unfilter(raw.ravel(), h, w, 3)
    plain = png.unfilter_plain(raw.ravel(), h, w)
    np.testing.assert_array_equal(nat, plain)
    np.testing.assert_array_equal(nat.reshape(h, w, 3), img)
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(raw.tobytes(), w, h))
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_filter_candidates_match_definition(kind):
    """The vectorised uint8 filters equal the byte-by-byte definition for
    all five types, wrap-around included."""
    img = _image(9, 11, kind, seed=4)
    cands = png.filter_candidates(img)
    for f in range(5):
        np.testing.assert_array_equal(cands[f], _filtered(img, f)[:, 1:],
                                      err_msg=str(f))


def test_writer_picks_least_abs_sum_filter():
    """Each row's filter is the one whose filtered bytes, as signed bytes,
    have the least absolute sum (the first on ties)."""
    img = _image(24, 31, "smooth", seed=3)
    img[5:9] = 0                                   # flat rows: ties
    rows = png.filter_rows(img)
    cands = [_filtered(img, f) for f in range(5)]
    for y in range(img.shape[0]):
        costs = [np.abs(c[y, 1:].view(np.int8).astype(int)).sum()
                 for c in cands]
        assert rows[y, 0] == int(np.argmin(costs)), (y, costs)
        np.testing.assert_array_equal(rows[y], cands[rows[y, 0]][y])


@pytest.mark.parametrize("mode,match", [
    ("RGBA", "colour type 6"), ("L", "colour type 0"),
    ("P", "colour type 3"), ("I;16", "bit depth 16"),
    ("interlaced", "interlace 1")])
def test_read_png_refuses_other_formats(tmp_path, mode, match):
    path = tmp_path / "x.png"
    img = _image(6, 7, "noise")
    if mode == "interlaced":
        path.write_bytes(_png_bytes(b"", 7, 6, interlace=1))
    elif mode == "I;16":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(path)
    else:
        Image.fromarray(img).convert(mode).save(path)
    with pytest.raises(ValueError, match=match):
        png.read_png(str(path))


def test_read_png_checks_crc(tmp_path):
    path = tmp_path / "a.png"
    png.write_png(str(path), _image(4, 5, "noise"))
    buf = bytearray(path.read_bytes())
    buf[-20] ^= 1                                  # inside the IDAT data
    path.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(path))


# ------------------------------------------------------------- FSC1 cache

def _sequence(seed=0, t=3, h=8, w=10):
    from freesurgs_tpu_torch.data.scared import VideoSequence
    rng = np.random.default_rng(seed)
    return VideoSequence(
        cam=TCam(height=h, width=w, fx=11.5, fy=12.25, cx=5.0, cy=4.0),
        colors=rng.uniform(size=(t, 3, h, w)).astype(np.float32),
        flows_fw=rng.normal(size=(t - 1, 2, h, w)).astype(np.float32),
        flows_bw=rng.normal(size=(t - 1, 2, h, w)).astype(np.float32),
        monodeps=rng.uniform(0.5, 1.5, (t, h, w)).astype(np.float32),
        gt_poses={"k0": rng.normal(size=(2, 4, 4)),
                  "k1": rng.normal(size=(1, 4, 4))},
        boundaries=[0, 2, 3], i_train=np.asarray([0, 2]),
        i_test=np.asarray([1]),
        image_names=[f"d1_k{i // 2}_frame_{i:06d}.png" for i in range(t)])


def _same_sequence(a, b):
    for k in ("colors", "flows_fw", "flows_bw", "monodeps", "i_train",
              "i_test"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)
    assert list(a.boundaries) == list(b.boundaries)
    assert list(a.image_names) == list(b.image_names)
    assert list(a.gt_poses) == list(b.gt_poses)
    for k in a.gt_poses:
        np.testing.assert_array_equal(a.gt_poses[k], b.gt_poses[k])
    np.testing.assert_array_equal(a.cam.intrinsic_matrix(),
                                  b.cam.intrinsic_matrix())
    assert (a.cam.height, a.cam.width) == (b.cam.height, b.cam.width)


def test_fsc1_cache_cross_read(tmp_path):
    """Both packages write the same bytes for one sequence, and each reads
    the other's cache back to the same arrays (poses and intrinsics as the
    f32 the format stores)."""
    seq = _sequence()
    tp, jp = str(tmp_path / "t.fsc"), str(tmp_path / "j.fsc")
    tnative.write_sequence_cache(tp, seq)
    jnative.write_sequence_cache(jp, seq)
    assert (tmp_path / "t.fsc").read_bytes() == (tmp_path / "j.fsc") \
        .read_bytes()
    from_j = tnative.read_sequence_cache(jp)
    from_t = jnative.read_sequence_cache(tp)
    _same_sequence(from_j, from_t)
    for k in seq.gt_poses:
        np.testing.assert_array_equal(
            from_j.gt_poses[k], seq.gt_poses[k].astype(np.float32))
    np.testing.assert_array_equal(from_j.colors, seq.colors)
    assert from_j.cam == seq.cam


def test_cache_reader_refuses_truncated_file(tmp_path):
    p = tmp_path / "t.fsc"
    tnative.write_sequence_cache(str(p), _sequence())
    p.write_bytes(p.read_bytes()[:-100])           # the index cut short
    with pytest.raises(OSError):
        tnative.CacheReader(str(p))


def test_native_ply_codec_interop(tmp_path):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(30, 5)).astype(np.float32)
    names = ["x", "y", "z", "opacity", "scale_0"]
    tnative.ply_write(str(tmp_path / "t.ply"), data, names)
    jnative.ply_write(str(tmp_path / "j.ply"), data, names)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply") \
        .read_bytes()
    out, names2 = tnative.ply_read(str(tmp_path / "j.ply"))
    assert names2 == names
    np.testing.assert_array_equal(out, data)


# -------------------------------------------------------------------- PLY

def _field_arrays(n_active, cap=24, sh_degree=2, seed=0):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    active = np.zeros(cap, bool)
    active[rng.permutation(cap)[:n_active]] = True
    return dict(
        means=rng.normal(size=(cap, 3)).astype(np.float32),
        quats=rng.normal(size=(cap, 4)).astype(np.float32),
        log_scales=rng.normal(size=(cap, 3)).astype(np.float32),
        logit_opacity=rng.normal(size=cap).astype(np.float32),
        sh_dc=rng.normal(size=(cap, 1, 3)).astype(np.float32),
        sh_rest=rng.normal(size=(cap, k - 1, 3)).astype(np.float32),
        active=active, max_radii2d=np.zeros(cap, np.float32),
        grad_accum=np.zeros(cap, np.float32),
        grad_denom=np.zeros(cap, np.float32),
        scene_radius=np.asarray(1.5, np.float32))


@pytest.mark.parametrize("n_active", [0, 1, 17])
def test_field_to_ply_bytes_match_jax(tmp_path, n_active):
    import jax.numpy as jnp
    arrays = _field_arrays(n_active)
    jf = JField(**{k: jnp.asarray(v) for k, v in arrays.items()},
                max_sh_degree=2)
    tf = field_from_numpy(arrays, device="cpu", max_sh_degree=2)
    jply.field_to_ply(jf, str(tmp_path / "j.ply"))
    tply.field_to_ply(tf, str(tmp_path / "t.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply") \
        .read_bytes()


@pytest.mark.parametrize("capacity", [None, 32])
def test_ply_to_field_matches_jax(tmp_path, capacity):
    arrays = _field_arrays(17)
    path = str(tmp_path / "t.ply")
    tply.field_to_ply(field_from_numpy(arrays, device="cpu",
                                       max_sh_degree=2), path)
    jf = jply.ply_to_field(path, max_sh_degree=2, capacity=capacity)
    tf = tply.ply_to_field(path, max_sh_degree=2, capacity=capacity,
                           device="cpu")
    for k in ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
              "sh_rest", "active", "max_radii2d", "grad_accum",
              "grad_denom", "scene_radius"):
        np.testing.assert_array_equal(np.asarray(getattr(jf, k)),
                                      getattr(tf, k).numpy(), err_msg=k)
    act = arrays["active"]
    np.testing.assert_array_equal(tf.means[:17].numpy(),
                                  arrays["means"][act])
    cols = tply.load_ply_arrays(path)
    assert set(cols) == set(jply.load_ply_arrays(path))


def test_cameras_json_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    from freesurgs_tpu.core.transforms import build_w2c
    w2cs = np.asarray(build_w2c(q.astype(np.float32),
                                rng.normal(size=(3, 3)).astype(np.float32)))
    tcam = TCam(height=32, width=48, fx=50.0, fy=51.0, cx=24.0, cy=16.0)
    from freesurgs_tpu.core.camera import Camera as JCam
    jcam = JCam(height=32, width=48, fx=50.0, fy=51.0, cx=24.0, cy=16.0)
    names = ["a.png", "b.png", "c.png"]
    for nm in (names, None):
        j = jcj.cameras_to_json(w2cs, jcam, nm)
        t = tcj.cameras_to_json(torch.from_numpy(w2cs.copy()), tcam, nm)
        assert len(j) == len(t) == 3
        for a, b in zip(j, t):
            for k in ("id", "img_name", "width", "height", "fx", "fy"):
                assert a[k] == b[k], k
            np.testing.assert_allclose(a["position"], b["position"],
                                       atol=1e-6)
            np.testing.assert_allclose(a["rotation"], b["rotation"],
                                       atol=1e-6)


# ------------------------------------------------------------- utils/image

def test_image_helpers_match_jax():
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.5, 2.0, (9, 14)).astype(np.float32)
    flow = rng.normal(size=(2, 9, 14)).astype(np.float32) * 3
    chw = rng.uniform(size=(3, 9, 14)).astype(np.float32)
    small = rng.uniform(size=(5, 7)).astype(np.float32)
    cases = [
        (lambda m: m.colorize_depth(depth)),
        (lambda m: m.colorize_depth(depth, lo=0.7, hi=1.5)),
        (lambda m: m.colorize_flow(flow)),
        (lambda m: m.colorize_flow(flow, max_mag=2.0)),
        (lambda m: m.hcat(chw, small, depth, gap=3)),
        (lambda m: m.vcat(chw, small, bg=0.0)),
        (lambda m: m.add_border(chw, width=2, value=0.5)),
        (lambda m: m.add_label(chw, "render gt depth", scale=2)),
        (lambda m: m.add_label(small, "monodep flow XYZ")),
    ]
    for i, fn in enumerate(cases):
        a, b = fn(jimg), fn(timg)
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


def test_log_image_writes_the_jax_path(tmp_path):
    rng = np.random.default_rng(6)
    panel = rng.uniform(-0.1, 1.1, (11, 23, 3)).astype(np.float32)
    jl, tl = JLogger(str(tmp_path / "j")), TLogger(str(tmp_path / "t"))
    for lg in (jl, tl):
        lg.log_image("compare_f0003", panel, 42)
        lg.log_image("plain", panel)
        lg.close()
    for name in ("compare_f0003_0000042.png", "plain.png"):
        j = np.asarray(Image.open(tmp_path / "j" / "panels" / name))
        t = png.read_png(str(tmp_path / "t" / "panels" / name))
        np.testing.assert_array_equal(j, t)
