"""The port's image files and image operations (`data/imageio.py`, no
cv2) against cv2, which rnr_tpu uses.

PNG and Radiance HDR round trips are bit-exact both ways (cv2 writes,
the port reads; the port writes, cv2 reads).  `resize` follows cv2's
INTER_AREA and INTER_LINEAR: float32 within 1e-5 (products and sums in
another order), uint8 INTER_AREA off by 1 on at most 1e-5 of the pixels,
uint8 INTER_LINEAR off by at most 1 on at most 6% of the pixels (cv2's vector path rounds its fixed-point sums differently from
its scalar formula, which the port follows).  `fill_poly` is cv2's
fillPoly (lines, then an even-odd fill) on at most 0.2% of the pixels
differing, `dilate` is exact.  What the JPEG and EXR readers do not
decode raises, naming the feature (the formats themselves are held to
cv2 in test_torch_image_formats.py)."""

import os
import struct

import numpy as np
import pytest

from rnr_tpu_torch.data import imageio as io

cv2 = pytest.importorskip("cv2")


PNG_KINDS = [((37, 41), np.uint8), ((37, 41, 3), np.uint8),
             ((37, 41, 4), np.uint8), ((37, 41), np.uint16),
             ((37, 41, 3), np.uint16), ((37, 41, 4), np.uint16)]


@pytest.mark.parametrize("shape,dtype", PNG_KINDS)
def test_png_round_trips_with_cv2(tmp_path, shape, dtype):
    """cv2 -> port and port -> cv2, gray / RGB / RGBA at 8 and 16 bits;
    the cv2 file carries its own row filters (smooth rows included)."""
    rng = np.random.default_rng(len(shape) * 10 + np.dtype(dtype).itemsize)
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    a[:10] = (np.arange(41) * 3)[None, :, None][..., :a.shape[2]
                                               ] if a.ndim == 3 else 0
    cv_path, port_path = str(tmp_path / "c.png"), str(tmp_path / "p.png")
    cv2.imwrite(cv_path, a)
    rgb = io.bgr_to_rgb(a) if a.ndim == 3 else a
    got = io.read_png(cv_path)
    assert got.dtype == dtype and np.array_equal(got, rgb)
    io.write_png(port_path, rgb)
    assert np.array_equal(cv2.imread(port_path, cv2.IMREAD_UNCHANGED), a)
    assert np.array_equal(io.read_image(port_path), rgb)


def test_png_reads_every_filter_type(tmp_path):
    """A photo-like 8-bit image, which libpng's adaptive filtering writes
    with the Sub, Up, Average and Paeth filters."""
    yy, xx = np.mgrid[0:96, 0:80]
    a = np.stack([(xx * 3 + yy) % 256, (yy * 2) % 256,
                  ((xx * yy) // 7) % 256], -1).astype(np.uint8)
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, a)
    assert np.array_equal(io.read_png(path), io.bgr_to_rgb(a))


@pytest.mark.parametrize("w", [37, 5, 300])
def test_hdr_round_trips_with_cv2(tmp_path, w):
    """RGBE: cv2's file read by the port, the port's read by cv2 (run-
    length scanlines from 8 pixels wide, flat below), to the same floats;
    zero and denormal pixels included."""
    rng = np.random.default_rng(w)
    img = (rng.uniform(0, 3, (20, w, 3))
           * rng.uniform(0, 1, (20, w, 1))).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = 1e-40
    cv_path, port_path = str(tmp_path / "c.hdr"), str(tmp_path / "p.hdr")
    cv2.imwrite(cv_path, img[..., ::-1].copy())
    ref = cv2.imread(cv_path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    ref = ref[..., ::-1]
    assert np.array_equal(io.read_hdr(cv_path), ref)
    io.write_hdr(port_path, img)
    back = cv2.imread(port_path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    assert np.array_equal(back[..., ::-1], ref)
    assert np.array_equal(io.read_hdr(port_path), ref)


RESIZES = [((32, 64, 3), (3200, 1600), "area"),
           ((256, 512, 3), (3200, 1600), "area"),
           ((640, 480, 3), (512, 512), "area"),
           ((600, 600, 3), (512, 512), "area"),
           ((1024, 1024, 3), (512, 512), "area"),
           ((64, 64), (512, 512), "linear"),
           ((512, 512, 3), (64, 48), "linear")]


@pytest.mark.parametrize("shape,size,mode", RESIZES)
def test_resize_float_matches_cv2(shape, size, mode):
    """INTER_AREA (shrinking at integer and fractional factors, and
    growing, where it takes linear taps of its own) and INTER_LINEAR on
    float32 images, within 1e-5."""
    a = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(
        np.float32)
    flag = cv2.INTER_AREA if mode == "area" else cv2.INTER_LINEAR
    ref = cv2.resize(a, size, interpolation=flag)
    got = io.resize(a, size, mode)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert float(np.abs(got - ref).max()) <= 1e-5


@pytest.mark.parametrize("shape,size", [((1024, 1024, 3), (512, 512)),
                                        ((700, 700, 3), (512, 512)),
                                        ((300, 400, 3), (64, 64))])
def test_resize_uint8_area_matches_cv2(shape, size):
    """train_rnr's texture image: uint8 INTER_AREA shrinking, exact at
    integer factors (halves rounded up, as cv2's integer sums), off by 1
    on at most 1e-5 of the pixels at fractional ones (measured 1.3e-6)."""
    a = np.random.default_rng(shape[0]).integers(0, 256, shape).astype(
        np.uint8)
    ref = cv2.resize(a, size, interpolation=cv2.INTER_AREA)
    diff = np.abs(ref.astype(int) - io.resize(a, size, "area"))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5


@pytest.mark.parametrize("size", [(512, 512), (64, 64), (100, 75)])
def test_resize_uint8_linear_matches_cv2(size):
    """The stitcher's mask path: uint8 INTER_LINEAR, off by at most 1 on
    at most 6% of the pixels (measured 4.5% at 64 -> 512)."""
    rng = np.random.default_rng(size[0])
    m = (rng.uniform(size=(64, 64)) > 0.7).astype(np.uint8) * 255
    src = m if size != (64, 64) else cv2.resize(m, (512, 512))
    ref = cv2.resize(src, size)
    got = io.resize(src, size, "linear")
    diff = np.abs(ref.astype(int) - got)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.06


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_poly_and_dilate_match_cv2(seed):
    """Random overlapping triangles (the even-odd rule shows where they
    overlap): fillPoly on at most 0.2% of the pixels differing (measured
    0-0.1%), then the 17 x 17 dilation exact on cv2's mask."""
    rng = np.random.default_rng(seed)
    tris = rng.integers(0, 64, (200, 3, 2)).astype(np.int32)
    ref = np.zeros((64, 64), np.uint8)
    cv2.fillPoly(ref, list(tris), 255)
    got = io.fill_poly(np.zeros((64, 64), np.uint8), tris, 255)
    assert (got != ref).mean() <= 0.002
    assert np.array_equal(io.dilate(ref, 17),
                          cv2.dilate(ref, np.ones((17, 17), np.uint8)))


def test_fill_poly_mesh_silhouette_matches_cv2():
    """The stitcher's use: a UV sphere's faces projected into a 64^2 view
    (front and back faces overlap), the mask after fill, dilation at 512
    and resize back: background pixels (mask == 0) equal to cv2's on all
    but 0.5% of the pixels."""
    from rnr_tpu_torch.drivers.stitch_lp import object_mask
    from rnr_tpu_torch.synthetic import sphere_mesh
    mesh = sphere_mesh(12, 16)
    ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    v = mesh.v
    for k, a in enumerate(ang[:4]):
        c, s = np.cos(a), np.sin(a)
        x = v[:, 0] * c - v[:, 2] * s
        z = v[:, 0] * s + v[:, 2] * c + 2.0
        px = np.stack([x / z * 77 + 32, v[:, 1] / z * 77 + 32]).astype(
            np.int32)
        got = object_mask(px, mesh.f_v_idx, 64, 64) == 0
        ref = np.zeros((64, 64), np.uint8)
        cv2.fillPoly(ref, list(px.T[mesh.f_v_idx]), 255)
        ref = cv2.resize(cv2.dilate(cv2.resize(ref, (512, 512)),
                                    np.ones((17, 17), np.uint8)), (64, 64))
        assert (got != (ref == 0)).mean() <= 0.005, k


def _exr_attr(name, typ, value):
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def _exr_head(compression, flags):
    """An OpenEXR header from the spec: magic, version 2 with `flags`,
    the required attributes, one HALF channel per R, G, B."""
    chans = b"".join(c + b"\0" + struct.pack("<iB3xii", 1, 0, 1, 1)
                     for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<4i", 0, 0, 15, 15)
    return (struct.pack("<iI", 20000630, 2 | flags)
            + _exr_attr("channels", "chlist", chans)
            + _exr_attr("compression", "compression", bytes([compression]))
            + _exr_attr("dataWindow", "box2i", box)
            + _exr_attr("displayWindow", "box2i", box)
            + _exr_attr("lineOrder", "lineOrder", b"\0")
            + _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1))
            + _exr_attr("screenWindowCenter", "v2f", bytes(8))
            + _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1))
            + b"\0" + bytes(16 * 8))


def _jpeg_head(sof, precision):
    """SOI, then a frame header from the spec: marker 0xFF `sof`, 8 x 8,
    one component; and EOI."""
    body = struct.pack(">BHHB", precision, 8, 8, 1) + b"\x01\x11\x00"
    return (b"\xff\xd8" + bytes([0xFF, sof]) + struct.pack(">H", 2 + len(body))
            + body + b"\xff\xd9")


@pytest.mark.parametrize("name,data,what", [
    ("piz.exr", _exr_head(4, 0), "PIZ compression"),
    ("tiled.exr", _exr_head(0, 0x200), "tiled"),
    ("sof9.jpg", _jpeg_head(0xC9, 8), r"arithmetic coding \(SOF9\)"),
    ("twelve.JPEG", _jpeg_head(0xC1, 12), "12-bit precision")])
def test_unsupported_formats_raise_naming_the_format(tmp_path, name, data,
                                                     what):
    """Files the readers do not decode, built from the specs' header
    bytes: a PIZ and a tiled EXR, an arithmetic-coded and a 12-bit
    JPEG."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=what):
        io.read_image(path)


def test_mat_images_read_through_scipy(tmp_path):
    import scipy.io
    img = np.random.default_rng(0).uniform(0, 1, (6, 7, 3)).astype(
        np.float32)
    path = os.path.join(tmp_path, "v.mat")
    scipy.io.savemat(path, {"img": img})
    assert np.array_equal(io.read_image(path), img)
