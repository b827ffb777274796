"""The image formats the port reads where rnr_tpu reads them through cv2:
JPEG, BMP and OpenEXR (`data/jpeg.py`, `data/imageio.py`), on the CPU.

- JPEG: the port's `load_img` bit-equal to rnr_tpu's (cv2, libjpeg-turbo)
  for every sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, gray), baseline
  and progressive, with and without restart intervals, at 1 x 1, 7 x 13
  and 257 x 383, quality 50 and 95 (files by cv2), and on PIL's files;
  the EXIF orientations 1-8 under both cv2 flags; the committed fixtures
  of tests/data/images against their committed cv2 decodes.
- BMP: 24-bit, 32-bit (cv2's BI_BITFIELDS and PIL's BI_RGB), 8-bit gray
  and colour palettes, top-down, against rnr_tpu's `load_img`.
- OpenEXR: a NONE file assembled here from the spec read exactly (mixed
  HALF / FLOAT, alpha, a dataWindow off the origin; Y alone in UINT);
  files of NONE, RLE, ZIPS and ZIP at HALF and FLOAT, written from the
  spec here, read exactly; `write_exr`'s header against the spec's
  attributes and its files read back exactly; each compression,
  tiled, deep and multi-part file the port does not read refused by
  name.
- stitch_lp at its default `.exr` views against rnr_tpu's stitch_lp
  (whose cv2 here has no OpenEXR: its `cv2.imread` returns the arrays
  the `.exr` files hold), under test_stitch_lp_matches_rnr_tpu's
  tolerances; train_rnr's reader of the port's `0.exr`.
cv2 and PIL only make and check files here; the port imports neither.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import scipy.io

from rnr_tpu_torch.data import imageio as io
from rnr_tpu_torch.data.dataset import load_img

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "images")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def smooth(h, w, seed):
    """BGR content: smooth ramps and sinusoids with mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w, 2)
    img = np.stack([128 + 100 * np.sin(6 * xx + 3 * yy),
                    128 + 100 * np.cos(15 * yy * xx), 255 * xx * yy], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def jload(path):
    from rnr_tpu.data.dataset import load_img as rnr_tpu_load_img
    return rnr_tpu_load_img(path)


def assert_load_img_equal(path):
    want, got = jload(path), load_img(path)
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[0].shape == want[0].shape and np.array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


# ------------------------------------------------------------------ JPEG


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", [*SAMPLING, "gray"])
def test_jpeg_load_img_bit_equal_to_rnr_tpu(tmp_path, sampling, progressive,
                                            restart):
    """Sizes 1 x 1, 7 x 13 (partial MCUs, chroma 2 or fewer samples wide)
    and 257 x 383 at quality 50 and 95."""
    for (h, w) in ((1, 1), (7, 13), (257, 383)):
        for q in (50, 95):
            img = smooth(h, w, h + w + q)
            flags = [cv2.IMWRITE_JPEG_QUALITY, q,
                     cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                     cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
            if sampling == "gray":
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            else:
                flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          SAMPLING[sampling]]
            path = str(tmp_path / f"v_{h}_{q}.jpg")
            assert cv2.imwrite(path, img, flags)
            with open(path, "rb") as f:
                data = f.read()
            assert (b"\xff\xc2" in data) == progressive
            assert (b"\xff\xdd" in data) == bool(restart)
            assert_load_img_equal(path)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_pil_files_bit_equal_to_cv2(tmp_path, subsampling,
                                         progressive):
    """PIL's writer (JFIF, optimized Huffman tables) at 4:4:4, 4:2:2 and
    4:2:0, and the port's upper-case `.JPEG` suffix."""
    img = smooth(61, 90, subsampling)[..., ::-1]
    path = str(tmp_path / "v.JPEG")
    Image.fromarray(np.ascontiguousarray(img)).save(
        path, "JPEG", quality=85, subsampling=subsampling,
        progressive=progressive, optimize=True)
    assert_load_img_equal(path)
    assert np.array_equal(io.read_image(path), np.asarray(Image.open(path)))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_under_both_flags(tmp_path, orientation):
    """cv2's default read turns the image by its EXIF orientation, the
    unchanged read does not; gray reads as three channels by default."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    for name, img in (("c", smooth(20, 40, orientation)[..., ::-1]),
                      ("g", smooth(20, 40, orientation)[..., 0])):
        path = str(tmp_path / f"{name}.jpg")
        Image.fromarray(np.ascontiguousarray(img)).save(
            path, "JPEG", quality=90, exif=exif.tobytes())
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
            want = cv2.imread(path, flag)
            want = io.bgr_to_rgb(want) if want.ndim == 3 else want
            got = io.read_image(path, flag)
            assert got.shape == want.shape and np.array_equal(got, want)
        turned = orientation >= 5
        assert io.read_image(path, io.IMREAD_COLOR).shape == (
            (40, 20, 3) if turned else (20, 40, 3))
        assert io.read_image(path).shape[:2] == (20, 40)


FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES)
                       if f.endswith((".jpg", ".bmp")))


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_committed_fixtures_decode_to_their_cv2_png(name):
    """chip_smoke.py's fixtures: the port's decode (both flags) equal to
    the committed cv2 decodes, which this cv2 also reproduces."""
    path = os.path.join(FIXTURES, name)
    stem = os.path.splitext(path)[0]
    want = io.read_png(stem + ".png")
    assert np.array_equal(io.read_image(path), want)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert np.array_equal(io.bgr_to_rgb(ref) if ref.ndim == 3 else ref, want)
    color = (io.read_png(stem + ".color.png")
             if os.path.isfile(stem + ".color.png") else want)
    assert np.array_equal(io.read_image(path, io.IMREAD_COLOR), color)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_gray_alpha_png_reads_as_cv2(tmp_path, dtype):
    """A gray + alpha PNG: cv2's unchanged read gives BGRA (the gray in
    each colour), its colour read the gray three times; rnr_tpu's
    load_img the gray in RGB, over 255."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    la = rng.integers(0, np.iinfo(dtype).max, (9, 14, 2)).astype(dtype)
    path = str(tmp_path / "la.png")
    io.write_png(path, la)
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert np.array_equal(io.read_image(path, flag),
                              io.bgr_to_rgb(cv2.imread(path, flag)))
    assert_load_img_equal(path)


def test_hdr_color_read_as_cv2(tmp_path):
    """cv2's default read of a Radiance HDR: round(255 x) saturated to
    8 bits, as `--tex_fp` takes it."""
    img = np.random.default_rng(3).uniform(0, 1.5, (21, 34, 3)).astype(
        np.float32)
    path = str(tmp_path / "t.hdr")
    cv2.imwrite(path, img)
    want = io.bgr_to_rgb(cv2.imread(path, cv2.IMREAD_COLOR))
    got = io.read_image(path, io.IMREAD_COLOR)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert (want == 255).any() and (want < 255).any()


# ------------------------------------------------------------------- BMP


def _top_down(src, dst):
    """A bottom-up BMP rewritten top-down (rows reversed, height < 0)."""
    with open(src, "rb") as f:
        d = bytearray(f.read())
    off = struct.unpack("<I", d[10:14])[0]
    w, h = struct.unpack("<ii", d[18:26])
    bpp = struct.unpack("<H", d[28:30])[0]
    stride = (w * bpp // 8 + 3) & ~3
    rows = [d[off + i * stride:off + (i + 1) * stride] for i in range(h)]
    d[off:off + h * stride] = b"".join(rows[::-1])
    d[22:26] = struct.pack("<i", -h)
    with open(dst, "wb") as f:
        f.write(d)


@pytest.mark.parametrize("kind", ["24", "32_bitfields", "32_rgb", "8_gray",
                                  "8_palette", "24_top_down"])
def test_bmp_load_img_bit_equal_to_rnr_tpu(tmp_path, kind):
    img = smooth(23, 37, len(kind))
    path = str(tmp_path / "v.bmp")
    if kind in ("24", "24_top_down"):
        cv2.imwrite(path, img)
        if kind == "24_top_down":
            _top_down(path, path)
    elif kind == "32_bitfields":
        cv2.imwrite(path, np.concatenate([img, img[..., :1]], -1))
    elif kind == "32_rgb":
        Image.fromarray(np.concatenate([img, img[..., :1]], -1),
                        "RGBA").save(path)
    elif kind == "8_gray":
        cv2.imwrite(path, img[..., 0])
    else:
        Image.fromarray(img).quantize(20).save(path)
    with open(path, "rb") as f:
        head = f.read(34)
    bpp, comp = struct.unpack("<HI", head[28:34])
    assert (bpp, comp) == {"24": (24, 0), "24_top_down": (24, 0),
                           "32_bitfields": (32, 3), "32_rgb": (32, 0),
                           "8_gray": (8, 0), "8_palette": (8, 0)}[kind]
    assert_load_img_equal(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = io.read_bmp(path)
    assert np.array_equal(got, io.bgr_to_rgb(want) if want.ndim == 3
                          else want)


# ------------------------------------------------------------------- EXR

EXR_PTYPE = {np.dtype("<u4"): 0, np.dtype("<f2"): 1, np.dtype("<f4"): 2}


def _attr(name, typ, value):
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def spec_header(channels, box, compression, flags=0, extra=b""):
    """The spec's magic, version and the eight required attributes;
    channels [(name, pixel type)] as listed."""
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i", t)
                      + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
                      for n, t in channels) + b"\0"
    return (struct.pack("<iI", 20000630, 2 | flags)
            + _attr("channels", "chlist", chlist)
            + _attr("compression", "compression", bytes([compression]))
            + _attr("dataWindow", "box2i", struct.pack("<4i", *box))
            + _attr("displayWindow", "box2i",
                    struct.pack("<4i", -4, -4, box[2] + 9, box[3] + 9))
            + _attr("lineOrder", "lineOrder", b"\0")
            + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
            + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
            + extra + b"\0")


EXR_CODES = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1), "ZIP": (3, 16)}


def _predict(raw: bytes) -> bytes:
    """The spec's ZIP / RLE pre-pass: even bytes then odd bytes, each
    stored as its difference from the one before plus 128."""
    t = np.frombuffer(raw, np.uint8)
    t = np.concatenate([t[0::2], t[1::2]])
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + 128
    return d.tobytes()


def _rle(raw: bytes) -> bytes:
    """OpenEXR's rleCompress, byte by byte: a run of 3 or more equal
    bytes (at most 128) as (count - 1, byte), else a literal group of at
    most 127 as (-count, bytes)."""
    out, n, start, end = bytearray(), len(raw), 0, 1
    while start < n:
        while end < n and raw[start] == raw[end] and end - start - 1 < 127:
            end += 1
        if end - start >= 3:
            out += bytes([end - start - 1, raw[start]])
            start = end
        else:
            while (end < n and (end + 1 >= n or raw[end] != raw[end + 1]
                                or end + 2 >= n
                                or raw[end + 1] != raw[end + 2])
                   and end - start < 127):
                end += 1
            out.append((start - end) & 255)
            out += raw[start:end]
            start = end
        end += 1
    return bytes(out)


def spec_exr(planes, x0=0, y0=0, compression="NONE"):
    """A scanline file of `planes` {name: [H, W] array} assembled from the
    spec: chunks of 1 (16 for ZIP) lines, each line the channels' rows in
    sorted order, compressed unless that does not shrink the chunk."""
    names = sorted(planes)
    h, w = planes[names[0]].shape
    code, lines = EXR_CODES[compression]
    head = spec_header([(n, EXR_PTYPE[planes[n].dtype]) for n in names],
                       (x0, y0, x0 + w - 1, y0 + h - 1), code)
    chunks = []
    for y in range(0, h, lines):
        raw = b"".join(planes[n][i].tobytes()
                       for i in range(y, min(y + lines, h)) for n in names)
        body = {"NONE": lambda r: r, "RLE": lambda r: _rle(_predict(r)),
                "ZIPS": lambda r: zlib.compress(_predict(r)),
                "ZIP": lambda r: zlib.compress(_predict(r))}[compression](raw)
        body = body if len(body) < len(raw) else raw
        chunks.append(struct.pack("<ii", y0 + y, len(body)) + body)
    pos = len(head) + 8 * len(chunks)
    offsets = np.cumsum([pos] + [len(c) for c in chunks[:-1]])
    return (head + struct.pack(f"<{len(chunks)}Q", *offsets)
            + b"".join(chunks))


def test_exr_spec_assembled_none_file_read_exactly(tmp_path):
    """RGBA with HALF and FLOAT channels and a dataWindow off the origin
    (the displayWindow ignored); then Y alone in UINT."""
    rng = np.random.default_rng(0)
    planes = {"R": rng.uniform(-2, 8, (9, 13)).astype("<f2"),
              "G": rng.uniform(-2, 8, (9, 13)).astype("<f4"),
              "B": rng.uniform(0, 1, (9, 13)).astype("<f2"),
              "A": rng.uniform(0, 1, (9, 13)).astype("<f4")}
    path = str(tmp_path / "none.exr")
    with open(path, "wb") as f:
        f.write(spec_exr(planes, 3, -2))
    got = io.read_image(path)
    want = np.stack([planes[c].astype(np.float32) for c in "RGBA"], -1)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    y = rng.integers(0, 2 ** 32, (5, 6), dtype=np.uint64).astype("<u4")
    with open(path, "wb") as f:
        f.write(spec_exr({"Y": y}))
    got = io.read_exr(path)
    assert got.dtype == np.uint32 and np.array_equal(got, y)


@pytest.mark.parametrize("pixel_type", ["<f2", "<f4"])
@pytest.mark.parametrize("compression", ["NONE", "RLE", "ZIPS", "ZIP"])
def test_exr_each_compression_read_exactly(tmp_path, compression,
                                           pixel_type):
    """Files of each compression the port reads, HALF and FLOAT, written
    here from the spec: random HDR values (no chunk shrinks: stored raw)
    and steps of ten equal pixels (every chunk compressed), RGB and
    RGBA, read back exactly."""
    rng = np.random.default_rng(len(compression))
    steps = np.repeat(np.linspace(0, 4, 7), 10)
    imgs = [rng.uniform(-3, 60, (37, 70, 3)),
            np.broadcast_to(steps[None, :, None], (37, 70, 4))]
    path = str(tmp_path / "r.exr")
    for img in imgs:
        planes = {c: img[..., i].astype(pixel_type)
                  for i, c in enumerate("RGBA"[:img.shape[2]])}
        with open(path, "wb") as f:
            f.write(spec_exr(planes, compression=compression))
        want = np.stack([planes[c] for c in "RGBA"[:img.shape[2]]],
                        -1).astype(np.float32)
        got = io.read_exr(path)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    raw = 37 * 70 * 4 * np.dtype(pixel_type).itemsize
    assert (os.path.getsize(path) < raw) == (compression != "NONE")


def test_write_exr_header_follows_the_spec(tmp_path):
    """cv2.imwrite's file for a float32 image: magic and version 2, the
    channels B, G, R (sorted) FLOAT unsampled, ZIP, both windows the
    image, INCREASING_Y, the default aspect and screen window; one
    offset per 16 lines, each chunk's y and zlib payload; read back
    exactly, as is a file of random values (its chunks stored raw)."""
    img = np.broadcast_to(np.linspace(0, 2, 21, dtype=np.float32)[
        None, :, None], (40, 21, 3))
    path = str(tmp_path / "h.exr")
    io.write_exr(path, img)
    with open(path, "rb") as f:
        data = f.read()
    assert struct.unpack("<iI", data[:8]) == (20000630, 2)
    attrs, pos = {}, 8
    while data[pos]:
        name, typ, rest = data[pos:].split(b"\0", 2)
        size = struct.unpack("<i", rest[:4])[0]
        attrs[name.decode()] = (typ.decode(), rest[4:4 + size])
        pos += len(name) + len(typ) + 2 + 4 + size
    pos += 1
    assert {k: v[0] for k, v in attrs.items()} == {
        "channels": "chlist", "compression": "compression",
        "dataWindow": "box2i", "displayWindow": "box2i",
        "lineOrder": "lineOrder", "pixelAspectRatio": "float",
        "screenWindowCenter": "v2f", "screenWindowWidth": "float"}
    entry = struct.pack("<iB3xii", 2, 0, 1, 1)
    assert attrs["channels"][1] == b"".join(
        c + b"\0" + entry for c in (b"B", b"G", b"R")) + b"\0"
    assert attrs["compression"][1] == b"\x03"
    box = struct.pack("<4i", 0, 0, 20, 39)
    assert attrs["dataWindow"][1] == attrs["displayWindow"][1] == box
    assert attrs["lineOrder"][1] == b"\0"
    assert struct.unpack("<f", attrs["pixelAspectRatio"][1]) == (1.0,)
    assert struct.unpack("<2f", attrs["screenWindowCenter"][1]) == (0, 0)
    assert struct.unpack("<f", attrs["screenWindowWidth"][1]) == (1.0,)
    offsets = struct.unpack("<3Q", data[pos:pos + 24])
    assert offsets[0] == pos + 24
    for i, off in enumerate(offsets):
        y, size = struct.unpack("<ii", data[off:off + 8])
        n = min(16, 40 - 16 * i)
        assert y == 16 * i
        assert len(zlib.decompress(data[off + 8:off + 8 + size])) == (
            n * 21 * 3 * 4)
    assert np.array_equal(io.read_exr(path), img)
    noise = np.random.default_rng(2).uniform(-1, 9, (19, 5, 4)).astype(
        np.float32)
    io.write_exr(path, noise)
    assert np.array_equal(io.read_exr(path), noise)


REFUSED_EXR = [("PIZ", 4, 0), ("PXR24", 5, 0), ("B44", 6, 0),
               ("B44A", 7, 0), ("DWAA", 8, 0), ("DWAB", 9, 0),
               ("tiled", 0, 0x200), ("deep", 0, 0x800),
               ("multi-part", 0, 0x1000)]


@pytest.mark.parametrize("what,compression,flags", REFUSED_EXR,
                         ids=[r[0] for r in REFUSED_EXR])
def test_exr_refuses_naming_the_feature(tmp_path, what, compression,
                                        flags):
    path = str(tmp_path / "x.exr")
    with open(path, "wb") as f:
        f.write(spec_header([("B", 1), ("G", 1), ("R", 1)], (0, 0, 7, 7),
                            compression, flags) + bytes(64))
    with pytest.raises(ValueError, match=what):
        io.read_image(path)


# ------------------------------------------------------------- stitch_lp


def _exr_scene(root, views):
    """The mesh, calib and `rgb0/%03d.exr` views (float HDR backgrounds
    and a dim object) of a camera ring at 64^2; returns {path: RGB}."""
    from rnr_tpu_torch.synthetic import camera_ring, sphere_mesh
    mesh = sphere_mesh(8, 12)
    os.makedirs(os.path.join(root, "rgb0"))
    with open(os.path.join(root, "mesh.obj"), "w") as f:
        f.write("".join("v %.7f %.7f %.7f\n" % tuple(v) for v in mesh.v))
        f.write("".join("vt %.7f %.7f\n" % tuple(t) for t in mesh.vt))
        f.write("".join("vn %.7f %.7f %.7f\n" % tuple(n) for n in mesh.vn))
        f.write("".join("f %d/%d/%d %d/%d/%d %d/%d/%d\n" % tuple(
            np.repeat(t + 1, 3)) for t in mesh.f_v_idx))
    ring = camera_ring(64, views)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    written = {}
    for i in range(views):
        img = np.stack([2.5 * xx + 0.1 * i, 1.5 * yy, 0.5 + 0.0 * xx], -1)
        img[np.hypot(yy - 0.5, xx - 0.5) < 0.3] *= 0.1
        path = os.path.join(root, "rgb0", "%03d.exr" % i)
        io.write_exr(path, img.astype(np.float32))
        written[path] = img.astype(np.float32)
    scipy.io.savemat(os.path.join(root, "calib.mat"), {
        "poses": np.stack([v["pose"] for v in ring]),
        "projs": np.stack([v["proj"] for v in ring]),
        "dist_coeffs": np.stack([v["dist_coeffs"] for v in ring]),
        "img_hws": np.tile([64, 64], (views, 1)), "global_RT": np.eye(4)})
    return written


def test_stitch_lp_default_exr_views_match_rnr_tpu(tmp_path, monkeypatch):
    """Both stitchers at their default `--img_suffix .exr` on the same
    views: every view used, coverage masks differing on at most 1% of the
    probe, the port's f32 `0.exr` within 1e-6 + 1e-2 of the pixel's
    largest channel of rnr_tpu's stitch (its `.hdr` where its cv2 has no
    OpenEXR) on at least 97% of the pixels both cover with the same
    count; train_rnr's reader takes the `.exr` as written."""
    from rnr_tpu.drivers import stitch_lp as jst
    from rnr_tpu_torch.drivers import stitch_lp
    from rnr_tpu_torch.drivers.train_rnr import _read_stitch
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    written = _exr_scene(jroot, 6)
    written.update(_exr_scene(proot, 6))
    real = cv2.imread

    def imread(path, flags=cv2.IMREAD_COLOR):
        if path.endswith(".exr"):
            assert flags == cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
            return written[path][..., ::-1].copy()
        return real(path, flags)

    monkeypatch.setattr(cv2, "imread", imread)
    args = ["--sampling_pattern", "all", "--lp_h", "64", "--lp_w", "128"]
    jst.main(["--data_root", jroot, *args])
    monkeypatch.setattr(cv2, "imread", real)
    stitch_lp.main(["--data_root", proot, *args])
    jd = os.path.join(jroot, "light_probe_stitch_all")
    pd = os.path.join(proot, "light_probe_stitch_all")
    assert os.path.isfile(os.path.join(pd, "0.exr"))
    assert not os.path.isfile(os.path.join(pd, "0.hdr"))
    cj = scipy.io.loadmat(os.path.join(jd, "count", "0.mat"))
    cp = scipy.io.loadmat(os.path.join(pd, "count", "0.mat"))
    assert cj["num_view"].item() == cp["num_view"].item() == 6
    mj = io.read_png(os.path.join(jd, "mask", "0.png"))
    mp = io.read_png(os.path.join(pd, "mask", "0.png"))
    assert (mj != mp).any(-1).mean() <= 0.01
    same = (cj["count"] == cp["count"]) & (cp["count"] > 0)
    jfile = "0.exr" if os.path.isfile(os.path.join(jd, "0.exr")) else "0.hdr"
    ej = io.read_image(os.path.join(jd, jfile))
    ep = io.read_exr(os.path.join(pd, "0.exr"))
    assert ep.max() > 1.5     # the HDR values came through
    close = np.abs(ej - ep).max(-1) <= 1e-6 + 1e-2 * np.abs(ej).max(-1)
    assert close[same].mean() >= 0.97
    probe, cover = _read_stitch(pd, 0, 1.0)
    covered = cover[..., 0] == 1
    assert covered.any() and np.array_equal(probe[covered], ep[covered])


def test_read_image_refuses_other_flags_and_formats(tmp_path):
    """Only cv2's two flags; IMREAD_COLOR of an EXR or .mat, and unknown
    suffixes, raise naming what is not read."""
    path = str(tmp_path / "a.exr")
    io.write_exr(path, np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="IMREAD_UNCHANGED only"):
        io.read_image(path, io.IMREAD_COLOR)
    with pytest.raises(ValueError, match="flags 0"):
        io.read_image(path, 0)
    other = str(tmp_path / "a.tif")
    open(other, "wb").close()
    with pytest.raises(ValueError, match=r"\.tif files are not read"):
        io.read_image(other)
