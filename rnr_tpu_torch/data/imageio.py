"""Image files and the few image operations the offline drivers need, in
numpy with no cv2 (the port's stand-in for what rnr_tpu takes from cv2).

- PNG, read and written by `zlib` and `struct`: 8- and 16-bit, gray,
  gray + alpha, RGB and RGBA, not interlaced; every filter type is read,
  rows are written unfiltered.
- Radiance `.hdr` (RGBE), read (flat or run-length scanlines) and written
  (run-length scanlines of literal chunks), with the RGBE rounding of
  Greg Ward's rgbe.c that cv2 uses.
- JPEG (`.jpg`, `.jpeg`, any case), read bit-equal to libjpeg-turbo's
  decode by `data/jpeg.py`: baseline, extended and progressive Huffman
  files, restart intervals, gray or YCbCr / RGB at any integral
  sampling, with the EXIF orientation.
- BMP, read: 24- and 32-bit BI_RGB, 32-bit BI_BITFIELDS with byte masks
  (cv2's own 32-bit files), 8-bit palettes; bottom-up and top-down.
- OpenEXR, read: single-part scanline files, NONE, RLE, ZIPS or ZIP,
  HALF (widened to float32), FLOAT or UINT channels R, G, B (+ A) or Y,
  the dataWindow; written as cv2.imwrite writes a float32 image (FLOAT,
  ZIP).
- `.mat` images through scipy (the `img` variable).
- `read_image(path, flags)` returns channels in file order (RGB, RGBA),
  where cv2 returns BGR; `bgr_to_rgb` flips cv2's order where one must
  be compared with the other.  `flags` is one of cv2's two flags that
  rnr_tpu reads 8-bit images with: IMREAD_UNCHANGED (the default: as
  stored, gray 2-D, no EXIF rotation) or IMREAD_COLOR (EXIF orientation
  applied, three 8-bit channels).  Any other format, and each feature
  the readers do not decode, raises a ValueError that names it.
- `resize` with cv2's INTER_AREA and INTER_LINEAR rules (their source
  coordinates, clamps and, for uint8, the 11-bit fixed-point weights).
- `fill_poly` and `dilate` as `cv2.fillPoly` (every edge drawn as an
  8-connected line, then an even-odd scanline fill over all polygons in
  16-bit fixed point) and `cv2.dilate` with a square kernel.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import scipy.io

from rnr_tpu_torch.data.jpeg import decode_jpeg

# cv2's values of the two flags rnr_tpu reads images with
IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels: gray, RGB, gray + alpha, RGBA
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _refuse(path: str) -> None:
    ext = os.path.splitext(path)[1].lower() or "this"
    raise ValueError(f"{path}: {ext} files are not read by the port, which "
                     "reads PNG, JPEG, BMP, OpenEXR, Radiance HDR (.hdr) "
                     "and .mat")


# ------------------------------------------------------------------- PNG


def _paeth_row(row: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x + pred) & 255
    return out


def _average_row(row: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (x + ((a + prev[i]) >> 1)) & 255
    return out


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """raw [H, 1 + stride] (each row's filter byte first) -> [H, stride]."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, row = int(raw[y, 0]), raw[y, 1:]
        if f == 0:
            cur = row
        elif f == 1:        # Sub: a running sum per byte of a pixel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:        # Up
            cur = row + prev
        elif f == 3:        # Average
            cur = np.frombuffer(_average_row(row.tobytes(), prev.tobytes(),
                                             bpp), np.uint8)
        elif f == 4:        # Paeth
            cur = np.frombuffer(_paeth_row(row.tobytes(), prev.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {f}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG as uint8 or uint16, [H, W] (gray) or [H, W, C] in file order
    (gray + alpha, RGB, RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if color not in PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG color type {color}, bit depth {depth}"
                         f", interlace {interlace}: the port reads 8- and "
                         "16-bit gray, gray + alpha, RGB and RGBA, not "
                         "interlaced")
    ch = PNG_CHANNELS[color]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rows.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 or uint16 [H, W] or [H, W, C] (C 1-4, file order) as a
    PNG."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png: dtype {a.dtype}, expected uint8 or "
                        "uint16")
    if a.ndim == 2:
        a = a[..., None]
    h, w, ch = a.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a)
    rows = rows.view(np.uint8).reshape(h, w * ch * a.dtype.itemsize)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  color, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


# ------------------------------------------------------------ Radiance HDR


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 -> [..., 3] float32 (rgbe2float: byte * 2^(e-136))."""
    f = np.ldexp(np.float32(1.0), rgbe[..., 3].astype(np.int32) - 136
                 ).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * f[..., None]
    return np.where(rgbe[..., 3:] > 0, out, np.float32(0.0))


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """[..., 3] float32 -> [..., 4] uint8 (float2rgbe: the largest channel's
    mantissa scaled to 256, each channel truncated)."""
    img = np.asarray(img, np.float32)
    v = img.max(axis=-1)
    m, e = np.frexp(v)
    tiny = v < 1e-32
    scale = (m.astype(np.float64) * 256.0
             / np.where(tiny, 1.0, v).astype(np.float64)).astype(np.float32)
    q = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    out = np.concatenate([q, (e + 128).clip(0, 255).astype(np.uint8)[
        ..., None]], axis=-1)
    out[tiny] = 0
    return out


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE file as float32 [H, W, 3], RGB."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    lines = []
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].decode("latin-1")
        pos = end + 1
        if lines and line.startswith(("-Y", "+Y")):
            break
        lines.append(line)
    if not lines[0].startswith("#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    parts = line.split()
    if parts[0] != "-Y" or parts[2] != "+X":
        raise ValueError(f"{path}: HDR orientation {line!r}, the port reads "
                         "'-Y H +X W'")
    h, w = int(parts[1]), int(parts[3])
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        head = buf[pos:pos + 4]
        if not (8 <= w < 32768 and head[0] == 2 and head[1] == 2
                and (int(head[2]) << 8 | int(head[3])) == w):
            # flat pixels from here to the end of the file
            out[y:] = buf[pos:pos + (h - y) * w * 4].reshape(h - y, w, 4)
            break
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                n = int(buf[pos])
                if n > 128:
                    out[y, x:x + n - 128, c] = buf[pos + 1]
                    x += n - 128
                    pos += 2
                else:
                    out[y, x:x + n, c] = buf[pos + 1:pos + 1 + n]
                    x += n
                    pos += 1 + n
    return _rgbe_to_float(out)


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write float [H, W, 3] (RGB) as Radiance RGBE: run-length scanlines
    of literal chunks where the width allows (8..32767), else flat."""
    rgbe = _float_to_rgbe(img)
    h, w = rgbe.shape[:2]
    head = f"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    if 8 <= w < 32768:
        comp = np.ascontiguousarray(np.moveaxis(rgbe, -1, 1))   # [H, 4, W]
        nfull, rem = divmod(w, 128)
        parts = []
        if nfull:
            body = comp[..., :nfull * 128].reshape(h, 4, nfull, 128)
            cnt = np.full((h, 4, nfull, 1), 128, np.uint8)
            parts.append(np.concatenate([cnt, body], -1).reshape(h, 4, -1))
        if rem:
            parts.append(np.concatenate(
                [np.full((h, 4, 1), rem, np.uint8), comp[..., nfull * 128:]],
                -1))
        rows = np.concatenate(parts, -1).reshape(h, -1)
        start = np.array([2, 2, w >> 8, w & 255], np.uint8)
        pixels = np.concatenate([np.broadcast_to(start, (h, 4)), rows], 1)
    else:
        pixels = rgbe
    with open(path, "wb") as f:
        f.write(head + np.ascontiguousarray(pixels).tobytes())


# ------------------------------------------------------------------ JPEG


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: the EXIF orientation (1-8) undone."""
    if orientation >= 5:
        img = np.swapaxes(img, 0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def read_jpeg(path: str, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """A JPEG as uint8, bit-equal to cv2.imread(path, flags) with its BGR
    flipped: [H, W] gray or [H, W, 3] RGB under IMREAD_UNCHANGED;
    [H, W, 3] with the EXIF orientation applied under IMREAD_COLOR."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        img, orientation = decode_jpeg(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return _as_color(img, orientation) if flags == IMREAD_COLOR else img


# ------------------------------------------------------------------- BMP


def read_bmp(path: str) -> np.ndarray:
    """A BMP as uint8, as cv2.imread(path, IMREAD_UNCHANGED) reads it
    (file order): 24-bit and 32-bit BI_RGB -> RGB, 32-bit BI_BITFIELDS
    with byte masks -> RGBA (alpha 255 where it has no alpha mask), an
    8-bit palette -> [H, W] where every entry is gray, else RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM" or len(data) < 54:
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize, w, h, _, bpp, comp = struct.unpack("<IiiHHI", data[14:34])
    if hsize < 40:
        raise ValueError(f"{path}: BMP with a {hsize}-byte OS/2 header: the "
                         "port reads BITMAPINFOHEADER and later headers")
    kind = {(24, 0): "rgb", (32, 0): "rgb", (32, 3): "bitfields",
            (8, 0): "palette"}.get((bpp, comp))
    if kind is None:
        names = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS",
                 4: "BI_JPEG", 5: "BI_PNG", 6: "BI_ALPHABITFIELDS"}
        raise ValueError(f"{path}: {bpp}-bit {names.get(comp, comp)} BMP: "
                         "the port reads 24- and 32-bit BI_RGB, 32-bit "
                         "BI_BITFIELDS and 8-bit palette BMPs")
    top_down, h = h < 0, abs(h)
    stride = (w * bpp // 8 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, h * stride, offset).reshape(h,
                                                                     stride)
    if not top_down:
        rows = rows[::-1]
    px = rows[:, :w * bpp // 8]
    if kind == "palette":
        n = struct.unpack("<I", data[46:50])[0] or 256
        pal = np.frombuffer(data, np.uint8, 4 * n, 14 + hsize).reshape(n, 4)
        pal = np.concatenate([pal, np.zeros((256 - n, 4), np.uint8)])
        if (pal[:n, 0] == pal[:n, 1]).all() and (pal[:n, 0]
                                                 == pal[:n, 2]).all():
            return np.ascontiguousarray(pal[px, 0])
        return np.ascontiguousarray(pal[px, 2::-1])
    px = px.reshape(h, w, bpp // 8)
    if kind == "rgb":
        return np.ascontiguousarray(px[..., 2::-1])
    masks = struct.unpack("<4I", data[54:70]) if hsize >= 56 else (
        struct.unpack("<3I", data[54:66]) + (0,))
    byte = {0xFF << (8 * i): i for i in range(4)}
    if any(m not in byte for m in masks[:3]) or (masks[3] and masks[3]
                                                 not in byte):
        raise ValueError(f"{path}: BMP bit fields {[hex(m) for m in masks]}"
                         ": the port reads byte-aligned masks")
    out = np.stack([px[..., byte[m]] for m in masks[:3]], -1)
    alpha = (px[..., byte[masks[3]]] if masks[3]
             else np.full((h, w), 255, np.uint8))
    return np.concatenate([out, alpha[..., None]], -1)


# --------------------------------------------------------------- OpenEXR

EXR_MAGIC = 20000630
# compression -> (name, scanlines per chunk); None: not read by the port
EXR_COMPRESSION = {0: ("NONE", 1), 1: ("RLE", 1), 2: ("ZIPS", 1),
                   3: ("ZIP", 16), 4: ("PIZ", None), 5: ("PXR24", None),
                   6: ("B44", None), 7: ("B44A", None), 8: ("DWAA", None),
                   9: ("DWAB", None)}
# pixel type -> numpy dtype: UINT, HALF, FLOAT
EXR_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _exr_unpredict(buf: bytes) -> np.ndarray:
    """OpenEXR's ZIP / RLE post-pass: the byte predictor undone (a uint8
    running sum of the deltas less 128), then the two halves
    interleaved."""
    t = np.frombuffer(buf, np.uint8).copy()
    t[1:] -= 128
    t = np.cumsum(t, dtype=np.uint8)
    out = np.empty_like(t)
    half = (t.size + 1) // 2
    out[0::2], out[1::2] = t[:half], t[half:]
    return out


def _exr_predict(raw: np.ndarray) -> bytes:
    """The inverse of _exr_unpredict: the two halves split, then each
    byte stored as its difference from the one before, plus 128."""
    t = np.concatenate([raw[0::2], raw[1::2]])
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + 128
    return d.tobytes()


def _rle_decode(buf: bytes, n: int) -> bytes:
    """OpenEXR's rleUncompress: a signed count byte, then count + 1
    copies of one byte (count >= 0) or -count literal bytes."""
    out, i = bytearray(), 0
    while i < len(buf) and len(out) < n:
        c = buf[i] - 256 if buf[i] > 127 else buf[i]
        if c < 0:
            out += buf[i + 1:i + 1 - c]
            i += 1 - c
        else:
            out += buf[i + 1:i + 2] * (c + 1)
            i += 2
    return bytes(out)


def _exr_header(data: bytes, path: str):
    magic, version = struct.unpack("<iI", data[:8])
    if magic != EXR_MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    for bit, what in ((0x200, "tiled"), (0x800, "deep"),
                      (0x1000, "multi-part")):
        if version & bit:
            raise ValueError(f"{path}: {what} OpenEXR file: the port reads "
                             "single-part scanline files")
    attrs, pos = {}, 8
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        tend = data.index(b"\0", end + 1)
        typ = data[end + 1:tend].decode()
        size = struct.unpack("<i", data[tend + 1:tend + 5])[0]
        attrs[name] = (typ, data[tend + 5:tend + 5 + size])
        pos = tend + 5 + size
    return attrs, pos + 1


def _exr_channels(value: bytes) -> list:
    chans, pos = [], 0
    while value[pos] != 0:
        end = value.index(b"\0", pos)
        ptype, _, xs, ys = struct.unpack("<iB3xii", value[end + 1:end + 17])
        chans.append((value[pos:end].decode(), ptype, xs, ys))
        pos = end + 17
    return chans


def read_exr(path: str) -> np.ndarray:
    """A single-part scanline OpenEXR file's dataWindow: float32 (HALF
    widened, FLOAT; uint32 where every channel is UINT), [H, W, 3] RGB,
    [H, W, 4] RGBA or [H, W] for Y alone."""
    with open(path, "rb") as f:
        data = f.read()
    attrs, pos = _exr_header(data, path)
    kind = attrs.get("type", (None, b"scanlineimage\0"))[1].rstrip(b"\0")
    if kind != b"scanlineimage":
        raise ValueError(f"{path}: OpenEXR part type {kind.decode()}: the "
                         "port reads single-part scanline files")
    comp = attrs["compression"][1][0]
    cname, lines = EXR_COMPRESSION.get(comp, (str(comp), None))
    if lines is None:
        raise ValueError(f"{path}: OpenEXR {cname} compression: the port "
                         "reads NONE, RLE, ZIPS and ZIP")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    chans = _exr_channels(attrs["channels"][1])
    names = [c[0] for c in chans]
    order = (["R", "G", "B", "A"] if set(names) == {"R", "G", "B", "A"}
             else ["R", "G", "B"] if set(names) == {"R", "G", "B"}
             else ["Y"] if names == ["Y"] else None)
    if order is None or any(c[1] not in EXR_TYPES or c[2:] != (1, 1)
                            for c in chans):
        raise ValueError(f"{path}: OpenEXR channels {chans}: the port reads "
                         "R, G, B (+ A) or Y, UINT / HALF / FLOAT, "
                         "unsubsampled")
    dtypes = [EXR_TYPES[c[1]] for c in chans]
    line_bytes = w * sum(d.itemsize for d in dtypes)
    n_chunks = -(-h // lines)
    offsets = np.frombuffer(data, "<u8", n_chunks, pos)
    planes = {n: np.empty((h, w), d) for n, d in zip(names, dtypes)}
    for off in offsets.tolist():
        y, size = struct.unpack("<ii", data[off:off + 8])
        n_lines = min(lines, y1 + 1 - y)
        raw_size = n_lines * line_bytes
        buf = data[off + 8:off + 8 + size]
        if size < raw_size:
            if cname == "RLE":
                buf = _rle_decode(buf, raw_size)
            elif cname in ("ZIP", "ZIPS"):
                buf = zlib.decompress(buf)
            buf = _exr_unpredict(buf).tobytes()
        if len(buf) != raw_size:
            raise ValueError(f"{path}: OpenEXR chunk at line {y} holds "
                             f"{len(buf)} bytes, expected {raw_size}")
        rows = np.frombuffer(buf, np.uint8).reshape(n_lines, line_bytes)
        col = 0
        for n, d in zip(names, dtypes):
            part = rows[:, col:col + w * d.itemsize]
            planes[n][y - y0:y - y0 + n_lines] = np.ascontiguousarray(
                part).view(d).reshape(n_lines, w)
            col += w * d.itemsize
    out_type = (np.uint32 if all(d.kind == "u" for d in dtypes)
                else np.float32)
    img = np.stack([planes[n].astype(out_type) for n in order], -1)
    return img[..., 0] if order == ["Y"] else img


def _exr_attr(name: str, typ: str, value: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def write_exr(path: str, img: np.ndarray) -> None:
    """Write float [H, W, 3] (RGB), [H, W, 4] (RGBA) or [H, W] (Y) as
    cv2.imwrite writes a float32 image: a scanline OpenEXR file,
    INCREASING_Y, the channels FLOAT in the sorted order the format
    requires, ZIP-compressed in blocks of 16 lines (a block that does not
    shrink stored raw, as OpenEXR does)."""
    a = np.asarray(img, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[
        a.shape[2]]
    h, w = a.shape[:2]
    order = sorted(names)
    chans = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1)
                     for n in order)
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<iI", EXR_MAGIC, 2)
              + _exr_attr("channels", "chlist", chans + b"\0")
              + _exr_attr("compression", "compression", bytes([3]))
              + _exr_attr("dataWindow", "box2i", box)
              + _exr_attr("displayWindow", "box2i", box)
              + _exr_attr("lineOrder", "lineOrder", b"\0")
              + _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1))
              + _exr_attr("screenWindowCenter", "v2f",
                          struct.pack("<2f", 0, 0))
              + _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1))
              + b"\0")
    planes = a[..., [names.index(n) for n in order]].astype("<f4")
    rows = np.ascontiguousarray(planes.transpose(0, 2, 1)).view(
        np.uint8).reshape(h, -1)             # per line: each channel's row
    chunks = []
    for y in range(0, h, 16):
        raw = rows[y:y + 16].reshape(-1)
        body = zlib.compress(_exr_predict(raw), 6)
        if len(body) >= raw.size:
            body = raw.tobytes()
        chunks.append(struct.pack("<ii", y, len(body)) + body)
    pos = len(header) + 8 * len(chunks)
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(offsets)}Q", *offsets)
                + b"".join(chunks))


# ------------------------------------------------------------- dispatch


def _as_color(img: np.ndarray, orientation: int = 1) -> np.ndarray:
    """cv2's IMREAD_COLOR of an image read unchanged: the EXIF
    orientation applied, 16 bits to their high byte, float to
    round(255 x) saturated, gray to three channels, alpha dropped:
    uint8 [H, W, 3]."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    elif img.dtype.kind == "f":
        img = np.clip(np.rint(img.astype(np.float32) * np.float32(255)),
                      0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    img = np.repeat(img, 3, -1) if img.shape[2] == 1 else img[..., :3]
    return _orient(img, orientation)


def read_image(path: str, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """An image file as cv2.imread(path, flags) reads it, in file channel
    order.  IMREAD_UNCHANGED: PNG uint8 / uint16 (gray + alpha as RGBA,
    the gray in each colour), JPEG and BMP uint8 (gray [H, W]), HDR
    float32 RGB, EXR float32 (uint32 for UINT channels),
    a .mat image's `img` variable as stored.  IMREAD_COLOR: uint8
    [H, W, 3] (`_as_color`) of PNG, JPEG, BMP and HDR (cv2's rule for a
    float image checked on .hdr); an EXR or .mat raises, as does any
    other format or flag."""
    ext = os.path.splitext(path)[1].lower()
    if flags not in (IMREAD_UNCHANGED, IMREAD_COLOR):
        raise ValueError(f"read_image: flags {flags}: the port reads with "
                         "IMREAD_UNCHANGED or IMREAD_COLOR")
    if ext in (".jpg", ".jpeg"):
        return read_jpeg(path, flags)
    readers = {".png": read_png, ".hdr": read_hdr, ".bmp": read_bmp,
               ".exr": read_exr,
               ".mat": lambda p: scipy.io.loadmat(p)["img"]}
    if ext not in readers:
        _refuse(path)
    img = readers[ext](path)
    if ext == ".png" and img.ndim == 3 and img.shape[2] == 2:
        img = img[..., [0, 0, 0, 1]]     # cv2: gray + alpha as BGRA
    if flags == IMREAD_UNCHANGED:
        return img
    if ext in (".exr", ".mat"):
        raise ValueError(f"{path}: the port reads {ext} files with "
                         "IMREAD_UNCHANGED only")
    return _as_color(img)


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    """Swap the first and third channels (cv2's BGR(A) <-> RGB(A))."""
    out = np.array(img)
    out[..., [0, 2]] = out[..., [2, 0]]
    return out


# ---------------------------------------------------------------- resize


def _linear_taps(dst: int, src: int, area_mode: bool):
    """cv2.resize's per-axis source index and weight of the second tap:
    INTER_LINEAR centres, or INTER_AREA's when it does not shrink."""
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst, dtype=np.float64)
    if area_mode:
        sx = np.floor(d * scale).astype(np.int64)
        fx = ((d + 1) - (sx + 1) * inv).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    else:
        fx = ((d + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(fx).astype(np.int64)
        fx = fx - sx.astype(np.float32)
    low, high = sx < 0, sx >= src - 1
    fx = np.where(low | high, np.float32(0), fx).astype(np.float32)
    sx = np.clip(sx, 0, src - 1)
    return sx, np.minimum(sx + 1, src - 1), fx


def _resize_linear(img: np.ndarray, w: int, h: int, area_mode: bool):
    sh, sw = img.shape[:2]
    x0, x1, fx = _linear_taps(w, sw, area_mode)
    y0, y1, fy = _linear_taps(h, sh, area_mode)
    if img.dtype == np.uint8:   # 11-bit weights, 22-bit rounding shift
        ax = np.rint((np.float32(1) - fx) * 2048).astype(np.int64)
        bx = np.rint(fx * 2048).astype(np.int64)
        ay = np.rint((np.float32(1) - fy) * 2048).astype(np.int64)
        by = np.rint(fy * 2048).astype(np.int64)
        s = img.astype(np.int64)
        ex = (slice(None),) + (None,) * (img.ndim - 2)
        rows = s[:, x0] * ax[ex] + s[:, x1] * bx[ex]
        ey = (slice(None),) + (None,) * (img.ndim - 1)
        out = rows[y0] * ay[ey] + rows[y1] * by[ey]
        return np.clip((out + (1 << 21)) >> 22, 0, 255).astype(np.uint8)
    s = np.asarray(img, np.float32)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    rows = s[:, x0] * (np.float32(1) - fx)[ex] + s[:, x1] * fx[ex]
    ey = (slice(None),) + (None,) * (img.ndim - 1)
    return rows[y0] * (np.float32(1) - fy)[ey] + rows[y1] * fy[ey]


def _area_weights(dst: int, src: int) -> np.ndarray:
    """[dst, src] weights of INTER_AREA's shrink: each destination pixel
    the mean of its source interval, partial pixels by their overlap."""
    scale = src / dst
    lo = np.arange(dst)[:, None] * scale
    edges = np.arange(src + 1, dtype=np.float64)
    overlap = np.clip(np.minimum(edges[1:], lo + scale)
                      - np.maximum(edges[:-1], lo), 0, None)
    return overlap / scale


def resize(img: np.ndarray, size: tuple[int, int],
           interpolation: str = "linear") -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation): "linear" (INTER_LINEAR) or
    "area" (INTER_AREA: the mean over each destination pixel's source
    area where it shrinks both axes, else INTER_AREA's linear taps).
    float32 or uint8 [H, W] / [H, W, C]; the same size returns a copy."""
    w, h = int(size[0]), int(size[1])
    if img.shape[:2] == (h, w):
        return np.array(img)
    if interpolation == "area" and h <= img.shape[0] and w <= img.shape[1]:
        wy = _area_weights(h, img.shape[0])
        wx = _area_weights(w, img.shape[1])
        rows = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
        out = np.moveaxis(np.tensordot(wx, rows, axes=(1, 1)), 0, 1)
        if img.dtype == np.uint8:   # halves up, as cv2's integer sums
            return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
        return out.astype(np.float32)
    if interpolation not in ("area", "linear"):
        raise ValueError(f"resize: interpolation {interpolation!r}")
    return _resize_linear(img, w, h, interpolation == "area")


# ------------------------------------------------------ polygons, dilate


def _lines(p0: np.ndarray, p1: np.ndarray):
    """(rows, cols) of cv2's 8-connected Bresenham lines from p0 to p1
    [E, 2] (x, y), drawn left to right; points already inside the image."""
    swap = p1[:, 0] < p0[:, 0]
    a = np.where(swap[:, None], p1, p0).astype(np.int64)
    b = np.where(swap[:, None], p0, p1).astype(np.int64)
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    x_major = dx >= dy
    big = np.where(x_major, dx, dy)
    small = np.where(x_major, dy, dx)
    edge = np.repeat(np.arange(len(a)), big + 1)
    k = np.arange(edge.size) - np.repeat(np.cumsum(big + 1) - (big + 1),
                                         big + 1)
    bg, sm = big[edge], small[edge]
    # the minor steps after k major ones: ceil((2 small k - big) / 2 big)
    minor = np.where(bg > 0, (2 * sm * k + bg - 1) // np.maximum(2 * bg, 1),
                     0)
    xm = x_major[edge]
    cols = a[edge, 0] + np.where(xm, k, minor)
    rows = a[edge, 1] + sy[edge] * np.where(xm, minor, k)
    return rows, cols


def fill_poly(img: np.ndarray, polys: np.ndarray, value) -> np.ndarray:
    """cv2.fillPoly(img, list(polys), value) for integer polygons [P, K, 2]
    (x, y) inside the image: every edge drawn as an 8-connected line, then
    the rows filled between pairs of edge crossings (even-odd over all
    polygons), crossings in 16-bit fixed point at the pixel centres.
    Writes into img and returns it."""
    h, w = img.shape[:2]
    polys = np.asarray(polys, np.int64)
    p1 = polys.reshape(-1, 2)
    p0 = np.roll(polys, 1, axis=1).reshape(-1, 2)
    r, c = _lines(p0, p1)
    img[r, c] = value
    # non-horizontal edges: top y0, bottom y1 (exclusive), x at y0 and the
    # step per row, both in 16-bit fixed point (C division: toward zero)
    keep = p0[:, 1] != p1[:, 1]
    if keep.sum() < 2:
        return img
    a, b = p0[keep], p1[keep]
    top = np.where((a[:, 1] < b[:, 1])[:, None], a, b)
    y0 = np.minimum(a[:, 1], b[:, 1])
    y1 = np.maximum(a[:, 1], b[:, 1])
    num = (b[:, 0] - a[:, 0]) << 16
    den = b[:, 1] - a[:, 1]
    step = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))
    x0 = (top[:, 0] << 16) + (1 << 15)
    n = y1 - y0
    e = np.repeat(np.arange(len(y0)), n)
    j = np.arange(e.size) - np.repeat(np.cumsum(n) - n, n)
    ys = y0[e] + j
    xs = x0[e] + j * step[e]
    inside = ys < h
    ys, xs = ys[inside], xs[inside]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    left, right = xs[0::2] >> 16, xs[1::2] >> 16
    row = ys[0::2]
    ok = (left < w) & (right >= 0)
    left, right, row = (np.clip(left[ok], 0, w - 1),
                        np.clip(right[ok], 0, w - 1), row[ok])
    span = np.zeros((h, w + 1), np.int64)
    np.add.at(span, (row, left), 1)
    np.add.at(span, (row, right + 1), -1)
    img[np.cumsum(span, axis=1)[:, :w] > 0] = value
    return img


def dilate(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.dilate with a ksize x ksize kernel of ones (centred anchor; the
    border adds nothing)."""
    r = ksize // 2
    out = img
    for axis in (0, 1):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (r, ksize - 1 - r)
        p = np.pad(out, pad)
        n = out.shape[axis]
        out = np.max(np.stack([np.take(p, np.arange(i, i + n), axis=axis)
                               for i in range(ksize)]), axis=0)
    return out
