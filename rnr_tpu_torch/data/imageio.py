"""Image files and the few image operations the offline drivers need, in
numpy with no cv2 (the port's stand-in for what rnr_tpu takes from cv2).

- PNG, read and written by `zlib` and `struct`: 8- and 16-bit, gray,
  gray + alpha, RGB and RGBA, not interlaced; every filter type is read,
  rows are written unfiltered.
- Radiance `.hdr` (RGBE), read (flat or run-length scanlines) and written
  (run-length scanlines of literal chunks), with the RGBE rounding of
  Greg Ward's rgbe.c that cv2 uses.
- `.mat` images through scipy (the `img` variable).
- `read_image` returns channels in file order (RGB, RGBA), where cv2
  returns BGR; `bgr_to_rgb` flips cv2's order where one must be compared
  with the other.  `.exr`, `.jpg` / `.jpeg` and `.bmp` raise a ValueError
  that names the format.
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

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels: gray, RGB, gray + alpha, RGBA
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
UNSUPPORTED = {".exr": "OpenEXR", ".jpg": "JPEG", ".jpeg": "JPEG",
               ".bmp": "BMP"}


def _refuse(path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    name = UNSUPPORTED.get(ext, ext or "this")
    raise ValueError(f"{path}: {name} files are not read or written by the "
                     "port, which reads PNG, Radiance HDR (.hdr) and .mat")


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


# ------------------------------------------------------------- dispatch


def read_image(path: str) -> np.ndarray:
    """PNG (uint8 / uint16, file order), HDR (float32 RGB) or a .mat image
    (its `img` variable, as stored); any other format raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".mat":
        return scipy.io.loadmat(path)["img"]
    _refuse(path)


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
