"""K7: the tile-binned rasterizer (csrc/rasterize_tiles.cu) and its plain
version.

Replaces rnr_tpu/ops/rasterize_pallas.py::rasterize_pallas.  Two stages,
as there:

1. `bin_faces` (plain torch on either device, as rnr_tpu keeps
   `_bin_faces` in XLA): the front, on-screen faces whose pixel bounding
   box meets a tile are listed for it in ascending face id, at most
   `max_faces_per_tile` of them; the rest are counted as overflow.  The
   list comes from a stable rank (a cumsum over face id), never from
   atomics: the order decides which face wins a depth tie, and under
   overflow which faces render at all.
2. `rasterize_tiles`: per tile, a z-buffer over its candidates in list
   order: edge-inclusive inside tests, clamped barycentrics from the
   face's inverse matrix, perspective depth, and a strict z-test, so the
   first face wins a tie.  On a CUDA tensor it launches the kernel, on a
   CPU tensor it runs `rasterize_tiles_torch`.

`rasterize_tiled` chains both and recomputes the winners' weights, as
rnr_tpu does outside its kernel.
"""

from __future__ import annotations

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)
from rnr_tpu_torch.ops.rasterize import (RasterOutput, _is_backface,
                                         _ndc_to_pixel, face_inv_matrix,
                                         finish_raster, pixel_ndc)

FACE_FLOATS = 18   # xyz of the 3 vertices, then the 3x3 face_inv, row-major


def _tile_of(v: torch.Tensor, tile: int, n_tiles: int) -> torch.Tensor:
    """floor(v) or ceil(v) pixel coordinates -> tile index, clipped.

    rnr_tpu casts to int32 with XLA's saturating conversion (NaN to 0,
    beyond the range to its ends) before the floor division; a plain
    torch cast of 1e12 gives -2^31 and would land a far face on tile 0
    instead of the last one.  So the cast is done in int64 from a value
    clamped to the int32 range, and clamped again.
    """
    i = torch.nan_to_num(v, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31)
    i = i.to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1)
    return torch.clamp(torch.div(i, tile, rounding_mode="floor"), 0,
                       n_tiles - 1)


def bin_faces(faces: torch.Tensor, image_size: int, tile_h: int,
              tile_w: int, max_faces_per_tile: int):
    """Assign faces [N, F, 3, 3] (NDC) to image tiles by bounding box.

    Returns (table [N, F, 18] f32: xyz of the vertices and face_inv per
    face; ids [N, T, K] int32, each tile's candidates in ascending face
    id, -1 past its count; counts [N, T] int32; overflow [N] int32, the
    candidates beyond K that were dropped), with T = (S / tile_h) x
    (S / tile_w) tiles in row-major order and K = max_faces_per_tile.
    """
    faces = faces.detach()
    s = image_size
    n, f = faces.shape[0], faces.shape[1]
    dev = faces.device
    k_cap = max_faces_per_tile
    front = ~_is_backface(faces)
    p = _ndc_to_pixel(faces[..., :2], s)                 # [N, F, 3, 2]
    finv = face_inv_matrix(p)

    xmin = torch.amin(p[..., 0], dim=-1)
    xmax = torch.amax(p[..., 0], dim=-1)
    ymin = torch.amin(p[..., 1], dim=-1)
    ymax = torch.amax(p[..., 1], dim=-1)
    n_ty, n_tx = s // tile_h, s // tile_w
    n_t = n_ty * n_tx
    tx0 = _tile_of(torch.floor(xmin), tile_w, n_tx)
    tx1 = _tile_of(torch.ceil(xmax), tile_w, n_tx)
    ty0 = _tile_of(torch.floor(ymin), tile_h, n_ty)
    ty1 = _tile_of(torch.ceil(ymax), tile_h, n_ty)
    offscreen = (xmax < 0) | (xmin > s - 1) | (ymax < 0) | (ymin > s - 1)
    ok = front & ~offscreen

    # [N, T, F], faces innermost: the rank below is a scan along the
    # last dimension (along an outer one, CUDA's scan takes milliseconds)
    t_y = torch.arange(n_ty, device=dev)[:, None]
    t_x = torch.arange(n_tx, device=dev)[:, None]
    in_y = (ty0[:, None, :] <= t_y) & (t_y <= ty1[:, None, :])  # [N, n_ty, F]
    in_x = (tx0[:, None, :] <= t_x) & (t_x <= tx1[:, None, :])  # [N, n_tx, F]
    overlap = (in_y[:, :, None, :] & in_x[:, None, :, :]
               & ok[:, None, None, :]).reshape(n, n_t, f)

    # each candidate's slot in its tile's list: its rank among the
    # tile's candidates by face id
    rank = torch.cumsum(overlap, dim=2, dtype=torch.int32) - 1
    keep = overlap & (rank < k_cap)
    # kept candidates go to their own slot; every other (tile, face) pair
    # to one dump slot past the lists, which is never read
    tile_base = ((torch.arange(n, device=dev)[:, None, None] * n_t
                  + torch.arange(n_t, device=dev)[None, :, None]) * k_cap)
    dest = torch.where(keep, tile_base + rank, n * n_t * k_cap)
    fid = torch.arange(f, dtype=torch.int32, device=dev)
    buf = torch.full((n * n_t * k_cap + 1,), -1, dtype=torch.int32,
                     device=dev)
    buf[dest.reshape(-1)] = fid.expand(n, n_t, f).reshape(-1)
    ids = buf[:n * n_t * k_cap].reshape(n, n_t, k_cap)

    true_counts = overlap.sum(dim=2, dtype=torch.int32)        # [N, T]
    counts = torch.clamp(true_counts, max=k_cap)
    overflow = torch.clamp(true_counts - k_cap, min=0).sum(
        dim=1, dtype=torch.int32)
    table = torch.cat([faces.reshape(n, f, 9), finv.reshape(n, f, 9)],
                      dim=-1).contiguous()
    return table, ids, counts, overflow


def tile_pixels(image_size: int, tile_h: int, tile_w: int, dtype, device):
    """Per tile t and pixel q of it (row-major in the tile): the integer
    pixel coordinates xi, yi and the pixel-centre NDC xp, yp, each
    [T, tile_h * tile_w]."""
    s = image_size
    n_ty, n_tx = s // tile_h, s // tile_w
    r = torch.arange(tile_h, device=device)
    c = torch.arange(tile_w, device=device)
    yi = (torch.arange(n_ty, device=device)[:, None, None, None] * tile_h
          + r[None, None, :, None]).expand(n_ty, n_tx, tile_h, tile_w)
    xi = (torch.arange(n_tx, device=device)[None, :, None, None] * tile_w
          + c[None, None, None, :]).expand(n_ty, n_tx, tile_h, tile_w)
    yi = yi.reshape(n_ty * n_tx, -1)
    xi = xi.reshape(n_ty * n_tx, -1)
    nd = pixel_ndc(s, dtype, device)
    return xi.to(dtype), yi.to(dtype), nd[xi], nd[yi]


def rasterize_tiles_torch(table: torch.Tensor, ids: torch.Tensor,
                          counts: torch.Tensor, image_size: int,
                          tile_h: int, tile_w: int, near: float = 0.0,
                          far: float = 1e5, chunk: int = 32):
    """Plain version of the per-tile z-buffer: (depth [N, S, S] f32, idx
    [N, S, S] int32) in raster orientation (row = yi), `far` / -1 where
    no face wins.

    The kernel's arithmetic per (pixel, candidate), in its order.  It
    takes `chunk` candidates at a time: the first of the chunk's least
    depths replaces the carry only when strictly less, which is what the
    kernel's candidate-by-candidate strict z-test gives.
    """
    s = image_size
    n, n_t, _ = ids.shape
    dev, dt = table.device, table.dtype
    xi, yi, xp, yp = (a[None, :, None, :]
                      for a in tile_pixels(s, tile_h, tile_w, dt, dev))
    rows = torch.arange(n, device=dev).reshape(n, 1, 1)
    depth = torch.full((n, n_t, tile_h * tile_w), far, dtype=dt, device=dev)
    idx = torch.full((n, n_t, tile_h * tile_w), -1, dtype=torch.int32,
                     device=dev)
    k_run = int(counts.max()) if counts.numel() else 0
    for k0 in range(0, k_run, chunk):
        cid = ids[:, :, k0:k0 + chunk]                          # [N, T, C]
        live = (torch.arange(k0, k0 + cid.shape[2], device=dev)
                < counts[..., None]) & (cid >= 0)
        d = table[rows, torch.clamp(cid, min=0).long()][..., None, :]
        x0, y0, z0 = d[..., 0], d[..., 1], d[..., 2]            # [N, T, C, 1]
        x1, y1, z1 = d[..., 3], d[..., 4], d[..., 5]
        x2, y2, z2 = d[..., 6], d[..., 7], d[..., 8]
        in0 = (yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0)
        in1 = (yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1)
        in2 = (yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2)
        w0 = torch.clamp(d[..., 9] * xi + d[..., 10] * yi + d[..., 11],
                         0.0, 1.0)
        w1 = torch.clamp(d[..., 12] * xi + d[..., 13] * yi + d[..., 14],
                         0.0, 1.0)
        w2 = torch.clamp(d[..., 15] * xi + d[..., 16] * yi + d[..., 17],
                         0.0, 1.0)
        wsum = w0 + w1 + w2
        wsum = torch.where(wsum == 0.0, 1e-30, wsum)
        inv_zp = (w0 / z0 + w1 / z1 + w2 / z2) / wsum
        zp = 1.0 / torch.where(inv_zp == 0.0, 1e-30, inv_zp)
        ok = (in0 & in1 & in2 & live[..., None] & (zp > near)
              & (zp < far))
        cmin, carg = torch.min(torch.where(ok, zp, torch.inf), dim=2)
        take = cmin < depth
        depth = torch.where(take, cmin, depth)
        idx = torch.where(take, torch.gather(cid, 2, carg), idx)
    return (_untile(depth, s, tile_h, tile_w),
            _untile(idx, s, tile_h, tile_w))


def _untile(a: torch.Tensor, s: int, tile_h: int, tile_w: int):
    """[N, T, tile_h * tile_w] -> [N, S, S]."""
    n = a.shape[0]
    n_ty, n_tx = s // tile_h, s // tile_w
    return (a.reshape(n, n_ty, n_tx, tile_h, tile_w).permute(0, 1, 3, 2, 4)
            .reshape(n, s, s))


def rasterize_tiles(table: torch.Tensor, ids: torch.Tensor,
                    counts: torch.Tensor, image_size: int, tile_h: int,
                    tile_w: int, near: float = 0.0, far: float = 1e5):
    """The per-tile z-buffer of `bin_faces`'s output: (depth [N, S, S]
    f32, idx [N, S, S] int32), raster orientation.  K7 on a CUDA tensor,
    `rasterize_tiles_torch` on a CPU tensor."""
    if not use_kernel(table, ids, counts):
        return rasterize_tiles_torch(table, ids, counts, image_size, tile_h,
                                     tile_w, near, far)
    s = image_size
    n, f = table.shape[0], table.shape[1]
    n_t, k_cap = ids.shape[1], ids.shape[2]
    if s % tile_h or s % tile_w or n_t != (s // tile_h) * (s // tile_w):
        raise ValueError(f"rasterize_tiles: {n_t} tiles of {tile_h}x{tile_w}"
                         f" do not cover {s}x{s}")
    require(table, "table", torch.float32, (n, f, FACE_FLOATS))
    require(ids, "ids", torch.int32, (n, n_t, k_cap))
    require(counts, "counts", torch.int32, (n, n_t))
    depth = torch.empty((n, s, s), dtype=torch.float32, device=table.device)
    idx = torch.empty((n, s, s), dtype=torch.int32, device=table.device)
    fn = _build.fn("rasterize_tiles", "rnr_rasterize_tiles", 5, 7, 2)
    rasterize_tiles.launches += 1
    check_launch(fn(table.data_ptr(), ids.data_ptr(), counts.data_ptr(),
                    depth.data_ptr(), idx.data_ptr(), n, f, n_t, k_cap, s,
                    tile_h, tile_w, float(near), float(far),
                    stream_of(table)), "rasterize_tiles")
    return depth, idx


rasterize_tiles.launches = 0


def rasterize_tiled(faces: torch.Tensor, image_size: int, near: float = 0.0,
                    far: float = 1e5, tile_h: int = 32, tile_w: int = 128,
                    max_faces_per_tile: int = 2048) -> RasterOutput:
    """Tile-binned rasterization of faces [N, F, 3, 3] (xy NDC, z camera
    depth), the counterpart of rnr_tpu's rasterize_pallas: the same
    RasterOutput as `rasterize_face_index`, plus `overflow` [N], the
    candidates the tile lists dropped (non-zero: the render is
    incomplete and max_faces_per_tile must be raised)."""
    s = image_size
    if s % tile_h or s % tile_w:
        raise ValueError(f"image_size {s} not divisible by tile "
                         f"{tile_h}x{tile_w}")
    n, f = faces.shape[0], faces.shape[1]
    table, ids, counts, overflow = bin_faces(faces, s, tile_h, tile_w,
                                             max_faces_per_tile)
    depth, idx = rasterize_tiles(table, ids, counts, s, tile_h, tile_w, near,
                                 far)
    return finish_raster(faces, idx, depth, s, far,
                         finv_all=table[..., 9:].reshape(n, f, 3, 3),
                         overflow=overflow)
