"""Triangle rasterization: the z-buffer oracle and the per-pixel
attributes of a fixed face assignment (port of rnr_tpu/ops/rasterize.py).

Semantics of the reference CUDA rasterizer that rnr_tpu holds: per-face
inverse barycentric matrices, a backface cull, edge-inclusive inside
tests, clamped and renormalized barycentrics, perspective depth
1/zp = sum(w_k / z_k), a strict z-test where the first face wins ties,
and a final row flip (row 0 is the top image row).

`rasterize_face_index` is the oracle: a loop over face chunks with a
[pixels] carry, O(pixels x faces).  It is a correctness reference for the
tile-binned rasterizer (`ops/rasterize_cuda.py`, K7) and is never the
card's path.  Sums of three terms are written out in rnr_tpu's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RasterOutput(NamedTuple):
    """Raster buffers, all vertically flipped to image orientation."""

    face_index_map: torch.Tensor   # [N, S, S] int32, -1 where empty
    weight_map: torch.Tensor       # [N, S, S, 3] clamped barycentrics
    depth_map: torch.Tensor        # [N, S, S] zp, `far` where empty
    alpha_map: torch.Tensor        # [N, S, S] float 0/1
    # [N] int32 count of candidate faces the tile binning dropped (the
    # tiled rasterizer only; None from the oracle).  Non-zero means the
    # render is incomplete: raise max_faces_per_tile.
    overflow: torch.Tensor | None = None


def _ndc_to_pixel(xy: torch.Tensor, image_size: int) -> torch.Tensor:
    """NDC [-1, 1] -> pixel coordinates [0, S-1]."""
    return 0.5 * (xy * image_size + image_size - 1)


def face_inv_matrix(p: torch.Tensor) -> torch.Tensor:
    """Inverse of [[x0,y0,1],[x1,y1,1],[x2,y2,1]] via the adjugate.

    p [..., 3, 2] pixel-space vertices -> [..., 3, 3].  A degenerate face
    (den == 0) divides by 1e-30 instead; its inside tests reject it.
    """
    x0, y0 = p[..., 0, 0], p[..., 0, 1]
    x1, y1 = p[..., 1, 0], p[..., 1, 1]
    x2, y2 = p[..., 2, 0], p[..., 2, 1]
    adj = torch.stack(
        [
            y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
            y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
            y0 - y1, x1 - x0, x0 * y1 - x1 * y0,
        ],
        dim=-1,
    ).reshape(p.shape[:-2] + (3, 3))
    den = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    den = torch.where(den == 0.0, 1e-30, den)
    return adj / den[..., None, None]


def _is_backface(f: torch.Tensor) -> torch.Tensor:
    """Backface predicate of faces [..., 3, 3] in NDC."""
    x0, y0 = f[..., 0, 0], f[..., 0, 1]
    x1, y1 = f[..., 1, 0], f[..., 1, 1]
    x2, y2 = f[..., 2, 0], f[..., 2, 1]
    return (y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0)


def _inside(f: torch.Tensor, xp: torch.Tensor, yp: torch.Tensor
            ) -> torch.Tensor:
    """Edge half-plane tests in NDC; pixels exactly on an edge are inside.
    f [..., 3, 3]; xp, yp broadcastable against f's batch dims."""
    x0, y0 = f[..., 0, 0], f[..., 0, 1]
    x1, y1 = f[..., 1, 0], f[..., 1, 1]
    x2, y2 = f[..., 2, 0], f[..., 2, 1]
    in0 = (yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0)
    in1 = (yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1)
    in2 = (yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2)
    return in0 & in1 & in2


def _clamped_weights(face_inv: torch.Tensor, xi: torch.Tensor,
                     yi: torch.Tensor) -> torch.Tensor:
    """Barycentric weights at integer pixel coordinates, clamped to [0, 1]
    and renormalized.  face_inv [..., 3, 3]; xi, yi broadcastable.
    Returns [..., 3]."""
    w = (face_inv[..., :, 0] * xi[..., None]
         + face_inv[..., :, 1] * yi[..., None]
         + face_inv[..., :, 2])
    w = torch.clamp(w, 0.0, 1.0)
    s = (w[..., 0:1] + w[..., 1:2]) + w[..., 2:3]
    return w / torch.where(s == 0.0, 1e-30, s)


def _zp_from_weights(w: torch.Tensor, fz: torch.Tensor) -> torch.Tensor:
    """Perspective depth 1 / sum(w_k / z_k)."""
    q = w / fz
    denom = (q[..., 0] + q[..., 1]) + q[..., 2]
    return 1.0 / torch.where(denom == 0.0, 1e-30, denom)


def pixel_ndc(image_size: int, dtype, device) -> torch.Tensor:
    """Pixel-centre NDC coordinates (2i + 1 - S) / S of i = 0..S-1, the
    division by a tensor (see ops/projection.py)."""
    s = image_size
    i = torch.arange(s, dtype=dtype, device=device)
    return (2.0 * i + 1.0 - s) / torch.tensor(float(s), dtype=dtype,
                                              device=device)


def rasterize_face_index(
    faces: torch.Tensor,
    image_size: int,
    near: float = 0.0,
    far: float = 1e5,
    face_chunk: int = 128,
) -> RasterOutput:
    """Z-buffer rasterization of faces [N, F, 3, 3] (xy NDC, z camera
    depth) at S = image_size: per-pixel winning face, weights, depth, in
    image orientation.  Walks the faces `face_chunk` at a time."""
    n, f = faces.shape[0], faces.shape[1]
    s = image_size
    dev, dt = faces.device, faces.dtype
    xi = torch.arange(s, dtype=dt, device=dev)
    yig, xig = torch.meshgrid(xi, xi, indexing="ij")   # row = yi
    xig, yig = xig.reshape(-1), yig.reshape(-1)
    nd = pixel_ndc(s, dt, dev)
    xp = nd[None, :].expand(s, s).reshape(-1)
    yp = nd[:, None].expand(s, s).reshape(-1)

    front = ~_is_backface(faces)                          # [N, F]
    finv = face_inv_matrix(_ndc_to_pixel(faces[..., :2], s))
    best_depth = torch.full((n, s * s), far, dtype=dt, device=dev)
    best_idx = torch.full((n, s * s), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, f, face_chunk):
        cf = faces[:, None, c0:c0 + face_chunk]           # [N, 1, C, 3, 3]
        cinv = finv[:, None, c0:c0 + face_chunk]
        inside = _inside(cf, xp[None, :, None], yp[None, :, None])
        w = _clamped_weights(cinv, xig[None, :, None], yig[None, :, None])
        zp = _zp_from_weights(w, cf[..., 2])              # [N, P, C]
        ok = (inside & front[:, None, c0:c0 + face_chunk]
              & (zp > near) & (zp < far))
        depth_c = torch.where(ok, zp, torch.inf)
        cmin, carg = torch.min(depth_c, dim=2)            # first minimum
        take = cmin < best_depth
        best_depth = torch.where(take, cmin, best_depth)
        best_idx = torch.where(take, (carg + c0).to(torch.int32), best_idx)
    depth = best_depth.reshape(n, s, s)
    idx = best_idx.reshape(n, s, s)
    return finish_raster(faces, idx, depth, s, far)


def finish_raster(faces: torch.Tensor, idx: torch.Tensor,
                  depth: torch.Tensor, image_size: int, far: float,
                  finv_all: torch.Tensor | None = None,
                  overflow: torch.Tensor | None = None) -> RasterOutput:
    """From the winner map idx and depth [N, S, S] in raster orientation
    (row = yi): the winners' clamped weights, `far` where empty, alpha,
    and the row flip to image orientation."""
    n, f = faces.shape[0], faces.shape[1]
    s = image_size
    if finv_all is None:
        finv_all = face_inv_matrix(_ndc_to_pixel(faces[..., :2], s))
    safe = torch.clamp(idx, 0, f - 1).long()
    rows = torch.arange(n, device=idx.device).reshape(n, 1, 1)
    finv_px = finv_all[rows, safe]                        # [N, S, S, 3, 3]
    xi = torch.arange(s, dtype=faces.dtype, device=faces.device)
    w = _clamped_weights(finv_px, xi[None, None, :], xi[None, :, None])
    covered = idx >= 0
    w = torch.where(covered[..., None], w, 0.0)
    depth = torch.where(covered, depth, far)
    return RasterOutput(
        face_index_map=torch.flip(idx, [1]),
        weight_map=torch.flip(w, [1]),
        depth_map=torch.flip(depth, [1]),
        alpha_map=torch.flip(covered, [1]).to(faces.dtype),
        overflow=overflow,
    )


def pixel_attrs(
    faces: torch.Tensor,
    face_index_map: torch.Tensor,
    image_size: int,
    return_face_px: bool = False,
):
    """Per-pixel weights and depth of a fixed face assignment.

    Recomputes the clamped barycentrics and the perspective depth from the
    projected faces [N, F, 3, 3] at the faces `face_index_map` [N, S, S]
    (image orientation, -1 empty) selects; differentiable in `faces`.
    Returns (weight_map [N, S, S, 3], depth_map [N, S, S], covered
    [N, S, S] bool) and, with return_face_px, the gathered faces
    [N, S, S, 3, 3].
    """
    n = faces.shape[0]
    s = image_size
    covered = face_index_map >= 0
    safe = torch.clamp(face_index_map, 0, faces.shape[1] - 1).long()
    rows = torch.arange(n, device=safe.device).reshape(n, 1, 1)
    f_px = faces[rows, safe]                              # [N, S, S, 3, 3]

    # the maps are flipped: row r is raster row yi = S - 1 - r
    xi = torch.arange(s, dtype=faces.dtype, device=faces.device)
    yi = (s - 1) - xi
    p = _ndc_to_pixel(f_px[..., :2], s)
    w = _clamped_weights(face_inv_matrix(p), xi[None, None, :],
                         yi[None, :, None])
    zp = _zp_from_weights(w, f_px[..., 2])
    w = torch.where(covered[..., None], w, 0.0)
    zp = torch.where(covered, zp, 0.0)
    if return_face_px:
        return w, zp, covered, f_px
    return w, zp, covered
