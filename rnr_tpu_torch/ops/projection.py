"""Camera projection and per-face attribute gathers (port of
rnr_tpu/ops/projection.py).

OpenCV-style pinhole projection with radial / tangential distortion and
the crop-offset / resize-scale extension.  The 3x3 products are written
as elementwise sums, and the one division by the image side divides by a
tensor: PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, so this keeps the card's NDC coordinates bit for bit equal to
the CPU's, and with them the rasterizer's winners.
"""

from __future__ import annotations

import torch


def rows_dot(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [N, ..., 3], m [N, 3, 3] -> sum_j a[..., j] m[n, k, j], i.e.
    einsum("n...j,nkj->n...k"), as ((a0 m0 + a1 m1) + a2 m2)."""
    mm = m.reshape((m.shape[0],) + (1,) * (a.dim() - 2) + (3, 3))
    return (a[..., 0:1] * mm[..., 0] + a[..., 1:2] * mm[..., 1]
            + a[..., 2:3] * mm[..., 2])


def projection(
    vertices: torch.Tensor,
    K: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    dist_coeffs: torch.Tensor,
    orig_size: int,
    offset: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    eps: float = 1e-9,
) -> torch.Tensor:
    """World-space vertices [N, V, 3] -> [N, V, 3] (u, v, z): u, v in NDC
    [-1, 1] with v pointing up, z the camera-space depth.

    K, R [N, 3, 3]; t [N, 1, 3] (camera-from-world); dist_coeffs [N, 5]
    (k1, k2, p1, p2, k3); offset / scale [N, 2] (y, x) or None.
    """
    cam = rows_dot(vertices, R) + t
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    x_ = x / (z + eps)
    y_ = y / (z + eps)

    k1 = dist_coeffs[:, None, 0]
    k2 = dist_coeffs[:, None, 1]
    p1 = dist_coeffs[:, None, 2]
    p2 = dist_coeffs[:, None, 3]
    k3 = dist_coeffs[:, None, 4]

    r2 = x_ * x_ + y_ * y_
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x__ = x_ * radial + 2.0 * p1 * x_ * y_ + p2 * (r2 + 2.0 * x_ * x_)
    y__ = y_ * radial + p1 * (r2 + 2.0 * y_ * y_) + 2.0 * p2 * x_ * y_

    pix = rows_dot(torch.stack([x__, y__, torch.ones_like(z)], dim=-1), K)
    u, v = pix[..., 0], pix[..., 1]

    if offset is not None and scale is not None:
        u = (u + offset[:, None, 1]) * scale[:, None, 1]
        v = (v + offset[:, None, 0]) * scale[:, None, 0]

    size = torch.tensor(float(orig_size), dtype=u.dtype, device=u.device)
    v = orig_size - v
    u = 2.0 * (u - orig_size / 2.0) / size
    v = 2.0 * (v - orig_size / 2.0) / size
    return torch.stack([u, v, z], dim=-1)


def _batch_gather(per_vertex: torch.Tensor, faces: torch.Tensor):
    """per_vertex [N, V, A], faces [N, F, 3] -> [N, F, 3, A]."""
    n = per_vertex.shape[0]
    rows = torch.arange(n, device=faces.device).reshape(n, 1, 1)
    return per_vertex[rows, faces.long()]


def vertices_to_faces(vertices: torch.Tensor, faces: torch.Tensor
                      ) -> torch.Tensor:
    """vertices [N, V, 3]; faces [1 or N, F, 3] int -> [N, F, 3, 3]."""
    if faces.shape[0] == 1 and vertices.shape[0] != 1:
        faces = faces.expand((vertices.shape[0],) + tuple(faces.shape[1:]))
    return _batch_gather(vertices, faces)


def vertex_attrs_to_faces(vertex_attrs: torch.Tensor, faces: torch.Tensor
                          ) -> torch.Tensor:
    """vertex_attrs [N, V, A]; faces [N, F, 3] int -> [N, F, 3, A]."""
    return _batch_gather(vertex_attrs, faces)


def interp_vertex_attr(v_attr: torch.Tensor, faces_v_idx: torch.Tensor,
                       face_index_map: torch.Tensor,
                       weight_map: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of vertex attributes over a raster.

    v_attr [V, A] or [N, V, A]; faces_v_idx [N, F, 3]; face_index_map
    [N, H, W]; weight_map [N, H, W, 3, 1] -> [N, H, W, A].
    """
    n = faces_v_idx.shape[0]
    if v_attr.dim() == 2:
        v_attr = v_attr[None].expand((n,) + tuple(v_attr.shape))
    faces_attr = vertex_attrs_to_faces(v_attr, faces_v_idx)   # [N, F, 3, A]
    idx = torch.clamp(face_index_map, 0, faces_attr.shape[1] - 1).long()
    rows = torch.arange(n, device=idx.device).reshape(n, 1, 1)
    px = faces_attr[rows, idx]                                # [N, H, W, 3, A]
    return torch.sum(px * weight_map, dim=-2)
