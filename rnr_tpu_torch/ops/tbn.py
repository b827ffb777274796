"""Per-pixel tangent / bitangent / normal frames (port of
rnr_tpu/ops/tbn.py): from face tangents (`get_tbn_map`, the G-buffer's)
or from screen-space differences of the position and uv maps
(`get_tbn_map_perpixel`, which no driver calls)."""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12
              ) -> torch.Tensor:
    """v / max(|v|, eps) along `dim`."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=dim, keepdim=True),
                           min=eps)


def face_tangents(faces_v: torch.Tensor, faces_texcoord: torch.Tensor
                  ) -> torch.Tensor:
    """Per-face tangent from UV deltas: faces_v [F, 3, 3] world positions,
    faces_texcoord [F, 3, 2] -> [F, 3] unnormalized."""
    e1 = faces_v[:, 1] - faces_v[:, 0]
    e2 = faces_v[:, 2] - faces_v[:, 0]
    duv1 = faces_texcoord[:, 1] - faces_texcoord[:, 0]
    duv2 = faces_texcoord[:, 2] - faces_texcoord[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    f = 1.0 / torch.clamp(det, min=1e-8)
    return f[:, None] * (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2)


def get_tbn_map(
    normal_map: torch.Tensor,
    face_index_map: torch.Tensor,
    faces_v: torch.Tensor | None = None,
    faces_texcoord: torch.Tensor | None = None,
    tangent: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-pixel tangent-space-to-world matrix [N, H, W, 3, 3] with columns
    (tangent, bitangent, normal): TBN @ v_tangent = v_world.

    normal_map [N, H, W, 3]; face_index_map [N, H, W] int (-1 empty,
    gathers clamp); the face tangents [F, 3] as `tangent`, or computed
    from faces_v [F, 3, 3] and faces_texcoord [F, 3, 2].
    """
    if tangent is None:
        if faces_v is None or faces_texcoord is None:
            raise ValueError("need faces_v/faces_texcoord when tangent is None")
        tangent = face_tangents(faces_v, faces_texcoord)
    tangent = normalize(tangent)
    idx = torch.clamp(face_index_map, 0, tangent.shape[0] - 1).long()
    tangent_map = tangent[idx]                        # [N, H, W, 3]
    normal_map = normalize(normal_map)
    bitangent_map = normalize(torch.linalg.cross(normal_map, tangent_map,
                                                 dim=-1))
    # re-orthogonalize the tangent against the interpolated normal
    tangent_map = normalize(torch.linalg.cross(bitangent_map, normal_map,
                                               dim=-1))
    return torch.stack((tangent_map, bitangent_map, normal_map), dim=-1)


def get_tbn_map_perpixel(normal_map: torch.Tensor, position_map: torch.Tensor,
                         uv_map: torch.Tensor, alpha_map: torch.Tensor
                         ) -> torch.Tensor:
    """Screen-space TBN [N, H, W, 3, 3] from finite differences of the
    position [N, H, W, 3] and uv [N, H, W, 2] maps: a forward difference
    where the next pixel is covered (alpha_map [N, H, W, 1]), else a
    backward one, along x and y; tangent and bitangent from the
    position-vs-uv derivatives (|det| below 1e-12 taken as 1e-12), the
    normal from normal_map [N, H, W, 3]."""
    data = torch.cat([position_map, uv_map], dim=-1)       # [N, H, W, 5]

    def diff(x, dim, forward):
        d = torch.diff(x, dim=dim)
        pad = [0, 0] * (x.ndim - 1 - dim) + ([0, 1] if forward else [1, 0])
        return torch.nn.functional.pad(d, pad)

    a = alpha_map
    a_x0 = (diff(a, 2, True) + a * 2 > 1.5) & (a > 0)   # next pixel covered
    a_y0 = (diff(a, 1, True) + a * 2 > 1.5) & (a > 0)
    ex = torch.where(a_x0, diff(data, 2, True), diff(data, 2, False))
    ey = torch.where(a_y0, diff(data, 1, True), diff(data, 1, False))
    dpos1, duv1 = ex[..., :3], ex[..., 3:]
    dpos2, duv2 = ey[..., :3], ey[..., 3:]
    det = duv1[..., 0] * duv2[..., 1] - duv2[..., 0] * duv1[..., 1]
    f = 1.0 / torch.where(torch.abs(det) < 1e-12,
                          torch.full_like(det, 1e-12), det)
    tangent = normalize(f[..., None] * (duv2[..., 1:2] * dpos1
                                        - duv1[..., 1:2] * dpos2))
    bitangent = normalize(f[..., None] * (-duv2[..., 0:1] * dpos1
                                          + duv1[..., 0:1] * dpos2))
    return torch.stack((tangent, bitangent, normalize(normal_map)), dim=-1)
