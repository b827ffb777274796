"""The per-view G-buffer: project, rasterize, interpolate every per-pixel
map (port of rnr_tpu/ops/gbuffer.py).

`render_gbuffer` is one view's mesh -> maps: the projection, the
z-buffer (`backend="auto"`: K7, the tile-binned rasterizer of
`ops/rasterize_cuda.py`, whose CPU tensors take its plain version;
`"xla"`: the oracle `rasterize_face_index`, as in rnr_tpu), then the
winners' perspective-corrected barycentrics and the uv, normal, position,
TBN, view-direction, reflection and SH-basis maps.  Contractions over a
face's three corners and 3x3 transforms are written as elementwise sums,
which round alike on the card and the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rnr_tpu_torch.ops.backend import resolve_device
from rnr_tpu_torch.ops.cameras import get_reflect_dir, get_view_dir_map
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear
from rnr_tpu_torch.ops.projection import (projection, rows_dot,
                                          vertices_to_faces)
from rnr_tpu_torch.ops.rasterize import (RasterOutput, pixel_attrs,
                                         rasterize_face_index)
from rnr_tpu_torch.ops.rasterize_cuda import rasterize_tiled
from rnr_tpu_torch.ops.sh import evaluate_sh_basis
from rnr_tpu_torch.ops.tbn import face_tangents, get_tbn_map, normalize

BACKENDS = ("auto", "xla")


class MeshBuffers(NamedTuple):
    """A mesh's arrays on the device."""

    vertices: torch.Tensor   # [V, 3]
    faces: torch.Tensor      # [F, 3] int32
    vt: torch.Tensor         # [Vt, 2]
    f_vt_idx: torch.Tensor   # [F, 3] int32
    vn: torch.Tensor         # [Vn, 3]
    f_vn_idx: torch.Tensor   # [F, 3] int32
    span_max: torch.Tensor   # [] the bounding box's largest span


def make_mesh_buffers(mesh, device=None) -> MeshBuffers:
    """Upload a host mesh (`rnr_tpu_torch.data.Mesh`, or anything with its
    v / f_v_idx / vt / f_vt_idx / vn / f_vn_idx / span_max) to the current
    CUDA device, or to `device`."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    return MeshBuffers(vertices=f32(mesh.v), faces=i32(mesh.f_v_idx),
                       vt=f32(mesh.vt), f_vt_idx=i32(mesh.f_vt_idx),
                       vn=f32(mesh.vn), f_vn_idx=i32(mesh.f_vn_idx),
                       span_max=f32(mesh.span_max))


def _gather_face_attr(per_face: torch.Tensor, face_index_map: torch.Tensor):
    """[F, 3, A] per-face-corner attributes at face ids [N, S, S] ->
    [N, S, S, 3, A]."""
    idx = torch.clamp(face_index_map, 0, per_face.shape[0] - 1).long()
    return per_face[idx]


def _corner_sum(w: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., k] px[..., k, :]: w [..., 3], px [..., 3, C]."""
    return (w[..., 0:1] * px[..., 0, :] + w[..., 1:2] * px[..., 1, :]
            + w[..., 2:3] * px[..., 2, :])


def project_faces(mesh: MeshBuffers, proj, pose, dist_coeffs, offset,
                  scale, image_size: int):
    """The mesh's vertices [N, V, 3] and faces [N, F, 3, 3] in NDC (xy)
    and camera depth (z), for each of the N cameras."""
    R = pose[:, :3, :3]
    t = pose[:, :3, 3][:, None, :]
    n = proj.shape[0]
    v_ndc = projection(mesh.vertices[None], proj, R, t, dist_coeffs,
                       image_size, offset, scale)
    faces_ndc = vertices_to_faces(
        v_ndc, mesh.faces[None].expand((n,) + tuple(mesh.faces.shape)))
    return v_ndc, faces_ndc


def _project_and_raster(mesh: MeshBuffers, proj, pose, dist_coeffs, offset,
                        scale, image_size: int, near: float, far: float,
                        face_chunk: int, backend: str):
    """Projection + z-buffer (the t_raster stage)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    s = image_size
    v_ndc, faces_ndc = project_faces(mesh, proj, pose, dist_coeffs, offset,
                                     scale, s)
    if backend == "auto":
        raster = rasterize_tiled(faces_ndc, s, near=near, far=far,
                                 tile_h=min(32, s), tile_w=min(128, s))
    else:
        raster = rasterize_face_index(faces_ndc, s, near=near, far=far,
                                      face_chunk=face_chunk)
    return v_ndc, faces_ndc, raster


def render_raster(mesh: MeshBuffers, proj: torch.Tensor, pose: torch.Tensor,
                  dist_coeffs: torch.Tensor, offset, scale, image_size: int,
                  near: float = 0.0, far: float = 1e5, face_chunk: int = 128,
                  backend: str = "auto") -> RasterOutput:
    """The raster stage alone: projection + winner-map z-buffer, no maps."""
    return _project_and_raster(mesh, proj, pose, dist_coeffs, offset, scale,
                               image_size, near, far, face_chunk, backend)[2]


def render_gbuffer(
    mesh: MeshBuffers,
    proj: torch.Tensor,
    pose: torch.Tensor,
    dist_coeffs: torch.Tensor,
    offset: torch.Tensor | None,
    scale: torch.Tensor | None,
    image_size: int,
    near: float = 0.0,
    far: float = 1e5,
    face_chunk: int = 128,
    with_high_maps: bool = True,
    with_sh: bool = True,
    sh_lmax: int = 2,
    backend: str = "auto",
) -> dict[str, Any]:
    """Render one batch of views' G-buffers.

    mesh: MeshBuffers; proj [N, 3, 3] intrinsics; pose [N, 4, 4]
    camera-from-world; dist_coeffs [N, 5]; offset, scale [N, 2] or None;
    image_size S.  Maps in image orientation (row 0 = top): uv_map
    [N,S,S,2], alpha_map [N,S,S], face_index_map [N,S,S], weight_map
    [N,S,S,3,1] (perspective-corrected), normal_map / normal_map_cam /
    position_map / position_map_cam [N,S,S,3], depth_map [N,S,S], v_uvz
    [N,V,3], v_front_mask [N,V], raster_overflow [N] (the tiled
    rasterizer's dropped candidates; not from the oracle), and with
    with_high_maps: TBN_map [N,S,S,3,3], view_dir_map[_cam],
    view_dir_map_tangent, reflect_dir_map [N,S,S,3] and, with with_sh,
    sh_basis_map [N,S,S,(sh_lmax+1)^2].
    """
    R = pose[:, :3, :3]
    t = pose[:, :3, 3][:, None, :]
    s = image_size
    n = proj.shape[0]

    v_ndc, faces_ndc, raster = _project_and_raster(
        mesh, proj, pose, dist_coeffs, offset, scale, s, near, far,
        face_chunk, backend)
    fim = raster.face_index_map
    depth = raster.depth_map
    alpha = raster.alpha_map
    covered = fim >= 0

    # screen-space vertex positions in pixels and front visibility
    v_uvz = torch.stack([(v_ndc[..., 0] * 0.5 + 0.5) * s,
                         (1.0 - (v_ndc[..., 1] * 0.5 + 0.5)) * s,
                         v_ndc[..., 2]], dim=-1)
    v_depth = torch.stack([
        interpolate_bilinear(depth[b][..., None], v_uvz[b, :, 0],
                             v_uvz[b, :, 1])[..., 0] for b in range(n)])
    v_front_mask = (v_uvz[..., 2] - v_depth) < mesh.span_max * 5e-3

    # clamped barycentrics at the winners, perspective-corrected:
    # w <- w / z_k * zp
    w, zp, _ = pixel_attrs(faces_ndc, fim, s)
    rows = torch.arange(n, device=fim.device).reshape(n, 1, 1)
    z_k = faces_ndc[..., 2][rows, torch.clamp(
        fim, 0, faces_ndc.shape[1] - 1).long()]              # [N, S, S, 3]
    w = w / torch.where(z_k == 0.0, 1e30, z_k) * zp[..., None]
    w = torch.where(covered[..., None], w, 0.0)

    # uv, wrapped to [0, 1)
    faces_vt = mesh.vt[mesh.f_vt_idx.long()]                # [F, 3, 2]
    uv_map = _corner_sum(w, _gather_face_attr(faces_vt, fim))
    uv_map = uv_map - torch.floor(uv_map)

    # normals, world and camera
    faces_vn = mesh.vn[mesh.f_vn_idx.long()]                # [F, 3, 3]
    normal_map = normalize(_corner_sum(w, _gather_face_attr(faces_vn, fim)))
    normal_map_cam = normalize(rows_dot(normal_map, R))

    # positions, world and camera
    faces_v = mesh.vertices[mesh.faces.long()]              # [F, 3, 3]
    position_map = _corner_sum(w, _gather_face_attr(faces_v, fim))
    position_map_cam = rows_dot(position_map, R) + t[:, None]

    out: dict[str, Any] = {
        "uv_map": uv_map,
        "alpha_map": alpha,
        "face_index_map": fim,
        "weight_map": w[..., None],
        "normal_map": normal_map,
        "normal_map_cam": normal_map_cam,
        "position_map": position_map,
        "position_map_cam": position_map_cam,
        "depth_map": depth,
        "v_uvz": v_uvz,
        "v_front_mask": v_front_mask,
    }
    if raster.overflow is not None:
        out["raster_overflow"] = raster.overflow

    if with_high_maps:
        tbn = get_tbn_map(normal_map, fim,
                          tangent=face_tangents(faces_v, faces_vt))
        # inv_ex: no check of the result on the host, so no sync (jnp's
        # inv does not check either)
        proj_inv = torch.linalg.inv_ex(proj).inverse
        view_dir_map, view_dir_map_cam = get_view_dir_map(
            (s, s), proj_inv, R.transpose(1, 2))
        # tangent-space view direction: TBN^T v
        vdt = normalize(view_dir_map[..., 0:1] * tbn[..., 0, :]
                        + view_dir_map[..., 1:2] * tbn[..., 1, :]
                        + view_dir_map[..., 2:3] * tbn[..., 2, :])
        out.update(
            TBN_map=tbn,
            view_dir_map=view_dir_map,
            view_dir_map_cam=view_dir_map_cam,
            view_dir_map_tangent=vdt,
            reflect_dir_map=(get_reflect_dir(view_dir_map, normal_map)
                             * alpha[..., None]),
        )
        if with_sh:
            out["sh_basis_map"] = evaluate_sh_basis(sh_lmax, view_dir_map)
    return out
