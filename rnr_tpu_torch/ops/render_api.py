"""The neural_renderer API (port of rnr_tpu/ops/render_api.py, plain
torch): the camera modes (look, look_at, perspective,
get_points_from_angles), per-face Lambert lighting, trilinear sampling of
per-face texture volumes, fill_back, rasterize_rgbad with its 2x
supersampled anti-aliasing, and the `Renderer` facade of
neural_renderer/renderer.py's render() contract.

The winner maps come from `rasterize_face_index`, the oracle, as in
rnr_tpu (its render_api runs its XLA oracle, never the tile kernel);
gradients flow through autograd into the faces' depth and the textures.
`ops/edge_grad.py` adds the coverage gradients on K7's maps.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from rnr_tpu_torch.ops.projection import projection, vertices_to_faces
from rnr_tpu_torch.ops.rasterize import RasterOutput, rasterize_face_index


def _normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-5):
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True),
                           min=eps)


def _row(x, like: torch.Tensor) -> torch.Tensor:
    """x as a float32 [B, 3] tensor on like's device (jnp.atleast_2d)."""
    t = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return t.reshape(1, -1) if t.dim() < 2 else t


def _camera(vertices: torch.Tensor, eye: torch.Tensor,
            z_axis: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    x_axis = _normalize(torch.linalg.cross(up.expand_as(z_axis), z_axis))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))
    r = torch.stack((x_axis, y_axis, z_axis), dim=1)       # [B, 3, 3]
    return torch.einsum("nvj,nkj->nvk", vertices - eye[:, None, :], r)


# ------------------------------------------------------------ camera modes


def look(vertices: torch.Tensor, eye, direction=(0, 1, 0), up=(0, 1, 0)):
    """Camera at `eye` facing `direction`: vertices [B, V, 3] into its
    frame (neural_renderer's look.py)."""
    eye = _row(eye, vertices)
    z_axis = _normalize(_row(direction, vertices))
    return _camera(vertices, eye, z_axis, _row(up, vertices))


def look_at(vertices: torch.Tensor, eye, at=(0, 0, 0), up=(0, 1, 0)):
    """Camera at `eye` looking at `at` (neural_renderer's look_at.py)."""
    eye = _row(eye, vertices)
    z_axis = _normalize(_row(at, vertices) - eye)
    return _camera(vertices, eye, z_axis, _row(up, vertices))


def perspective(vertices: torch.Tensor, angle: float = 30.0):
    """x and y divided by z tan(angle) (perspective.py)."""
    width = math.tan(math.radians(angle))
    z = vertices[..., 2]
    x = vertices[..., 0] / z / width
    y = vertices[..., 1] / z / width
    return torch.stack((x, y, z), dim=-1)


def get_points_from_angles(distance, elevation, azimuth, degrees=True):
    """The camera position at `distance`, `elevation`, `azimuth`
    (get_points_from_angles.py) -> float32 [..., 3]."""
    elevation = torch.as_tensor(elevation, dtype=torch.float32)
    azimuth = torch.as_tensor(azimuth, dtype=torch.float32)
    if degrees:
        elevation = torch.deg2rad(elevation)
        azimuth = torch.deg2rad(azimuth)
    return torch.stack([
        distance * torch.cos(elevation) * torch.sin(azimuth),
        distance * torch.sin(elevation),
        -distance * torch.cos(elevation) * torch.cos(azimuth)], dim=-1)


# -------------------------------------------------------------- lighting


def lighting(faces: torch.Tensor, textures: torch.Tensor,
             intensity_ambient: float = 0.5,
             intensity_directional: float = 0.5,
             color_ambient=(1, 1, 1), color_directional=(1, 1, 1),
             direction=(0, 1, 0)) -> torch.Tensor:
    """Ambient + directional Lambert light multiplied into the textures
    (lighting.py): faces [N, F, 3, 3], textures [N, F, ts, ts, ts, 3]."""
    bs, nf = faces.shape[:2]
    dev = faces.device
    color_ambient = torch.as_tensor(color_ambient, dtype=torch.float32,
                                    device=dev).reshape(1, 3)
    color_directional = torch.as_tensor(
        color_directional, dtype=torch.float32, device=dev).reshape(1, 3)
    direction = torch.as_tensor(direction, dtype=torch.float32,
                                device=dev).reshape(1, 3)
    light = torch.zeros((bs, nf, 3), dtype=torch.float32, device=dev)
    if intensity_ambient != 0:
        light = light + intensity_ambient * color_ambient[:, None, :]
    if intensity_directional != 0:
        v10 = faces[:, :, 0] - faces[:, :, 1]
        v12 = faces[:, :, 2] - faces[:, :, 1]
        normals = _normalize(torch.linalg.cross(v10, v12))
        cos = torch.relu(torch.sum(normals * direction[:, None, :], dim=-1))
        light = light + intensity_directional * (
            color_directional[:, None, :] * cos[:, :, None])
    return textures * light[:, :, None, None, None, :]


# ------------------------------------------------------- texture sampling


def sample_textures(faces: torch.Tensor, textures: torch.Tensor,
                    face_index_map: torch.Tensor, weight_map: torch.Tensor,
                    depth_map: torch.Tensor, eps: float = 1e-4,
                    faces_px: torch.Tensor | None = None) -> torch.Tensor:
    """Trilinear samples of per-face volumes textures [N, F, ts, ts, ts, C]
    at the perspective-corrected barycentrics w_k (ts - 1) depth / z_k,
    clamped to [0, ts - 1 - eps], blended over the 2^3 corners; 0 where
    no face covers the pixel.  faces [N, F, 3, 3] (z in column 2),
    face_index_map [N, S, S], weight_map [N, S, S, 3], depth_map [N, S,
    S]; faces_px [N, S, S, 3, 3], the faces already gathered per pixel
    (`pixel_attrs(return_face_px=True)`), spares the gather.  Returns
    [N, S, S, C]."""
    n, f = faces.shape[0], faces.shape[1]
    ts, c = textures.shape[2], textures.shape[-1]
    s = face_index_map.shape[1]
    covered = face_index_map >= 0
    safe = torch.clamp(face_index_map, 0, f - 1).long()
    rows = torch.arange(n, device=safe.device).reshape(n, 1, 1)
    fz = (faces_px[..., :, 2] if faces_px is not None
          else faces[..., 2][rows, safe])                    # [N, S, S, 3]

    ti = weight_map * (ts - 1) * (depth_map[..., None] / fz)
    ti = torch.clamp(ti, 0.0, ts - 1 - eps)
    t0 = torch.floor(ti).to(torch.int64)
    frac = ti - t0

    tex_flat = textures.reshape(n, f * ts * ts * ts, c)
    out = torch.zeros((n, s, s, c), dtype=textures.dtype,
                      device=textures.device)
    for corner in range(8):
        w = torch.ones_like(frac[..., 0])
        idx3 = []
        for k in range(3):
            if (corner >> k) % 2 == 0:
                w = w * (1.0 - frac[..., k])
                idx3.append(t0[..., k])
            else:
                w = w * frac[..., k]
                idx3.append(t0[..., k] + 1)
        lin = (safe * (ts * ts * ts) + idx3[0] * (ts * ts) + idx3[1] * ts
               + idx3[2])
        out = out + w[..., None] * tex_flat[rows, lin]
    return torch.where(covered[..., None], out, 0.0)


def fill_back_faces(faces_idx: torch.Tensor) -> torch.Tensor:
    """Each face also with reversed winding: [N, F, 3] -> [N, 2F, 3]."""
    return torch.cat([faces_idx, faces_idx.flip(-1)], dim=1)


# ----------------------------------------------------------- rasterization


def pool2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 average of the two axes after the first: [B, 2S, 2S, ...] ->
    [B, S, S, ...], summed in rnr_tpu's order."""
    return (x[:, 0::2, 0::2] + x[:, 0::2, 1::2]
            + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) * 0.25


def rasterize_rgbad(faces: torch.Tensor,
                    textures: torch.Tensor | None = None,
                    image_size: int = 256, anti_aliasing: bool = True,
                    near: float = 0.1, far: float = 100.0,
                    eps: float = 1e-4, background_color=(0.0, 0.0, 0.0),
                    face_chunk: int = 128) -> dict[str, Any]:
    """Rasterize faces [N, F, 3, 3] (xy NDC, z depth) and optionally their
    texture volumes: {"rgb" [N, C, S, S] or None, "alpha", "depth" [N, S,
    S], "face_index_map" [N, S, S], "weight_map" [N, S, S, 3]}.  With
    anti_aliasing the render is made at 2S and pooled 2 x 2; the discrete
    maps keep each block's top-left sample."""
    s_render = image_size * 2 if anti_aliasing else image_size
    out: RasterOutput = rasterize_face_index(faces, s_render, near=near,
                                             far=far, face_chunk=face_chunk)
    rgb = None
    if textures is not None:
        rgb = sample_textures(faces, textures, out.face_index_map,
                              out.weight_map, out.depth_map, eps)
        bg = torch.as_tensor(background_color, dtype=rgb.dtype,
                             device=rgb.device)
        mask = (out.face_index_map >= 0)[..., None].to(rgb.dtype)
        rgb = (rgb * mask + (1.0 - mask) * bg).permute(0, 3, 1, 2)
    alpha, depth = out.alpha_map, out.depth_map
    fim, wmap = out.face_index_map, out.weight_map
    if anti_aliasing:
        if rgb is not None:
            n, c = rgb.shape[0], rgb.shape[1]
            rgb = pool2(rgb.reshape(n * c, s_render, s_render)).reshape(
                n, c, image_size, image_size)
        alpha, depth = pool2(alpha), pool2(depth)
        fim, wmap = fim[:, 0::2, 0::2], wmap[:, 0::2, 0::2]
    return {"rgb": rgb, "alpha": alpha, "depth": depth,
            "face_index_map": fim, "weight_map": wmap}


def rasterize_silhouettes(faces, image_size=256, anti_aliasing=True,
                          near=0.1, far=100.0) -> torch.Tensor:
    """The alpha map alone."""
    return rasterize_rgbad(faces, None, image_size, anti_aliasing, near,
                           far)["alpha"]


def rasterize_depth(faces, image_size=256, anti_aliasing=True, near=0.1,
                    far=100.0) -> torch.Tensor:
    """The depth map alone."""
    return rasterize_rgbad(faces, None, image_size, anti_aliasing, near,
                           far)["depth"]


# ------------------------------------------------------------- the facade


class Renderer:
    """neural_renderer's Renderer: camera modes "projection" (K, R, t,
    dist_coeffs, orig_size), "look_at" and "look" (`eye`, perspective by
    `viewing_angle`), fill_back, Lambert lighting into the textures, then
    rasterize_rgbad.  render() returns the fork's 8-tuple (rgb, depth,
    alpha, face_index_map, weight_map, vertices, faces_v, faces)."""

    def __init__(self, image_size: int = 256, anti_aliasing: bool = True,
                 background_color=(0, 0, 0), fill_back: bool = True,
                 camera_mode: str = "projection", K=None, R=None, t=None,
                 dist_coeffs=None, orig_size: int = 1024,
                 perspective_flag: bool = True, viewing_angle: float = 30.0,
                 camera_direction=(0, 0, 1), near: float = 0.1,
                 far: float = 100.0, light_intensity_ambient: float = 0.5,
                 light_intensity_directional: float = 0.5,
                 light_color_ambient=(1, 1, 1),
                 light_color_directional=(1, 1, 1),
                 light_direction=(0, 1, 0)):
        self.image_size = image_size
        self.anti_aliasing = anti_aliasing
        self.background_color = background_color
        self.fill_back = fill_back
        self.camera_mode = camera_mode
        self.K, self.R, self.t = K, R, t
        self.dist_coeffs = dist_coeffs
        self.orig_size = orig_size
        self.perspective = perspective_flag
        self.viewing_angle = viewing_angle
        self.camera_direction = camera_direction
        self.eye = None
        self.near = near
        self.far = far
        self.rasterizer_eps = 1e-3
        self.light_intensity_ambient = light_intensity_ambient
        self.light_intensity_directional = light_intensity_directional
        self.light_color_ambient = light_color_ambient
        self.light_color_directional = light_color_directional
        self.light_direction = light_direction

    def _transform(self, vertices, K, R, t, dist_coeffs, orig_size, offset,
                   scale):
        if self.camera_mode in ("look_at", "look"):
            v = (look_at(vertices, self.eye) if self.camera_mode == "look_at"
                 else look(vertices, self.eye, self.camera_direction))
            return perspective(v, self.viewing_angle) if self.perspective \
                else v
        if self.camera_mode == "projection":
            K = K if K is not None else self.K
            R = R if R is not None else self.R
            t = t if t is not None else self.t
            if dist_coeffs is None:
                dist_coeffs = self.dist_coeffs
            if dist_coeffs is None:
                dist_coeffs = torch.zeros((vertices.shape[0], 5),
                                          device=vertices.device)
            orig_size = orig_size if orig_size is not None else \
                self.orig_size
            return projection(vertices, K, R, t, dist_coeffs, orig_size,
                              offset, scale)
        raise ValueError(f"unknown camera mode {self.camera_mode}")

    def render(self, vertices, faces, textures, K=None, R=None, t=None,
               dist_coeffs=None, orig_size=None, offset=None, scale=None):
        if self.fill_back:
            faces = fill_back_faces(faces)
            if textures is not None:
                textures = torch.cat(
                    [textures, textures.permute(0, 1, 4, 3, 2, 5)], dim=1)
        if textures is not None:
            textures = lighting(
                vertices_to_faces(vertices, faces), textures,
                self.light_intensity_ambient,
                self.light_intensity_directional, self.light_color_ambient,
                self.light_color_directional, self.light_direction)
        vertices = self._transform(vertices, K, R, t, dist_coeffs,
                                   orig_size, offset, scale)
        faces_v = vertices_to_faces(vertices, faces)
        out = rasterize_rgbad(faces_v, textures, self.image_size,
                              self.anti_aliasing, self.near, self.far,
                              self.rasterizer_eps, self.background_color)
        return (out["rgb"], out["depth"], out["alpha"],
                out["face_index_map"], out["weight_map"], vertices, faces_v,
                faces)
