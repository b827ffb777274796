"""Per-face texture volumes <-> a 2-D texture image (port of
rnr_tpu/ops/texture_atlas.py, plain torch: rnr_tpu runs no Pallas kernel
here).

- `load_textures` fills per-face volumetric textures [F, ts, ts, ts, 3]
  from a texture image through the face corners' UVs, a wrap mode and
  bilinear or nearest sampling (neural_renderer's load_textures kernel).
- `create_texture_image` bakes per-face volumes into a tiled 2-D atlas
  and the faces' atlas UVs, for an OBJ export (its create_texture_image
  kernel).

Both are gathers, differentiable in the image and the volumes.
"""

from __future__ import annotations

import math

import torch

REPEAT = 0
MIRRORED_REPEAT = 1
CLAMP_TO_EDGE = 2
CLAMP_TO_BORDER = 3


def _wrap_uv(face_uv: torch.Tensor, mode: int) -> torch.Tensor:
    """UVs wrapped into [0, 1] by `mode` (jnp.mod's floored remainder)."""
    if mode == REPEAT:
        return torch.remainder(face_uv, 1.0)
    if mode == MIRRORED_REPEAT:
        frac = torch.remainder(face_uv, 1.0)
        return torch.where(torch.remainder(face_uv, 2.0) < 1.0, frac,
                           1.0 - frac)
    if mode in (CLAMP_TO_EDGE, CLAMP_TO_BORDER):
        return torch.clamp(face_uv, 0.0, 1.0)
    raise ValueError(f"unknown wrap mode {mode}")


def load_textures(image: torch.Tensor, faces_uv: torch.Tensor,
                  texture_size: int, wrap: int = REPEAT,
                  use_bilinear: bool = True) -> torch.Tensor:
    """Sample a texture image [H, W, 3] into per-face volumes.

    faces_uv [F, 3, 2]: per-face-corner UVs (v from the bottom, flipped
    by the caller as the reference's load_obj does).  Each voxel (i, j, k)
    of a face's ts^3 volume samples the image at the corners' UVs blended
    by the weights (i, j, k) / (i + j + k) (voxel (0, 0, 0): weights 0,
    pixel (0, 0)), scaled to pixels by (W - 1, H - 1).  CLAMP_TO_BORDER
    gives zeros.  Returns [F, ts, ts, ts, 3]."""
    h, w = image.shape[0], image.shape[1]
    ts = texture_size
    uv = _wrap_uv(faces_uv, wrap)                          # [F, 3, 2]

    d0 = torch.arange(ts, dtype=image.dtype, device=image.device) / (ts - 1)
    g0, g1, g2 = torch.meshgrid(d0, d0, d0, indexing="ij")
    gsum = g0 + g1 + g2
    scale = torch.where(gsum > 0, 1.0 / torch.clamp(gsum, min=1e-20),
                        torch.ones_like(gsum))
    w0, w1, w2 = g0 * scale, g1 * scale, g2 * scale         # [ts, ts, ts]

    def corner(c, axis):
        return uv[:, c, axis][:, None, None, None]

    pos_x = (corner(0, 0) * w0 + corner(1, 0) * w1
             + corner(2, 0) * w2) * (w - 1)
    pos_y = (corner(0, 1) * w0 + corner(1, 1) * w1
             + corner(2, 1) * w2) * (h - 1)

    flat = image.reshape(h * w, 3)
    if use_bilinear:
        x0 = torch.floor(pos_x).to(torch.int64)
        y0 = torch.floor(pos_y).to(torch.int64)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        wx1 = pos_x - x0
        wx0 = 1.0 - wx1
        wy1 = pos_y - y0
        wy0 = 1.0 - wy1
        out = (flat[y0 * w + x0] * (wx0 * wy0)[..., None]
               + flat[y1 * w + x0] * (wx0 * wy1)[..., None]
               + flat[y0 * w + x1] * (wx1 * wy0)[..., None]
               + flat[y1 * w + x1] * (wx1 * wy1)[..., None])
    else:
        xi = torch.round(pos_x).to(torch.int64)
        yi = torch.round(pos_y).to(torch.int64)
        out = flat[yi * w + xi]
    if wrap == CLAMP_TO_BORDER:
        out = torch.zeros_like(out)
    return out


def create_texture_image(textures: torch.Tensor, texture_size_out: int = 16,
                         eps: float = 1e-5):
    """Bake per-face volumes [F, tsi, tsi, tsi, 3] into a tiled atlas.

    Face f takes the tile (f % tile_width, f // tile_width) of
    texture_size_out pixels a side, sampled trilinearly at its canonical
    right triangle's barycentrics.  Returns (image [H, W, 3], faces_uv
    [F, 3, 2]): the atlas and the faces' normalised UVs into it (v from
    the top, like the image)."""
    f = textures.shape[0]
    tsi = textures.shape[1]
    tso = texture_size_out
    dt, dev = textures.dtype, textures.device
    tile_width = int(math.ceil(math.sqrt(f)))
    tile_height = int(math.ceil(f / tile_width))
    h, w = tile_height * tso, tile_width * tso

    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    fn = torch.clamp(xs // tso + (ys // tso) * tile_width, 0, f - 1)

    x_in = (xs % tso).to(dt)
    y_in = (ys % tso).to(dt)
    denom = float(tso - 1)
    w1 = x_in / denom - y_in / denom
    w2 = y_in / denom
    w0 = 1.0 - w1 - w2
    wts = torch.stack([w0, w1, w2], dim=-1)
    wts = wts / (torch.sum(wts, dim=-1, keepdim=True) + eps)

    ti = torch.clamp(wts * (tsi - 1), 0.0, tsi - 1 - eps)
    t0 = torch.floor(ti).to(torch.int64)
    frac = ti - t0

    tex_flat = textures.reshape(f * tsi * tsi * tsi, 3)
    out = torch.zeros((h, w, 3), dtype=dt, device=dev)
    for c in range(8):
        cw = torch.ones_like(frac[..., 0])
        idx3 = []
        for k in range(3):
            if (c >> k) % 2 == 0:
                cw = cw * (1.0 - frac[..., k])
                idx3.append(t0[..., k])
            else:
                cw = cw * frac[..., k]
                idx3.append(torch.clamp(t0[..., k] + 1, max=tsi - 1))
        lin = (fn * (tsi * tsi * tsi) + idx3[0] * (tsi * tsi)
               + idx3[1] * tsi + idx3[2])
        out = out + cw[..., None] * tex_flat[lin]

    fid = torch.arange(f, device=dev)
    x0f = ((fid % tile_width) * tso).to(dt)
    y0f = ((fid // tile_width) * tso).to(dt)
    p0 = torch.stack([x0f, y0f], -1)
    p1 = torch.stack([x0f + tso - 1, y0f], -1)
    p2 = torch.stack([x0f, y0f + tso - 1], -1)
    uv = torch.stack([p0, p1, p2], dim=1)
    uv = uv / torch.tensor([w - 1, h - 1], dtype=dt, device=dev)
    return out, uv
