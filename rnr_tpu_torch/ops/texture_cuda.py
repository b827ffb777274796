"""K2: mipmap texture gather (csrc/mipmap_gather.cu) and its twin.

Replaces rnr_tpu/ops/texture_pallas.py::mipmap_sample (the forward
`gather_taps` per level, summed).  The kernel reads the texture in f32,
matching the f32 XLA path the JAX model takes off the TPU, not the TPU
kernel's bf16 rounding of the texture.
"""

from __future__ import annotations

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear

LEVELS_PER_LAUNCH = 4   # csrc/mipmap_gather.cu MAX_LEVELS


def level_coords(uv_map: torch.Tensor, size: int):
    """uv in [0, 1] -> texel coordinates of a level (v flipped)."""
    x = uv_map[..., 0] * (size - 1)
    y = (size - 1) - uv_map[..., 1] * (size - 1)
    return x, y


def mipmap_sample_torch(textures, uv_map: torch.Tensor) -> torch.Tensor:
    """Plain twin: interpolate_bilinear per level, summed in level order."""
    out = None
    for tex in textures:
        x, y = level_coords(uv_map, tex.shape[0])
        s = interpolate_bilinear(tex, x, y)
        out = s if out is None else out + s
    return out


def mipmap_sample(textures, uv_map: torch.Tensor) -> torch.Tensor:
    """textures: sequence of [S_l, S_l, Ch] f32; uv_map [N, H, W, 2] f32
    -> [N, H, W, Ch] f32."""
    if not use_kernel(uv_map, *textures):
        return mipmap_sample_torch(textures, uv_map)
    n, h, w, _ = uv_map.shape
    ch = textures[0].shape[-1]
    uv = uv_map.contiguous()
    require(uv, "uv_map", torch.float32, (n, h, w, 2))
    texs = [t.contiguous() for t in textures]
    for i, t in enumerate(texs):
        require(t, f"texture_{i}", torch.float32,
                (t.shape[0], t.shape[0], ch))
    out = torch.empty((n, h, w, ch), dtype=torch.float32,
                      device=uv.device)
    f = _build.fn("mipmap_gather", "rnr_mipmap_gather", 6, 8)
    stream = stream_of(uv)
    for g in range(0, len(texs), LEVELS_PER_LAUNCH):
        grp = texs[g:g + LEVELS_PER_LAUNCH]
        ptrs = [t.data_ptr() for t in grp] + [0] * (LEVELS_PER_LAUNCH - len(grp))
        sizes = [t.shape[0] for t in grp] + [0] * (LEVELS_PER_LAUNCH - len(grp))
        mipmap_sample.launches += 1
        check_launch(f(*ptrs, uv.data_ptr(), out.data_ptr(), *sizes,
                       len(grp), n * h * w, ch, int(g > 0), stream),
                     "mipmap_gather")
    return out


mipmap_sample.launches = 0
