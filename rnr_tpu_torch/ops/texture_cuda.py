"""K2 / K2b: mipmap texture gather (csrc/mipmap_gather.cu) and its
backward, the bilinear scatter into every level (csrc/mipmap_scatter.cu),
with their plain versions, bound into one autograd.Function.

Replaces rnr_tpu/ops/texture_pallas.py::mipmap_sample with its custom VJP
(the forward `gather_taps` per level, summed; the backward `scatter_taps`
per level).  Both kernels work in f32, matching the f32 XLA path the JAX
model takes off the TPU, not the TPU kernels' bf16 rounding of the texture
and of w * g.  uv is G-buffer data and gets no gradient (:589).
"""

from __future__ import annotations

import numpy as np
import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)
from rnr_tpu_torch.ops.interpolate import bilinear_taps, interpolate_bilinear

LEVELS_PER_LAUNCH = 4   # csrc/mipmap_common.cuh MAX_LEVELS
SCATTER_MAX_CH = 128    # csrc/mipmap_scatter.cu MAX_CH


def level_coords(uv_map: torch.Tensor, size: int):
    """uv in [0, 1] -> texel coordinates of a level (v flipped)."""
    x = uv_map[..., 0] * (size - 1)
    y = (size - 1) - uv_map[..., 1] * (size - 1)
    return x, y


def mipmap_sample_torch(textures, uv_map: torch.Tensor) -> torch.Tensor:
    """Plain version: interpolate_bilinear per level, summed in level order."""
    out = None
    for tex in textures:
        x, y = level_coords(uv_map, tex.shape[0])
        s = interpolate_bilinear(tex, x, y)
        out = s if out is None else out + s
    return out


def scatter_taps_torch(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Plain version of one level's scatter (`_xla_scatter_taps`):
    x, y [...] texel coordinates, g [..., Ch] -> [size, size, Ch] f32, the
    four taps added in the order 00, 10, 01, 11."""
    ch = g.shape[-1]
    gf = g.reshape(-1, ch).to(torch.float32)
    out = torch.zeros((size * size, ch), dtype=torch.float32, device=g.device)
    for idx, w in bilinear_taps(x.reshape(-1).to(torch.float32),
                                y.reshape(-1).to(torch.float32), size, size):
        out.index_add_(0, idx, w[:, None] * gf)
    return out.reshape(size, size, ch)


def mipmap_scatter_torch(uv_map: torch.Tensor, g: torch.Tensor, sizes):
    """Plain version of K2b: the gradient of every level, f32."""
    grads = []
    for s in sizes:
        x, y = level_coords(uv_map, s)
        grads.append(scatter_taps_torch(x, y, g, s))
    return grads


def grid_exponent(gmax: float, n_pixels: int) -> int:
    """K2b's fixed-point grid 2^-k for one call, the rule of
    `grid_exponent` in csrc/mipmap_scatter.cu: with M = max|g| < 2^(E+1)
    (E from M's f32 exponent field, at least -126) and P < 2^p pixels,
    k = 61 - p - E keeps P * M * 2^k, the most a texel's sum can reach,
    below 2^62."""
    bits = int(np.float32(abs(gmax)).view(np.uint32))
    return 61 - int(n_pixels).bit_length() - (max(bits >> 23, 1) - 127)


def mipmap_scatter_fixed_torch(uv_map: torch.Tensor, g: torch.Tensor,
                               sizes):
    """K2b's arithmetic in plain torch, bit for bit: each tap's w * g,
    exact in float64, rounded onto the grid 2^-k (`grid_exponent`, ties
    to even), summed as int64 (in any order: the sum is exact), then the
    sum to float64, times 2^-k, to f32.  NaN everywhere for a non-finite
    g.  Off the main path: it is what K2b is held to bit for bit, where
    `mipmap_scatter_torch` is the f32 oracle."""
    ch = g.shape[-1]
    gd = g.reshape(-1, ch).to(torch.float64)
    gmax = float(g.abs().max()) if g.numel() else 0.0
    n_pix = g.numel() // ch if ch else 0
    k = grid_exponent(gmax, n_pix) if gmax else 0
    grads = []
    for s in sizes:
        if not np.isfinite(gmax):
            grads.append(torch.full((s, s, ch), float("nan"),
                                    device=g.device))
            continue
        x, y = level_coords(uv_map, s)
        acc = torch.zeros((s * s, ch), dtype=torch.int64, device=g.device)
        for idx, w in bilinear_taps(x.reshape(-1).to(torch.float32),
                                    y.reshape(-1).to(torch.float32), s, s):
            q = torch.round(w.to(torch.float64)[:, None] * gd * 2.0 ** k)
            acc.index_add_(0, idx, q.to(torch.int64))
        grads.append((acc.to(torch.float64) * 2.0 ** -k).to(
            torch.float32).reshape(s, s, ch))
    return grads


def scatter_rounding_bound(uv_map: torch.Tensor, g: torch.Tensor,
                           sizes) -> list[torch.Tensor]:
    """Per level and texel, the most K2b's grid can move a texel's sum
    before its last rounding: (its taps of nonzero weight) x 2^-(k+1)."""
    ch = g.shape[-1]
    gmax = float(g.abs().max())
    k = grid_exponent(gmax, g.numel() // ch)
    out = []
    for s in sizes:
        x, y = level_coords(uv_map, s)
        taps = torch.zeros(s * s, dtype=torch.float64, device=g.device)
        for idx, w in bilinear_taps(x.reshape(-1).to(torch.float32),
                                    y.reshape(-1).to(torch.float32), s, s):
            taps.index_add_(0, idx, (w != 0).to(torch.float64))
        out.append((taps * 2.0 ** -(k + 1)).reshape(s, s, 1))
    return out


def touched_texels(uv_map: torch.Tensor, sizes) -> list[int]:
    """Per level, the texels that the taps of every pixel address, of
    weight 0 or not: each is read at least once."""
    counts = []
    for s in sizes:
        x, y = level_coords(uv_map.reshape(-1, 2), s)
        seen = torch.zeros(s * s, dtype=torch.bool, device=uv_map.device)
        for idx, _ in bilinear_taps(x, y, s, s):
            seen[idx] = True
        counts.append(int(seen.sum()))
    return counts


_gather_entry = None   # K2's C entry, looked up once per process


def _launch_gather(textures, uv_map):
    """K2 on CUDA tensors: f32 levels [S, S, C] and uv [N, H, W, 2],
    contiguous (made so here), uv 8-byte aligned (a view at an odd float
    offset is copied: the kernel reads each pixel's uv as a float2); one
    launch per LEVELS_PER_LAUNCH levels, each after the first adding into
    the output."""
    global _gather_entry
    if _gather_entry is None:
        _gather_entry = _build.fn("mipmap_gather", "rnr_mipmap_gather", 6, 10)
    uv = uv_map.contiguous()
    if uv.data_ptr() % 8:
        uv = uv.clone()
    texs = [t.contiguous() for t in textures]
    n, h, w, two = uv.shape
    ch = texs[0].shape[-1]
    if two != 2:
        raise ValueError(f"uv_map: shape {tuple(uv.shape)}, expected "
                         "[N, H, W, 2]")
    for i, t in enumerate((uv, *texs)):
        if t.dtype != torch.float32:
            raise TypeError(f"mipmap_gather: input {i} is {t.dtype}, the "
                            "kernel takes float32")
        if i and (t.dim() != 3 or t.shape[0] != t.shape[1]
                  or t.shape[2] != ch):
            raise ValueError(f"texture_{i - 1}: shape {tuple(t.shape)}, "
                             f"expected [S, S, {ch}]")
    out = torch.empty((n, h, w, ch), dtype=torch.float32, device=uv.device)
    stream = stream_of(uv)
    for g in range(0, len(texs), LEVELS_PER_LAUNCH):
        grp = texs[g:g + LEVELS_PER_LAUNCH]
        pad = [0] * (LEVELS_PER_LAUNCH - len(grp))
        mipmap_sample.launches += 1
        check_launch(_gather_entry(
            *[t.data_ptr() for t in grp], *pad, uv.data_ptr(),
            out.data_ptr(), *[t.shape[0] for t in grp], *pad, len(grp), n,
            h, w, ch, int(g > 0), stream), "mipmap_gather")
    return out


def _sample(textures, uv_map: torch.Tensor) -> torch.Tensor:
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if use_kernel(uv_map, *textures):
        return _launch_gather(textures, uv_map)
    return mipmap_sample_torch(textures, uv_map)


def mipmap_scatter(uv_map: torch.Tensor, g: torch.Tensor, sizes):
    """K2b: uv_map [N, H, W, 2] f32, g [N, H, W, Ch] -> the gradient
    [S_l, S_l, Ch] f32 of every level of side `sizes[l]`; the plain
    version on CPU tensors.  The kernel pre-reduces each warp's 8 x 4
    pixel tile per texel in shared memory and sums in 64-bit fixed point
    (csrc/mipmap_scatter.cu), so its result does not depend on the order
    blocks run in: bit-equal run to run, and to
    `mipmap_scatter_fixed_torch`.  Ch <= 128.  The kernel reads uv as
    float2 and, where Ch % 4 == 0, g as float4: a view at an offset off
    those alignments is copied here (the C entry refuses it)."""
    if not use_kernel(uv_map, g):
        return mipmap_scatter_torch(uv_map, g, sizes)
    n, h, w, ch = g.shape
    if ch > SCATTER_MAX_CH:
        raise ValueError(f"mipmap_scatter kernel: Ch={ch} > {SCATTER_MAX_CH}")
    uv = uv_map.contiguous()
    if uv.data_ptr() % 8:
        uv = uv.clone()
    gf = g.to(torch.float32).contiguous()
    if ch % 4 == 0 and gf.data_ptr() % 16:
        gf = gf.clone()
    require(uv, "uv_map", torch.float32, (n, h, w, 2))
    require(gf, "g", torch.float32, (n, h, w, ch))
    grads = [torch.empty((s, s, ch), dtype=torch.float32, device=uv.device)
             for s in sizes]
    # the int64 copy of each level of a launch, and max|g|'s bits
    acc = torch.empty(max(sum(s * s for s in sizes[k:k + LEVELS_PER_LAUNCH])
                          for k in range(0, len(sizes), LEVELS_PER_LAUNCH))
                      * ch, dtype=torch.int64, device=uv.device)
    mbits = torch.empty(1, dtype=torch.int32, device=uv.device)
    f = _build.fn("mipmap_scatter", "rnr_mipmap_scatter", 8, 9)
    stream = stream_of(uv)
    for k in range(0, len(grads), LEVELS_PER_LAUNCH):
        grp = grads[k:k + LEVELS_PER_LAUNCH]
        pad = LEVELS_PER_LAUNCH - len(grp)
        mipmap_scatter.launches += 1
        check_launch(f(*[t.data_ptr() for t in grp], *[0] * pad,
                       acc.data_ptr(), mbits.data_ptr(), uv.data_ptr(),
                       gf.data_ptr(), *[t.shape[0] for t in grp],
                       *[0] * pad, len(grp), n, h, w, ch, stream),
                     "mipmap_scatter")
    return grads


class MipmapSampleFn(torch.autograd.Function):
    """K2 forward / K2b backward on CUDA tensors, the plain versions on CPU
    tensors.  Differentiable in the texture levels only."""

    @staticmethod
    def forward(ctx, uv_map, *textures):
        ctx.save_for_backward(uv_map)
        ctx.sizes = [t.shape[0] for t in textures]
        ctx.dtypes = [t.dtype for t in textures]
        return _sample(textures, uv_map)

    @staticmethod
    def backward(ctx, g):
        (uv_map,) = ctx.saved_tensors
        grads = mipmap_scatter(uv_map, g, ctx.sizes)
        return (None, *(d.to(dt) for d, dt in zip(grads, ctx.dtypes)))


def mipmap_sample(textures, uv_map: torch.Tensor) -> torch.Tensor:
    """textures: sequence of [S_l, S_l, Ch] f32; uv_map [N, H, W, 2] f32
    -> [N, H, W, Ch] f32, differentiable in the textures.  Where no
    gradient is asked for (eval frames), K2 or the plain version runs
    without the autograd Function's host time."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in textures):
        return MipmapSampleFn.apply(uv_map, *textures)
    return _sample(textures, uv_map)


mipmap_sample.launches = 0
mipmap_scatter.launches = 0
