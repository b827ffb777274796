"""Screen-space coverage (silhouette / edge) gradients of rasterization
(port of rnr_tpu/ops/edge_grad.py).

The reference walks, per face, the pixels its edges cross and adds
(neighbour - edge pixel) * grad / distance into the edge's vertices
(neural_renderer's backward_pixel_map).  rnr_tpu turns the walk around
and the port keeps its form: every boundary pixel gathers its own
contribution from its four neighbours (the crossing edge is the
barycentric that reaches zero first toward the neighbour, its rate a
finite difference between same-face neighbours, the distance at least one
pixel), and one accumulating index_put_ per image sums the contributions
into the faces' corners in pixel order.

`silhouette` and `rasterize_opt` are torch.autograd.Functions.  Their
forward takes the winner maps from `_rasterize_winner`: K7
(`rasterize_tiled`: the kernel on CUDA tensors, its plain version on CPU
tensors) on every call, on the TPU kernel's 32 x 128 tiles at any frame
size (edge tiles cut by the frame; rnr_tpu can only take them at sizes
they divide, and draws the rest with its oracle), and, as rnr_tpu's
overflow rule, the oracle `rasterize_face_index` again whenever K7
reports that its tile lists dropped candidates; ORACLE_TAKEN counts
those runs.  Their backward is the edge terms in
plain torch; rasterize_opt adds the interior gradients (weights, depth,
textures) by autograd through `pixel_attrs` and `sample_textures` on the
fixed winner map.
"""

from __future__ import annotations

import torch

from rnr_tpu_torch.ops.rasterize import (RasterOutput, pixel_attrs,
                                         rasterize_face_index)
from rnr_tpu_torch.ops.rasterize_cuda import rasterize_tiled
from rnr_tpu_torch.ops.render_api import pool2, sample_textures

BACKENDS = ("auto", "pallas", "pallas_interpret", "xla")
# oracle runs of _rasterize_winner after K7's tile lists overflowed
ORACLE_TAKEN = {"overflow": 0}


def _rasterize_winner(faces: torch.Tensor, image_size: int, near: float,
                      far: float, backend: str = "auto") -> RasterOutput:
    """The winner maps of the differentiable paths (no gradient).

    backend "xla": the oracle.  Otherwise ("auto", and rnr_tpu's "pallas"
    / "pallas_interpret", which are the same here) K7 on 32 x 128 tiles
    at any frame size (min with S; the last row and column of tiles cut
    by the frame); when K7 reports overflow (read on the host: a synchronisation), the
    oracle's maps, with K7's overflow kept in the result."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    faces = faces.detach()
    s = image_size
    if backend == "xla":
        return rasterize_face_index(faces, s, near=near, far=far)
    out = rasterize_tiled(faces, s, near=near, far=far)
    if int(out.overflow.sum()) == 0:
        return out
    ORACLE_TAKEN["overflow"] += 1
    o = rasterize_face_index(faces, s, near=near, far=far)
    return o._replace(overflow=out.overflow)


def _neighbor_shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """[N, S, S, ...] shifted so that pixel p reads p + (dy, dx); the
    exposed border takes `fill`."""
    out = torch.roll(x, shifts=(-dy, -dx), dims=(1, 2))
    s = x.shape[1]
    if dy == 1:
        out[:, s - 1] = fill
    elif dy == -1:
        out[:, 0] = fill
    if dx == 1:
        out[:, :, s - 1] = fill
    elif dx == -1:
        out[:, :, 0] = fill
    return out


def edge_gradients(faces: torch.Tensor, face_index_map: torch.Tensor,
                   weight_map: torch.Tensor, alpha_map: torch.Tensor,
                   grad_alpha: torch.Tensor | None = None,
                   rgb_map: torch.Tensor | None = None,
                   grad_rgb: torch.Tensor | None = None,
                   eps: float = 1e-3) -> torch.Tensor:
    """Coverage gradients of the projected faces.

    faces [N, F, 3, 3] (xy NDC); face_index_map [N, S, S], weight_map
    [N, S, S, 3], alpha_map [N, S, S] in image orientation; grad_alpha
    [N, S, S] the upstream gradient of the alpha map, rgb_map / grad_rgb
    [N, S, S, C] the rendered colours and theirs (the photometric edge
    term); either may be None.  Returns grad_faces [N, F, 3, 3], its z
    column zero."""
    n, f = faces.shape[0], faces.shape[1]
    s = face_index_map.shape[1]
    dtype, dev = faces.dtype, faces.device
    covered = face_index_map >= 0
    fidx = torch.clamp(face_index_map, 0, f - 1).long()
    w_p = weight_map

    def value_diff(dy, dx):
        """(value_q - value_p) . grad_p summed over channels, per pixel."""
        total = torch.zeros((n, s, s), dtype=dtype, device=dev)
        if grad_alpha is not None:
            a_q = _neighbor_shift(alpha_map, dy, dx, 0.0)
            total = total + (a_q - alpha_map) * grad_alpha
        if grad_rgb is not None and rgb_map is not None:
            r_q = _neighbor_shift(rgb_map, dy, dx, 0.0)
            total = total + torch.sum((r_q - rgb_map) * grad_rgb, dim=-1)
        return total

    # the neighbours' maps; an uncovered neighbour reads -1, never face 0
    shifts = {d: (_neighbor_shift(face_index_map, *d, -1),
                  _neighbor_shift(w_p, *d, 0.0))
              for d in ((0, 1), (0, -1), (1, 0), (-1, 0))}

    # each pixel's contributions, all to its own covering face, gathered
    # in a [6] slot vector (corner x axis) and summed into the faces once
    slot_acc = torch.zeros((n, s, s, 6), dtype=dtype, device=dev)
    for (dy, dx) in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        vdiff = value_diff(dy, dx)
        boundary = covered & (vdiff != 0.0)
        # the step toward q in raster coordinates: +x is +xi, and the +y
        # neighbour in image rows is -yi
        ax = 0 if dx != 0 else 1
        step = dx if dx != 0 else -dy

        # each barycentric's rate toward q, from a same-face neighbour
        # (forward, else backward), and the distance until it reaches 0
        fim_f, w_f = shifts[(dy, dx)]
        fim_b, w_b = shifts[(-dy, -dx)]
        same_f = (fim_f == face_index_map)[..., None]
        same_b = (fim_b == face_index_map)[..., None]
        rate = torch.where(same_f, w_f - w_p,
                           torch.where(same_b, w_p - w_b, 0.0))
        dist_k = torch.where(rate < -eps,
                             w_p / torch.clamp(-rate, min=eps), torch.inf)
        k_min = torch.argmin(dist_k, dim=-1)
        dist = torch.clamp(torch.amin(dist_k, dim=-1), min=1.0)

        # 1-pixel-thin coverage: no rate to read; the edge lies within a
        # pixel, so dist 1 and the smallest barycentric's opposite edge
        sliver = ~(same_f[..., 0] | same_b[..., 0])
        k_min = torch.where(sliver, torch.argmin(w_p, dim=-1), k_min)
        dist = torch.where(sliver, 1.0, dist)

        g_edge = torch.where(boundary, -vdiff / dist, 0.0)
        k1 = (k_min + 1) % 3
        k2 = (k_min + 2) % 3

        def pick(idx):
            return torch.where(idx == 0, w_p[..., 0],
                               torch.where(idx == 1, w_p[..., 1],
                                           w_p[..., 2]))

        w1, w2 = pick(k1), pick(k2)
        g_step = g_edge * step / torch.clamp(w1 + w2, min=eps)
        c1, c2 = g_step * w1, g_step * w2
        for j in range(3):
            cj = (torch.where(k_min == (j + 2) % 3, c1, 0.0)
                  + torch.where(k_min == (j + 1) % 3, c2, 0.0))
            slot_acc[..., j * 2 + ax] += cj

    # per face, its pixels' terms summed in pixel order: index_put_'s
    # accumulate sorts the indices stably and adds each run in turn (on
    # the card too, where index_add_ adds with atomics in no fixed order)
    grad_faces = torch.zeros((n, f, 6), dtype=dtype, device=dev)
    for b in range(n):
        grad_faces[b].index_put_((fidx[b].reshape(-1),),
                                 slot_acc[b].reshape(-1, 6), accumulate=True)
    # pixel-coordinate gradients to NDC: p = (x_ndc S + S - 1) / 2
    grad_ndc = grad_faces.reshape(n, f, 3, 2) * (s / 2.0)
    return torch.cat([grad_ndc, torch.zeros((n, f, 3, 1), dtype=dtype,
                                            device=dev)], dim=-1)


class SilhouetteFn(torch.autograd.Function):
    """The alpha map of `_rasterize_winner`, its gradient the coverage
    terms of `edge_gradients`."""

    @staticmethod
    def forward(ctx, faces, image_size, near, far, backend):
        out = _rasterize_winner(faces, image_size, near, far, backend)
        ctx.save_for_backward(faces, out.face_index_map, out.weight_map,
                              out.alpha_map)
        return out.alpha_map

    @staticmethod
    def backward(ctx, g):
        faces, fim, w, alpha = ctx.saved_tensors
        grad = edge_gradients(faces, fim, w, alpha, grad_alpha=g)
        return grad, None, None, None, None


def silhouette(faces: torch.Tensor, image_size: int, near: float = 0.0,
               far: float = 1e5, backend: str = "auto") -> torch.Tensor:
    """Differentiable silhouette [N, S, S]: the alpha map of faces [N, F,
    3, 3], equal to rasterize_face_index's, with coverage gradients."""
    return SilhouetteFn.apply(faces, image_size, near, far, backend)


def _interior(faces, textures, fim, image_size, near, far, eps, bg):
    """rgb [N, S, S, C], alpha, depth [N, S, S] and the weights on the
    fixed winner map fim, differentiable in faces and textures."""
    w, zp, covered, f_px = pixel_attrs(faces, fim, image_size,
                                       return_face_px=True)
    depth = torch.where(covered, zp, far)
    alpha = covered.to(faces.dtype)
    rgb = sample_textures(faces, textures, fim, w, zp, eps, faces_px=f_px)
    bgc = torch.as_tensor(bg, dtype=rgb.dtype, device=rgb.device)
    mask = covered[..., None].to(rgb.dtype)
    rgb = rgb * mask + (1.0 - mask) * bgc
    return rgb, alpha, depth, w


class RasterizeOptFn(torch.autograd.Function):
    """(rgb [N, S, S, C], alpha, depth) on `_rasterize_winner`'s map; the
    backward adds the interior gradients (autograd of `_interior`) and the
    coverage terms of alpha and rgb (`edge_gradients`)."""

    @staticmethod
    def forward(ctx, faces, textures, image_size, near, far, eps, bg,
                backend):
        fim = _rasterize_winner(faces, image_size, near, far,
                                backend).face_index_map
        with torch.enable_grad():
            f_in = faces.detach().requires_grad_()
            t_in = textures.detach().requires_grad_()
            rgb, alpha, depth, w = _interior(f_in, t_in, fim, image_size,
                                             near, far, eps, bg)
        ctx.graph = (f_in, t_in, rgb, depth)
        ctx.save_for_backward(faces, fim, w.detach(), alpha,
                              rgb.detach())
        return rgb.detach(), alpha, depth.detach()

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth):
        faces, fim, w, alpha, rgb = ctx.saved_tensors
        f_in, t_in, rgb_g, depth_g = ctx.graph
        df, dt = torch.autograd.grad(
            (rgb_g, depth_g), (f_in, t_in),
            (torch.zeros_like(rgb) if g_rgb is None else g_rgb,
             torch.zeros_like(alpha) if g_depth is None else g_depth))
        df = df + edge_gradients(faces, fim, w, alpha, grad_alpha=g_alpha,
                                 rgb_map=rgb, grad_rgb=g_rgb)
        del ctx.graph
        return df, dt, None, None, None, None, None, None


def rasterize_opt(faces: torch.Tensor, textures: torch.Tensor,
                  image_size: int = 256, anti_aliasing: bool = False,
                  near: float = 0.1, far: float = 100.0, eps: float = 1e-4,
                  background_color=(0.0, 0.0, 0.0), backend: str = "auto"
                  ) -> dict[str, torch.Tensor]:
    """Textured rasterization whose gradients move the mesh's vertices:
    faces [N, F, 3, 3] (xy NDC, z depth), textures [N, F, ts, ts, ts, C]
    -> {"rgb" [N, C, S, S], "alpha", "depth" [N, S, S]}, the coverage
    terms of rgb and alpha on top of the interior gradients.  With
    anti_aliasing the 2S render is pooled 2 x 2."""
    s_render = image_size * 2 if anti_aliasing else image_size
    rgb, alpha, depth = RasterizeOptFn.apply(
        faces, textures, s_render, near, far, eps, tuple(background_color),
        backend)
    if anti_aliasing:
        rgb, alpha, depth = pool2(rgb), pool2(alpha), pool2(depth)
    return {"rgb": rgb.permute(0, 3, 1, 2), "alpha": alpha, "depth": depth}
