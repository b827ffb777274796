"""Synthetic inputs and seeded weights for the port, with no JAX.

`build_batch` is a NumPy copy of the G-buffer half of
`__graft_entry__._build` (which imports JAX): a sphere filling about 80%
of the frame, with smooth uv / normal / TBN maps, and a spatially coherent
vertex cloud for the GCN.  `build_config` mirrors that function's
RNRConfig; `init_weights` fills a model from a NumPy seed;
`build_statics` gives the training anchors `bench.py` draws.
`make_sphere` / `sphere_mesh` and `camera_ring` give a procedural mesh
and the views around it for the G-buffer path (mesh + camera -> frame);
`make_probes` gives procedural equirect light probes for relighting.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from rnr_tpu_torch.config import (GCNTrainConfig, LightingConfig, LossConfig,
                                  RaysConfig, RenderNetConfig, RNRConfig,
                                  TextureConfig, TrainConfig)
from rnr_tpu_torch.models.lighting import fib_sphere

__all__ = ["build_batch", "build_config", "build_statics", "camera_ring",
           "fib_sphere", "init_weights", "make_probes", "make_sphere",
           "sphere_mesh", "to_torch"]


def build_config(img_size: int, tex_size: int, lmax: int, nf0: int,
                 num_down: int, gcn_blocks: int, num_azi: int,
                 num_polar: int, rays_dtype: str = "bfloat16",
                 num_sample: int = 4096) -> RNRConfig:
    """The RNRConfig of `__graft_entry__._build` with the shipped knobs of
    tools/out/best_config.json: the hand 3x3 conv ("pallas3"), fan-fused
    SH shading, graph refresh 1; bf16 rays unless asked otherwise;
    `num_sample` light samples."""
    return RNRConfig(
        texture=TextureConfig(texture_size=tex_size, texture_num_ch=24,
                              mipmap_level=4),
        lighting=LightingConfig(sh_lmax=lmax, num_sample=num_sample,
                                num_lighting=2, lp_recon_h=64,
                                lp_recon_w=128),
        rays=RaysConfig(num_azi=num_azi, num_polar=num_polar,
                        rays_dtype=rays_dtype, sh_fan_fuse=True),
        gcn=GCNTrainConfig(n_blocks=gcn_blocks, kernel_size=16, n_filters=64,
                           out_channels=512, graph_refresh_every=1),
        render_net=RenderNetConfig(nf0=nf0, num_down_unet=num_down,
                                   conv_backend="pallas3"),
        loss=LossConfig(),
        train=TrainConfig(img_size=img_size),
    )


def build_batch(img_size: int, gcn_v: int, batch: int = 1) -> dict:
    """NumPy G-buffer batch, identical to `__graft_entry__._build`'s."""
    rng = np.random.default_rng(0)
    s = img_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    xx = (2 * xx + 1 - s) / s
    yy = (2 * yy + 1 - s) / s
    r2 = xx * xx + yy * yy
    rad = 0.8
    inside = r2 < rad * rad
    zz = np.sqrt(np.maximum(rad * rad - r2, 1e-12))
    normal = np.stack([xx, yy, zz], -1) / rad
    normal = np.where(inside[..., None], normal, [0.0, 0.0, 1.0])
    normal = normal.astype(np.float32)
    u = np.arctan2(normal[..., 2], normal[..., 0]) / (2 * np.pi) + 0.5
    v = np.arccos(np.clip(normal[..., 1], -1, 1)) / np.pi
    uv = np.where(inside[..., None], np.stack([u, v], -1), 0.0
                  ).astype(np.float32)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    t_ = up - normal * (normal @ up)[..., None]
    t_ /= np.maximum(np.linalg.norm(t_, axis=-1, keepdims=True), 1e-6)
    b_ = np.cross(normal, t_)
    tbn = np.stack([t_, b_, normal], axis=-1).astype(np.float32)
    vdt = np.broadcast_to(np.asarray([0, 0, 1], np.float32), (s, s, 3))
    sh_b = np.stack(
        [np.ones_like(u)] + [normal[..., i] for i in range(3)]
        + [normal[..., i] * normal[..., j]
           for i, j in ((0, 1), (1, 2), (0, 2), (0, 0), (1, 1))],
        axis=-1,
    ).astype(np.float32)
    img_gt = (0.5 + 0.5 * np.sin(6 * uv[..., :1]) * np.cos(4 * uv[..., 1:])
              ) * np.ones((1, 1, 3), np.float32)

    def rep(a):
        return np.broadcast_to(a, (batch,) + a.shape).copy()

    pos = fib_sphere(gcn_v).T
    pos = pos[np.argsort(pos[:, 2], kind="stable")]
    pos = pos + 0.01 * rng.standard_normal((gcn_v, 3)).astype(np.float32)
    return {
        "uv_map": rep(uv),
        "sh_basis_map": rep(sh_b),
        "normal_map": rep(normal),
        "view_dir_map": rep(vdt.copy()),
        "view_dir_map_tangent": rep(vdt.copy()),
        "TBN_map": rep(tbn),
        "alpha_map": rep(inside[..., None].astype(np.float32)),
        "img_gt": rep(img_gt.astype(np.float32)),
        "gcn_pos": pos.astype(np.float32),
    }


def to_torch(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}


def build_statics(model: torch.nn.Module, num_sample: int,
                  seed: int = 1) -> dict:
    """The training anchors of `bench.py:166-175`, on the model's device:
    l_samples_init ~ U(0, 1) [S, 3], l_samples_mask = U > 0.3 [S] (both
    drawn with NumPy in that order), and the model's current
    tex_flatten_init."""
    from rnr_tpu_torch.train.steps import rnr_texture_flatten_init

    rng = np.random.default_rng(seed)
    dev = model.lighting.coeff.device
    init = rng.uniform(0, 1, (num_sample, 3)).astype(np.float32)
    mask = (rng.uniform(size=num_sample) > 0.3).astype(np.float32)
    return {"l_samples_init": torch.from_numpy(init).to(dev),
            "l_samples_mask": torch.from_numpy(mask).to(dev),
            "tex_flatten_init": rnr_texture_flatten_init(model)}


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded NumPy weights: fan-in-scaled normal kernels, zero biases,
    unit norm scales, textures around their JAX init, and a nonzero SH
    lighting (rnr_tpu starts it at zero, which renders black)."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(p.shape)
        if leaf.startswith("texture_"):
            a = 0.5 + 0.5 * rng.standard_normal(shape)
        elif leaf == "coeff":
            a = 0.3 * rng.standard_normal(shape)
        elif leaf in ("scale", "norm_scale"):
            a = np.ones(shape)
        elif leaf in ("bias", "norm_bias"):
            a = np.zeros(shape)
        elif leaf == "prelu_slope":
            a = np.full(shape, 0.2)
        else:   # conv / dense kernels: lecun-normal by fan-in
            if leaf == "kernel":        # [..., in, out] (HWIO or dense)
                fan_in = int(np.prod(shape[:-1]))
            else:                       # nn.Linear [out, in]
                fan_in = shape[-1]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        p.copy_(torch.from_numpy(a.astype(np.float32)))
    for name, b in model.named_buffers():
        if name.endswith(".u"):
            b.copy_(torch.from_numpy(
                rng.standard_normal(tuple(b.shape)).astype(np.float32)))
    return model


def make_sphere(n_lat: int = 64, n_lon: int = 96, radius: float = 0.5):
    """A UV sphere about +y (a copy of tools/tpu_smoke.py's): vertices
    [V, 3], uvs [V, 2], unit normals [V, 3] (one per vertex, the seam
    column doubled) and faces [F, 3] int32, F = 2 n_lon (n_lat - 1)."""
    vs, vts, vns, faces = [], [], [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon + 1):
            ph = 2 * np.pi * j / n_lon
            vs.append((radius * np.sin(th) * np.cos(ph),
                       radius * np.cos(th),
                       radius * np.sin(th) * np.sin(ph)))
            vns.append((np.sin(th) * np.cos(ph), np.cos(th),
                        np.sin(th) * np.sin(ph)))
            vts.append((j / n_lon, 1 - i / n_lat))

    def vid(i, j):
        return i * (n_lon + 1) + j

    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((a, c, d))
    return (np.asarray(vs, np.float32), np.asarray(vts, np.float32),
            np.asarray(vns, np.float32), np.asarray(faces, np.int32))


def sphere_mesh(n_lat: int, n_lon: int, radius: float = 0.5):
    """`make_sphere` as a mesh for `ops.gbuffer.make_mesh_buffers` (uv and
    normal triplets share the vertex indices)."""
    v, vt, vn, f = make_sphere(n_lat, n_lon, radius)
    return types.SimpleNamespace(
        v=v, vt=vt, vn=vn, f_v_idx=f, f_vt_idx=f, f_vn_idx=f,
        span_max=float((v.max(0) - v.min(0)).max()))


def camera_ring(img_size: int, n_views: int = 20, elevation_deg: float = 30.0,
                distance: float = 2.5, focal_512: float = 1004.0) -> list:
    """Views on a ring around the origin, looking at it with +y up:
    `n_views` azimuths 360 / n_views degrees apart at `elevation_deg`,
    `distance` away; focal length `focal_512` px at 512^2 and the
    principal point at the centre, both scaled with the side.  At the
    defaults a sphere of radius 0.5 spans about 80% of the frame width.
    Each view is {"proj" [3, 3], "pose" [4, 4], "dist_coeffs" [5]}, f32."""
    from rnr_tpu_torch.ops.cameras import rt_from_pos_lookat

    f = focal_512 * img_size / 512.0
    c = img_size / 2.0
    proj = np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32)
    el = np.radians(elevation_deg)
    views = []
    for k in range(n_views):
        az = 2 * np.pi * k / n_views
        pos = distance * np.array([np.cos(el) * np.sin(az), np.sin(el),
                                   np.cos(el) * np.cos(az)])
        views.append({"proj": proj.copy(),
                      "pose": rt_from_pos_lookat(pos).astype(np.float32),
                      "dist_coeffs": np.zeros(5, np.float32)})
    return views


def make_probes(n: int = 2, h: int = 256, w: int = 512, seed: int = 0
                ) -> np.ndarray:
    """`n` equirect light probes [n, h, w, 3] f32 (the probe size of
    rnr_tpu's config), HDR: a sky gradient about +y (zenith, horizon and
    ground colours drawn per probe) plus two sharp sun lobes c exp(k (d.s
    - 1)) with k in 300..1500, which put energy into the high SH bands.
    The first probe's first sun sits on the seam (u = 0 / 1, the -x axis)
    at 20 degrees up; every other sun is drawn above the horizon.  Texel
    (i, j) holds the direction of u = j / w, v = i / h, where the probe
    gather reads it."""
    rng = np.random.default_rng(seed)
    v = np.arange(h, dtype=np.float64)[:, None] / h
    u = np.arange(w, dtype=np.float64)[None, :] / w
    y = np.cos(v * np.pi) * np.ones_like(u)
    r = np.sin(v * np.pi)
    t = (2.0 * u - 1.0) * np.pi
    d = np.stack([r * np.cos(t), y, r * np.sin(t)], axis=-1)   # [h, w, 3]
    out = []
    for k in range(n):
        zenith, horizon, ground = rng.uniform(0.05, 1.0, (3, 3))
        up = np.clip(y, 0.0, 1.0)[..., None]
        img = np.where(y[..., None] >= 0, horizon + (zenith - horizon) * up,
                       ground * (0.3 + 0.7 * np.clip(-y, 0, 1))[..., None])
        for s in range(2):
            if k == 0 and s == 0:
                el, az = np.radians(20.0), np.pi      # on the seam
            else:
                el = np.radians(rng.uniform(10.0, 70.0))
                az = rng.uniform(-np.pi, np.pi)
            sun = np.array([np.cos(el) * np.cos(az), np.sin(el),
                            np.cos(el) * np.sin(az)])
            sharp = rng.uniform(300.0, 1500.0)
            color = rng.uniform(2.0, 20.0) * rng.uniform(0.6, 1.0, 3)
            img = img + color * np.exp(sharp * (d @ sun - 1.0))[..., None]
        out.append(img)
    return np.stack(out).astype(np.float32)
