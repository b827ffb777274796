"""The relightable neural renderer (port of rnr_tpu/models/rnr.py).

Data flow of one frame:
  v_feature  = gcn(mesh_pos)                 # K4; cached when serving
  neural_img = texture(uv_map, sh_basis_map)  # K2 (backward K2b)
  rays       = fans of 13 + 13 rays (elementwise, or RaySampler's einsum,
               which also gives the probe UVs)
  rays_lt    = unet([rays || normal || view || neural_img], v_feature)
                                              # K3 (backward K3, K3b);
                                              # by conv_backend K8a (K8b),
                                              # K6, K8's 4x4 pair
  image      = SH shading of the rays          # K1 fan-fused (K1b), or
                                              # K5 on rays_dir (K5b)
             | or the probe gather (ray_render) from a light probe: a
               novel one (lp_override) or the learned SH lighting
               reconstructed on the probe grid (direct_sh_shading=False)
The SH path runs when SH coefficients are given (sh_coeff_override) or
when no probe is given and direct_sh_shading is on; the probe path
otherwise.  Every configuration is ported, for serving and for training
(train=True: dropout, the stochastic GCN graphs and the SNDense
power-iteration update), every conv_backend among them
(models/unet.py::conv_routes; an unknown name raises ValueError), except
remat, which raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rnr_tpu_torch.config import RNRConfig
from rnr_tpu_torch.models.gcn import DenseDeepGCN, GCNConfig
from rnr_tpu_torch.models.lighting import LightingSH, fib_sphere
from rnr_tpu_torch.models.rays import (RaySampler, build_fan_channels,
                                       ray_render, ray_render_sh)
from rnr_tpu_torch.models.texture import TextureMapper
from rnr_tpu_torch.models.unet import RenderingNet
from rnr_tpu_torch.ops.backend import resolve_device


class RNRModel(nn.Module):
    """cfg: the port's RNRConfig.  num_v: the GCN mesh's vertex count (the
    first spectral-norm layer spans the vertex axis; flax infers it from
    the input, torch needs it up front).  l_dir: [3, S] sphere sample
    directions of the lighting (default: the Fibonacci sphere of
    cfg.lighting.num_sample, the synthetic set).  The model is built on
    `device`: the current CUDA device when None (raising without one),
    "cpu" for the plain versions of the kernels."""

    def __init__(self, cfg: RNRConfig, num_v: int,
                 l_dir: np.ndarray | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        c = cfg
        if c.render_net.remat not in (False, "none"):
            raise NotImplementedError("remat is not ported")
        self.cfg = cfg
        self.rays_dtype = getattr(torch, c.rays.rays_dtype)
        self.texture_mapper = TextureMapper(
            c.texture.texture_size, c.texture.texture_num_ch,
            c.texture.mipmap_level, c.texture.apply_sh, c.texture.fix_tex)
        self.render_net = RenderingNet(
            nf0=c.render_net.nf0, in_channels=c.render_net_in_channels,
            out_channels=c.render_net_out_channels,
            num_down_unet=c.render_net.num_down_unet,
            out_channels_gcn=c.gcn.out_channels, use_gcn=c.use_gcn,
            norm=c.render_net.norm, compute_dtype=c.render_net.compute_dtype,
            fuse_mode=c.render_net.fuse_mode, pad_mode=c.render_net.pad_mode,
            conv_backend=c.render_net.conv_backend)
        if c.use_gcn:
            g = c.gcn
            self.gcn = DenseDeepGCN(GCNConfig(
                in_channels=g.in_channels, n_filters=g.n_filters,
                kernel_size=g.kernel_size, n_blocks=g.n_blocks,
                conv_type=g.conv_type, block_type=g.block_type,
                act_type=g.act_type, norm_type=g.norm_type,
                use_bias=g.use_bias, stochastic=g.stochastic,
                epsilon=g.epsilon, num_v=num_v,
                out_channels=g.out_channels, knn_approx=g.knn_approx,
                compute_dtype=g.compute_dtype,
                graph_refresh_every=g.graph_refresh_every,
                strat_min_dilation=g.strat_min_dilation,
                stratum_width=g.stratum_width))
        if l_dir is None:
            l_dir = fib_sphere(c.lighting.num_sample)
        self.lighting = LightingSH(l_dir, c.lighting.sh_lmax,
                                   c.lighting.num_lighting, 3,
                                   c.lighting.fix_lighting,
                                   c.lighting.lp_recon_h,
                                   c.lighting.lp_recon_w)
        self.ray_sampler = spec = RaySampler(
            c.rays.num_azi, c.rays.num_polar, c.rays.interval_polar_specular,
            "reflect")
        self.ray_sampler_diffuse = diff = RaySampler(
            c.rays.num_azi, c.rays.num_polar, c.rays.interval_polar_diffuse,
            "diffuse")
        self.num_ray_specular = spec.num_ray
        self.num_ray_diffuse = diff.num_ray
        self.register_buffer("fan_pivots", torch.from_numpy(np.concatenate(
            [spec.pivots_dir.T, diff.pivots_dir.T], axis=0).astype(np.float32)))
        self.to(device)

    def compute_v_feature(self, gcn_pos: torch.Tensor) -> torch.Tensor:
        """Run just the GCN ([1, out]); cached across the frames of a
        sequence, since it does not depend on the view."""
        if not self.cfg.use_gcn:
            raise ValueError("use_gcn is off")
        return self.gcn(gcn_pos)

    def forward(self, batch: dict, lighting_idx: int = 0,
                lp_override: torch.Tensor | None = None,
                v_feature_override: torch.Tensor | None = None,
                sh_coeff_override: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """batch: NHWC G-buffer maps uv_map, sh_basis_map, normal_map,
        view_dir_map, view_dir_map_tangent, TBN_map, alpha_map, and
        gcn_pos [V, 3].  lp_override [1 or N, Hl, Wl, C]: a probe to
        relight with through the probe gather; sh_coeff_override [B, C]:
        SH coefficients to relight with through the SH path, which takes
        precedence.  train=True runs dropout and the stochastic GCN
        graphs from `generator` and advances the SNDense vectors."""
        c = self.cfg
        n, h, w = batch["alpha_map"].shape[:3]
        v_feature = None
        if c.use_gcn:
            v_feature = (v_feature_override if v_feature_override is not None
                         else self.gcn(batch["gcn_pos"], train=train,
                                       generator=generator))
            v_feature = v_feature.expand(n, v_feature.shape[-1])

        neural_img = self.texture_mapper(batch["uv_map"],
                                         batch["sh_basis_map"], sh_start_ch=6)
        albedo_diffuse = neural_img[..., 0:3]
        albedo_specular = neural_img[..., 3:6]

        # the SH path never touches a probe, so it skips the equirect UVs
        use_sh = sh_coeff_override is not None or (
            lp_override is None and c.rays.direct_sh_shading)
        rdt = self.rays_dtype
        tbn, vdt = batch["TBN_map"], batch["view_dir_map_tangent"]
        rays_uv = None
        if use_sh and c.rays.fan_impl == "elementwise":
            net_rays, rays_dir = build_fan_channels(
                tbn, vdt, batch["alpha_map"], self.fan_pivots,
                self.num_ray_specular)
            net_rays = net_rays.to(rdt)
            rays_dir = rays_dir.to(rdt)
        else:
            dir_s, uv_s, _ = self.ray_sampler(tbn, vdt, batch["alpha_map"],
                                              with_uv=not use_sh)
            dir_d, uv_d, _ = self.ray_sampler_diffuse(
                tbn, vdt, batch["alpha_map"], with_uv=not use_sh)
            rays_dir = torch.cat([dir_s, dir_d], dim=-1).to(rdt)
            if not use_sh:
                rays_uv = torch.cat([uv_s, uv_d], dim=-1)
            # per-ray xyz grouping of the U-Net's ray channels
            net_rays = torch.swapaxes(rays_dir, -1, -2).reshape(n, h, w, -1)
        r_total = rays_dir.shape[-1]

        net_in = torch.cat([net_rays, batch["normal_map"].to(rdt),
                            batch["view_dir_map"].to(rdt),
                            neural_img.to(rdt)], dim=-1)
        lt = self.render_net(net_in, v_feature, train, generator)
        rays_lt = lt.reshape(n, h, w, r_total, 3)
        rays_lt = ((rays_lt * 0.5 + 0.5) * c.rays.lt_max_val).to(rdt)

        if use_sh:
            sh_coeff = (sh_coeff_override if sh_coeff_override is not None
                        else self.lighting.get_lighting_params(lighting_idx))
            rendered = ray_render_sh(
                albedo_specular, rays_dir, batch["alpha_map"], rays_lt,
                sh_coeff, c.lighting.sh_lmax,
                num_ray_diffuse=self.num_ray_diffuse,
                albedo_diffuse=albedo_diffuse,
                fan_inputs=((tbn, vdt, self.fan_pivots)
                            if c.rays.sh_fan_fuse else None))
        else:
            lp = (self.lighting(lighting_idx, is_lp=True)
                  if lp_override is None else lp_override)
            rendered = ray_render(
                albedo_specular, rays_uv, rays_lt, lp,
                num_ray_diffuse=self.num_ray_diffuse,
                albedo_diffuse=albedo_diffuse, separate_albedo=True)
        return {
            "img": rendered["out"],
            "l_samples_est": self.lighting(lighting_idx)[0],
            "rays_lt": rays_lt,
            "rays_uv": rays_uv,
            "rays_dir": rays_dir,
            "neural_img": neural_img,
            "albedo_specular": albedo_specular,
            "albedo_diffuse": albedo_diffuse,
            "v_feature": v_feature,
            "lp": rendered["lp"],
            "ltt_specular_map": rendered["ltt_specular_map"],
            "ltt_diffuse_map": rendered["ltt_diffuse_map"],
        }

    def lighting_samples(self, lighting_idx) -> torch.Tensor:
        """The learned lighting's samples at the sphere directions [S, C]."""
        return self.lighting(lighting_idx)[0]

    def reconstruct_lp(self, lighting_idx) -> torch.Tensor:
        """The learned lighting as a probe [H, W, C] on the recon grid."""
        return self.lighting(lighting_idx, is_lp=True)[0]
