"""Steps (port of rnr_tpu/train/steps.py:44-273): the RNR training step,
its loss, its optimizer and the eval step.

One Adam over every parameter, as rnr_tpu's optax.adam.  A step runs where
the model lives and keeps every result on that device: no `.item()`, so a
run of steps never waits on the host.  Randomness (dropout masks, the
stochastic GCN picks) comes from a torch.Generator that the caller passes
to each step (`make_generator`).
"""

from __future__ import annotations

from typing import Callable

import torch

from rnr_tpu_torch.models.rays import rays_lt_chrom_loss
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.ops.backend import resolve_device
from rnr_tpu_torch.ops.metrics import masked_err_metrics
from rnr_tpu_torch.train.losses import (albedo_prior_loss, image_l1_loss,
                                        lighting_loss)


def make_generator(seed: int, device=None) -> torch.Generator:
    """The generator of a training run: on the current CUDA device when
    `device` is None (raising without one), else on `device` ("cpu" for
    a CPU run; it must be the model's device)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return g


def create_rnr_optimizer(model: RNRModel, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8 added
    to sqrt(v_hat)) over every parameter."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


@torch.no_grad()
def rnr_texture_flatten_init(model: RNRModel) -> torch.Tensor:
    """relu of the flattened initial albedo mipmap (channels 0..5): the
    albedo prior's anchor."""
    return torch.relu(model.texture_mapper.flatten_mipmap(0, 6))


def make_rnr_loss_fn(model: RNRModel, lighting_idx: int = 0) -> Callable:
    """The RNR training loss: render L1 + lighting + chrom + albedo priors.

    loss_fn(batch, statics, generator) -> (loss, aux); `statics` holds
    l_samples_init [S, C], l_samples_mask [S] and tex_flatten_init
    [H, W, 6]; aux holds the five loss terms and the image.
    """
    cfg = model.cfg

    def loss_fn(batch: dict, statics: dict, generator: torch.Generator):
        out = model(batch, lighting_idx=lighting_idx, train=True,
                    generator=generator)
        alpha = batch["alpha_map"]
        img_gt = batch["img_gt"]
        loss_rn = image_l1_loss(out["img"], img_gt, alpha,
                                cfg.loss.border_crop)
        if cfg.lighting.fix_lighting:
            loss_light = torch.zeros((), device=alpha.device)
        else:
            loss_light = lighting_loss(
                out["l_samples_est"], statics["l_samples_init"],
                statics["l_samples_mask"], cfg.loss.loss_lighting_weight,
                cfg.loss.loss_lighting_uncovered_weight)
        loss_chrom = (rays_lt_chrom_loss(out["rays_lt"], alpha, img_gt)[0]
                      * cfg.loss.loss_rays_lt_chrom_weight)
        albedo_flat = model.texture_mapper.flatten_mipmap(0, 6)
        tex_init = statics["tex_flatten_init"]
        loss_alb = (albedo_prior_loss(albedo_flat[..., 0:3],
                                      tex_init[..., 0:3])
                    + albedo_prior_loss(albedo_flat[..., 3:6],
                                        tex_init[..., 3:6])
                    ) * cfg.loss.loss_alb_weight
        loss = loss_rn + loss_light + loss_chrom + loss_alb
        aux = {"loss": loss, "loss_rn": loss_rn, "loss_lighting": loss_light,
               "loss_rays_lt_chrom": loss_chrom, "loss_alb": loss_alb,
               "img": out["img"]}
        return loss, aux

    return loss_fn


def make_rnr_train_step(model: RNRModel, optimizer: torch.optim.Optimizer,
                        lighting_idx: int = 0) -> Callable:
    """The RNR training step: step(batch, statics, generator) -> metrics,
    the loss terms, masked_err_metrics over the border-cropped, masked
    image (0..255) and the image, all detached tensors on the model's
    device.  It updates the parameters and the SNDense vectors in place."""
    loss_fn = make_rnr_loss_fn(model, lighting_idx)
    b = model.cfg.loss.border_crop

    def step(batch: dict, statics: dict, generator: torch.Generator) -> dict:
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, statics, generator)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            alpha_c = batch["alpha_map"][:, b:-b, b:-b]
            metrics = masked_err_metrics(
                aux["img"][:, b:-b, b:-b] * alpha_c * 255.0,
                batch["img_gt"][:, b:-b, b:-b] * alpha_c * 255.0, alpha_c)
            metrics.update({k: v.detach() for k, v in aux.items()})
        return metrics

    return step


def make_rnr_eval_step(model: RNRModel, lighting_idx: int = 0,
                       output_keys: tuple[str, ...] | None = ("img",)
                       ) -> Callable:
    """Inference step: step(batch, v_feature=None, lp_override=None,
    sh_override=None, relight=False) -> dict of `output_keys` (all
    outputs when None).

    Pass the cached `model.compute_v_feature(batch["gcn_pos"])` as
    `v_feature` to skip the GCN per frame.  With `relight`, the frame is
    lit by `sh_override` [B, C] through the SH path, else by the probe
    `lp_override` [1 or N, Hl, Wl, C] through the probe gather; without
    it both are ignored and the learned lighting `lighting_idx` lights
    the frame (rnr_tpu's semantics).  The model runs in eval mode under
    torch.inference_mode().

    The U-Net runs the model's conv_backend as configured.  rnr_tpu's
    eval step swaps "auto" for "xla" (rnr_tpu/train/steps.py:238-247)
    because a TPU measurement found XLA's fused forward convs faster
    there; nothing measured that on this card, so "auto" stays "pallas3"
    here as in the training step.
    """
    model.eval()

    def step(batch: dict, v_feature: torch.Tensor | None = None,
             lp_override: torch.Tensor | None = None,
             sh_override: torch.Tensor | None = None,
             relight: bool = False) -> dict:
        with torch.inference_mode():
            out = model(batch, lighting_idx=lighting_idx,
                        lp_override=lp_override if relight else None,
                        v_feature_override=v_feature,
                        sh_coeff_override=sh_override if relight else None)
        if output_keys is not None:
            out = {k: out[k] for k in output_keys}
        return out

    return step
