"""Steps (port of rnr_tpu/train/steps.py): the RNR training step, its
loss, its optimizer and the eval step (:44-273), and the DNR block
(:280-406): the neural texture and a U-Net with no GCN and no lighting,
trained with the border-cropped, alpha-masked L1.

One Adam over every parameter, as rnr_tpu's optax.adam.  A step runs where
the model lives and keeps every result on that device: no `.item()`, so a
run of steps never waits on the host.  Randomness (dropout masks, the
stochastic GCN picks) comes from a torch.Generator that the caller passes
to each step (`make_generator`).

Each step takes an optional `mesh` (parallel/sharding.py; None is one
rank): each rank then runs its samples and image rows of the global
batch (dp, sp), its batch norms over the global batch's moments, its
convs on halo-extended rows and its group norms over its sp group
(`sharding.row_shards`), its share of the loss, the gradients summed
over the ranks before Adam, and gives the global batch's loss and
metrics; over more than one rank dropout draws from the rank's own
generator, seeded from (seed, rank).  The GCN runs whole on every rank.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from torch import nn

from rnr_tpu_torch.config import DNRConfig
from rnr_tpu_torch.models.rays import rays_lt_chrom_loss
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.models.texture import TextureMapper
from rnr_tpu_torch.models.unet import RenderingNet
from rnr_tpu_torch.ops.backend import resolve_device
from rnr_tpu_torch.ops.metrics import masked_err_metrics
from rnr_tpu_torch.parallel import sharding
from rnr_tpu_torch.train.losses import (albedo_prior_loss, image_l1_loss,
                                        lighting_loss)

# the standard deviation of a unit normal truncated at +-2: flax's
# truncated-normal initialisers divide by it to keep the variance asked
TRUNC_NORMAL_STD = 0.87962566103423978


def make_generator(seed: int, device=None) -> torch.Generator:
    """The generator of a training run: on the current CUDA device when
    `device` is None (raising without one), else on `device` ("cpu" for
    a CPU run; it must be the model's device)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return g


@torch.no_grad()
def init_rnr_params(model: nn.Module, seed: int) -> nn.Module:
    """The initial weights of rnr_tpu's create_rnr_state (flax's
    defaults), drawn from a CPU generator seeded with `seed`, so a run on
    the card and one on the CPU start from the same weights: every
    kernel (conv HWIO, Dense [in, out], nn.Linear [out, in]) lecun-normal,
    a normal truncated at two deviations with variance 1 / fan-in; the
    SNDense vectors `u` standard normal; nn.Linear's biases zero (flax
    Dense's, where torch's own init would draw them from the global RNG,
    another draw in every process).  The other biases, norm scales,
    textures, the PReLU slope and the SH coefficients keep their
    constructed values."""
    gen = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        in_linear = isinstance(modules[".".join(path)], torch.nn.Linear)
        if in_linear and leaf == "bias":
            p.zero_()
            continue
        linear = in_linear and leaf == "weight"
        if leaf != "kernel" and not linear:
            continue
        fan_in = p.shape[-1] if linear else int(np.prod(p.shape[:-1]))
        std = (1.0 / fan_in) ** 0.5 / TRUNC_NORMAL_STD
        w = torch.empty(p.shape)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=gen)
        p.copy_(w)
    for name, b in model.named_buffers():
        if name.endswith(".u"):
            b.copy_(torch.randn(b.shape, generator=gen))
    return model


def create_rnr_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8 added
    to sqrt(v_hat)) over every parameter."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


@torch.no_grad()
def rnr_texture_flatten_init(model: RNRModel) -> torch.Tensor:
    """relu of the flattened initial albedo mipmap (channels 0..5): the
    albedo prior's anchor."""
    return torch.relu(model.texture_mapper.flatten_mipmap(0, 6))


def make_rnr_loss_fn(model: RNRModel, lighting_idx: int = 0,
                     mesh: sharding.Mesh | None = None) -> Callable:
    """The RNR training loss: render L1 + lighting + chrom + albedo priors.

    loss_fn(batch, statics, generator, dropout_generator=None) -> (loss,
    aux); `statics` holds l_samples_init [S, C], l_samples_mask [S] and
    tex_flatten_init [H, W, 6]; aux holds the five loss terms and the
    image.  Dropout draws from `dropout_generator` where one is given,
    else from `generator`.

    With `mesh`, `batch` holds this rank's samples and rows (of a frame
    of `frame_rows`) and the terms are its shares of the global batch's
    loss, which sum over the ranks to that loss: the image L1's sum over
    the global batch's cropped element count (`image_l1_share`), the
    priors on parameters
    alone divided by the world size, the chroma prior's masked sum over
    the global batch's alpha sum.
    """
    cfg = model.cfg
    mesh = mesh or sharding.ONE_RANK
    world = mesh.world

    def loss_fn(batch: dict, statics: dict, generator: torch.Generator,
                dropout_generator: torch.Generator | None = None,
                frame_rows: int | None = None):
        out = model(batch, lighting_idx=lighting_idx, train=True,
                    generator=generator, dropout_generator=dropout_generator)
        alpha = batch["alpha_map"]
        img_gt = batch["img_gt"]
        loss_rn = image_l1_share(out["img"], img_gt, alpha,
                                 cfg.loss.border_crop, mesh, frame_rows)
        if cfg.lighting.fix_lighting:
            loss_light = torch.zeros((), device=alpha.device)
        else:
            loss_light = lighting_loss(
                out["l_samples_est"], statics["l_samples_init"],
                statics["l_samples_mask"], cfg.loss.loss_lighting_weight,
                cfg.loss.loss_lighting_uncovered_weight) / world
        loss_chrom = rays_lt_chrom_loss(
            out["rays_lt"], alpha, img_gt, mesh.sum_(torch.sum(alpha))
        )[0] * cfg.loss.loss_rays_lt_chrom_weight
        albedo_flat = model.texture_mapper.flatten_mipmap(0, 6)
        tex_init = statics["tex_flatten_init"]
        loss_alb = (albedo_prior_loss(albedo_flat[..., 0:3],
                                      tex_init[..., 0:3])
                    + albedo_prior_loss(albedo_flat[..., 3:6],
                                        tex_init[..., 3:6])
                    ) * cfg.loss.loss_alb_weight / world
        loss = loss_rn + loss_light + loss_chrom + loss_alb
        aux = {"loss": loss, "loss_rn": loss_rn, "loss_lighting": loss_light,
               "loss_rays_lt_chrom": loss_chrom, "loss_alb": loss_alb,
               "img": out["img"]}
        return loss, aux

    return loss_fn


def image_l1_share(out: torch.Tensor, img_gt: torch.Tensor,
                   alpha: torch.Tensor, b: int, mesh: sharding.Mesh,
                   frame_rows: int | None = None) -> torch.Tensor:
    """This rank's share of the global batch's image_l1_loss: its rows
    cropped by b at the frame's global edges only (`sharding.crop_rows`),
    summed over the global batch's cropped element count (a frame of
    `frame_rows`, sp equal shares of this rank's when None); the whole
    loss on one rank."""
    n, h, w, c = out.shape
    rows = frame_rows if frame_rows is not None else h * mesh.sp
    count = n * mesh.dp * (rows - 2 * b) * (w - 2 * b) * c
    return image_l1_loss(out, img_gt, alpha, b, sharding.crop_rows(mesh, b),
                         count)


def crop_metrics(img: torch.Tensor, batch: dict, b: int,
                 mesh: sharding.Mesh | None = None) -> dict:
    """masked_err_metrics of the border-cropped (by b), alpha-masked image
    against batch["img_gt"], both scaled to 0..255.  Over row shards the
    rows are cropped at the frame's global top and bottom only and each
    image's sums are summed over its sp group, so that every rank gets
    its samples' whole-frame values."""
    mesh = mesh or sharding.ONE_RANK
    rows = sharding.crop_rows(mesh, b)
    cols = slice(b, -b) if b else slice(None)
    alpha_c = batch["alpha_map"][:, rows, cols]
    return masked_err_metrics(
        img[:, rows, cols] * alpha_c * 255.0,
        batch["img_gt"][:, rows, cols] * alpha_c * 255.0, alpha_c,
        mesh.sp_sum if mesh.sp > 1 else None)


def _num_down(model: nn.Module) -> int:
    return model.render_net.Unet_0.num_down


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_rnr_train_step(model: RNRModel, optimizer: torch.optim.Optimizer,
                        lighting_idx: int = 0,
                        mesh: sharding.Mesh | None = None, seed: int = 0
                        ) -> Callable:
    """The RNR training step: step(batch, statics, generator) -> metrics,
    the loss terms, masked_err_metrics over the border-cropped, masked
    image (0..255) and the image, all detached tensors on the model's
    device.  It updates the parameters and the SNDense vectors in place.
    Over a mesh (module docstring) the metrics are the global batch's,
    given on every rank, and "img" holds this rank's samples and rows
    (fetch_global(img, mesh.sp) gathers them); `generator` must be in
    the same state on every rank (the GCN's picks)."""
    mesh = mesh or sharding.ONE_RANK
    loss_fn = make_rnr_loss_fn(model, lighting_idx, mesh)
    drop = sharding.dropout_generator(mesh, seed, _device(model))
    b = model.cfg.loss.border_crop

    def step(batch: dict, statics: dict, generator: torch.Generator) -> dict:
        h = batch["alpha_map"].shape[1]
        sharding.check_rows(h, mesh.sp, _num_down(model))
        local = sharding.shard_rnr_batch(batch, mesh, 2 ** _num_down(model))
        optimizer.zero_grad(set_to_none=True)
        with sharding.global_batch_norm(
                model, mesh, (local["alpha_map"].shape[1], h)), \
                sharding.row_shards(model, mesh):
            loss, aux = loss_fn(local, statics, generator, drop, h)
            loss.backward()
        sharding.all_reduce_grads(model, mesh)
        optimizer.step()
        with torch.no_grad():
            img = aux.pop("img")
            metrics = sharding.global_metrics(
                mesh, crop_metrics(img, local, b, mesh), aux)
        metrics["img"] = img.detach()
        return metrics

    return step


def make_rnr_eval_step(model: RNRModel, lighting_idx: int = 0,
                       output_keys: tuple[str, ...] | None = ("img",),
                       mesh: sharding.Mesh | None = None) -> Callable:
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

    Over a mesh each rank renders its samples and rows of the global
    batch, normalised by the global batch's statistics, its convs on
    halo-extended rows, so that its rows equal those of the
    single-device frame of the whole batch (fetch_global(img, mesh.sp)
    gathers them).  Each rank takes the whole G-buffer and keeps its
    rows, as rnr_tpu renders whole and then shards.
    """
    mesh = mesh or sharding.ONE_RANK
    model.eval()

    def step(batch: dict, v_feature: torch.Tensor | None = None,
             lp_override: torch.Tensor | None = None,
             sh_override: torch.Tensor | None = None,
             relight: bool = False) -> dict:
        h = batch["alpha_map"].shape[1]
        sharding.check_rows(h, mesh.sp, _num_down(model))
        local = sharding.shard_rnr_batch(batch, mesh, 2 ** _num_down(model))
        with torch.inference_mode(), \
                sharding.global_batch_norm(
                    model, mesh, (local["alpha_map"].shape[1], h)), \
                sharding.row_shards(model, mesh):
            out = model(local,
                        lighting_idx=lighting_idx,
                        lp_override=lp_override if relight else None,
                        v_feature_override=v_feature,
                        sh_coeff_override=sh_override if relight else None)
        if output_keys is not None:
            out = {k: out[k] for k in output_keys}
        return out

    return step


# ---------------------------------------------------------------------------
# DNR
# ---------------------------------------------------------------------------


class DNRModules(nn.Module):
    """rnr_tpu's DNRModules as one module with the flax parts' names, so
    that `convert.load_jax_variables` and the checkpoints carry a flax
    DNR state ({"texture_mapper": ..., "render_net": ...}) across.

    As rnr_tpu's build_dnr_modules: the texture from cfg.texture (never
    fixed), `texture_init` [S, S, C0] into level 0; the U-Net with no GCN,
    cfg.texture.texture_num_ch in, 3 out, cfg.render_net's nf0, downs,
    norm, pad_mode and conv_backend, in float32 whatever
    cfg.render_net.compute_dtype says (rnr_tpu's build_dnr_modules leaves
    its RenderingNet at that default), so that its convs' kernels take f32
    activations (`ops/conv_cuda.py::f32_by_three`, `f32_by_six` for the
    weight gradients)."""

    def __init__(self, cfg: DNRConfig, texture_init: np.ndarray | None = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        t, r = cfg.texture, cfg.render_net
        self.cfg = cfg
        self.texture_mapper = TextureMapper(
            t.texture_size, t.texture_num_ch, t.mipmap_level, t.apply_sh,
            texture_init=texture_init)
        self.render_net = RenderingNet(
            nf0=r.nf0, in_channels=t.texture_num_ch, out_channels=3,
            num_down_unet=r.num_down_unet, use_gcn=False, norm=r.norm,
            compute_dtype="float32", pad_mode=r.pad_mode,
            conv_backend=r.conv_backend, remat=r.remat)
        self.to(device)


def build_dnr_modules(cfg: DNRConfig, texture_init: np.ndarray | None = None,
                      device=None) -> DNRModules:
    """The DNR modules on `device` (the current CUDA device when None,
    raising without one), with the constructors' values; the initial
    weights come from `init_dnr_params`."""
    return DNRModules(cfg, texture_init, device)


def init_dnr_params(mods: DNRModules, seed: int) -> DNRModules:
    """rnr_tpu's create_dnr_state initial weights by flax's distributions
    (every conv kernel lecun-normal), from a CPU generator seeded with
    `seed`; textures, biases and norm scales keep their constructed
    values."""
    return init_rnr_params(mods, seed)


def create_dnr_state(cfg: DNRConfig, seed: int, lr: float,
                     texture_init: np.ndarray | None = None, device=None
                     ) -> tuple[DNRModules, torch.optim.Adam]:
    """The modules with their initial weights and their Adam (optax.adam
    over the texture and the U-Net)."""
    mods = init_dnr_params(build_dnr_modules(cfg, texture_init, device), seed)
    return mods, create_rnr_optimizer(mods, lr)


def dnr_forward(mods: DNRModules, batch: dict, train: bool = True,
                generator: torch.Generator | None = None,
                sh_start_ch: int = 3, img_max_val: float = 2.0):
    """(image [N, H, W, 3], the neural image): the texture sampled at
    batch["uv_map"] (K2), modulated by batch["sh_basis_map"] from
    `sh_start_ch`, through the U-Net, its tanh output mapped to [0,
    img_max_val].  train=True runs dropout from `generator`."""
    neural_img = mods.texture_mapper(batch["uv_map"],
                                     batch.get("sh_basis_map"),
                                     sh_start_ch=sh_start_ch)
    out = mods.render_net(neural_img, None, train, generator)
    return (out * 0.5 + 0.5) * img_max_val, neural_img


def make_dnr_train_step(cfg: DNRConfig, mods: DNRModules,
                        optimizer: torch.optim.Optimizer,
                        mesh: sharding.Mesh | None = None, seed: int = 0
                        ) -> Callable:
    """The DNR training step: step(batch, generator) -> metrics, the
    masked_err_metrics of the border-cropped, masked image (0..255) and
    the loss, detached tensors on the modules' device.  batch holds
    uv_map, sh_basis_map, alpha_map [N, H, W, 1] and img_gt, every map
    sharded over a mesh's ranks (samples over dp, rows over sp); the
    parameters are updated in place."""
    mesh = mesh or sharding.ONE_RANK
    drop = sharding.dropout_generator(mesh, seed, _device(mods))
    b = cfg.loss.border_crop

    def step(batch: dict, generator: torch.Generator) -> dict:
        h = batch["alpha_map"].shape[1]
        sharding.check_rows(h, mesh.sp, _num_down(mods))
        local = sharding.shard_batch(batch, mesh, 2 ** _num_down(mods))
        optimizer.zero_grad(set_to_none=True)
        with sharding.global_batch_norm(
                mods, mesh, (local["alpha_map"].shape[1], h)), \
                sharding.row_shards(mods, mesh):
            out, _ = dnr_forward(mods, local, train=True,
                                 generator=drop or generator,
                                 sh_start_ch=cfg.sh_start_ch)
            loss = image_l1_share(out, local["img_gt"], local["alpha_map"],
                                  b, mesh, h)
            loss.backward()
        sharding.all_reduce_grads(mods, mesh)
        optimizer.step()
        with torch.no_grad():
            return sharding.global_metrics(
                mesh, crop_metrics(out, local, b, mesh), {"loss": loss})

    return step


def make_dnr_eval_step(cfg: DNRConfig, mods: DNRModules) -> Callable:
    """step(batch) -> the image [N, H, W, 3] in [0, 2], no dropout, under
    torch.inference_mode()."""
    def step(batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            return dnr_forward(mods, batch, train=False,
                               sh_start_ch=cfg.sh_start_ch)[0]

    return step
