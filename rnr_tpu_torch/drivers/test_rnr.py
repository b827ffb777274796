"""Free-viewpoint (re)lighting inference driver (port of
rnr_tpu/drivers/test_rnr.py).

`main` loads a training run's `params.json` and checkpoint (the port's
own, or one that rnr_tpu wrote), computes the GCN's v_feature once, then
for each test view rasterizes the mesh into a full G-buffer on the fly
(`_gbuffer` around `ops.gbuffer.render_gbuffer`: K7 and the per-pixel
maps), turns it into the model's batch (`_to_batch`) and renders one frame
per lighting of its list (`lightings`: novel probes from `--lp_dir`,
fitted to SH or gathered as they are, or the learned lightings as
probes) with the eval step and the cached v_feature (`relit_frame`,
which can composite the probe behind the object), writing one PNG per
view and lighting.  It prints per-view times: t_prep, t_raster and
t_network_render, or with `--per_stage_timing` the reference's buckets
(t_prep, t_raster, t_preproc, t_sh, t_texture, t_rays, t_network,
t_render; `_make_staged`), each on the card timed by CUDA events that it
waits for.  `_reconcile_sh_bands` fits a novel probe's SH projection to
the model's band count.  `--mesh_devices N --mesh_dp D` spawns N ranks
(on cuda:{rank} or the CPU) joined in one process group, laid out as a
(D, N / D) mesh (parallel/sharding.py): view i goes to the ranks of dp
index i mod D, whose N / D sp ranks render its frame together at batch
1, rnr_tpu's tile-sharded frames.  Each of them rasterizes the whole
G-buffer (K7) and runs the network on its rows (halo exchanges and
norms over its sp group), so each frame is the single-device frame;
the first sp rank of each dp index writes the PNGs of its views'
gathered frames.  The rows must split: img_size % 2**num_down == 0, at
least 2 innermost rows a rank (sharding.check_rows), checked before any
rank starts.  With `--per_stage_timing` over sp ranks each rank times
each bucket between barriers of its sp group, on its rows, and the first
sp rank's times are reported, as rnr_tpu's driver does on a mesh.

Usage:
  python -m rnr_tpu_torch.drivers.test_rnr --data_root DATA \
      --checkpoint_dir LOGDIR [--lighting_idx 0] [--lp_dir _/light_probe]
      [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import scipy.io
import torch

from rnr_tpu_torch.config import RNRConfig, load_config
from rnr_tpu_torch.data import LightProbeDataset, Mesh, ViewDataset, load_obj
from rnr_tpu_torch.drivers.common import (cond_mkdir, load_sphere_samples,
                                          resolve, save_png, setup_device,
                                          str2bool)
from rnr_tpu_torch.models.lighting import LightingLP
from rnr_tpu_torch.models.rays import ray_render, ray_render_sh
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.ops.gbuffer import (make_mesh_buffers, render_gbuffer,
                                       render_raster)
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear
from rnr_tpu_torch.ops.spherical import spherical_mapping
from rnr_tpu_torch.parallel.distributed import (fetch_global, free_port,
                                                init_distributed,
                                                rank_device, run_ranks)
from rnr_tpu_torch.parallel import sharding
from rnr_tpu_torch.train.checkpoint import load_checkpoint
from rnr_tpu_torch.train.steps import make_rnr_eval_step
from rnr_tpu_torch.utils.trace import StepTimer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--checkpoint_dir", required=True,
                   help="training log dir holding params.json + *.ckpt")
    p.add_argument("--checkpoint_name", type=str, default="model_final.ckpt")
    p.add_argument("--calib_fp", type=str, default="_/calib.mat")
    # a directory holding calib.mat; overrides --calib_fp when given
    p.add_argument("--calib_dir", type=str, default=None)
    p.add_argument("--obj_high_fp", type=str, default="_/mesh.obj")
    p.add_argument("--obj_gcn_fp", type=str, default="_/mesh_7500v.obj")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--img_gamma", type=float, default=1.0)
    p.add_argument("--sampling_pattern", type=str, default="all")
    p.add_argument("--lighting_idx", type=int, default=None,
                   help="render under this learned lighting (default: all)")
    p.add_argument("--lp_dir", type=str, default=None,
                   help="directory of novel light probes to relight with")
    # SH band limit for novel probes; None = the checkpoint's lmax
    p.add_argument("--sh_lmax", type=int, default=None)
    # reference alias: "SH" = --lp_sh true, "train" = no lp_dir, the
    # checkpoint's trained lighting
    p.add_argument("--lighting_type", type=str, default=None,
                   choices=["SH", "train"])
    p.add_argument("--lp_sh", default=True, type=str2bool,
                   help="fit novel probes to SH and relight through the SH "
                        "path; false = the probe gather")
    p.add_argument("--per_stage_timing", default=False, type=str2bool,
                   help="time texture / rays / U-Net / render as separate "
                        "stages instead of the fused step")
    p.add_argument("--sphere_samples_fp", type=str,
                   default="./sphere_samples_4096.mat")
    # --save_img_bg is the reference's name for --save_lp_background;
    # --force_recompute is accepted and ignored (nothing is cached)
    p.add_argument("--save_img_bg", default=None, type=str2bool)
    p.add_argument("--force_recompute", default=False, type=str2bool)
    p.add_argument("--save_lp_background", default=False, type=str2bool)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--platform", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    # reference-script compatibility: accepted and ignored
    p.add_argument("--gpu_id", type=str, default=None)
    p.add_argument("--calib_format", type=str, default="convert",
                   choices=["convert"])
    p.add_argument("--mesh_devices", type=int, default=None,
                   help="render over N ranks: views over --mesh_dp, each "
                        "frame's rows over N / mesh_dp")
    p.add_argument("--mesh_dp", type=int, default=1)
    return p


def _gbuffer(render_fn, mesh_buf, view: dict, img_size: int, **kw):
    """One view's `render_fn` (render_gbuffer or render_raster) on the
    mesh's device: view holds proj [3, 3], pose [4, 4] and dist_coeffs
    [>= 5] as host arrays."""
    dev = mesh_buf.vertices.device

    def host(a):
        return torch.from_numpy(np.asarray(a, np.float32)[None]).to(dev)

    return render_fn(mesh_buf, host(view["proj"]), host(view["pose"]),
                     host(np.asarray(view["dist_coeffs"])[:5]), None, None,
                     img_size, **kw)


def _to_batch(gb: dict, gcn_pos) -> dict:
    """The eval step's batch from a G-buffer: the first 9 SH basis maps,
    alpha with a channel axis, a zero ground truth."""
    dev = gb["normal_map"].device
    return {
        "uv_map": gb["uv_map"],
        "sh_basis_map": gb["sh_basis_map"][..., :9],
        "normal_map": gb["normal_map"],
        "view_dir_map": gb["view_dir_map"],
        "view_dir_map_tangent": gb["view_dir_map_tangent"],
        "TBN_map": gb["TBN_map"],
        "alpha_map": gb["alpha_map"][..., None],
        "img_gt": torch.zeros_like(gb["normal_map"]),
        "gcn_pos": torch.as_tensor(gcn_pos, dtype=torch.float32, device=dev),
    }


def _reconcile_sh_bands(sh_coeffs: torch.Tensor, nb_train: int
                        ) -> torch.Tensor:
    """A probe's SH projection [L, B, C] -> [L, nb_train, C]: missing high
    bands zero-padded (a band-limited relight), extra bands cut."""
    if sh_coeffs.shape[1] < nb_train:
        pad = torch.zeros(
            (sh_coeffs.shape[0], nb_train - sh_coeffs.shape[1],
             sh_coeffs.shape[2]), dtype=sh_coeffs.dtype,
            device=sh_coeffs.device)
        return torch.cat([sh_coeffs, pad], dim=1)
    return sh_coeffs[:, :nb_train]


@torch.no_grad()
def lightings(model, probes: np.ndarray | None = None, lp_sh: bool = True,
              sh_lmax: int | None = None, lighting_idx: int | None = None
              ) -> list:
    """The lightings to render under, as (name, probe [1, H, W, C] or
    None, SH coefficients [B, C] or None), on the model's device
    (rnr_tpu/drivers/test_rnr.py:201-250).

    With `probes` [L, H, W, C] (novel light probes): "novel%02d" each
    with its probe and, when `lp_sh`, its SH coefficients, fitted by
    `LightingLP(l_dir, lps=probes).fit_sh(sh_lmax or the model's lmax)`
    and cut or zero-padded to the model's band count; the eval step then
    relights through the SH path, else through the probe gather.
    Without: the learned lighting `lighting_idx`, or every learned
    lighting, each as its reconstructed probe ("learned%d")."""
    light = model.lighting
    dev = light.coeff.device
    if probes is not None:
        lps = torch.as_tensor(np.asarray(probes, np.float32), device=dev)
        sh = None
        if lp_sh:
            lp_model = LightingLP(light.l_dir.cpu().numpy(), lps=probes,
                                  device=dev)
            sh = _reconcile_sh_bands(
                lp_model.fit_sh(light.lmax if sh_lmax is None else sh_lmax),
                (light.lmax + 1) ** 2)
        return [("novel%02d" % i, lps[i][None], None if sh is None else sh[i])
                for i in range(lps.shape[0])]
    idx = ([lighting_idx] if lighting_idx is not None
           else range(light.coeff.shape[0]))
    return [(f"learned{i}", light(i, is_lp=True), None) for i in idx]


def lp_background(lp: torch.Tensor, view_dir_map: torch.Tensor
                  ) -> torch.Tensor:
    """The probe lp [H, W, C] seen along the camera rays: its bilinear
    value at spherical_mapping(-view_dir) per pixel, view_dir_map
    [h, w, 3] -> [h, w, C]."""
    uv = spherical_mapping(-torch.movedim(view_dir_map, -1, 0))
    h, w = lp.shape[0], lp.shape[1]
    x = torch.clamp(uv[0] * w, max=w - 1)
    y = torch.clamp(uv[1] * h, max=h - 1)
    return interpolate_bilinear(lp, x, y)


def relit_frame(step, batch: dict, lp: torch.Tensor | None,
                sh_coeff: torch.Tensor | None, v_feature=None,
                save_lp_background: bool = False) -> torch.Tensor:
    """One view under one lighting of `lightings`: the eval step with
    relight on (SH coefficients take precedence over the probe), the
    first image masked by alpha [H, W, C] and, with
    `save_lp_background`, the probe composited behind the object, weighted
    by 1 - alpha (rnr_tpu/drivers/test_rnr.py:325-343)."""
    out = step(batch, v_feature=v_feature, lp_override=lp,
               sh_override=sh_coeff, relight=True)
    alpha = batch["alpha_map"][0]
    img = out["img"][0] * alpha
    if save_lp_background:
        img = img + lp_background(lp[0], batch["view_dir_map"][0]) * (
            1.0 - alpha)
    return img


def main(argv=None, keep_frames: bool = False) -> dict:
    """Render the test views.  Returns {"views", "lightings", "render_s"
    (the views' wall time, each view ending with its PNG writes),
    "buckets" (every printed time summed over the views), "frames"}:
    with `keep_frames` the frames {(image stem, lighting name):
    [H, W, C] tensor}, else empty."""
    opt = build_argparser().parse_args(argv)
    n = opt.mesh_devices or 1
    _, sp = sharding.mesh_shape(n, opt.mesh_dp)
    if sp > 1:
        cfg = load_config(RNRConfig,
                          os.path.join(opt.checkpoint_dir, "params.json"))
        sharding.check_rows(opt.img_size, sp, cfg.render_net.num_down_unet)
    dev = setup_device(opt.platform)
    if n == 1:
        return _render(opt, dev, keep_frames)
    # the first sp rank of each dp index: its views' frames, counted once
    parts = run_ranks(_render_rank, n, opt, keep_frames, free_port())[::sp]
    frames, buckets = {}, {}
    for part in parts:
        frames.update({k: torch.from_numpy(v)
                       for k, v in part["frames"].items()})
        for k, v in part["buckets"].items():
            buckets[k] = buckets.get(k, 0.0) + v
    return {"views": sum(p["views"] for p in parts),
            "lightings": parts[0]["lightings"],
            "render_s": max(p["render_s"] for p in parts),
            "buckets": buckets, "frames": frames}


def _render_rank(rank: int, opt, keep_frames: bool, port: int) -> dict:
    """A spawned rank: joins the group, renders its share of the views
    and leaves; frames as host arrays."""
    n = opt.mesh_devices
    if opt.platform == "cpu":     # the host's cores shared by the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init_distributed(f"127.0.0.1:{port}", 1, 0, n, local_rank=rank,
                     platform=opt.platform)
    try:
        out = _render(opt, rank_device(rank, opt.platform), keep_frames,
                      sharding.make_mesh(n, dp=opt.mesh_dp))
    finally:
        torch.distributed.destroy_process_group()
    out["frames"] = {k: v.float().cpu().numpy()
                     for k, v in out["frames"].items()}
    return out


def _render(opt, dev: torch.device, keep_frames: bool,
            ranks: sharding.Mesh | None = None) -> dict:
    """main's render on `dev`: over the mesh `ranks`, the views of its dp
    index (index, index + dp, ...; "views" counts them), each frame's
    rows over its sp group; the frames kept and written by its first sp
    rank."""
    if opt.calib_dir:
        opt.calib_fp = os.path.join(resolve(opt.calib_dir, opt.data_root),
                                    "calib.mat")
    opt.calib_fp = resolve(opt.calib_fp, opt.data_root)
    if opt.save_img_bg is not None:
        opt.save_lp_background = opt.save_img_bg
    opt.obj_high_fp = resolve(opt.obj_high_fp, opt.data_root)
    opt.obj_gcn_fp = resolve(opt.obj_gcn_fp, opt.data_root)
    opt.lp_dir = resolve(opt.lp_dir, opt.data_root)

    cfg = load_config(RNRConfig,
                      os.path.join(opt.checkpoint_dir, "params.json"))
    l_dir = load_sphere_samples(resolve(opt.sphere_samples_fp,
                                        opt.data_root))
    calib = scipy.io.loadmat(opt.calib_fp)
    mesh = Mesh(opt.obj_high_fp,
                global_RT=calib["global_RT"].astype(np.float32))
    mesh_buf = make_mesh_buffers(mesh, dev)
    gcn_pos = load_obj(opt.obj_gcn_fp).v

    ds = ViewDataset(root_dir=opt.data_root, calib_path=opt.calib_fp,
                     img_dir=None, load_img=False,
                     img_size=(opt.img_size, opt.img_size),
                     sampling_pattern=opt.sampling_pattern)

    t0 = time.time()
    model = RNRModel(cfg, len(gcn_pos), l_dir=l_dir, device=dev)
    load_checkpoint(os.path.join(opt.checkpoint_dir, opt.checkpoint_name),
                    model)
    print(f"restored checkpoint ({time.time() - t0:.1f}s)")
    part, parts, write = 0, 1, True
    eval_step = make_rnr_eval_step(model)
    if ranks is not None:
        part, parts, write = ranks.dp_index, ranks.dp, ranks.sp_index == 0
        sp_mesh = ranks.sp_mesh()
        eval_step = _gathered(make_rnr_eval_step(model, mesh=sp_mesh),
                              sp_mesh)

    # the GCN feature does not depend on the view: once for the sequence
    v_feature = None
    if cfg.use_gcn:
        with torch.inference_mode():
            v_feature = model.compute_v_feature(
                torch.from_numpy(gcn_pos).to(dev))

    if opt.lighting_type == "SH":
        opt.lp_sh = True
    elif opt.lighting_type == "train":
        opt.lp_dir = None
        if opt.lighting_idx is None:
            opt.lighting_idx = cfg.lighting.lighting_idx or 0

    if opt.lp_dir is not None and os.path.isdir(opt.lp_dir):
        lp_ds = LightProbeDataset(opt.lp_dir, img_gamma=opt.img_gamma)
        lp_ds.buffer_all()
        probes = np.stack([lp_ds[i]["lp_img"] for i in range(len(lp_ds))])
        lps = lightings(model, probes, lp_sh=opt.lp_sh, sh_lmax=opt.sh_lmax)
    else:
        lps = lightings(model, lighting_idx=opt.lighting_idx)

    out_dir = opt.out_dir or os.path.join(
        opt.checkpoint_dir, f"test_seq_{opt.sampling_pattern}")
    for name, _, _ in lps:
        cond_mkdir(os.path.join(out_dir, name))

    timer = StepTimer(dev)
    sp_ranks = sp_mesh if ranks is not None and ranks.sp > 1 else None

    def timed(fn):
        _barrier(sp_ranks)
        timer.start()
        out = fn()
        return out, timer.stop()

    staged = (_make_staged(model, dev, sp_ranks) if opt.per_stage_timing
              else None)
    frames = {}
    buckets: dict = {}
    mine = range(part, len(ds), parts)
    print(f"rendering {len(mine)} of {len(ds)} views under {len(lps)} "
          "lightings")
    t_views = time.perf_counter()
    for i in mine:
        t0 = time.time()
        view = ds.read_view(i)
        t_prep = time.time() - t0
        times = {}
        if staged is not None:
            # t_raster: projection and z-buffer alone; t_preproc: the maps
            # without the SH basis; t_sh: the SH basis map
            _, t_raster = timed(lambda: _gbuffer(render_raster, mesh_buf,
                                                 view, opt.img_size))
            _, t_nosh = timed(lambda: _gbuffer(render_gbuffer, mesh_buf,
                                               view, opt.img_size,
                                               with_sh=False))
            gb, t_full = timed(lambda: _gbuffer(render_gbuffer, mesh_buf,
                                                view, opt.img_size))
            times["t_preproc"] = max(t_nosh - t_raster, 0.0)
            times["t_sh"] = max(t_full - t_nosh, 0.0)
        else:
            gb, t_raster = timed(lambda: _gbuffer(render_gbuffer, mesh_buf,
                                                  view, opt.img_size))
        if "raster_overflow" in gb and int(gb["raster_overflow"].sum()):
            print(f"WARNING view {i}: raster tile-binning overflow -- "
                  "render incomplete, raise max_faces_per_tile")
        batch = _to_batch(gb, gcn_pos)
        stem = view["img_fn"].split(".")[0]

        t0 = time.time()
        for name, lp, sh in lps:
            if staged is not None:
                img, stage_times = staged(batch, lp, sh, v_feature,
                                          opt.save_lp_background)
                for k, v in stage_times.items():
                    times[k] = times.get(k, 0.0) + v
            else:
                img = relit_frame(eval_step, batch, lp, sh, v_feature,
                                  opt.save_lp_background)
            if keep_frames and write:
                frames[(stem, name)] = img
            if write:
                save_png(os.path.join(out_dir, name, stem + ".png"), img)
        t_net = time.time() - t0   # the PNG writes wait for each frame
        stage_str = "".join(f"  {k} {v:.3f}" for k, v in times.items())
        print(f"view {i:04d}  t_prep {t_prep:.3f}  t_raster {t_raster:.3f}  "
              f"t_network_render {t_net:.3f}{stage_str}")
        times.update(t_prep=t_prep, t_raster=t_raster, t_network_render=t_net)
        for k, v in times.items():
            buckets[k] = buckets.get(k, 0.0) + v
    render_s = time.perf_counter() - t_views
    print("wrote", out_dir)
    return {"views": len(mine), "lightings": len(lps), "render_s": render_s,
            "buckets": buckets, "frames": frames}


def _gathered(step, mesh: sharding.Mesh):
    """The eval step over the row shards of `mesh` (dp 1) with each
    output gathered whole on every rank (a collective of the mesh)."""
    if mesh.sp == 1:
        return step

    def run(batch, **kw):
        out = step(batch, **kw)
        return {k: torch.from_numpy(fetch_global(v, mesh.sp, mesh.group)
                                    ).to(v.device) for k, v in out.items()}

    return run


def _barrier(mesh: sharding.Mesh | None) -> None:
    """Wait for the other ranks of the mesh's group (none without one)."""
    if mesh is not None:
        torch.distributed.barrier(group=mesh.group)


def _make_staged(model, dev, mesh: sharding.Mesh | None = None):
    """The eval frame split into stages, each timed by CUDA events on the
    card (the host clock on the CPU) that it waits for: texture sampling
    (K2), the ray fans, the U-Net (the GCN feature cached) and the SH
    shading of the materialised rays (K5) or the probe gather, as
    rnr_tpu's reference-granularity buckets.  Over the row shards of
    `mesh` (dp 1) each rank runs every stage on its rows (the U-Net's
    norms and halos over the mesh), each stage starting after a barrier
    of the mesh's group, and the frame is gathered whole on every rank.
    Slower than the fused step; for diagnostics.  run(batch, lp,
    sh_coeff, v_feature, save_lp_background) -> (frame [H, W, C] as
    relit_frame's, this rank's times)."""
    c = model.cfg
    timer = StepTimer(dev)
    unit = 2 ** model.render_net.Unet_0.num_down
    num_ray_diffuse = c.rays.num_azi * c.rays.num_polar + 1

    def rays(batch):
        tbn, vdt = batch["TBN_map"], batch["view_dir_map_tangent"]
        ds_, us_, _ = model.ray_sampler(tbn, vdt, batch["alpha_map"])
        dd_, ud_, _ = model.ray_sampler_diffuse(tbn, vdt, batch["alpha_map"])
        return torch.cat([ds_, dd_], -1), torch.cat([us_, ud_], -1)

    def network(batch, neural_img, rays_dir, v_feature):
        n, h, w = batch["alpha_map"].shape[:3]
        r_total = rays_dir.shape[-1]
        vf = (None if v_feature is None
              else v_feature.expand(n, v_feature.shape[-1]))
        net_in = torch.cat([
            torch.swapaxes(rays_dir, -1, -2).reshape(n, h, w, r_total * 3),
            batch["normal_map"], batch["view_dir_map"], neural_img], dim=-1)
        lt = model.render_net(net_in, vf, False, None)
        return (lt.reshape(n, h, w, r_total, 3) * 0.5 + 0.5) * (
            c.rays.lt_max_val)

    def render(batch, neural_img, rays_dir, rays_uv, rays_lt, lp, sh_coeff):
        if sh_coeff is not None:
            return ray_render_sh(
                neural_img[..., 3:6], rays_dir, batch["alpha_map"], rays_lt,
                sh_coeff, c.lighting.sh_lmax,
                num_ray_diffuse=num_ray_diffuse,
                albedo_diffuse=neural_img[..., 0:3])
        return ray_render(neural_img[..., 3:6], rays_uv, rays_lt, lp,
                          num_ray_diffuse=num_ray_diffuse,
                          albedo_diffuse=neural_img[..., 0:3],
                          separate_albedo=True)

    @torch.inference_mode()
    def run(batch, lp, sh_coeff, v_feature, save_lp_background=False):
        times = {}
        mesh_ = mesh or sharding.ONE_RANK
        h = batch["alpha_map"].shape[1]
        batch = sharding.shard_rnr_batch(batch, mesh_, unit)

        def stage(name, fn):
            _barrier(mesh)
            timer.start()
            out = fn()
            times[name] = timer.stop()
            return out

        neural_img = stage("t_texture", lambda: model.texture_mapper(
            batch["uv_map"], batch["sh_basis_map"], sh_start_ch=6))
        rays_dir, rays_uv = stage("t_rays", lambda: rays(batch))
        with sharding.global_batch_norm(
                model, mesh_, (batch["alpha_map"].shape[1], h)), \
                sharding.row_shards(model, mesh_):
            rays_lt = stage("t_network", lambda: network(
                batch, neural_img, rays_dir, v_feature))
        out = stage("t_render", lambda: render(
            batch, neural_img, rays_dir, rays_uv, rays_lt, lp, sh_coeff))
        alpha = batch["alpha_map"][0]
        img = out["out"][0] * alpha
        if save_lp_background:
            img = img + lp_background(lp[0], batch["view_dir_map"][0]) * (
                1.0 - alpha)
        if mesh is not None:
            img = torch.from_numpy(fetch_global(img[None], mesh.sp,
                                                mesh.group)[0]).to(img.device)
        return img, times

    return run


if __name__ == "__main__":
    main()
