"""Free-viewpoint relighting: the per-view and per-lighting pieces (port
of rnr_tpu/drivers/test_rnr.py).

For every view, rnr_tpu's `test_rnr` rasterizes the mesh into a full
G-buffer (`_gbuffer` around `ops.gbuffer.render_gbuffer`), turns it into
the model's batch (`_to_batch`) and renders one frame per lighting of its
list (`lightings`: novel probes, fitted to SH or gathered as they are, or
the learned lightings as probes) with the eval step and the cached
`v_feature` (`relit_frame`, which can composite the probe behind the
object).  `_reconcile_sh_bands` fits a novel probe's SH projection to the
model's band count.  Those functions are ported here.  Its `main()` is
not: it needs the checkpoint reader (`train/checkpoint.py`), the view
dataset with its calibration and the probe-image reader.  A sequence is
rendered by hand:

    mesh_buf = make_mesh_buffers(mesh)              # on the card
    v_feature = model.compute_v_feature(gcn_pos)
    step = make_rnr_eval_step(model)
    lights = lightings(model, probes)               # [L, H, W, 3] probes
    for view in views:
        gb = _gbuffer(render_gbuffer, mesh_buf, view, 512)
        batch = _to_batch(gb, gcn_pos)
        for name, lp, sh in lights:
            img = relit_frame(step, batch, lp, sh, v_feature)
"""

from __future__ import annotations

import numpy as np
import torch

from rnr_tpu_torch.models.lighting import LightingLP
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear
from rnr_tpu_torch.ops.spherical import spherical_mapping


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
