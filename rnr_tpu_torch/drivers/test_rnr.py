"""Free-viewpoint inference: the per-view pieces (port of
rnr_tpu/drivers/test_rnr.py).

For every view, rnr_tpu's `test_rnr` rasterizes the mesh into a full
G-buffer (`_gbuffer` around `ops.gbuffer.render_gbuffer`), turns it into
the model's batch (`_to_batch`) and runs the eval step with the cached
`v_feature`; `_reconcile_sh_bands` fits a novel probe's SH projection to
the checkpoint's band count.  Those functions are ported here.  Its
`main()` is not ported yet: it needs the checkpoint reader
(`train/checkpoint.py`), the view dataset with its calibration, and the
light-probe render path, none of which the port has.  A sequence is
rendered by hand:

    mesh_buf = make_mesh_buffers(mesh)              # on the card
    v_feature = model.compute_v_feature(gcn_pos)
    step = make_rnr_eval_step(model)
    for view in views:
        gb = _gbuffer(render_gbuffer, mesh_buf, view, 512)
        img = step(_to_batch(gb, gcn_pos), v_feature=v_feature)["img"]
"""

from __future__ import annotations

import numpy as np
import torch


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
