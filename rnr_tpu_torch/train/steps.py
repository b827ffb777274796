"""Steps (port of rnr_tpu/train/steps.py): the eval step only.

The training step, the losses and the optimizer come with the next slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from rnr_tpu_torch.models.rnr import RNRModel


def make_rnr_eval_step(model: RNRModel, lighting_idx: int = 0,
                       output_keys: tuple[str, ...] | None = ("img",)
                       ) -> Callable:
    """Inference step: step(batch, v_feature=None, sh_override=None) ->
    dict of `output_keys` (all outputs when None).

    Pass the cached `model.compute_v_feature(batch["gcn_pos"])` as
    `v_feature` to skip the GCN per frame; `sh_override` [B, C] relights
    through the SH-direct path.  The model runs in eval mode under
    torch.inference_mode().
    """
    model.eval()

    def step(batch: dict, v_feature: torch.Tensor | None = None,
             sh_override: torch.Tensor | None = None) -> dict:
        with torch.inference_mode():
            out = model(batch, lighting_idx=lighting_idx,
                        v_feature_override=v_feature,
                        sh_coeff_override=sh_override)
        if output_keys is not None:
            out = {k: out[k] for k in output_keys}
        return out

    return step
