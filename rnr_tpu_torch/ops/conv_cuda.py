"""K3: 3x3 stride-1 conv (csrc/conv3x3.cu) and its twin.

Replaces rnr_tpu/ops/conv_pallas.py::conv3x3 (forward, fuse_act=False as
the U-Net calls it): NHWC activations, HWIO weights cast to the
activation dtype, f32 accumulation, + bias in f32, output in the
activation dtype.  Zero ("same") or reflect padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)


def conv3x3_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  pad_mode: str = "same") -> torch.Tensor:
    """Plain twin: F.conv2d on the NCHW view, in f32 from inputs rounded
    to the activation dtype, + bias, rounded back to that dtype."""
    dt = x.dtype
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(dt).to(torch.float32).permute(3, 2, 0, 1)
    if pad_mode == "reflect":
        xf = F.pad(xf, (1, 1, 1, 1), mode="reflect")
        y = F.conv2d(xf, wf)
    else:
        y = F.conv2d(xf, wf, padding=1)
    y = y + b.to(torch.float32)[None, :, None, None]
    return y.permute(0, 2, 3, 1).to(dt)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            pad_mode: str = "same") -> torch.Tensor:
    """x [N, H, W, C], w [3, 3, C, O], b [O] -> [N, H, W, O] in x.dtype.
    The kernel takes bf16 activations."""
    if pad_mode not in ("same", "reflect"):
        raise ValueError(f"pad_mode {pad_mode!r}")
    if not use_kernel(x, w, b):
        return conv3x3_torch(x, w, b, pad_mode)
    n, h, wd, c = x.shape
    o = w.shape[-1]
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W >= 2")
    xb = x.contiguous()
    require(xb, "x", torch.bfloat16, (n, h, wd, c))
    wb = w.to(torch.bfloat16).contiguous()
    require(wb, "w", torch.bfloat16, (3, 3, c, o))
    bf = b.to(torch.float32).contiguous()
    require(bf, "b", torch.float32, (o,))
    y = torch.empty((n, h, wd, o), dtype=torch.bfloat16, device=x.device)
    f = _build.fn("conv3x3", "rnr_conv3x3", 4, 6)
    conv3x3.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(), bf.data_ptr(), y.data_ptr(),
                   n, h, wd, c, o, int(pad_mode == "reflect"), stream_of(xb)),
                 "conv3x3")
    return y


conv3x3.launches = 0
