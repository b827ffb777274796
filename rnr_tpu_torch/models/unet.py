"""Deferred-rendering U-Net with GCN feature fusion (port of
rnr_tpu/models/unet.py).

NHWC at every module boundary.  `conv_backend` picks what runs each conv,
as rnr_tpu's selector does (rnr_tpu/models/unet.py:98-138, 170-182):

  selector                  3x3 stride 1   4x4 stride-2 down   4x4 transpose
  "xla"                     plain          plain               plain
  "pallas3", "auto"         K3             plain               plain
  "pallas", "pallas_interpret"  K3         K6 down4            K6 convt4
  "p3s4"                    K3             K8 down4s           K8 convt4s
  "slab3"                   K8a conv3x3s   plain               plain
  "slab"                    K8a conv3x3s   K8 down4s           K8 convt4s

"plain" is F.conv2d / F.conv_transpose2d at the activation dtype (cuDNN
on the card), where rnr_tpu has XLA's convs.  K3 and K8a (the 3x3 slab
conv) are ops/conv_cuda.py, K6 and K8's 4x4 pair ops/conv4_cuda.py; each
backward is its kernels' too (K3b, K8b for the 3x3 weight gradients).
"auto" is "pallas3" in every step: rnr_tpu's eval step swaps it to
"xla" on the strength of a TPU measurement (rnr_tpu/train/steps.py:
238-247), which says nothing of this card.  "pallas_interpret" is
"pallas" (the CPU runs the plain versions anyway).  Every selector
shares one parameter layout: each conv and transpose conv keeps flax's
HWIO `kernel`.

Normalisation uses current-batch statistics ("batch", no running
state), flax's GroupNorm with groups of 16 channels ("group"), or none.
Under data parallelism the batch statistics are the global batch's
(`BatchActNorm.moments`, set by parallel/sharding.py::global_batch_norm);
over row shards every conv route takes a halo exchange (`Conv.halo`)
and group norm sums its statistics over the shards (`GroupNorm.group_sum`,
both set by parallel/sharding.py::row_shards).
`remat` recomputes blocks in the backward instead of storing their
activations, as rnr_tpu's nn.remat (rnr_tpu/models/unet.py:387-420):
False / "none" stores everything, True / "all" recomputes every
DownBlock, GcnFuseBlock and UpBlock, "wide" only those at level 0 and 1
and the fusion block.
With train=True, dropout (p 0.1) follows every activation where
rnr_tpu's Unet has it, its masks drawn from the torch.Generator the
caller passes.  Submodule names mirror the flax auto-names (Conv_0,
BatchActNorm_1, GroupNorm_0, DownBlock_2, ...), so that
`rnr_tpu_torch.convert` can map a JAX parameter tree by path.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rnr_tpu_torch.ops.conv4_cuda import convt4, convt4s, down4, down4s
from rnr_tpu_torch.ops.conv_cuda import conv3x3, conv3x3s, reflect_pad1

DROPOUT_P = 0.1   # rnr_tpu's RenderingNet fixes the U-Net's dropout rate
GROUP_SIZE = 16   # rnr_tpu's GroupNorm(num_groups=None, group_size=16)

# conv_backend -> (3x3 stride 1, 4x4 stride-2 down, 4x4 transpose)
CONV_ROUTES = {
    "xla": ("plain", "plain", "plain"),
    "auto": ("k3", "plain", "plain"),
    "pallas3": ("k3", "plain", "plain"),
    "pallas": ("k3", "down4", "convt4"),
    "pallas_interpret": ("k3", "down4", "convt4"),
    "p3s4": ("k3", "down4s", "convt4s"),
    "slab3": ("slab", "plain", "plain"),
    "slab": ("slab", "down4s", "convt4s"),
}


# (kernel, stride) -> (halo rows, output rows dropped at each side) of a
# conv over row shards: 3x3 reads one row each side; the 4x4 stride-2
# down conv takes two, so that the stride keeps its parity, and drops
# the one output row that reads its own padding
ROW_HALO = {(3, 1): (1, 1), (4, 2): (2, 1)}


# rnr_tpu's Unet.remat values -> the blocks recomputed in the backward
REMAT_MODES = {False: "none", "none": "none", True: "all", "all": "all",
               "wide": "wide"}


def remat_mode(remat) -> str:
    """"none", "all" or "wide" for a RenderNetConfig.remat value; raises
    ValueError for another."""
    mode = REMAT_MODES.get(remat) if isinstance(remat, (bool, str)) else None
    if mode is None:
        raise ValueError(f"remat {remat!r}: expected one of "
                         f"{list(REMAT_MODES)}")
    return mode


def remat_call(fn, generator: torch.Generator | None, *args):
    """fn(*args) under torch.utils.checkpoint (non-reentrant): its
    activations are recomputed in the backward instead of stored.
    checkpoint restores only the global RNGs, so the recompute restarts
    `generator` (dropout's) from where fn's forward found it and then sets
    it back to where the backward found it: the masks are the forward's,
    and a run with remat leaves the generator where one without leaves
    it."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    entry = generator.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        left = generator.get_state()
        generator.set_state(entry)
        try:
            return fn(*a)
        finally:
            generator.set_state(left)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def conv_routes(backend: str) -> tuple[str, str, str]:
    """The routes of a conv_backend selector; raises for an unknown one."""
    if backend not in CONV_ROUTES:
        raise ValueError(f"conv_backend {backend!r}: expected one of "
                         f"{sorted(CONV_ROUTES)}")
    return CONV_ROUTES[backend]


def _check_norm(norm: str) -> str:
    if norm not in ("batch", "group", "none"):
        raise NotImplementedError(f"norm {norm!r}: the port has 'batch', "
                                  "'group' and 'none'")
    return norm


class Conv(nn.Module):
    """kxk conv with bias optional and the HWIO `kernel` [k, k, I, O] of
    flax.  Padding is internal: reflect by 1, or zero "same".  `backend`
    (a conv_backend selector) picks K3 or K8a for 3x3 stride 1 and K6 / K8
    for 4x4 stride 2, or the plain conv; a kernel's output gets the bias
    added in the activation dtype after it, as rnr_tpu does, except K3's
    and K8a's, which add it in f32 inside.  `halo`, when set
    (parallel/sharding.py::row_shards), extends a row shard by its sp
    neighbours' rows (ROW_HALO) before the conv, whose output rows that
    read its own padding are then dropped."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 dtype: torch.dtype | None = None, pad_mode: str = "reflect",
                 backend: str = "auto"):
        super().__init__()
        if pad_mode not in ("reflect", "same"):
            raise ValueError(f"pad_mode {pad_mode!r}")
        self.k, self.stride = kernel_size, stride
        self.dtype, self.pad_mode = dtype, pad_mode
        r3, r4, _ = conv_routes(backend)
        self.route = (r3 if (kernel_size, stride) == (3, 1)
                      else r4 if (kernel_size, stride) == (4, 2) else "plain")
        self.kernel = nn.Parameter(torch.zeros((kernel_size, kernel_size,
                                                in_ch, out_ch)))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.halo = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype)
        if self.halo is None:
            return self._conv(x)
        if (self.k, self.stride) not in ROW_HALO:
            raise NotImplementedError(f"a {self.k}x{self.k} stride "
                                      f"{self.stride} conv over row shards")
        k, crop = ROW_HALO[(self.k, self.stride)]
        return self._conv(self.halo(x, k, self.pad_mode))[:, crop:-crop]

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.route in ("k3", "slab"):
            b = self.bias if self.bias is not None else torch.zeros(
                self.kernel.shape[-1], device=x.device)
            op = conv3x3 if self.route == "k3" else conv3x3s
            return op(x, self.kernel, b, self.pad_mode)
        if self.route == "down4":
            y = down4(x, self.kernel, self.pad_mode)
        elif self.route == "down4s":
            y = down4s(x, self.kernel, self.pad_mode)
        else:
            xn = x.permute(0, 3, 1, 2)
            if self.pad_mode == "reflect":
                xn = reflect_pad1(xn)
            else:   # XLA "SAME": total pad (out-1)*s + k - in, low half first
                pads = []
                for size in (xn.shape[3], xn.shape[2]):
                    out = -(-size // self.stride)
                    tot = max((out - 1) * self.stride + self.k - size, 0)
                    pads += [tot // 2, tot - tot // 2]
                xn = F.pad(xn, pads)
            y = F.conv2d(xn, self.kernel.to(dt).permute(3, 2, 0, 1),
                         stride=self.stride).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ConvTranspose(nn.Module):
    """4x4 stride-2 "SAME" transpose conv with flax's HWIO `kernel`
    [4, 4, I, O]: jax.lax.conv_transpose(..., (2, 2), "SAME"), a
    correlation on the dilated input.  `backend` picks K6's convt4, K8's
    convt4s or the plain F.conv_transpose2d (with the kernel flipped, as
    [I, O, 4, 4], padding 1); the bias follows in the activation dtype.
    Over row shards (`halo` set) the input gains a row each side (zeros
    at the frame's edges) and the output drops 2 rows each side."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 dtype: torch.dtype | None = None, backend: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.route = conv_routes(backend)[2]
        self.kernel = nn.Parameter(torch.zeros((4, 4, in_ch, out_ch)))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.halo = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype)
        if self.halo is None:
            return self._conv(x)
        # a row of zeros at the frame's edges, as the dilated input's own
        return self._conv(self.halo(x, 1, "same"))[:, 2:-2]

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.route == "convt4":
            y = convt4(x, self.kernel)
        elif self.route == "convt4s":
            y = convt4s(x, self.kernel)
        else:
            k = self.kernel.to(dt).flip(0, 1).permute(2, 3, 0, 1)
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), k, stride=2,
                                   padding=1).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class BatchActNorm(nn.Module):
    """Affine normalisation by current-batch statistics over (N, H, W).
    `moments`, when set, gives (var, mean) of f32 activations in place of
    torch.var_mean: the global batch's under data parallelism."""

    def __init__(self, ch: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.moments = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if self.moments is not None:
            var, mean = self.moments(x32)
        else:
            var, mean = torch.var_mean(x32, dim=(0, 1, 2), keepdim=True,
                                       unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups=None, group_size=16): statistics per
    sample over (H, W) and each group of 16 channels, in f32, the variance
    as E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6; the output is f32 for
    any input, as flax promotes to the parameters' dtype.  `group_sum`,
    when set (parallel/sharding.py::row_shards), sums the per-sample sums
    and counts over the ranks that hold the sample's other rows."""

    epsilon = 1e-6

    def __init__(self, ch: int):
        super().__init__()
        if ch % GROUP_SIZE:
            raise ValueError(f"GroupNorm: {ch} channels are not a multiple "
                             f"of the group size {GROUP_SIZE}")
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.group_sum = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        x32 = x.to(torch.float32)
        xg = x32.reshape(n, -1, c // GROUP_SIZE, GROUP_SIZE)
        if self.group_sum is None:
            mean = xg.mean(dim=(1, 3))
            ex2 = (xg * xg).mean(dim=(1, 3))
        else:
            s1 = xg.sum(dim=(1, 3))
            s = self.group_sum(torch.stack([
                s1, (xg * xg).sum(dim=(1, 3)),
                torch.full_like(s1, xg.shape[1] * GROUP_SIZE)]))
            mean, ex2 = s[0] / s[2], s[1] / s[2]
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        mean = mean.repeat_interleave(GROUP_SIZE, dim=1)
        mul = torch.rsqrt(var + self.epsilon).repeat_interleave(
            GROUP_SIZE, dim=1) * self.scale
        shape = (n,) + (1,) * (x.ndim - 2) + (c,)
        return (x32 - mean.reshape(shape)) * mul.reshape(shape) + self.bias


def _add_norms(mod: nn.Module, norm: str, *chs: int, first: int = 0) -> None:
    """The module's norms in flax's creation order: BatchActNorm_i or
    GroupNorm_i for the i-th width from `first`, none for "none"."""
    for i, ch in enumerate(chs, first):
        if norm == "batch":
            setattr(mod, f"BatchActNorm_{i}", BatchActNorm(ch))
        elif norm == "group":
            setattr(mod, f"GroupNorm_{i}", GroupNorm(ch))


def _norm_act(mod: nn.Module, idx: int, x: torch.Tensor, act) -> torch.Tensor:
    norm = (getattr(mod, f"BatchActNorm_{idx}", None)
            or getattr(mod, f"GroupNorm_{idx}", None))
    if norm is not None:
        x = norm(x)
    return act(x)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _identity(x):
    return x


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax nn.Dropout in training: keep each value with probability 1 - p
    and scale the kept ones by 1 / (1 - p).  The mask is drawn from
    `generator` (on x's device), never from the global RNG."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class DownBlock(nn.Module):
    """[3x3 prep conv to middle_ch (in_ch when None), norm, LeakyReLU] +
    [kxk stride-s conv, norm, LeakyReLU]."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 stride: int = 2, kernel: int = 4,
                 dtype: torch.dtype | None = None, pad_mode: str = "reflect",
                 backend: str = "auto", middle_ch: int | None = None):
        super().__init__()
        use_bias = _check_norm(norm) == "none"
        mid = middle_ch or in_ch
        self.Conv_0 = Conv(in_ch, mid, 3, 1, use_bias, dtype, pad_mode,
                           backend)
        self.Conv_1 = Conv(mid, out_ch, kernel, stride, use_bias, dtype,
                           pad_mode, backend)
        _add_norms(self, norm, mid, out_ch)

    def forward(self, x, drop=_identity):
        x = drop(_norm_act(self, 0, self.Conv_0(x), _lrelu))
        return drop(_norm_act(self, 1, self.Conv_1(x), _lrelu))


class UpBlock(nn.Module):
    """4x4 stride-2 transpose conv + 3x3 post conv, each norm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 dtype: torch.dtype | None = None, pad_mode: str = "reflect",
                 backend: str = "auto"):
        super().__init__()
        use_bias = _check_norm(norm) == "none"
        self.ConvTranspose_0 = ConvTranspose(in_ch, out_ch, use_bias, dtype,
                                             backend)
        self.Conv_0 = Conv(out_ch, out_ch, 3, 1, use_bias, dtype, pad_mode,
                           backend)
        _add_norms(self, norm, out_ch, out_ch)

    def forward(self, x, drop=_identity):
        x = drop(_norm_act(self, 0, self.ConvTranspose_0(x), torch.relu))
        return drop(_norm_act(self, 1, self.Conv_0(x), torch.relu))


class GcnFuseBlock(nn.Module):
    """GCN fusion with the constant-map conv collapsed to a dense: a 3x3
    conv of h to the concat width plus Dense(v) broadcast over space,
    norm, LeakyReLU, then a 3x3 conv to out_ch, norm, LeakyReLU."""

    def __init__(self, h_ch: int, v_ch: int, out_ch: int,
                 norm: str = "batch", dtype: torch.dtype | None = None,
                 pad_mode: str = "reflect", backend: str = "auto"):
        super().__init__()
        use_bias = _check_norm(norm) == "none"
        mid = h_ch + v_ch
        self.dtype = dtype
        self.Conv_0 = Conv(h_ch, mid, 3, 1, use_bias, dtype, pad_mode,
                           backend)
        self.Dense_0 = nn.Linear(v_ch, mid, bias=False)
        self.Conv_1 = Conv(mid, out_ch, 3, 1, use_bias, dtype, pad_mode,
                           backend)
        _add_norms(self, norm, mid, out_ch)

    def forward(self, h, v, drop=_identity):
        dt = self.dtype or v.dtype
        proj = F.linear(v.to(dt), self.Dense_0.weight.to(dt))
        x = self.Conv_0(h) + proj[:, None, None, :]
        x = drop(_norm_act(self, 0, x, _lrelu))
        return drop(_norm_act(self, 1, self.Conv_1(x), _lrelu))


class Unet(nn.Module):
    """Skip-connected encoder/decoder with GCN fusion after level 0.
    Dropout (p DROPOUT_P) runs in training; `use_dropout` may be switched
    off on an instance (as rnr_tpu's Unet field), e.g. to compare two
    devices' gradients.  `conv_backend` routes every conv and `remat`
    picks the blocks recomputed in the backward (module docstring)."""

    def __init__(self, in_channels: int, out_channels: int, nf0: int = 64,
                 num_down: int = 5, max_channels: int = 512,
                 norm: str = "batch", outermost_linear: bool = True,
                 out_channels_gcn: int = 512, use_gcn: bool = True,
                 outermost_highway_mode: str = "concat",
                 compute_dtype: str = "float32", fuse_mode: str = "concat",
                 pad_mode: str = "reflect", conv_backend: str = "auto",
                 remat: bool | str = False):
        super().__init__()
        _check_norm(norm)
        self.remat = remat_mode(remat)
        conv_routes(conv_backend)
        if fuse_mode not in ("concat", "dense"):
            raise ValueError(f"fuse_mode {fuse_mode!r}")
        if outermost_highway_mode not in ("concat", "residual", "no_highway"):
            raise ValueError(f"outermost_highway_mode {outermost_highway_mode!r}")
        nd = num_down
        self.num_down, self.use_gcn, self.fuse_mode = nd, use_gcn, fuse_mode
        self.use_dropout = True
        self.outermost_linear = outermost_linear
        self.highway = outermost_highway_mode
        self.cdtype = cdt = getattr(torch, compute_dtype)
        chs = [nf0] + [min(2 ** (i + 1) * nf0, max_channels)
                       for i in range(nd - 1)]
        chs.append(min(2 ** (nd - 1) * nf0, max_channels))
        kw = dict(dtype=cdt, pad_mode=pad_mode, backend=conv_backend)

        self.Conv_0 = Conv(in_channels, nf0, 3, 1, norm == "none", **kw)
        _add_norms(self, norm, nf0)

        # flax numbers modules per class in creation order: the concat
        # fusion DownBlock is created right after level 0's
        self.down_names: list[str] = []
        created: list[tuple[str, int]] = []    # (block, level) in order
        n_down = 0
        for i in range(nd):
            level_norm = "none" if i == nd - 1 else norm
            name = f"DownBlock_{n_down}"
            setattr(self, name, DownBlock(chs[i], chs[i + 1], level_norm,
                                          **kw))
            self.down_names.append(name)
            created.append((name, i))
            n_down += 1
            if i == 0 and use_gcn:
                if fuse_mode == "dense":
                    self.GcnFuseBlock_0 = GcnFuseBlock(
                        chs[1], out_channels_gcn, chs[1], norm, **kw)
                    created.append(("GcnFuseBlock_0", 0))
                else:
                    self.fuse_name = f"DownBlock_{n_down}"
                    setattr(self, self.fuse_name, DownBlock(
                        chs[1] + out_channels_gcn, chs[1], norm, stride=1,
                        kernel=3, **kw))
                    created.append((self.fuse_name, 0))
                    n_down += 1

        # UpBlock_0 is the innermost level (created first, i = nd-1)
        for j, i in enumerate(reversed(range(nd))):
            level_norm = "none" if i == nd - 1 else norm
            in_ch = chs[nd] if i == nd - 1 else 2 * chs[i + 1]
            setattr(self, f"UpBlock_{j}", UpBlock(in_ch, chs[i], level_norm,
                                                  **kw))
            created.append((f"UpBlock_{j}", i))

        # rnr_tpu's names of the blocks (for convert.py): nn.remat makes a
        # class "Checkpoint<Block>", numbered apart from the plain one
        self.flax_names: dict[str, str] = {}
        count: dict[str, int] = {}
        for name, level in created:
            cls = name.rsplit("_", 1)[0]
            if self._remats(level):
                cls = "Checkpoint" + cls
            self.flax_names[name] = f"{cls}_{count.get(cls, 0)}"
            count[cls] = count.get(cls, 0) + 1

        out_in = 2 * chs[0] if outermost_highway_mode == "concat" else chs[0]
        self.Conv_1 = Conv(out_in, out_channels, 3, 1,
                           outermost_linear or norm == "none", **kw)
        if not outermost_linear:
            _add_norms(self, norm, out_channels, first=1)

    def _remats(self, level: int) -> bool:
        """Whether the blocks of `level` are recomputed in the backward."""
        return self.remat == "all" or (self.remat == "wide" and level <= 1)

    def forward(self, x: torch.Tensor, v_fea: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None):
        drop, drop_gen = _identity, None
        if train and self.use_dropout:
            if generator is None:
                raise ValueError("dropout in training needs a torch.Generator")
            drop = functools.partial(dropout, p=DROPOUT_P,
                                     generator=generator)
            drop_gen = generator

        def block(level: int, mod: nn.Module, *args):
            if torch.is_grad_enabled() and self._remats(level):
                return remat_call(mod, drop_gen, *args, drop)
            return mod(*args, drop)

        x = x.to(self.cdtype)
        if v_fea is not None:
            v_fea = v_fea.to(self.cdtype)
        h = drop(_norm_act(self, 0, self.Conv_0(x), _lrelu))
        skips = []
        for i, name in enumerate(self.down_names):
            skips.append(h)
            h = block(i, getattr(self, name), h)
            if i == 0 and self.use_gcn:
                if v_fea is None:
                    raise ValueError("use_gcn=True requires v_fea")
                if self.fuse_mode == "dense":
                    h = block(0, self.GcnFuseBlock_0, h, v_fea)
                else:
                    tiled = v_fea[:, None, None, :].expand(
                        h.shape[0], h.shape[1], h.shape[2], v_fea.shape[-1])
                    h = block(0, getattr(self, self.fuse_name),
                              torch.cat([h, tiled], dim=-1))
        for j, i in enumerate(reversed(range(self.num_down))):
            h = block(i, getattr(self, f"UpBlock_{j}"), h)
            mode = self.highway if i == 0 else "concat"
            if mode == "concat":
                h = torch.cat([skips[i], h], dim=-1)
            elif mode == "residual":
                h = skips[i] + h
        h = self.Conv_1(h)
        if not self.outermost_linear:
            h = drop(_norm_act(self, 1, h, torch.relu))
        return h


class RenderingNet(nn.Module):
    """U-Net + tanh head; `Unet_0` as in the flax tree, with dropout
    (rnr_tpu's RenderingNet forces use_dropout=True)."""

    def __init__(self, nf0: int, in_channels: int, out_channels: int,
                 num_down_unet: int = 5, out_channels_gcn: int = 512,
                 use_gcn: bool = True, outermost_highway_mode: str = "concat",
                 norm: str = "batch", compute_dtype: str = "float32",
                 fuse_mode: str = "concat", pad_mode: str = "reflect",
                 conv_backend: str = "auto", remat: bool | str = False):
        super().__init__()
        self.Unet_0 = Unet(
            in_channels, out_channels, nf0=nf0, num_down=num_down_unet,
            max_channels=8 * nf0, norm=norm, outermost_linear=True,
            out_channels_gcn=out_channels_gcn, use_gcn=use_gcn,
            outermost_highway_mode=outermost_highway_mode,
            compute_dtype=compute_dtype, fuse_mode=fuse_mode,
            pad_mode=pad_mode, conv_backend=conv_backend, remat=remat)

    def forward(self, x, v_fea=None, train: bool = False,
                generator: torch.Generator | None = None):
        return torch.tanh(self.Unet_0(x, v_fea, train, generator).to(
            torch.float32))
