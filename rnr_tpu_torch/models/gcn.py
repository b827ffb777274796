"""Dense deep GCN over mesh vertices (port of rnr_tpu/models/gcn.py).

A head EdgeConv on vertex positions, residual (or dense) dynamic EdgeConv
blocks whose kNN graphs are rebuilt from the current features with growing
dilation, a fusion layer to 1024 channels, a channel max per vertex and a
spectral-normalised MLP over the vertex axis -> one [1, out] feature.

Graphs: the head and the blocks below `strat_min_dilation` rank the full
distance matrix (`knn_graph`); the other blocks sample strata of the
stratified candidate set (K4, ops/knn_cuda.py).  In training with
`stochastic`, each block's pick is, with probability `epsilon`, k random
columns instead of the strided ones (one coin and one permutation per
block and step, drawn from the caller's torch.Generator); graphs take
detached features, as rnr_tpu's stop_gradient does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rnr_tpu_torch.ops.knn_cuda import stratified_knn


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    """rnr_tpu's GCNConfig (ApproxTopK's recall has no counterpart in an
    exact sort); `num_v` sizes the first SNDense."""

    in_channels: int = 6
    n_filters: int = 64
    kernel_size: int = 16
    n_blocks: int = 20
    conv_type: str = "edge"
    block_type: str = "res"
    act_type: str = "relu"
    norm_type: str | None = None
    use_bias: bool = True
    stochastic: bool = True
    epsilon: float = 0.2
    num_v: int = 7500
    out_channels: int = 512
    knn_approx: bool = True
    compute_dtype: str = "float32"
    graph_refresh_every: int = 1
    strat_min_dilation: int = 3
    stratum_width: int = 16


def _topk_lowest_index(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest per row; ties go to the lower index, as in
    jax.lax.top_k."""
    order = torch.sort(score.to(torch.float32), dim=-1, descending=True,
                       stable=True).indices
    return order[:, :k].to(torch.int32)


def pairwise_distance(x: torch.Tensor, approx: bool = False) -> torch.Tensor:
    """[V, C] -> [V, V] squared distances, as rnr_tpu's knn_graph forms them.

    approx=True is bf16 end to end: bf16 features, bf16 squared norms, a
    bf16 inner-product matrix, and (sq + sq^T) - 2 inner with each op
    rounded to bf16 (rnr_tpu runs these ops one by one, unfused).
    """
    if approx:
        xb = x.to(torch.bfloat16)
        sq = torch.sum(xb * xb, dim=-1, keepdim=True)
        return (sq + sq.T) - 2.0 * (xb @ xb.T)
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return sq + sq.T - 2.0 * (x @ x.T)


def knn_graph(x: torch.Tensor, k: int, approx: bool = False) -> torch.Tensor:
    """[V, C] -> [V, k] int32 nearest neighbours, self included.  bf16
    distances (approx=True) tie often; ties go to the lower index."""
    return _topk_lowest_index(-pairwise_distance(x.detach(), approx), k)


def draw_pick(n_cols: int, k: int, epsilon: float,
              generator: torch.Generator):
    """One block's random pick: (use_random, a bool scalar tensor that is
    True with probability epsilon; the first k of a random permutation of
    n_cols).  Both stay on the generator's device: no host sync."""
    dev = generator.device
    coin = torch.rand((), generator=generator, device=dev) < epsilon
    perm = torch.randperm(n_cols, generator=generator, device=dev)[:k]
    return coin, perm


def _pick(cols: torch.Tensor, strided: torch.Tensor, pick) -> torch.Tensor:
    if pick is None:
        return strided
    use_random, perm = pick
    return torch.where(use_random, cols[:, perm.to(cols.device)], strided)


def sample_strata(strat: torch.Tensor, k: int, phase_seed: int,
                  pick=None) -> torch.Tensor:
    """A phase-strided subset of k strata, or, where `pick` (from
    draw_pick over the strata) says so, its k random strata."""
    ns = strat.shape[1]
    stride = max(ns // k, 1)
    phase = (phase_seed * 7) % stride
    return _pick(strat, strat[:, phase::stride][:, :k], pick)


def dilate_edges(idx: torch.Tensor, k: int, dilation: int,
                 pick=None) -> torch.Tensor:
    """Every `dilation`-th of the k*dilation nearest, or, where `pick`
    (from draw_pick over the k*dilation columns) says so, its k random
    columns."""
    return _pick(idx, idx[:, ::dilation][:, :k], pick)


class _Act(nn.Module):
    """relu / leakyrelu(0.2) / prelu with one learned slope."""

    def __init__(self, act_type: str = "relu"):
        super().__init__()
        if act_type not in ("relu", "leakyrelu", "prelu"):
            raise ValueError(f"act_type {act_type!r}")
        self.act_type = act_type
        if act_type == "prelu":
            self.prelu_slope = nn.Parameter(torch.tensor(0.2))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.act_type == "relu":
            return torch.relu(h)
        if self.act_type == "leakyrelu":
            return torch.nn.functional.leaky_relu(h, 0.2)
        return torch.where(h >= 0, h, h * self.prelu_slope.to(h.dtype))


class EdgeConv(nn.Module):
    """max_j MLP([x_i || x_j - x_i]) ("edge") or MLP([x_i || max_j(x_j -
    x_i)]) ("mr"); the MLP is Dense -> activation -> optional norm."""

    def __init__(self, in_ch: int, out_ch: int, conv_type: str = "edge",
                 act_type: str = "relu", norm_type: str | None = None,
                 use_bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        if conv_type not in ("edge", "mr"):
            raise ValueError(f"conv_type {conv_type!r}")
        self.conv_type = conv_type
        self.norm_type = None if norm_type in (None, "none") else norm_type
        if self.norm_type not in (None, "batch", "instance"):
            raise ValueError(f"norm_type {norm_type!r}")
        self.dtype = dtype
        self.Dense_0 = nn.Linear(2 * in_ch, out_ch, bias=use_bias)
        self._Act_0 = _Act(act_type)
        if self.norm_type == "batch":
            self.norm_scale = nn.Parameter(torch.ones(out_ch))
            self.norm_bias = nn.Parameter(torch.zeros(out_ch))

    def _dense(self, feat: torch.Tensor) -> torch.Tensor:
        d = self.Dense_0
        dt = self.dtype or feat.dtype
        b = d.bias.to(dt) if d.bias is not None else None
        return torch.nn.functional.linear(feat.to(dt), d.weight.to(dt), b)

    def _norm(self, h: torch.Tensor) -> torch.Tensor:
        if self.norm_type is None:
            return h
        axes = tuple(range(h.ndim - 1))
        h32 = h.to(torch.float32)
        var, mean = torch.var_mean(h32, dim=axes, keepdim=True,
                                   unbiased=False)
        y = (h32 - mean) * torch.rsqrt(var + 1e-5)
        if self.norm_type == "batch":
            y = y * self.norm_scale + self.norm_bias
        return y.to(h.dtype)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x_j = x[idx.long()]                 # [V, k, C]
        x_i = x[:, None, :]
        if self.conv_type == "edge":
            feat = torch.cat([x_i.expand_as(x_j), x_j - x_i], dim=-1)
            h = self._norm(self._Act_0(self._dense(feat)))
            return torch.amax(h, dim=1)
        rel = torch.amax(x_j - x_i, dim=1)
        feat = torch.cat([x, rel], dim=-1)
        return self._norm(self._Act_0(self._dense(feat)))


class SNDense(nn.Module):
    """Dense layer with spectral weight normalisation.  `kernel` [in, out]
    keeps the JAX layout; `u` is the stored power-iteration vector.  Each
    call runs one power iteration from `u` with no gradient through u and
    v (rnr_tpu stops it there); with train=True the new u is written
    back, as flax's `spectral` collection is."""

    def __init__(self, in_features: int, features: int, power_iters: int = 1):
        super().__init__()
        self.power_iters = power_iters
        self.kernel = nn.Parameter(torch.zeros((in_features, features)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.zeros(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w = self.kernel
        with torch.no_grad():
            u = self.u
            v = None
            for _ in range(self.power_iters):
                v = w @ u
                v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
                u = v @ w
                u = u / torch.clamp(torch.linalg.norm(u), min=1e-12)
            if train:
                self.u.copy_(u)
        sigma = torch.einsum("i,ij,j->", v, w, u)
        return x @ (w / sigma) + self.bias


class DenseDeepGCN(nn.Module):
    """Vertex GCN -> one global feature vector [1, out_channels]."""

    def __init__(self, cfg: GCNConfig = GCNConfig()):
        super().__init__()
        self.cfg = cfg
        cdt = getattr(torch, cfg.compute_dtype)
        kw = dict(conv_type=cfg.conv_type, act_type=cfg.act_type,
                  norm_type=cfg.norm_type, use_bias=cfg.use_bias, dtype=cdt)
        nf = cfg.n_filters
        self.EdgeConv_0 = EdgeConv(cfg.in_channels, nf, **kw)
        width = nf
        widths = [nf]
        for i in range(cfg.n_blocks - 1):
            setattr(self, f"EdgeConv_{i + 1}", EdgeConv(width, nf, **kw))
            if cfg.block_type == "dense":
                width += nf
            elif cfg.block_type != "res":
                raise ValueError(f"block_type {cfg.block_type!r}")
            widths.append(width)
        self.Dense_0 = nn.Linear(sum(widths), 1024, bias=cfg.use_bias)
        self._Act_0 = _Act(cfg.act_type)
        self.SNDense_0 = SNDense(cfg.num_v, 2048)
        self.SNDense_1 = SNDense(2048, cfg.out_channels)

    def forward(self, pos: torch.Tensor, x: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        stochastic = train and cfg.stochastic
        if stochastic and generator is None:
            raise ValueError("stochastic GCN training needs a torch.Generator")
        if x is None:
            x = pos
        data = torch.cat([pos, x], dim=-1)
        if data.shape[-1] != cfg.in_channels:
            raise ValueError(f"GCN input has {data.shape[-1]} channels, "
                             f"in_channels={cfg.in_channels}")
        k = cfg.kernel_size
        feats = [self.EdgeConv_0(data, knn_graph(pos, k, cfg.knn_approx))]

        idx_cache = None
        strat_cache = None
        strat_possible = (cfg.strat_min_dilation > 0
                          and pos.shape[0] >= k * cfg.stratum_width)
        for i in range(cfg.n_blocks - 1):
            dilation = 1 + i
            h = feats[-1]
            if strat_possible and dilation >= cfg.strat_min_dilation:
                if strat_cache is None or i % cfg.graph_refresh_every == 0:
                    strat_cache = stratified_knn(h.to(torch.float32),
                                                 cfg.stratum_width)
                pick = (draw_pick(strat_cache.shape[1], k, cfg.epsilon,
                                  generator) if stochastic else None)
                idx = sample_strata(strat_cache, k, i, pick)
            else:
                if idx_cache is None or i % cfg.graph_refresh_every == 0:
                    # one window for every windowed block until the next
                    # refresh
                    last = min(i + cfg.graph_refresh_every - 1,
                               cfg.n_blocks - 2)
                    if strat_possible:
                        last = min(last, cfg.strat_min_dilation - 2)
                    idx_cache = knn_graph(h.to(torch.float32),
                                          k * (1 + last), cfg.knn_approx)
                pick = (draw_pick(k * dilation, k, cfg.epsilon, generator)
                        if stochastic and dilation > 1 else None)
                idx = dilate_edges(idx_cache[:, :k * dilation], k, dilation,
                                   pick)
            conv = getattr(self, f"EdgeConv_{i + 1}")
            if cfg.block_type == "res":
                feats.append(conv(h, idx) + h)
            else:
                feats.append(torch.cat([h, conv(h, idx)], dim=-1))

        fused = torch.cat(feats, dim=-1).to(torch.float32)
        fused = self._Act_0(self.Dense_0(fused))
        per_vertex = torch.amax(fused, dim=-1)
        h = self.SNDense_0(per_vertex[None, :], train)
        return self.SNDense_1(h, train)
