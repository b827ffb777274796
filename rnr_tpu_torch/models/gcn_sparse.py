"""Edge-list ("sparse") graph convolutions (port of
rnr_tpu/models/gcn_sparse.py, which no driver uses): EdgeConv and
MRConv over a COO edge list [2, E] (source = neighbour, target =
centre), their per-centre max a scatter-max over the targets (a centre
with no edge gets -inf, as jax.ops.segment_max), and a residual
dynamic block over recomputed kNN edges.  Submodules carry the flax
names (`Dense_0`, `SparseEdgeConv_0`, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from rnr_tpu_torch.models.gcn import knn_graph


def knn_edges(x: torch.Tensor, k: int) -> torch.Tensor:
    """[2, V k] (neighbour, centre) pairs of the exact kNN graph of x
    [V, C], in the dense graph's order."""
    v = x.shape[0]
    nbr = knn_graph(x, k).long()
    center = torch.arange(v, device=x.device)[:, None].expand(v, k)
    return torch.stack([nbr.reshape(-1), center.reshape(-1)])


def segment_max(data: torch.Tensor, seg: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Row-wise max of data [E, C] per segment id seg [E] -> [n, C]."""
    out = torch.full((n, data.shape[-1]), float("-inf"), dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(data), data, "amax",
                              include_self=True)


class SparseEdgeConv(nn.Module):
    """max over j of relu(Dense([x_i || x_j - x_i]))."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Dense_0 = nn.Linear(2 * in_ch, out_ch)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor):
        src, dst = edge_index[0], edge_index[1]
        x_i, x_j = x[dst], x[src]
        h = torch.relu(self.Dense_0(torch.cat([x_i, x_j - x_i], dim=-1)))
        return segment_max(h, dst, x.shape[0])


class SparseMRConv(nn.Module):
    """relu(Dense([x_i || max over j of (x_j - x_i)]))."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Dense_0 = nn.Linear(2 * in_ch, out_ch)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor):
        src, dst = edge_index[0], edge_index[1]
        rel = segment_max(x[src] - x[dst], dst, x.shape[0])
        return torch.relu(self.Dense_0(torch.cat([x, rel], dim=-1)))


class SparseResDynBlock(nn.Module):
    """x + conv(x, kNN edges of x), the conv "edge" or "mr"."""

    def __init__(self, channels: int, kernel_size: int = 9,
                 conv_type: str = "edge"):
        super().__init__()
        self.k = kernel_size
        convs = {"edge": SparseEdgeConv, "mr": SparseMRConv}
        if conv_type not in convs:
            raise ValueError(f"conv_type {conv_type!r}")
        self.conv_name = f"{convs[conv_type].__name__}_0"
        setattr(self, self.conv_name, convs[conv_type](channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, self.conv_name)
        return conv(x, knn_edges(x, self.k)) + x
