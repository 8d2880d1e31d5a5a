"""Graph attention encoder over the gene-pathway graph.

Counterpart of osteosarcoma_diffusionmodel_tpu/models/gnn.py: a
multi-head GAT stack with ELU and dropout, global mean pooling (or a
per-graph mean over ``batch``) and a latent projection, under the Flax
module's submodule names (``input_proj``, ``gat_<i>.lin`` without a bias,
``gat_<i>.attn_src`` / ``attn_dst`` of shape (heads, features),
``output_proj``), so :mod:`..convert` carries its weights across. As in
the JAX package it is optional: no architecture wires it in.

Each destination node's softmax over its incoming edges takes the segment
max with ``scatter_reduce_(..., "amax", include_self=False)`` and the
segment sums with ``index_add_``, all in float32; the self-loops of
:func:`gene_pathway_edges` give every node an incoming edge. Dropout acts
in training mode only, as Flax's does outside ``deterministic``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def gene_pathway_edges(gene_pathway_matrix: np.ndarray) -> np.ndarray:
    """Build a bidirectional gene<->gene edge list: two genes are
    connected when they share a pathway (via the bipartite membership
    matrix). Returns (2, E) int32, self-loops included."""
    gp = np.asarray(gene_pathway_matrix) > 0
    adj = (gp @ gp.T) > 0
    np.fill_diagonal(adj, True)
    src, dst = np.nonzero(adj)
    return np.stack([src, dst]).astype(np.int32)


def _segment_sum(values: torch.Tensor, segments: torch.Tensor, n: int) -> torch.Tensor:
    return values.new_zeros((n,) + values.shape[1:]).index_add_(0, segments, values)


class GATLayer(nn.Module):
    """One multi-head graph attention layer (Velickovic et al. 2018)."""

    def __init__(self, in_features: int, features: int, heads: int = 4, concat: bool = True):
        super().__init__()
        self.features, self.heads, self.concat = features, heads, concat
        self.lin = nn.Linear(in_features, features * heads, bias=False)
        self.attn_src = nn.Parameter(torch.empty(heads, features))
        self.attn_dst = nn.Parameter(torch.empty(heads, features))
        self.flax_init(None)

    def flax_init(self, generator: Optional[torch.Generator]) -> None:
        """Flax's glorot_uniform for the (heads, features) attention
        vectors: U(±sqrt(6 / (heads + features)))."""
        bound = math.sqrt(6.0 / (self.heads + self.features))
        with torch.no_grad():
            for p in (self.attn_src, self.attn_dst):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def attention(self, wh: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """(E, H) softmax weights of each edge over its destination's
        incoming edges; ``wh`` is (N, H, F) float32."""
        n = wh.shape[0]
        alpha_src = torch.einsum("nhf,hf->nh", wh, self.attn_src.float())
        alpha_dst = torch.einsum("nhf,hf->nh", wh, self.attn_dst.float())
        logits = F.leaky_relu(alpha_src[src] + alpha_dst[dst], negative_slope=0.2)
        index = dst[:, None].expand_as(logits)
        logits_max = logits.new_zeros((n, self.heads)).scatter_reduce_(
            0, index, logits, "amax", include_self=False)[dst]
        unnorm = torch.exp(logits - logits_max)
        denom = _segment_sum(unnorm, dst, n)[dst]
        return unnorm / denom.clamp_min(1e-16)

    def forward(self, h: torch.Tensor, edge_index: torch.Tensor,
                dropout: float = 0.0) -> torch.Tensor:
        n = h.shape[0]
        src, dst = edge_index[0].long(), edge_index[1].long()
        wh = self.lin(h).reshape(n, self.heads, self.features).float()
        alpha = self.attention(wh, src, dst)
        if dropout > 0 and self.training:
            alpha = F.dropout(alpha, dropout, training=True)
        out = _segment_sum(wh[src] * alpha[..., None], dst, n)  # (N, H, F)
        if self.concat:
            return out.reshape(n, self.heads * self.features)
        return out.mean(dim=1)


class PathwayGraphEncoder(nn.Module):
    """GAT stack -> global mean pool -> latent projection."""

    def __init__(self, input_dim: int, hidden_dim: int, latent_dim: int, num_layers: int = 3,
                 heads: int = 4, dropout: float = 0.2):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        self.input_proj = nn.Linear(input_dim, hidden_dim)
        width = hidden_dim
        for i in range(num_layers):
            last = i == num_layers - 1
            layer = GATLayer(width, hidden_dim, heads=1 if last else heads, concat=not last)
            setattr(self, f"gat_{i}", layer)
            width = hidden_dim if last else hidden_dim * heads
        self.output_proj = nn.Linear(width, latent_dim)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                batch: Optional[torch.Tensor] = None, num_graphs: int = 1) -> torch.Tensor:
        """``x`` (N, input_dim), ``edge_index`` (2, E) src -> dst, ``batch``
        (N,) graph ids of ``num_graphs`` graphs or None for one graph.
        Returns (num_graphs, latent_dim) float32."""
        p = self.dropout if self.training else 0.0
        h = F.dropout(F.elu(self.input_proj(x.float())), p, self.training)
        for i in range(self.num_layers):
            h = getattr(self, f"gat_{i}")(h, edge_index, self.dropout)
            h = F.dropout(F.elu(h), p, self.training)
        if batch is not None:
            batch = batch.long()
            pooled = _segment_sum(h, batch, num_graphs)
            counts = _segment_sum(h.new_ones((h.shape[0], 1)), batch, num_graphs)
            pooled = pooled / counts.clamp_min(1.0)
        else:
            pooled = h.mean(dim=0, keepdim=True)
        return self.output_proj(pooled).float()
