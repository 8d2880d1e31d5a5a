"""Kimi Delta Attention (KDA), the linear-attention sublayer of Kimi
Linear's hybrid blocks (``model.transformer.linear_attn_config``;
Kimi Linear, arXiv:2510.26692; fla's ``KimiDeltaAttention`` and the
published ``modeling_kimi.py``).

Per head of width ``head_dim`` (d), token t, x the normed input:

- ``q, k, v = SiLU(causal depthwise conv(W·x))`` for each of ``q_proj``,
  ``k_proj``, ``v_proj`` (``short_conv_kernel_size`` taps, no bias); q and
  k L2-normalised (``x·rsqrt(Σx² + 1e-6)``);
- the decay ``g_t = −exp(A_log) · softplus(f_proj(x) + dt_bias)``, one
  value a key channel (``f_proj`` low rank: hidden -> d -> heads·d);
  ``β_t = sigmoid(b_proj(x))``, one value a head;
- the gated delta rule ``S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} +
  β_t k_t v_tᵀ`` from S_0 = 0 in token order, ``o_t = S_tᵀ q_t / √d``
  (``ops/kda.py``: the hand-written chunked kernel on the card);
- a per-head RMSNorm of o gated by ``sigmoid(g_proj(x))`` (low rank,
  hidden -> d -> heads·d with a bias), then ``o_proj``.

Precision with bfloat16 parameters: the projections take bf16 operands and
accumulate in f32, each result rounded to bf16; the convolution's taps
are summed in f32 and SiLU taken in f32 before one rounding; the L2
norms, g, β, the recurrence and its state, and the gated norm's
statistics in f32, rounded once before ``o_proj``. With float32 every
step is f32. The short convolutions and the gates run as PyTorch ops.

Counter ``kda.chunks``: sequences × heads × ⌈L / 64⌉ of every layer call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from ..ops import kda as kda_ops
from ..utils.profiling import COUNTERS
from .dit import Linear, RMSNorm, _param

L2_EPS = 1e-6  # fla's l2norm: x · rsqrt(Σx² + eps)
A_RANGE = (1.0, 16.0)  # A = exp(A_log) ~ U(1, 16) at the published initialisation
DT_RANGE = (1e-3, 1e-1)  # dt ~ logU(0.001, 0.1); dt_bias = softplus⁻¹(dt)


class ShortConv(nn.Module):
    """A causal depthwise convolution of ``size`` taps along the sequence,
    then SiLU: (B, S, C) -> (B, S, C) in the input's dtype, the taps summed
    in f32 (tap ``size − 1`` on token t, tap ``size − 1 − i`` on token
    t − i), SiLU in f32, rounded once. ``weight`` (C, size)."""

    def __init__(self, channels: int, size: int, dtype: torch.dtype):
        super().__init__()
        self.weight = _param(channels, size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        xf = x.float()
        size = w.shape[1]
        y = xf * w[:, size - 1]
        for i in range(1, min(size, x.shape[1])):
            y[:, i:] += xf[:, :-i] * w[:, size - 1 - i]
        return F.silu(y).to(x.dtype)


class KimiDeltaAttention(nn.Module):
    """The KDA sublayer: (B, S, hidden) normed input -> (B, S, hidden) in
    the parameters' dtype."""

    def __init__(self, tc: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        lac = tc.linear_attn_config
        h = tc.hidden_size
        heads, d = int(lac["num_heads"]), int(lac["head_dim"])
        size = int(lac["short_conv_kernel_size"])
        width = heads * d
        self.heads, self.head_dim = heads, d
        self.q_proj = Linear(h, width, dtype)
        self.k_proj = Linear(h, width, dtype)
        self.v_proj = Linear(h, width, dtype)
        self.q_conv1d = ShortConv(width, size, dtype)
        self.k_conv1d = ShortConv(width, size, dtype)
        self.v_conv1d = ShortConv(width, size, dtype)
        self.f_proj = nn.Sequential(Linear(h, d, dtype), Linear(d, width, dtype))
        self.b_proj = Linear(h, heads, dtype)
        self.A_log = _param(heads, dtype=torch.float32)
        self.dt_bias = _param(width, dtype=torch.float32)
        self.g_proj = nn.Sequential(Linear(h, d, dtype), Linear(d, width, dtype, bias=True))
        self.o_norm = RMSNorm(d, tc.rms_norm_eps, dtype)
        self.o_proj = Linear(width, h, dtype)
        self.scale = 1.0 / math.sqrt(d)

    @torch.no_grad()
    def init_decay(self, generator: torch.Generator) -> None:
        """The published initialisation of the decay and the convolutions:
        A_log = log U(1, 16) a head, dt_bias = softplus⁻¹(dt) with dt ~
        logU(0.001, 0.1) a channel (at least 1e-4), conv taps U(±1/√size)."""
        u = torch.rand(self.A_log.shape, generator=generator)
        self.A_log.copy_(torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u))
        lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
        dt = torch.exp(lo + (hi - lo) * torch.rand(self.dt_bias.shape, generator=generator))
        dt = dt.clamp_min(1e-4)
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        for conv in (self.q_conv1d, self.k_conv1d, self.v_conv1d):
            bound = conv.weight.shape[1] ** -0.5
            u = torch.rand(conv.weight.shape, generator=generator) * 2 - 1
            conv.weight.copy_((bound * u).to(conv.weight.dtype))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.float().unflatten(-1, (self.heads, self.head_dim))

    def forward(self, a: torch.Tensor, rope: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``rope`` is taken and ignored: KDA has no positions but its order."""
        b, s, _ = a.shape

        def unit(x: torch.Tensor) -> torch.Tensor:
            x = self._heads(x)
            return (x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)).contiguous()

        q = unit(self.q_conv1d(self.q_proj(a)))
        k = unit(self.k_conv1d(self.k_proj(a)))
        v = self._heads(self.v_conv1d(self.v_proj(a))).contiguous()
        dt = self._heads(self.f_proj(a)) + self.dt_bias.float().view(self.heads, self.head_dim)
        g = (-self.A_log.float().exp()[:, None] * F.softplus(dt)).contiguous()
        beta = self.b_proj(a).float().sigmoid().contiguous()
        o = kda_ops.kda_chunk(q, k, v, g, beta, self.scale)
        COUNTERS["kda.chunks"] += b * self.heads * -(-s // kda_ops.CHUNK)
        o = F.rms_norm(o, (self.head_dim,), self.o_norm.weight.float(), self.o_norm.eps)
        o = o * torch.sigmoid(self._heads(self.g_proj(a)))
        return self.o_proj(o.to(self.o_proj.weight.dtype).flatten(-2))
