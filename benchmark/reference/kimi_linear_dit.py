"""Plain reference of the Kimi-Linear-48B-A3B transformer denoiser, in
PyTorch ops only, float32 (TF32 off).

Written from the published model (https://huggingface.co/moonshotai/
Kimi-Linear-48B-A3B-Instruct, ``config.json``, ``model_type`` kimi_linear;
the layer equations of Kimi Linear, arXiv:2510.26692): the Moonlight
reference's blocks (pre-norm residual, RMSNorm, MLA without q-LoRA, a dense
SwiGLU in the first ``first_k_dense_replace`` layers, then DeepSeekMoE with
sigmoid scores, a correction bias, the top ``num_experts_per_tok``
renormalised and scaled, and the shared experts) and the same DiT
departures (patch embedding and head, two condition tokens first), with:

- the layers of ``linear_attn_config["kda_layers"]`` (numbered from 1)
  taking Kimi Delta Attention in place of MLA, causal in token order and
  written as its token-by-token recurrence: per head of width d,
  ``q, k, v = SiLU(causal depthwise conv(W·x))`` (taps summed in f32; q
  and k then L2-normalised, ``x·rsqrt(Σx² + 1e-6)``), ``g =
  −exp(A_log)·softplus(f_proj(x) + dt_bias)`` a key channel, ``β =
  sigmoid(b_proj(x))`` a head, ``S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t)
  S_{t−1} + β_t k_t v_tᵀ`` from S_0 = 0, ``o_t = S_tᵀ q_t / √d``; then a
  per-head RMSNorm times ``sigmoid(g_proj(x))`` and ``o_proj``;
- MLA without RoPE where ``mla_use_nope`` (the rope parts unrotated; the
  softmax scale stays 1/sqrt(nope + rope)); bidirectional, as in the
  Moonlight denoiser;
- the expert share of an expert-parallel layer (``ep_size`` cards, this one
  the ``ep_rank``-th): the router scores and chooses over every routed
  expert, and only the chosen copies of the experts held here
  (``first … first + held − 1``) are computed and summed; the shared
  experts are computed whole.

Precision as the configuration states it, as in the Moonlight reference;
in a KDA layer each projection's result is rounded to bf16, the
convolution's SiLU output is rounded once, and the L2 norms, g, β, the
recurrence with its state and the gated norm are f32, rounded once before
``o_proj``. Weights under the program's checkpoint names (the Moonlight
reference's, and ``layers.{i}.attn.{q,k,v}_proj.weight``,
``{q,k,v}_conv1d.weight`` (C, taps), ``f_proj.{0,1}.weight``,
``b_proj.weight``, ``A_log`` (heads,), ``dt_bias`` (heads·d,),
``g_proj.{0,1}.weight``, ``g_proj.1.bias``, ``o_norm.weight`` (d,),
``o_proj.weight``; ``mlp.w_gate_up`` and ``mlp.w_down`` hold the held
experts only). Nothing here imports the measured program or JAX.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.moonlight_dit import (  # noqa: F401  (ddim_chain runs either reference)
    COND_TOKENS,
    Reference,
    ddim_chain,
    sinusoid,
)

L2_EPS = 1e-6


class KimiReference(Reference):
    """The denoiser's forward pass (:meth:`Reference.forward`); ``conf``
    adds ``linear_attn_config``, ``mla_use_nope``, ``ep_size`` and
    ``ep_rank`` to Moonlight's keys."""

    def __init__(self, weights, conf, block_dims, device, bf16: bool = True):
        super().__init__(weights, conf, block_dims, device, bf16)
        lac = self.c.get("linear_attn_config") or {}
        self.kda_layers = {int(i) - 1 for i in lac.get("kda_layers", [])}
        experts = int(self.c["n_routed_experts"])
        self.held = experts // int(self.c.get("ep_size", 1))
        self.first = int(self.c.get("ep_rank", 0)) * self.held

    # -- MLA, with or without RoPE --------------------------------------
    def attention(self, a: torch.Tensor, i: int) -> torch.Tensor:
        if not self.c.get("mla_use_nope"):
            return super().attention(a, i)
        c = self.c
        b, s, _ = a.shape
        nh, nope, rope, vd = (int(c["num_attention_heads"]), int(c["qk_nope_head_dim"]),
                              int(c["qk_rope_head_dim"]), int(c["v_head_dim"]))
        rank = int(c["kv_lora_rank"])
        pre = f"layers.{i}.attn"
        q = self.linear(a, f"{pre}.q_proj").view(b, s, nh, nope + rope).transpose(1, 2).float()
        ckv = self.linear(a, f"{pre}.kv_a_proj_with_mqa")
        lat = self.rmsnorm(ckv[..., :rank], f"{pre}.kv_a_layernorm.weight")
        kv = self.linear(lat, f"{pre}.kv_b_proj").view(b, s, nh, nope + vd).transpose(1, 2)
        k_pe = ckv[..., rank:][:, None].expand(b, nh, s, rope)
        k = torch.cat([kv[..., :nope], k_pe], dim=-1).float()
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(nope + rope)
        o = self.r(torch.softmax(scores, dim=-1) @ kv[..., nope:].float())
        return self.linear(o.transpose(1, 2).reshape(b, s, nh * vd), f"{pre}.o_proj")

    # -- KDA ---------------------------------------------------------------
    def short_conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """SiLU of the causal depthwise convolution along the sequence, taps
        summed in f32 from the latest token back; rounded once."""
        w = self.p(name).float()
        taps = w.shape[1]
        xf = x.float()
        y = xf * w[:, taps - 1]
        for lag in range(1, min(taps, x.shape[1])):
            shifted = torch.zeros_like(xf)
            shifted[:, lag:] = xf[:, :-lag]
            y = y + shifted * w[:, taps - 1 - lag]
        return self.r(F.silu(y))

    @staticmethod
    def delta_rule(q, k, v, g, beta, scale: float) -> torch.Tensor:
        """o (B, L, H, Dv) of the gated delta rule, token by token, f32."""
        b, length, heads, dk = q.shape
        dv = v.shape[-1]

        def rows(x):  # (B, L, H, ...) -> (B·H, L, ...)
            return x.transpose(1, 2).reshape(b * heads, length, *x.shape[3:])

        q, k, v, alpha, beta = rows(q), rows(k), rows(v), rows(g.exp()), rows(beta)
        kb, vb = k * beta[..., None], v * beta[..., None]
        state = torch.zeros(b * heads, dk, dv, device=q.device)
        out = []
        for t in range(length):
            state.mul_(alpha[:, t, :, None])
            delta = vb[:, t, None, :] - torch.bmm(kb[:, t, None, :], state)
            state.baddbmm_(k[:, t, :, None], delta)
            out.append(torch.bmm(q[:, t, None, :], state))
        o = torch.cat(out, dim=1) * scale  # (B·H, L, Dv)
        return o.view(b, heads, length, dv).transpose(1, 2)

    def kda(self, a: torch.Tensor, i: int) -> torch.Tensor:
        lac = self.c["linear_attn_config"]
        heads, d = int(lac["num_heads"]), int(lac["head_dim"])
        b, s, _ = a.shape
        pre = f"layers.{i}.attn"

        def split(x):
            return x.float().view(b, s, heads, d)

        def unit(x):
            return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)

        q = unit(split(self.short_conv(self.linear(a, f"{pre}.q_proj"), f"{pre}.q_conv1d.weight")))
        k = unit(split(self.short_conv(self.linear(a, f"{pre}.k_proj"), f"{pre}.k_conv1d.weight")))
        v = split(self.short_conv(self.linear(a, f"{pre}.v_proj"), f"{pre}.v_conv1d.weight"))
        f = split(self.linear(self.linear(a, f"{pre}.f_proj.0"), f"{pre}.f_proj.1"))
        dt = f + self.p(f"{pre}.dt_bias").float().view(heads, d)
        g = -self.p(f"{pre}.A_log").float().exp()[:, None] * F.softplus(dt)
        beta = torch.sigmoid(self.linear(a, f"{pre}.b_proj").float())
        o = self.delta_rule(q, k, v, g, beta, 1.0 / math.sqrt(d))
        o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + float(self.c["rms_norm_eps"]))
        o = o * self.p(f"{pre}.o_norm.weight").float()
        gate = split(self.linear(self.linear(a, f"{pre}.g_proj.0"), f"{pre}.g_proj.1", True))
        o = self.r(o * torch.sigmoid(gate)).reshape(b, s, heads * d)
        return self.linear(o, f"{pre}.o_proj")

    # -- the expert share ----------------------------------------------
    def moe(self, m: torch.Tensor, i: int, route: Optional[torch.Tensor],
            scores_out: Optional[List[torch.Tensor]]) -> torch.Tensor:
        c = self.c
        pre = f"layers.{i}.mlp"
        k = int(c["num_experts_per_tok"])
        scores = torch.sigmoid(m.float() @ self.p(f"{pre}.gate.weight").float().T)
        biased = scores + self.p(f"{pre}.e_score_correction_bias").float()
        if scores_out is not None:
            scores_out.append(biased)
        choice = biased.topk(k, dim=1).indices if route is None else route.to(m.device).long()
        weight = scores.gather(1, choice)
        if c["norm_topk_prob"]:
            weight = weight / (weight.sum(dim=1, keepdim=True) + 1e-20)
        weight = weight * float(c["routed_scaling_factor"])
        w_gu, w_down = self.w[f"{pre}.w_gate_up"], self.w[f"{pre}.w_down"]
        out = torch.zeros(m.shape, device=m.device)
        for e in range(self.held):
            tok, slot = (choice == self.first + e).nonzero(as_tuple=True)
            if tok.numel():
                y = self.swiglu(m[tok], w_gu[e].to(self.device), w_down[e].to(self.device))
                out.index_add_(0, tok, weight[tok, slot][:, None] * y)
        return out + self.dense_swiglu(m, f"{pre}.shared")

    def _forward(self, x, t_norm, cond, routes, scores_out):
        c = self.c
        b = x.shape[0]
        t_tok = self.linear(F.silu(self.linear(sinusoid(t_norm, int(c["time_embed_dim"])),
                                               "time_fc1", True)), "time_fc2", True)
        c_tok = self.linear(F.silu(self.linear(cond, "cond_fc1", True)), "cond_fc2", True)
        h = torch.cat([t_tok[:, None], c_tok[:, None],
                       self.linear(self.patchify(x), "patch_embed", True)], dim=1).float()
        dense = int(c["first_k_dense_replace"])
        for i in range(int(c["num_hidden_layers"])):
            a = self.rmsnorm(h, f"layers.{i}.attn_norm.weight")
            h = h + (self.kda(a, i) if i in self.kda_layers else self.attention(a, i))
            m = self.rmsnorm(h, f"layers.{i}.ffn_norm.weight").reshape(b * self.seq_len, -1)
            if i < dense:
                y = self.dense_swiglu(m, f"layers.{i}.mlp")
            else:
                route = None if routes is None else routes[i - dense]
                y = self.moe(m, i, route, scores_out)
            h = h + y.view(b, self.seq_len, -1)
        out = self.linear(self.rmsnorm(h[:, COND_TOKENS:], "final_norm.weight"), "head", True)
        return self.unpatchify(out.float())

