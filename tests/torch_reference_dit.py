"""Plain reference of the Moonlight-16B-A3B transformer denoiser and of its
DDIM chain, in PyTorch ops only, float32.

Written from the published model (https://huggingface.co/moonshotai/
Moonlight-16B-A3B, ``config.json``, ``model_type`` deepseek_v3: pre-norm
residual blocks with RMSNorm; MLA attention without q-LoRA, RoPE on the
rope parts with the rope key shared by every head, softmax scale
1/sqrt(qk_nope + qk_rope); a dense SwiGLU in the first
``first_k_dense_replace`` layers, then DeepSeekMoE: sigmoid scores, the
top ``num_experts_per_tok`` of scores + ``e_score_correction_bias``
(``noaux_tc``, one group), the chosen scores normalised and scaled by
``routed_scaling_factor``, plus the shared experts as one SwiGLU) with
these departures, DiT-style (arXiv:2212.09748):

- a patch embedding (``patch_size`` -> hidden, with bias) and a patch head
  (RMSNorm, hidden -> ``patch_size``, with bias) replace the vocabulary and
  the LM head; each feature block of the patient vector (mutations,
  expression, pathways) is cut into patches, zero-padded at its end;
- two condition tokens first: the timestep's ``time_embed_dim``-wide
  sinusoid through Linear -> SiLU -> Linear, the clinical conditions
  through Linear -> SiLU -> Linear; RoPE positions 0-1, the patches from 2;
- bidirectional attention (no causal mask).

Precision as the configuration states it: with ``bf16`` every product's
operands are rounded to bfloat16 and the product is the float32 sum of
their exact products (TF32 off); a product's result is rounded to bfloat16
except the routed experts' gate-up products (SiLU(gate)·up taken of the
float32 sums, then rounded) and down products (summed with their routing
weights in float32); the dense and shared SwiGLUs round SiLU(gate) and
its product with up, each; RMSNorm statistics, router scores and the softmax are float32,
the residual stream and the DDIM carry float32. Without ``bf16`` nothing is
rounded.

The experts run one at a time over the tokens that chose them. The
routing can be given (``routes``: one (N, k) tensor of expert ids per
routed layer) instead of chosen here; ``scores_out`` then receives each
routed layer's own biased scores, so that a given choice can be judged
against them (:func:`route_gaps`).

Weights come as a dict of tensors under the program's checkpoint names:
``patch_embed.weight`` (H, P), ``layers.{i}.attn.q_proj.weight`` (out,
in), ``layers.{i}.mlp.w_gate_up`` (E, H, 2I) [gate | up] (the transposes
of ``gate_proj`` and ``up_proj``), ``layers.{i}.mlp.w_down`` (E, I, H),
``layers.{i}.mlp.shared.gate_up.weight`` (2·n_shared_experts·I, H)
[gate | up] and ``layers.{i}.mlp.shared.down.weight`` (H,
n_shared_experts·I), the dense layers' ``layers.{i}.mlp.gate_up.weight``
and ``layers.{i}.mlp.down.weight`` likewise at ``intermediate_size``,
``layers.{i}.mlp.gate.weight`` (E, H),
``layers.{i}.mlp.e_score_correction_bias`` (E,). Nothing here imports the
measured program or JAX.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

COND_TOKENS = 2


def _betas_cosine(num_steps: int) -> np.ndarray:
    s = np.arange(num_steps + 1, dtype=np.float64) / num_steps
    acp = np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2
    acp = acp / acp[0]
    return np.clip(1.0 - acp[1:] / acp[:-1], 0.0001, 0.9999)


def _betas(schedule: str, num_steps: int) -> np.ndarray:
    if schedule == "cosine":
        return _betas_cosine(num_steps)
    if schedule == "linear":
        return np.linspace(1e-4, 0.02, num_steps, dtype=np.float64)
    if schedule == "sigmoid":
        x = np.linspace(-6.0, 6.0, num_steps, dtype=np.float64)
        return 1.0 / (1.0 + np.exp(-x)) * (0.02 - 1e-4) + 1e-4
    raise ValueError(f"unknown schedule {schedule!r}")


def ddim_rows(schedule: str, num_steps: int, ddim_steps: int):
    """(t_norm (n,), rows (n, 4)) of the eta = 0 DDIM over ``ddim_steps``
    strided timesteps, latest first: sqrt(acp_t), sqrt(1 - acp_t),
    sqrt(acp_prev), sqrt(1 - acp_prev), in float32 from float32 acp."""
    n = min(ddim_steps, num_steps)
    ts = np.unique((np.arange(n) * (num_steps / n)).round().astype(np.int64))[::-1].copy()
    prev = np.concatenate([ts[1:], [-1]])
    acp = np.cumprod(1.0 - _betas(schedule, num_steps)).astype(np.float32)
    one = np.float32(1.0)
    acp_t = acp[ts]
    acp_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], one)
    rows = np.stack([np.sqrt(acp_t), np.sqrt(one - acp_t), np.sqrt(acp_prev),
                     np.sqrt(np.maximum(one - acp_prev, np.float32(0.0)))], axis=1)
    return ts.astype(np.float32) / np.float32(num_steps), rows.astype(np.float32)


def sinusoid(t_norm: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin | cos] of t_norm times dim/2 log-spaced frequencies, float32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t_norm.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t_norm.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def route_gaps(biased: torch.Tensor, choice: torch.Tensor, top_k: int) -> torch.Tensor:
    """Per token, how far a given choice (N, k') of experts stands from the
    top ``top_k`` of the reference's own biased scores (N, E): the largest
    of s_k - b_c over chosen experts c outside the reference's top k, and
    of b_r - s_(k+1) over the reference's top-k experts r left out (s_j the
    j-th largest score). 0 where the two sets agree; a near tie flipped by
    rounding reads the width of the tie."""
    n, e = biased.shape
    top = biased.topk(min(top_k + 1, e), dim=1).values
    s_k = top[:, top_k - 1]
    s_next = top[:, top_k] if e > top_k else torch.full_like(s_k, -math.inf)
    chosen = torch.zeros(n, e, dtype=torch.bool, device=biased.device)
    chosen.scatter_(1, choice.long(), True)
    ref = torch.zeros_like(chosen)
    ref.scatter_(1, biased.topk(top_k, dim=1).indices, True)
    extra = torch.where(chosen & ~ref, s_k[:, None] - biased, torch.zeros_like(biased))
    missing = torch.where(ref & ~chosen, biased - s_next[:, None], torch.zeros_like(biased))
    return torch.maximum(extra.amax(dim=1), missing.amax(dim=1)).clamp_min(0.0)


class Reference:
    """The denoiser's forward pass. ``conf``: the configuration's
    transformer keys (Moonlight's names, ``patch_size``,
    ``time_embed_dim``); ``block_dims``: the feature blocks' widths."""

    def __init__(self, weights: Mapping[str, torch.Tensor], conf: Mapping, block_dims: Sequence[int],
                 device, bf16: bool = True):
        self.w = weights
        self.c = dict(conf)
        self.block_dims = [int(d) for d in block_dims]
        self.device = torch.device(device)
        self.bf16 = bf16
        p = int(self.c["patch_size"])
        self.patches = [-(-d // p) for d in self.block_dims]
        self.seq_len = COND_TOKENS + sum(self.patches)

    # -- precision -----------------------------------------------------
    def r(self, x: torch.Tensor) -> torch.Tensor:
        """Rounded to bf16 where the configuration states bf16 (a bf16
        tensor, which marks the rounding done), else float32."""
        return x.to(torch.bfloat16) if self.bf16 else x.float()

    def p(self, name: str) -> torch.Tensor:
        """Weight ``name`` on the device, in its own dtype."""
        return self.w[name].to(self.device)

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (.., K) times w (K, N): bf16 operands, f32 sums."""
        return self.r(a).float() @ self.r(w).float()

    def linear(self, a: torch.Tensor, name: str, bias: bool = False) -> torch.Tensor:
        """x·Wᵀ (+ b) of the (out, in) weight ``name``; result rounded."""
        y = self.mm(a, self.p(f"{name}.weight").T)
        if bias:
            y = y + self.p(f"{name}.bias").float()
        return self.r(y)

    def rmsnorm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = x.float()
        y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + float(self.c["rms_norm_eps"]))
        return self.r(y * self.p(name).float())

    def swiglu(self, x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
        """One routed SwiGLU expert: bf16(SiLU(x·W_g)·(x·W_u)) · W_down, f32
        result."""
        inter = w_gate_up.shape[1] // 2
        gu = self.mm(x, w_gate_up)
        h = self.r(F.silu(gu[:, :inter]) * gu[:, inter:])
        return self.mm(h, w_down)

    def dense_swiglu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """A dense SwiGLU ``name`` (the shared experts, a dense layer): each
        product's result rounded as :meth:`linear`'s, SiLU(gate) rounded,
        its product with up rounded; f32 result."""
        gu = self.linear(x, f"{name}.gate_up").float()
        inter = gu.shape[1] // 2
        h = self.r(self.r(F.silu(gu[:, :inter])).float() * gu[:, inter:])
        return self.linear(h, f"{name}.down").float()

    # -- the model -----------------------------------------------------
    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """Pairs (x[2i], x[2i+1]) of the last axis rotated by p·theta^(-2i/d),
        positions on the second-to-last axis; result rounded."""
        d = x.shape[-1]
        inv = float(self.c["rope_theta"]) ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
        ang = torch.arange(x.shape[-2], dtype=torch.float64)[:, None] * inv[None, :]
        cos, sin = ang.cos().float().to(x.device), ang.sin().float().to(x.device)
        x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
        return self.r(torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).flatten(-2))

    def attention(self, a: torch.Tensor, i: int) -> torch.Tensor:
        c = self.c
        b, s, _ = a.shape
        nh, nope, rope, vd = (int(c["num_attention_heads"]), int(c["qk_nope_head_dim"]),
                              int(c["qk_rope_head_dim"]), int(c["v_head_dim"]))
        rank = int(c["kv_lora_rank"])
        pre = f"layers.{i}.attn"
        q = self.linear(a, f"{pre}.q_proj").view(b, s, nh, nope + rope).transpose(1, 2)
        ckv = self.linear(a, f"{pre}.kv_a_proj_with_mqa")
        lat = self.rmsnorm(ckv[..., :rank], f"{pre}.kv_a_layernorm.weight")
        kv = self.linear(lat, f"{pre}.kv_b_proj").view(b, s, nh, nope + vd).transpose(1, 2)
        q = torch.cat([q[..., :nope], self.rope(q[..., nope:])], dim=-1).float()
        k_pe = self.rope(ckv[..., rank:][:, None]).expand(b, nh, s, rope)
        k = torch.cat([kv[..., :nope], k_pe], dim=-1).float()
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(nope + rope)
        o = self.r(torch.softmax(scores, dim=-1) @ kv[..., nope:].float())
        return self.linear(o.transpose(1, 2).reshape(b, s, nh * vd), f"{pre}.o_proj")

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
        # The token copies grouped by expert (one read of the counts a layer).
        order = torch.argsort(choice.reshape(-1), stable=True)
        counts = torch.bincount(choice.reshape(-1), minlength=w_gu.shape[0]).tolist()
        tokens, weights = order // choice.shape[1], weight.reshape(-1)[order]
        at = 0
        for e, n in enumerate(counts):
            if n:
                tok = tokens[at:at + n]
                y = self.swiglu(m[tok], w_gu[e].to(self.device), w_down[e].to(self.device))
                out.index_add_(0, tok, weights[at:at + n, None] * y)
            at += n
        return out + self.dense_swiglu(m, f"{pre}.shared")

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        p = int(self.c["patch_size"])
        parts, at = [], 0
        for d, n in zip(self.block_dims, self.patches):
            blk = torch.zeros(x.shape[0], n * p, device=x.device)
            blk[:, :d] = x[:, at:at + d]
            parts.append(blk.view(x.shape[0], n, p))
            at += d
        return torch.cat(parts, dim=1)

    def unpatchify(self, y: torch.Tensor) -> torch.Tensor:
        p = int(self.c["patch_size"])
        parts, at = [], 0
        for d, n in zip(self.block_dims, self.patches):
            parts.append(y[:, at:at + n].reshape(y.shape[0], n * p)[:, :d])
            at += n
        return torch.cat(parts, dim=1)

    def forward(self, x: torch.Tensor, t_norm: torch.Tensor, conditions: torch.Tensor,
                routes: Optional[Sequence[torch.Tensor]] = None,
                scores_out: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The x0 prediction (R, D) f32 of x (R, D) at t_norm (R,) under
        conditions (R, C). ``routes``: the routed layers' expert ids, each
        (R·seq_len, k), tokens row-major (patient, position). Autograd
        follows the weights where they require it."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._forward(x.to(self.device).float(), t_norm.to(self.device).float(),
                                 conditions.to(self.device).float(), routes, scores_out)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

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
            h = h + self.attention(self.rmsnorm(h, f"layers.{i}.attn_norm.weight"), i)
            m = self.rmsnorm(h, f"layers.{i}.ffn_norm.weight").reshape(b * self.seq_len, -1)
            if i < dense:
                y = self.dense_swiglu(m, f"layers.{i}.mlp")
            else:
                route = None if routes is None else routes[i - dense]
                y = self.moe(m, i, route, scores_out)
            h = h + y.view(b, self.seq_len, -1)
        out = self.linear(self.rmsnorm(h[:, COND_TOKENS:], "final_norm.weight"), "head", True)
        return self.unpatchify(out.float())


@torch.no_grad()
def ddim_chain(ref: Reference, x_init: torch.Tensor, conditions: torch.Tensor, *, schedule: str,
               num_steps: int, ddim_steps: int, clip: float,
               routes: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> torch.Tensor:
    """The eta = 0 DDIM chain from ``x_init`` (R, D) under ``conditions``:
    x0 = clip(prediction), eps = (x - sqrt(acp_t)·x0) / sqrt(1 - acp_t),
    x <- sqrt(acp_prev)·x0 + sqrt(1 - acp_prev)·eps, float32 carry.
    ``routes[s]``: step s's routing (as :meth:`Reference.forward` takes)."""
    t_norm, rows = ddim_rows(schedule, num_steps, ddim_steps)
    x = x_init.to(ref.device).float()
    for s in range(len(t_norm)):
        sa, so, sap, dcoef = (float(v) for v in rows[s])
        t = torch.full((x.shape[0],), float(t_norm[s]), device=ref.device)
        pred = ref.forward(x, t, conditions, None if routes is None else routes[s])
        x0 = torch.clamp(pred, -clip, clip)
        eps = (x - sa * x0) / max(so, 1e-8)
        x = sap * x0 + dcoef * eps
    return x
