"""Moonlight-16B-A3B's transformer as the denoiser of the x0-parameterised
diffusion model (``model.denoiser: moonlight_dit``).

The language model (https://huggingface.co/moonshotai/Moonlight-16B-A3B,
``model_type`` deepseek_v3) is used block for block at the widths of
``model.transformer`` (Moonlight's ``config.json`` keys): pre-norm residual
blocks with RMSNorm; MLA attention without q-LoRA (``q_proj``, the
``kv_a_proj_with_mqa`` latent with its RMSNorm, ``kv_b_proj``, RoPE on the
rope parts, the rope key shared by every head, softmax scale
1/sqrt(nope + rope), ``o_proj``); a dense SwiGLU in the first
``first_k_dense_replace`` layers, DeepSeekMoE after them: sigmoid scores,
the top ``num_experts_per_tok`` of scores + ``e_score_correction_bias``
(``noaux_tc`` with one group), the chosen scores normalised and scaled by
``routed_scaling_factor``, plus ``n_shared_experts`` shared experts as one
SwiGLU of that many expert widths.

Departures from the published model, DiT-style (Peebles & Xie,
arXiv:2212.09748):

- a patch embedding (``patch_size`` -> hidden) and a patch head (RMSNorm,
  hidden -> ``patch_size``) replace the vocabulary and the LM head; the
  patient vector is cut into patches within each feature block (mutations,
  expression, pathways), each block zero-padded at its end;
- two in-context condition tokens come first: the timestep's
  ``time_embed_dim``-wide sinusoid through a 2-layer SiLU MLP, and the
  clinical conditions through a 2-layer SiLU MLP; RoPE positions 0-1, the
  patches 2 onward;
- attention is bidirectional (no causal mask);
- ``e_score_correction_bias`` is a buffer that training leaves as it is
  (Moonlight's auxiliary-loss-free balancing updates it outside the
  gradient).

Precision, with ``compute_dtype`` bfloat16: parameters in bf16; every
product takes bf16 operands and accumulates in f32; a product's output is
rounded to bf16 (the routed experts' SiLU·up is taken in f32 from the bf16
``[gate | up]`` and rounded once, their routing weight and combine are in
f32; the dense and shared SwiGLUs round SiLU and the product with up, as
Moonlight's module in bf16); RMSNorm statistics, the router's scores and
the attention softmax in f32; the residual stream in f32. With float32
every step is f32.

The same block stack runs Kimi-Linear-48B-A3B
(https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct;
``config/kimi_linear_dit.yaml``), DeepSeek's keys for its MLA and
DeepSeekMoE, plus: ``linear_attn_config``, whose ``kda_layers`` (numbered
from 1) take Kimi Delta Attention (models/kda.py: causal, in token order,
the condition tokens first) in place of MLA; ``mla_use_nope``, MLA's rope
parts used unrotated (the softmax scale stays 1/sqrt(nope + rope)); and
the expert share of an expert-parallel layer, ``ep_size`` cards with this
one the ``ep_rank``-th: the router scores and chooses over every routed
expert (global ids), the layer computes only the copies routed to the
experts it holds, and a token sums those (0 to k) with the shared
experts, computed whole.

The routed experts' two grouped products are ``torch._grouped_mm`` calls
over the expert-sorted rows (``ops/moe.py``), under autograd too; the
shared experts, the dense feed-forward and the other products run on
PyTorch's matrix products and attention.

Spans (``utils/profiling.span``, recorded only under a profiler):
``dit.embed``, ``dit.attn`` (a block's MLA sublayer), ``dit.kda`` (a
block's KDA sublayer), ``dit.router``
(gate, top-k, permutation), ``dit.experts`` (grouped products and
combine), ``dit.shared`` (the shared experts, and the dense feed-forward
of the leading layers), ``dit.head``. Counters: ``dit.tokens`` (tokens
through a denoiser call), ``moe.routed_rows`` (token copies routed, over
layer calls), ``moe.held_rows`` (those of them whose expert is held here),
``kda.chunks`` (models/kda.py) and ``moe.max_expert_rows`` (the largest expert's rows,
summed over layer calls; kept on the device and added to ``COUNTERS`` by
:meth:`MoonlightDiT.flush_counters`, which reads it once).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from ..ops import moe
from ..utils.profiling import COUNTERS, span
from .networks import sinusoid

COND_TOKENS = 2  # the time token and the condition token, before the patches

# The values of Moonlight's keys that the denoiser implements.
IMPLEMENTED = {"q_lora_rank": None, "n_group": 1, "topk_group": 1, "scoring_func": "sigmoid",
               "topk_method": "noaux_tc", "hidden_act": "silu", "attention_bias": False,
               "moe_layer_freq": 1, "rope_scaling": None}


# Kimi Linear's ``linear_attn_config`` keys, all required.
LINEAR_ATTN_KEYS = ("kda_layers", "full_attn_layers", "num_heads", "head_dim",
                    "short_conv_kernel_size")


def check_transformer(tc: TransformerConfig) -> None:
    """ValueError for a key whose value the denoiser does not implement."""
    for key, value in IMPLEMENTED.items():
        if getattr(tc, key) != value:
            raise ValueError(f"model.transformer.{key} = {getattr(tc, key)!r}: the moonlight_dit "
                             f"denoiser implements {value!r} only")
    if tc.qk_rope_head_dim % 2 or tc.num_experts_per_tok > tc.n_routed_experts:
        raise ValueError("model.transformer: qk_rope_head_dim must be even and "
                         "num_experts_per_tok at most n_routed_experts")
    if tc.mla_use_nope not in (True, False):
        raise ValueError(f"model.transformer.mla_use_nope = {tc.mla_use_nope!r}: true or false")
    if (tc.ep_size < 1 or tc.n_routed_experts % tc.ep_size
            or not 0 <= tc.ep_rank < tc.ep_size):
        raise ValueError(f"model.transformer: ep_size {tc.ep_size} must divide n_routed_experts "
                         f"{tc.n_routed_experts}, and 0 <= ep_rank {tc.ep_rank} < ep_size")
    lac = tc.linear_attn_config
    if lac is None:
        return
    if not isinstance(lac, dict) or sorted(lac) != sorted(LINEAR_ATTN_KEYS):
        raise ValueError(f"model.transformer.linear_attn_config must hold exactly the keys "
                         f"{', '.join(LINEAR_ATTN_KEYS)}; got {lac!r}")
    kda, full = list(lac["kda_layers"]), list(lac["full_attn_layers"])
    if sorted(kda + full) != list(range(1, tc.num_hidden_layers + 1)):
        raise ValueError(f"model.transformer.linear_attn_config: kda_layers and "
                         f"full_attn_layers must number each of the {tc.num_hidden_layers} "
                         f"layers from 1 once; got {kda} and {full}")
    for key in ("num_heads", "head_dim", "short_conv_kernel_size"):
        if not isinstance(lac[key], int) or lac[key] < 1:
            raise ValueError(f"model.transformer.linear_attn_config.{key} = {lac[key]!r}: a "
                             f"positive integer")


def kda_layers(tc: TransformerConfig) -> frozenset:
    """The 0-based indices of the layers whose attention is KDA."""
    lac = tc.linear_attn_config
    return frozenset(i - 1 for i in lac["kda_layers"]) if lac else frozenset()


def _param(*shape: int, dtype: torch.dtype) -> nn.Parameter:
    """Uninitialised: a module of 15 B parameters is built without drawing
    them (the caller loads or draws its weights)."""
    return nn.Parameter(torch.empty(*shape, dtype=dtype))


class Linear(nn.Module):
    """``x·Wᵀ (+ b)`` in the parameters' dtype; W (out, in) as Moonlight's
    checkpoint holds it."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype, bias: bool = False):
        super().__init__()
        self.weight = _param(fan_out, fan_in, dtype=dtype)
        self.bias = _param(fan_out, dtype=dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class RMSNorm(nn.Module):
    """f32 statistics; ``x·rsqrt(mean(x²) + eps)·w`` in f32, rounded once
    to the weight's dtype."""

    def __init__(self, width: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = _param(width, dtype=dtype)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.rms_norm(x.float(), (x.shape[-1],), self.weight.float(), self.eps)
        return y.to(self.weight.dtype)


def rope_table(seq_len: int, dim: int, theta: float, device) -> torch.Tensor:
    """(seq_len, dim/2) complex64: cos + i·sin of position p and pair i at
    angle p·theta^(-2i/dim) (computed in float64)."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ang = torch.arange(seq_len, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64).to(device)


def apply_rope(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[2i], x[2i+1]) of the last axis (positions on the
    axis the table's rows follow) as complex numbers in f32; the result
    as f32 (the caller rounds it). (DeepSeek-V3's rotation of the
    de-interleaved halves, up to a permutation that q and k share.)"""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(xc * table).flatten(-2)


class MLAttention(nn.Module):
    """Multi-head latent attention without q-LoRA, bidirectional."""

    def __init__(self, tc: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        h, heads = tc.hidden_size, tc.num_attention_heads
        self.heads, self.nope, self.rope, self.v_dim = (heads, tc.qk_nope_head_dim,
                                                        tc.qk_rope_head_dim, tc.v_head_dim)
        self.rank = tc.kv_lora_rank
        self.q_proj = Linear(h, heads * (self.nope + self.rope), dtype)
        self.kv_a_proj_with_mqa = Linear(h, self.rank + self.rope, dtype)
        self.kv_a_layernorm = RMSNorm(self.rank, tc.rms_norm_eps, dtype)
        self.kv_b_proj = Linear(self.rank, heads * (self.nope + self.v_dim), dtype)
        self.o_proj = Linear(heads * self.v_dim, h, dtype)
        self.scale = 1.0 / math.sqrt(self.nope + self.rope)
        self.rotary = not tc.mla_use_nope  # NoPE: the rope parts enter unrotated

    def forward(self, a: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
        b, s, _ = a.shape
        nh = self.heads
        q = self.q_proj(a).view(b, s, nh, self.nope + self.rope)
        c, k_pe = self.kv_a_proj_with_mqa(a).split([self.rank, self.rope], dim=-1)
        if self.rotary:
            q[..., self.nope:] = apply_rope(q[..., self.nope:], rope[:, None])
            k_pe = apply_rope(k_pe, rope)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(b, s, nh, self.nope + self.v_dim)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        k_pe = k_pe.to(kv.dtype)[:, :, None].expand(b, s, nh, self.rope)
        k = torch.cat([k_nope, k_pe], dim=-1)
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), scale=self.scale)
        return self.o_proj(o.transpose(1, 2).reshape(b, s, nh * self.v_dim))


class SwiGLU(nn.Module):
    """A dense SwiGLU feed-forward of width ``inter``, as Moonlight's
    module computes it: ``down(SiLU(gate)·up)``, every result in the
    weights' dtype; ``gate_up`` (2·inter, hidden) holds ``gate_proj`` over
    ``up_proj``, ``down`` (hidden, inter); (T, hidden) -> (T, hidden) f32."""

    def __init__(self, hidden: int, inter: int, dtype: torch.dtype):
        super().__init__()
        self.gate_up = Linear(hidden, 2 * inter, dtype)
        self.down = Linear(inter, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = self.gate_up(x).chunk(2, dim=-1)
        return self.down(F.silu(g) * u).float()


class MoEFeedForward(nn.Module):
    """DeepSeekMoE: ``n_routed_experts`` SwiGLU experts of width
    ``moe_intermediate_size``, ``num_experts_per_tok`` a token, and the
    shared experts; (T, hidden) -> (T, hidden) f32."""

    def __init__(self, tc: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        h, inter, e = tc.hidden_size, tc.moe_intermediate_size, tc.n_routed_experts
        self.experts, self.top_k = e, tc.num_experts_per_tok
        self.held = e // tc.ep_size  # experts first … first + held − 1 live here
        self.first = tc.ep_rank * self.held
        self.norm_topk_prob = bool(tc.norm_topk_prob)
        self.scaling = float(tc.routed_scaling_factor)
        self.gate = Linear(h, e, dtype)
        self.register_buffer("e_score_correction_bias", torch.empty(e, dtype=torch.float32))
        self.w_gate_up = _param(self.held, h, 2 * inter, dtype=dtype)
        self.w_down = _param(self.held, inter, h, dtype=dtype)
        self.shared = SwiGLU(h, inter * tc.n_shared_experts, dtype)
        self.max_rows: Optional[torch.Tensor] = None  # on the device; see MoonlightDiT

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(choice (T, k) int64, weight (T, k) f32) of tokens ``x`` (T,
        hidden): the top k of sigmoid scores + ``e_score_correction_bias``
        (largest first), and their scores normalised and scaled."""
        scores = F.linear(x.float(), self.gate.weight.float()).sigmoid()
        choice = torch.topk(scores + self.e_score_correction_bias, self.top_k, dim=-1).indices
        weight = scores.gather(1, choice)
        if self.norm_topk_prob:
            weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
        return choice, weight * self.scaling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The routed experts held here, over the token copies routed to
        them (a token's 0 to k), plus the shared experts."""
        t, k = x.shape[0], self.top_k
        dev = x.device
        with span("dit.router", dev):
            choice, weight = self.route(x)
            if self.held == self.experts:
                plan, dest, counts = moe.expert_plan(choice, self.experts)
            else:
                plan, dest, counts = moe.held_plan(choice, self.first, self.held)
            a = x[dest // k]
            row_scale = weight.reshape(-1)[dest]
            COUNTERS["moe.routed_rows"] += t * k
            COUNTERS["moe.held_rows"] += plan.rows
            most = counts.max()
            self.max_rows = most if self.max_rows is None else self.max_rows + most
        with span("dit.experts", dev):
            h = moe.grouped_swiglu(a, self.w_gate_up, plan)
            routed = moe.grouped_down(h, self.w_down, plan, row_scale, dest, top_k=k, tokens=t)
        with span("dit.shared", dev):
            return _add(routed, self.shared(x))


def _add(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """h + y, in place in f32 ``h`` where autograd does not follow it."""
    return h.add_(y) if not torch.is_grad_enabled() else h + y


class Block(nn.Module):
    """A pre-norm residual block: MLA attention, or with ``linear`` KDA
    (models/kda.py), then the dense or DeepSeekMoE feed-forward."""

    def __init__(self, tc: TransformerConfig, dense: bool, dtype: torch.dtype,
                 linear: bool = False):
        super().__init__()
        self.attn_norm = RMSNorm(tc.hidden_size, tc.rms_norm_eps, dtype)
        if linear:
            from .kda import KimiDeltaAttention

            self.attn, self.attn_span = KimiDeltaAttention(tc, dtype), "dit.kda"
        else:
            self.attn, self.attn_span = MLAttention(tc, dtype), "dit.attn"
        self.ffn_norm = RMSNorm(tc.hidden_size, tc.rms_norm_eps, dtype)
        self.mlp = (SwiGLU(tc.hidden_size, tc.intermediate_size, dtype) if dense
                    else MoEFeedForward(tc, dtype))

    def forward(self, h: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
        with span(self.attn_span, h.device):
            h = _add(h, self.attn(self.attn_norm(h), rope))
        b, s, width = h.shape
        m = self.ffn_norm(h).view(b * s, width)
        if isinstance(self.mlp, SwiGLU):
            with span("dit.shared", h.device):
                return _add(h, self.mlp(m).view(b, s, width))
        return _add(h, self.mlp(m).view(b, s, width))


class MoonlightDiT(nn.Module):
    """The denoiser: (x (B, D) f32, t_norm (B,)) and the conditions (or
    their token, :meth:`embed_conditions`) -> the x0 prediction (B, D) f32.
    ``block_dims``: the widths of the patient vector's feature blocks, in
    order (mutations, expression, pathways)."""

    input_skip = False  # no g(t)·x path: the kernel sampler does not take this denoiser

    def __init__(self, tc: TransformerConfig, block_dims: Sequence[int], condition_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        check_transformer(tc)
        h, p = tc.hidden_size, tc.patch_size
        self.config = tc
        self.block_dims = [int(d) for d in block_dims]
        self.data_dim = sum(self.block_dims)
        self.patch_size = p
        self.patches = [-(-d // p) for d in self.block_dims]
        self.seq_len = COND_TOKENS + sum(self.patches)
        self.patch_embed = Linear(p, h, dtype, bias=True)
        self.time_fc1 = Linear(tc.time_embed_dim, h, dtype, bias=True)
        self.time_fc2 = Linear(h, h, dtype, bias=True)
        self.cond_fc1 = Linear(condition_dim, h, dtype, bias=True)
        self.cond_fc2 = Linear(h, h, dtype, bias=True)
        linear = kda_layers(tc)
        self.layers = nn.ModuleList([Block(tc, i < tc.first_k_dense_replace, dtype, i in linear)
                                     for i in range(tc.num_hidden_layers)])
        self.final_norm = RMSNorm(h, tc.rms_norm_eps, dtype)
        self.head = Linear(h, p, dtype, bias=True)
        self._rope = {}

    # ------------------------------------------------------------------
    def flax_init(self, generator: torch.Generator) -> None:
        """Training's initial weights (the trainer's init hook): every
        projection and expert weight normal(0, 0.02) (Moonlight's
        ``initializer_range``), biases 0, RMSNorm scales 1, the router's
        correction bias 0; KDA's decay and convolutions as published
        (:meth:`~.kda.KimiDeltaAttention.init_decay`)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            for name, b in self.named_buffers():
                if name.endswith("e_score_correction_bias"):
                    b.zero_()
            for blk in self.layers:
                if blk.attn_span == "dit.kda":
                    blk.attn.init_decay(generator)

    def moe_layers(self) -> List[MoEFeedForward]:
        return [blk.mlp for blk in self.layers if isinstance(blk.mlp, MoEFeedForward)]

    def flush_counters(self) -> None:
        """Add the routed layers' device-side ``moe.max_expert_rows`` to
        ``COUNTERS`` (one read of the device) and reset it."""
        kept = [m for m in self.moe_layers() if m.max_rows is not None]
        if kept:
            COUNTERS["moe.max_expert_rows"] += int(torch.stack([m.max_rows for m in kept]).sum())
            for m in kept:
                m.max_rows = None

    # ------------------------------------------------------------------
    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D) -> (B, patches, patch_size): each feature block cut into
        patches, zero-padded at its end."""
        parts, at = [], 0
        for d, n in zip(self.block_dims, self.patches):
            blk = x[:, at:at + d]
            parts.append(F.pad(blk, (0, n * self.patch_size - d)).view(x.shape[0], n,
                                                                      self.patch_size))
            at += d
        return torch.cat(parts, dim=1)

    def unpatchify(self, y: torch.Tensor) -> torch.Tensor:
        """(B, patches, patch_size) -> (B, D): each block's padding dropped."""
        parts, at = [], 0
        for d, n in zip(self.block_dims, self.patches):
            parts.append(y[:, at:at + n].reshape(y.shape[0], n * self.patch_size)[:, :d])
            at += n
        return torch.cat(parts, dim=1)

    def embed_conditions(self, conditions: torch.Tensor) -> torch.Tensor:
        """The condition token (B, hidden) f32, loop-invariant in sampling."""
        return self.cond_fc2(F.silu(self.cond_fc1(conditions))).float()

    def _rope_table(self, device) -> torch.Tensor:
        if device not in self._rope:
            tc = self.config
            self._rope[device] = rope_table(self.seq_len, tc.qk_rope_head_dim, tc.rope_theta,
                                            device)
        return self._rope[device]

    def forward(self, x: torch.Tensor, t_norm: torch.Tensor,
                conditions: Optional[torch.Tensor] = None,
                c_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The x0 prediction (B, D) f32; ``t_norm`` = t / T."""
        dev = x.device
        with span("dit.embed", dev):
            if c_proj is None:
                if conditions is None:
                    raise ValueError("provide `conditions` or precomputed `c_proj`")
                c_proj = self.embed_conditions(conditions)
            t_tok = self.time_fc2(F.silu(self.time_fc1(sinusoid(t_norm.float(),
                                                                self.config.time_embed_dim))))
            h = torch.cat([t_tok.float()[:, None], c_proj.float()[:, None],
                           self.patch_embed(self.patchify(x.float())).float()], dim=1)
            COUNTERS["dit.tokens"] += h.shape[0] * h.shape[1]
        rope = self._rope_table(dev)
        for blk in self.layers:
            h = blk(h, rope)
        with span("dit.head", dev):
            y = self.head(self.final_norm(h[:, COND_TOKENS:])).float()
            return self.unpatchify(y)

