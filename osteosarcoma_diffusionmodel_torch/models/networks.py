"""The diffusion denoiser as PyTorch modules (main-path parts).

Counterpart of osteosarcoma_diffusionmodel_tpu/models/networks.py
(`TimeEmbedding`, `ConditionEmbedding`, `DenoiserBlock`,
`DiffusionDenoiser` with the input-skip gain): a skip-connected MLP of
Linear -> GroupNorm(8) -> SiLU -> Dropout -> Linear -> GroupNorm(8) ->
SiLU blocks with additive time and condition injection.

Parameters are float32; ``compute_dtype`` sets the dtype of the Linear
products as in the Flax modules (bfloat16 rounds each product's output
to bfloat16, as Flax's ``Dense(dtype=bfloat16)`` does). GroupNorm always
runs in float32 with eps 1e-6. Submodule names follow the Flax parameter
names (``enc_0``, ``bottleneck``, ``dec_0``, ...), so
``convert.flax_params_to_state_dict`` maps one tree onto the other.
Dropout holds no parameters and acts only in training mode: the samplers
run the module in eval mode (``ConditionalDiffusion.from_config`` returns
it so), and the kernel samplers read the weights directly.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_GROUPS = 8
GN_EPS = 1e-6


def sinusoid(t_norm: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of normalized t in [0, 1], in the dtype of a
    floating ``t_norm`` (float32 in the module as in Flax; float64 for
    the sampler's host tables as in the JAX sampler)."""
    dtype = t_norm.dtype if t_norm.is_floating_point() else torch.float32
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=dtype, device=t_norm.device)
        * (-math.log(10000.0) / (half - 1))
    )
    args = t_norm.to(dtype)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class _Dense(nn.Linear):
    """Linear whose product runs in ``compute_dtype`` (params stay f32)."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class ConditionEmbedding(nn.Module):
    """Linear -> SiLU -> Linear over the clinical conditions."""

    def __init__(self, condition_dim: int, embedding_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.fc1 = _Dense(condition_dim, embedding_dim, compute_dtype)
        self.fc2 = _Dense(embedding_dim, embedding_dim, compute_dtype)

    def forward(self, conditions: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(conditions)))


class DenoiserBlock(nn.Module):
    """Linear -> GroupNorm(8) -> SiLU -> Dropout -> Linear -> GroupNorm(8)
    -> SiLU."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = _Dense(in_features, features, compute_dtype)
        self.norm1 = nn.GroupNorm(GN_GROUPS, features, eps=GN_EPS)
        self.drop = nn.Dropout(dropout)
        self.fc2 = _Dense(features, features, compute_dtype)
        self.norm2 = nn.GroupNorm(GN_GROUPS, features, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.drop(F.silu(self.norm1(self.fc1(x).float())))
        return F.silu(self.norm2(self.fc2(h).float()))


class DiffusionDenoiser(nn.Module):
    """Skip-connected MLP denoiser conditioned on time and clinical values.

    Encoder blocks over ``hidden_dims[1:]`` push their outputs onto a skip
    stack; decoder blocks pop it LIFO and take ``[h | skip]``. With
    ``input_skip`` a learned scalar gain g(t) adds g(t)·x to the output.
    """

    def __init__(
        self,
        data_dim: int,
        condition_dim: int,
        time_dim: int = 128,
        condition_embed_dim: int = 64,
        hidden_dims: Sequence[int] = (256, 512, 256),
        compute_dtype: torch.dtype = torch.float32,
        input_skip: bool = True,
        dropout: float = 0.0,
    ):
        super().__init__()
        hidden = list(hidden_dims)
        if any(h % GN_GROUPS for h in hidden):
            raise ValueError(f"hidden dims must divide into {GN_GROUPS} groups: {hidden}")
        self.data_dim = data_dim
        self.condition_dim = condition_dim
        self.time_dim = time_dim
        self.hidden_dims = hidden
        self.compute_dtype = compute_dtype
        self.input_skip = input_skip
        cd = compute_dtype

        self.time_proj = _Dense(time_dim, hidden[0], cd)
        if input_skip:
            # f32 like the Flax module, zero-initialized there.
            self.skip_gain = nn.Linear(time_dim, 1)
        self.condition_embed = ConditionEmbedding(condition_dim, condition_embed_dim, cd)
        self.cond_proj = _Dense(condition_embed_dim, hidden[0], cd)
        self.input_proj = _Dense(data_dim, hidden[0], cd)

        self.encoder_names: List[str] = []
        enc_in = hidden[0]
        enc_feats = []
        for i, feat in enumerate(hidden[1:]):
            self.add_module(f"enc_{i}", DenoiserBlock(enc_in, feat, cd, dropout))
            self.encoder_names.append(f"enc_{i}")
            enc_feats.append(feat)
            enc_in = feat
        self.bottleneck = DenoiserBlock(enc_in, hidden[-1], cd, dropout)
        self.decoder_names: List[str] = []
        dec_in = hidden[-1]
        for j, i in enumerate(range(len(hidden) - 2, -1, -1)):
            if not enc_feats:
                break
            skip = enc_feats.pop()
            self.add_module(f"dec_{j}", DenoiserBlock(dec_in + skip, hidden[i], cd, dropout))
            self.decoder_names.append(f"dec_{j}")
            dec_in = hidden[i]
        self.output_proj = _Dense(dec_in, data_dim, cd)

    # ------------------------------------------------------------------
    def embed_conditions(self, conditions: torch.Tensor) -> torch.Tensor:
        """Condition projection, loop-invariant during sampling."""
        return self.cond_proj(self.condition_embed(conditions))

    def hidden_forward(self, h: torch.Tensor) -> torch.Tensor:
        """Encoder/bottleneck/decoder stack from the post-input-projection
        activation to the pre-output-projection hidden state."""
        skips = []
        for name in self.encoder_names:
            h = getattr(self, name)(h)
            skips.append(h)
        h = self.bottleneck(h)
        for name in self.decoder_names:
            h = getattr(self, name)(torch.cat([h, skips.pop()], dim=-1))
        return h

    def forward(
        self,
        x: torch.Tensor,
        t_norm: torch.Tensor,
        conditions: Optional[torch.Tensor] = None,
        c_proj: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x0 prediction (B, data_dim) in float32; ``t_norm`` = t / T."""
        if c_proj is None:
            if conditions is None:
                raise ValueError("provide `conditions` or precomputed `c_proj`")
            c_proj = self.embed_conditions(conditions)
        t_sin = sinusoid(t_norm, self.time_dim)
        t_emb = self.time_proj(t_sin)
        h = self.input_proj(x)
        h = self.hidden_forward(h + t_emb + c_proj.to(h.dtype))
        out = self.output_proj(h).float()
        if self.input_skip:
            out = out + self.skip_gain(t_sin) * x.float()
        return out


def init_flax(module: DiffusionDenoiser, generator: torch.Generator) -> None:
    """The Flax module's initial weights, drawn from ``generator``: Dense
    kernels LeCun normal (a normal truncated to +-2 std, rescaled to
    variance 1/fan_in), biases 0, GroupNorm scale 1 and bias 0, and the
    skip gain's kernel 0 (networks.py:186-219 in the JAX package). The
    draws are torch's, not JAX's: the distribution is the same, the
    values are not."""
    std = 1.0 / 0.87962566103423978  # std of a unit normal truncated to +-2
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.mul_(std / math.sqrt(mod.in_features))
                mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if module.input_skip:
            module.skip_gain.weight.zero_()


def init_weights(module: DiffusionDenoiser, generator: torch.Generator) -> None:
    """Seeded random weights: Linear weights and biases ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), GroupNorm scale 1 and bias 0, and a small nonzero
    skip gain so that the g(t)·x path carries signal."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if module.input_skip:
            module.skip_gain.weight.mul_(0.1)
