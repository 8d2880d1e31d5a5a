"""The diffusion denoiser and the layers the model families share, as
PyTorch modules.

Counterpart of osteosarcoma_diffusionmodel_tpu/models/networks.py
(`TimeEmbedding`, `ConditionEmbedding`, `DenoiserBlock`,
`DiffusionDenoiser`, `SurvivalHead`), with Flax's BatchNorm written out
for the cVAE (:class:`BatchNorm`) and :func:`init_flax`, the Flax
initializers of every family. The denoiser is a skip-connected MLP of
Linear -> GroupNorm(8) -> SiLU -> Dropout -> Linear -> GroupNorm(8) ->
SiLU blocks with additive time and condition injection, the input-skip
gain, and the optional heads of :137-250 there: the learned-sigma
projection, the latent-factor encoder, the AR (FVSBN) mutation head and
the low-rank sigma parameters.

Parameters are float32; ``compute_dtype`` sets the dtype of the Linear
products as in the Flax modules (bfloat16 rounds each product's output
to bfloat16, as Flax's ``Dense(dtype=bfloat16)`` does). GroupNorm always
runs in float32 with eps 1e-6. Submodule names follow the Flax parameter
names (``enc_0``, ``bottleneck``, ``dec_0``, ``sigma_proj``,
``ar_coupling``, ...), so ``convert.flax_params_to_state_dict`` maps one
tree onto the other.
Dropout holds no parameters and acts only in training mode: the samplers
run the module in eval mode (``ConditionalDiffusion.from_config`` returns
it so), and the kernel samplers read the weights directly. The trainer
attaches its step's :class:`~..parallel.batch.BatchShard` to the
:class:`Dropout` and :class:`BatchNorm` layers: dropout then draws the
global batch's mask from the trainer's generator and keeps this rank's
rows, and BatchNorm normalizes with the global batch's moments.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.batch import BatchShard

GN_GROUPS = 8
GN_EPS = 1e-6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``model.compute_dtype`` as a torch dtype; ValueError when unknown."""
    if name not in DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return DTYPES[name]


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


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the batch axis (momentum 0.99, epsilon
    1e-5, ``dtype=float32``), not ``nn.BatchNorm1d``: in training mode the
    statistics are float32 over the (bf16) input, the variance E[x^2] -
    E[x]^2 clipped at 0 and biased, and it normalizes with that variance
    and updates ``mean <- 0.99 mean + 0.01 mu`` and ``var <- 0.99 var +
    0.01 sigma^2`` in place; in eval mode it normalizes with the running
    statistics. The output is float32: (x - mean) * (rsqrt(var + eps) *
    scale) + bias, in Flax's order. The buffers carry Flax's
    ``batch_stats`` names, ``mean`` and ``var``; ``weight``/``bias`` are
    its ``scale``/``bias``."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        # The step's global batch (parallel.batch.attached): its moments.
        self.shard: Optional[BatchShard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            if self.shard is None:
                mu = x.mean(dim=0)
                var = torch.clamp_min((x * x).mean(dim=0) - mu * mu, 0.0)
            else:
                mu = self.shard.mean(x, 0)
                var = torch.clamp_min(self.shard.mean(x * x, 0) - mu * mu, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mu)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mu, var = self.mean, self.var
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class Dropout(nn.Dropout):
    """``nn.Dropout``; with a :class:`~..parallel.batch.BatchShard`
    attached, the mask of the global batch (this rank's rows times the
    shard's world) is drawn from the shard's generator and the rank keeps
    its rows of it, so every rank's rows see the mask that one device
    would draw for the whole batch: ``x * bernoulli(1 - p) / (1 - p)``."""

    def __init__(self, p: float = 0.5):
        super().__init__(p)
        self.shard: Optional[BatchShard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = self.shard
        if shard is None or shard.generator is None or not self.training or self.p == 0:
            return super().forward(x)
        keep = torch.empty((x.shape[0] * shard.world,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device).bernoulli_(1.0 - self.p, generator=shard.generator)
        return x * shard.take(keep).div_(1.0 - self.p)


class SurvivalHead(nn.Module):
    """Auxiliary survival-time regressor over a latent vector (JAX
    `SurvivalHead`, networks.py:328-344): Dense(128) -> ReLU ->
    Dropout(0.2) -> Dense(1), squeezed to (B,) float32. The rate is fixed,
    not taken from the config, as there."""

    def __init__(self, in_features: int, compute_dtype: torch.dtype,
                 hidden_dim: int = 128, dropout: float = 0.2):
        super().__init__()
        self.fc1 = _Dense(in_features, hidden_dim, compute_dtype)
        self.drop = Dropout(dropout)
        self.fc2 = _Dense(hidden_dim, 1, compute_dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.drop(F.relu(self.fc1(z)))).float().squeeze(-1)


def generator_on(generator: Optional[torch.Generator], device) -> Optional[torch.Generator]:
    """``generator`` where it lies on ``device``, else a generator there
    seeded once from it, so that a model's draws stay on its device."""
    device = torch.device(device)
    if generator is None or generator.device == device:
        return generator
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    return torch.Generator(device=device).manual_seed(seed)


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
        self.drop = Dropout(dropout)
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

    Optional heads (each off at 0 / False): ``learn_sigma`` appends the
    clipped per-feature log-variance of x0 to the output;
    ``latent_factor_dim`` adds the x0 encoder (input width
    ``latent_input_dim``, 0 = ``data_dim``) whose factors the caller
    appends to the conditions (``condition_dim`` counts them);
    ``ar_head_dim`` adds the FVSBN couplings, biases and the f32 context
    MLP over ``ar_context_dim`` inputs; ``low_rank_sigma_dim`` adds U
    (``low_rank_sigma_rows`` rows, 0 = ``data_dim``), the log-diagonal and
    the per-step log-scales (``low_rank_sigma_steps``).
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
        learn_sigma: bool = False,
        latent_factor_dim: int = 0,
        latent_input_dim: int = 0,
        low_rank_sigma_dim: int = 0,
        low_rank_sigma_steps: int = 0,
        low_rank_sigma_rows: int = 0,
        ar_head_dim: int = 0,
        ar_context_dim: int = 0,
        ar_context_hidden: int = 64,
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
        self.learn_sigma = learn_sigma
        self.latent_factor_dim = latent_factor_dim
        self.low_rank_sigma_dim = low_rank_sigma_dim
        self.ar_head_dim = ar_head_dim
        cd = compute_dtype

        if low_rank_sigma_dim > 0:
            rows = low_rank_sigma_rows or data_dim
            self.lowrank_U = nn.Parameter(torch.zeros(rows, low_rank_sigma_dim))
            self.lowrank_logdiag = nn.Parameter(torch.zeros(data_dim))
            self.lowrank_logs = nn.Parameter(torch.zeros(low_rank_sigma_steps))
        if ar_head_dim > 0:
            self.ar_coupling = nn.Parameter(torch.zeros(ar_head_dim, ar_head_dim))
            self.ar_bias = nn.Parameter(torch.zeros(ar_head_dim))
            # f32, as in Flax: the outputs sit on the logit scale.
            self.ar_ctx_fc1 = nn.Linear(ar_context_dim, ar_context_hidden)
            self.ar_ctx_fc2 = nn.Linear(ar_context_hidden, ar_head_dim)
        if latent_factor_dim > 0:
            self.latent_enc_fc1 = _Dense(latent_input_dim or data_dim, 128, cd)
            self.latent_enc_fc2 = nn.Linear(128, latent_factor_dim)  # f32
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
        if learn_sigma:
            self.sigma_proj = nn.Linear(dec_in, data_dim)  # f32

    def flax_init(self, generator: torch.Generator) -> None:
        """The Flax inits of the heads (networks.py:137-250 in the JAX
        package), after :func:`init_flax`'s defaults: a zero kernel for the
        skip gain and the AR context's output layer; a zero kernel and a -6
        bias for the sigma projection; normal(0.01) for the AR couplings
        and U; zeros for the AR biases and the low-rank log-diagonal and
        log-scales."""
        with torch.no_grad():
            if self.input_skip:
                self.skip_gain.weight.zero_()
            if self.learn_sigma:
                self.sigma_proj.weight.zero_()
                self.sigma_proj.bias.fill_(-6.0)
            _init_raw_heads(self, generator, 0.01)
            if self.ar_head_dim:
                self.ar_ctx_fc2.weight.zero_()

    # ------------------------------------------------------------------
    def embed_conditions(self, conditions: torch.Tensor) -> torch.Tensor:
        """Condition projection, loop-invariant during sampling (with latent
        factors, of the widened [clinical | factors] vector)."""
        return self.cond_proj(self.condition_embed(conditions))

    def encode_latent(self, x0: torch.Tensor) -> torch.Tensor:
        """The encoder's view of clean patient vectors -> latent factors
        (f32): fc1 in the compute dtype, fc2 in f32."""
        h = F.silu(self.latent_enc_fc1(x0))
        return self.latent_enc_fc2(h.float())

    def lowrank_sigma(self):
        """(U, log_diag, log_s) of the low-rank residual covariance."""
        return self.lowrank_U, self.lowrank_logdiag, self.lowrank_logs

    def ar_context_logits(self, context: torch.Tensor) -> torch.Tensor:
        """Per-gene logit contribution of the AR head's context (f32)."""
        return self.ar_ctx_fc2(F.silu(self.ar_ctx_fc1(context.float())))

    def ar_logits(self, bits: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """Teacher-forced FVSBN logits: gene i sees bits j < i only (strict
        lower-triangular mask) plus the context term."""
        w = torch.tril(self.ar_coupling, -1)
        return bits.float() @ w.T + self.ar_bias + self.ar_context_logits(context)

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
        """The prediction (B, data_dim) in float32, with the log-variance
        (B, data_dim) appended under ``learn_sigma``; ``t_norm`` = t / T."""
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
        if self.learn_sigma:
            logvar = torch.clamp(self.sigma_proj(h.float()), -12.0, 4.0)
            return torch.cat([out, logvar], dim=-1)
        return out


def init_flax(module: nn.Module, generator: torch.Generator) -> None:
    """The Flax module's initial weights, drawn from ``generator``: Dense
    kernels LeCun normal (a normal truncated to +-2 std, rescaled to
    variance 1/fan_in), biases 0, GroupNorm and BatchNorm scale 1 and bias
    0, BatchNorm's running mean 0 and variance 1; then each submodule's
    ``flax_init`` hook, in module order, for the inits that differ from
    these (the denoiser's heads, the flow's zero output kernels). The draws
    are torch's, not JAX's: the distribution is the same, the values are
    not."""
    std = 1.0 / 0.87962566103423978  # std of a unit normal truncated to +-2
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.mul_(std / math.sqrt(mod.in_features))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.GroupNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.mean.zero_()
                    mod.var.fill_(1.0)
        for mod in module.modules():
            hook = getattr(mod, "flax_init", None)
            if hook is not None:
                hook(generator)


def _init_raw_heads(module: DiffusionDenoiser, generator: torch.Generator, scale: float) -> None:
    """normal(``scale``) AR couplings and U; zero AR biases, log-diagonal
    and log-scales."""
    if module.ar_head_dim:
        module.ar_coupling.copy_(scale * torch.randn(module.ar_coupling.shape, generator=generator))
        module.ar_bias.zero_()
    if module.low_rank_sigma_dim:
        module.lowrank_U.copy_(scale * torch.randn(module.lowrank_U.shape, generator=generator))
        module.lowrank_logdiag.zero_()
        module.lowrank_logs.zero_()


def init_weights(module: DiffusionDenoiser, generator: torch.Generator) -> None:
    """Seeded random weights: Linear weights and biases ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), GroupNorm scale 1 and bias 0, a small nonzero skip
    gain so that the g(t)·x path carries signal, the sigma projection's
    bias at -6 (a residual sigma near e^-3), normal(0.1) AR couplings and
    U, and zero AR biases and low-rank log-diagonal and log-scales."""
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
        if module.learn_sigma:
            module.sigma_proj.bias.fill_(-6.0)
        _init_raw_heads(module, generator, 0.1)
