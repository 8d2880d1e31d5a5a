"""Conditional DDPM over the flat patient vector.

Counterpart of osteosarcoma_diffusionmodel_tpu/models/diffusion.py
`ConditionalDiffusion`, with every variant of the diffusion architecture:
the x0, epsilon and v parameterizations, learned and low-rank sigma,
latent-factor conditioning, classifier-free guidance, the binary D3PM
mutation head (`discrete_head`, :151, :308-311) and the AR (FVSBN)
mutation head (`ar_sample`, :373-408).

:meth:`ConditionalDiffusion.loss` is the training objective (`loss`,
:481-705): the l1/l2/huber loss on the continuous block against the
parameterization's target (optionally block-balanced), the D3PM head's
BCE, the AR head's teacher-forced CE with its two L2 terms, the
learned-sigma and low-rank-sigma NLLs on a detached mean, the latent
factors' pull, CFG condition dropout, and the four constraint losses on
the predicted x0. Its random draws (t, the Gaussian noise, the bit-flip
uniforms, the CFG keep uniforms) come from a ``torch.Generator`` or are
passed in, so a test can feed it the JAX key's draws.

Two families of samplers:

- :meth:`sample` and :meth:`sample_ddim` are plain PyTorch loops over the
  ``nn.Module`` denoiser: the plain version of the whole kernel sampler
  (``ops/fused_sampler.py``), for the models it accepts
  (:func:`~..ops.fused_sampler.supports_fused`): x0, the x0 clip, the
  input skip, uniform U(-sqrt3, sqrt3) noise, no sigma head. Same tables,
  same bf16 carry (f32 arithmetic, one bf16 rounding per step), same
  D3PM algebra, same ``x_init``/``noise`` seams; ``quantize`` routes the
  marked products through the plain versions of K5/K6.
- :meth:`scan_sample` and :meth:`scan_sample_ddim` follow the JAX
  package's ``lax.scan`` samplers (`sample`, :752-937; `sample_ddim`,
  :942-1063) step by step, for every configuration: the JAX package runs
  them where it runs no Pallas kernel (v/epsilon, learned or low-rank
  sigma, no clip, no input skip, normal noise, CFG at guidance != 1), and
  so does the port's generator. They are ordinary PyTorch ops on the
  model's device; every draw can be passed in (``draws``).
  :meth:`ddim_chain` is the DDIM one with autograd on, for sample-path
  fine-tuning (``training/finetune.py``).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config, FrozenDims
from ..ops.discrete import bernoulli_cross_entropy, posterior_prob_one, q_sample_bits
from ..ops.fused_sampler import (
    coefficient_table,
    int8_parts,
    quant_flags,
    reverse_timesteps,
    supports_fused,
    x_prior,
)
from ..ops.sampler_kernels import gemm_s8_plain, mutation_transform, rowquant_s8_plain
from ..ops.schedules import DiffusionSchedule, ddim_timesteps
from ..parallel.batch import BatchShard, RowBlock, batch_mean
from ..parallel.mesh import group_devices
from .constraints import ConstraintSpec, SpecTensors, constraint_losses
from .networks import DTYPES, DiffusionDenoiser, generator_on, sinusoid

QUANTIZE_MODES = ("none", "out", "io", "all")
LOSS_TYPES = ("l1", "l2", "huber")
AR_CONTEXTS = ("pathways", "continuous", "none")
UNIFORM_SCALE = math.sqrt(3.0)
logger = logging.getLogger(__name__)


def finetune_skip_reason(config: Config, dims: FrozenDims) -> Optional[str]:
    """The JAX CLI's warning where it skips an enabled sample-path
    fine-tuning (cli.py:193-225 there): another architecture than the
    diffusion model, the D3PM, latent-factor or AR heads; None where it
    would run it."""
    dc, m = config.model.diffusion, dims.mutation_dim
    if config.model.architecture != "diffusion":
        return ("sample_path_finetune only applies to the diffusion architecture; skipping "
                f"(architecture={config.model.architecture})")
    if dc.discrete_mutation_head and m:
        return ("sample_path_finetune is incompatible with the discrete mutation head (no "
                "pathwise gradient through bit draws); skipping")
    if dc.latent_factor_dim > 0:
        return ("sample_path_finetune does not support latent-factor conditioning (the DDIM "
                "chain would need prior draws threaded through the loss); skipping")
    if dc.ar_mutation_head and m:
        return ("sample_path_finetune is pointless with the AR mutation head: generation "
                "replaces the mutation scores its co-occurrence objective tunes with the "
                "sequential AR draw; skipping")
    return None


def visible_devices(device: str | torch.device | None) -> int:
    """The devices a trainer on ``device``'s kind could spread over: the
    process group's world size where one is initialized (one process per
    device); else the visible cards for "cuda" (the default), one for the
    CPU."""
    if torch.distributed.is_initialized():
        return group_devices()
    kind = torch.device(device or "cuda").type
    return torch.cuda.device_count() if kind == "cuda" else 1


def check_supported(config: Config, dims: FrozenDims, training: bool = False,
                    device: str | torch.device | None = None) -> None:
    """Raise ValueError for an unknown ``generation.fused_quantize``, loss
    type, block weighting, compute dtype or carry dtype. With ``training``,
    fewer visible devices (:func:`visible_devices`) than
    ``training.num_devices`` train on one device with the JAX trainer's
    warning (its ``__init__``, :190-198); with that many, the trainer
    builds its mesh. Every architecture
    passes: :func:`~..training.trainer.build_model` refuses an unknown one.
    A ``generation.sampler`` other than "ddim" samples with DDPM, as in the
    JAX package (its generator tests for "ddim" only); one warning says
    so."""
    mc, dc, gen = config.model, config.model.diffusion, config.generation
    if gen.fused_quantize not in QUANTIZE_MODES + (None,):
        raise ValueError(f"generation.fused_quantize must be one of {QUANTIZE_MODES}, "
                         f"got {gen.fused_quantize!r}")
    if dc.loss_type not in LOSS_TYPES:
        raise ValueError(f"Unknown loss_type: {dc.loss_type}")
    if dc.block_loss_weighting not in ("balanced", "none"):
        raise ValueError(f"unknown block_loss_weighting {dc.block_loss_weighting!r}")
    wanted = config.training.num_devices or 1
    if training and wanted > 1 and visible_devices(device) < wanted:
        visible = visible_devices(device)
        logger.warning("training.num_devices=%d but only %d devices visible; "
                       "training single-device", wanted, visible)
    if gen.sampler not in ("ddpm", "ddim"):
        logger.warning("generation.sampler %r is not 'ddim': sampling with DDPM, as the JAX "
                       "package does", gen.sampler)
    for what, value in (("compute_dtype", mc.compute_dtype),
                        ("generation.sample_dtype", gen.sample_dtype)):
        if value not in DTYPES:
            raise ValueError(f"unknown {what} {value!r}")


def check_variants(config: Config, dims: FrozenDims) -> None:
    """The JAX package's conflicts between heads (`from_config`, :192-240
    there), each a ValueError."""
    dc, m = config.model.diffusion, dims.mutation_dim
    if dc.parameterization not in ("x0", "epsilon", "v"):
        raise ValueError(f"Unknown diffusion.parameterization {dc.parameterization!r}; "
                         "expected x0|epsilon|v")
    if dc.low_rank_sigma_dim > 0 and dc.learn_sigma:
        raise ValueError("low_rank_sigma_dim and learn_sigma are mutually exclusive "
                         "residual-sigma channels")
    mutation_scoped = dc.low_rank_sigma_dim > 0 and dc.low_rank_sigma_scope == "mutations"
    if mutation_scoped and dc.discrete_mutation_head and m > 0:
        raise ValueError("low_rank_sigma_scope='mutations' is incompatible with "
                         "discrete_mutation_head: the discrete head removes the mutation "
                         "rows from the Gaussian residual channel")
    if dc.ar_mutation_head and dc.discrete_mutation_head:
        raise ValueError("ar_mutation_head and discrete_mutation_head are mutually exclusive "
                         "owners of the mutation block")
    if mutation_scoped and dc.ar_mutation_head and m > 0:
        raise ValueError("low_rank_sigma_scope='mutations' is incompatible with "
                         "ar_mutation_head: the AR head replaces the sampled mutation scores, "
                         "voiding the correlated-noise channel")
    if dc.ar_context not in AR_CONTEXTS:
        raise ValueError(f"Unknown diffusion.ar_context {dc.ar_context!r}; "
                         "expected pathways|continuous|none")


def _int8_product(x: torch.Tensor, parts: List[tuple], bias: torch.Tensor) -> torch.Tensor:
    """The TPU's int8 ``mm`` on f32 ``x`` through the plain versions of K5
    and K6: one quantized product per row part of the weight, summed in
    f32, then the bias."""
    acc = None
    for lo, hi, q, scale in parts:
        qa, rs = rowquant_s8_plain(x[:, lo:hi])
        acc = gemm_s8_plain(qa, rs, q, scale, acc_into=acc)
    return acc + bias


def _elementwise_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str) -> torch.Tensor:
    """l1 | l2 | huber (delta 1)."""
    if loss_type == "l1":
        return torch.abs(pred - target)
    if loss_type == "l2":
        return (pred - target) ** 2
    if loss_type == "huber":
        err = torch.abs(pred - target)
        return torch.where(err <= 1.0, 0.5 * err**2, err - 0.5)
    raise ValueError(f"Unknown loss_type: {loss_type}")


def _f32_table(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


class _Draws:
    """The scan samplers' random draws: the tensor under a name in
    ``given`` (a whole array, or its row ``step``), else a fresh draw on
    ``device``. A ``generator`` on another device seeds one there, so the
    per-step draws never cross from the host. With ``rows`` (a block of a
    cohort split over ranks), each draw is the whole cohort's and the block
    keeps its rows, so every rank's rows get the draws of one device."""

    def __init__(self, given: Optional[Mapping[str, torch.Tensor]],
                 generator: Optional[torch.Generator], device,
                 rows: Optional[RowBlock] = None):
        self.given = dict(given or {})
        self.device = torch.device(device)
        self.generator = generator_on(generator, self.device)
        self.rows = rows

    def take(self, value: torch.Tensor) -> torch.Tensor:
        return value if self.rows is None else self.rows.take(value)

    def __call__(self, name: str, kind: str, shape, dtype=torch.float32,
                 step: Optional[int] = None) -> torch.Tensor:
        """``kind``: "normal", "uniform" (U(-sqrt3, sqrt3)) or "unit" (U[0, 1))."""
        if name in self.given:
            value = self.given[name] if step is None else self.given[name][step]
            return self.take(value.to(self.device, dtype))
        if self.generator is None:
            raise ValueError(f"no generator and no {name!r} draws given")
        if self.rows is not None:
            shape = (self.rows.total,) + tuple(shape[1:])
        g = self.generator
        if kind == "normal":
            value = torch.randn(shape, generator=g, device=self.device)
        else:
            value = torch.rand(shape, generator=g, device=self.device)
            if kind == "uniform":
                value = (value * 2.0 - 1.0) * UNIFORM_SCALE
        return self.take(value.to(dtype))


@dataclass
class _LossTables:
    """The loss's constants on one device: schedule rows (f32) and the
    constraint spec's index tensors."""

    sqrt_acp: torch.Tensor
    sqrt_om: torch.Tensor
    acp: torch.Tensor
    feature_weights: Optional[torch.Tensor]
    spec: Optional[SpecTensors]


@dataclass
class ConditionalDiffusion:
    denoiser: DiffusionDenoiser
    schedule: DiffusionSchedule
    clip_value: float = 30.0
    discrete_head: bool = False
    mutation_dim: int = 0
    loss_type: str = "l2"
    discrete_ce_weight: float = 1.0
    # (D,) per-feature loss weights (sum-preserving); None = plain mean.
    feature_loss_weights: Optional[np.ndarray] = None
    constraint_spec: Optional[ConstraintSpec] = None
    pathway_coherence_weight: float = 0.0
    mutation_expression_weight: float = 0.0
    mutual_exclusivity_weight: float = 0.0
    cooccurrence_weight: float = 0.0
    # The variants (see DiffusionConfig and the JAX dataclass).
    parameterization: str = "x0"
    clip_denoised: bool = True
    learn_sigma: bool = False
    sigma_loss_weight: float = 1.0
    low_rank_sigma_dim: int = 0
    low_rank_sigma_weight: float = 1.0
    latent_factor_dim: int = 0
    latent_encoder_input: str = "full"
    cfg_dropout_prob: float = 0.0
    # The scan samplers' carry dtype and step noise (the kernel sampler's
    # carry is bf16 and its noise uniform whatever these say).
    sample_dtype: str = "bfloat16"
    noise_type: str = "uniform"
    ar_head: bool = False
    ar_context: str = "pathways"
    ar_ce_weight: float = 1.0
    ar_l2: float = 1e-5
    ar_ctx_l2: float = 1e-2
    ar_lr: float = 1e-2
    pathway_dim: int = 0

    @property
    def module(self) -> DiffusionDenoiser:
        """The ``nn.Module`` that holds every parameter (the trainer's and
        the generator's handle, as for the cVAE and the flow)."""
        return self.denoiser

    @staticmethod
    def from_config(config: Config, dims: FrozenDims,
                    constraint_spec: Optional[ConstraintSpec] = None) -> "ConditionalDiffusion":
        """The model of ``config``; its denoiser is in eval mode (no
        dropout), the mode every sampler runs it in."""
        check_supported(config, dims)
        check_variants(config, dims)
        mc, dc = config.model, config.model.diffusion
        m = dims.mutation_dim
        ar_on = bool(dc.ar_mutation_head and m > 0)
        if dc.ar_context == "pathways":
            ar_context_dim = dims.pathway_dim + dims.condition_dim
        elif dc.ar_context == "continuous":
            ar_context_dim = dims.data_dim - m + dims.condition_dim
        else:
            ar_context_dim = dims.condition_dim
        denoiser = DiffusionDenoiser(
            data_dim=dims.data_dim,
            condition_dim=dims.condition_dim + dc.latent_factor_dim,
            time_dim=mc.latent_dim,
            condition_embed_dim=mc.latent_dim // 2,
            hidden_dims=tuple(mc.hidden_dims),
            compute_dtype=DTYPES[mc.compute_dtype],
            input_skip=mc.denoiser_input_skip,
            dropout=mc.gnn.dropout,
            learn_sigma=dc.learn_sigma,
            latent_factor_dim=dc.latent_factor_dim,
            latent_input_dim=m if dc.latent_encoder_input == "mutations" and m else 0,
            low_rank_sigma_dim=dc.low_rank_sigma_dim,
            low_rank_sigma_steps=dc.num_steps,
            low_rank_sigma_rows=m if dc.low_rank_sigma_scope == "mutations" else 0,
            ar_head_dim=m if ar_on else 0,
            ar_context_dim=ar_context_dim,
            ar_context_hidden=dc.ar_context_hidden,
        ).eval()
        feature_weights = None
        if dc.block_loss_weighting == "balanced":
            blocks = [dims.mutation_dim, dims.expression_dim, dims.pathway_dim]
            feature_weights = np.concatenate([
                np.full(b, dims.data_dim / (len(blocks) * b), np.float32) for b in blocks if b > 0
            ])
        cc = mc.constraints
        use_constraints = cc.enabled and constraint_spec is not None

        def weight(w):
            return float(w) if use_constraints else 0.0

        return ConditionalDiffusion(
            denoiser, DiffusionSchedule.create(dc.beta_schedule, dc.num_steps),
            float(dc.denoised_clip_value),
            discrete_head=bool(dc.discrete_mutation_head and m > 0),
            mutation_dim=m,
            loss_type=dc.loss_type,
            discrete_ce_weight=float(dc.discrete_ce_weight),
            feature_loss_weights=feature_weights,
            constraint_spec=constraint_spec if use_constraints else None,
            pathway_coherence_weight=weight(cc.pathway_coherence_weight),
            mutation_expression_weight=weight(cc.mutation_expression_weight),
            mutual_exclusivity_weight=weight(cc.gene_network_weight),
            cooccurrence_weight=weight(cc.cooccurrence_weight),
            parameterization=dc.parameterization,
            clip_denoised=bool(dc.clip_denoised),
            learn_sigma=bool(dc.learn_sigma),
            sigma_loss_weight=float(dc.sigma_loss_weight),
            low_rank_sigma_dim=int(dc.low_rank_sigma_dim),
            low_rank_sigma_weight=float(dc.low_rank_sigma_weight),
            latent_factor_dim=int(dc.latent_factor_dim),
            latent_encoder_input=dc.latent_encoder_input,
            cfg_dropout_prob=float(mc.cfg_dropout_prob),
            sample_dtype=config.generation.sample_dtype,
            noise_type=config.generation.noise_type,
            ar_head=ar_on,
            ar_context=dc.ar_context,
            ar_ce_weight=float(dc.ar_ce_weight),
            ar_l2=float(dc.ar_l2),
            ar_ctx_l2=float(dc.ar_ctx_l2),
            ar_lr=float(dc.ar_lr),
            pathway_dim=dims.pathway_dim,
        )

    # ------------------------------------------------------------------
    # Heads
    # ------------------------------------------------------------------
    def _latent_encoder_view(self, x0: torch.Tensor) -> torch.Tensor:
        if self.latent_encoder_input == "mutations" and self.mutation_dim:
            return x0[:, : self.mutation_dim]
        return x0

    def encode_latents(self, x0: torch.Tensor) -> torch.Tensor:
        """Full patient vectors (B, D) -> latent factors (B, k), through the
        configured encoder view (whole vector or mutation block)."""
        return self.denoiser.encode_latent(self._latent_encoder_view(x0))

    def _ar_context_view(self, continuous: torch.Tensor, conditions: torch.Tensor) -> torch.Tensor:
        """What the AR head conditions on: the pathway block (or the whole
        continuous block, or nothing) beside the clinical conditions.
        ``continuous`` is the (B, D - M) block, or just its last columns
        where only the pathways are read."""
        if self.ar_context == "pathways" and self.pathway_dim > 0:
            view = continuous[:, -self.pathway_dim:]
        elif self.ar_context == "continuous":
            view = continuous
        else:
            return conditions.float()
        return torch.cat([view.float(), conditions.float()], dim=1)

    @torch.no_grad()
    def ar_sample(self, continuous: torch.Tensor, conditions: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sequential FVSBN draw of the (B, M) mutation bits on the
        denoiser's device, conditioned on ``continuous`` (the calibrated
        continuous block, or its pathway columns) and the clinical
        ``conditions``. Gene i's bits are ``u[:, i] < sigmoid(logit_i)``
        with ``uniforms`` (B, M), or uniforms drawn from ``generator``; the
        loop-invariant context logits are computed once."""
        d = self.denoiser
        dev = d.ar_bias.device
        ctx = self._ar_context_view(continuous.to(dev), conditions.to(dev))
        ctx_logits = d.ar_context_logits(ctx)
        w = torch.tril(d.ar_coupling, -1)
        batch, M = ctx.shape[0], self.mutation_dim
        if uniforms is None:
            uniforms = torch.rand((batch, M), generator=generator, device=generator.device)
        u = uniforms.to(dev, torch.float32)
        bits = torch.zeros((batch, M), dtype=torch.float32, device=dev)
        base = ctx_logits + d.ar_bias
        for i in range(M):
            logit = bits @ w[i] + base[:, i]
            bits[:, i] = (u[:, i] < torch.sigmoid(logit)).float()
        return bits

    def _lowrank_params(self):
        """(U, log_diag, log_s); U zero-padded to the full width when the
        loadings are scoped to the mutation block."""
        U, logdiag, logs = self.denoiser.lowrank_sigma()
        D = self.denoiser.data_dim
        if U.shape[0] < D:
            U = torch.cat([U, U.new_zeros(D - U.shape[0], U.shape[1])], dim=0)
        return U, logdiag, logs

    def _split_sigma(self, pred: torch.Tensor):
        """(prediction, log-variance or None)."""
        if not self.learn_sigma:
            return pred, None
        D = self.denoiser.data_dim
        return pred[:, :D], pred[:, D:]

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _loss_tables(self, device: torch.device) -> _LossTables:
        cached = getattr(self, "_tables", None)
        if cached is None or cached.sqrt_acp.device != device:
            sch = self.schedule
            cached = _LossTables(
                _f32_table(sch.sqrt_alphas_cumprod, device),
                _f32_table(sch.sqrt_one_minus_alphas_cumprod, device),
                _f32_table(sch.alphas_cumprod, device),
                None if self.feature_loss_weights is None
                else _f32_table(self.feature_loss_weights, device),
                None if self.constraint_spec is None else self.constraint_spec.tensors(device),
            )
            self._tables = cached
        return cached

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) in closed form."""
        tables = self._loss_tables(x0.device)
        return tables.sqrt_acp[t][:, None] * x0 + tables.sqrt_om[t][:, None] * noise

    def _predict_x0(self, pred, x_t, sqrt_acp, sqrt_om, inv_sqrt_acp=None):
        """x0 from the prediction under the parameterization (epsilon's
        1/sqrt(acp) as a product with ``inv_sqrt_acp`` where given, as the
        JAX DDPM scan computes it)."""
        if self.parameterization == "x0":
            return pred
        if self.parameterization == "v":
            return sqrt_acp * x_t - sqrt_om * pred
        if inv_sqrt_acp is not None:
            return (x_t - sqrt_om * pred) * inv_sqrt_acp
        return (x_t - sqrt_om * pred) / sqrt_acp

    def loss_draws(self, batch: int, generator: Optional[torch.Generator], device, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                   bit_uniforms: Optional[torch.Tensor] = None,
                   cfg_uniforms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The draws :meth:`loss` makes for a ``batch``-row batch, in its
        order, from ``generator`` on ``device``; given ones are kept: ``t``
        (B,), ``noise`` (B, D - M), with the D3PM head ``bit_uniforms`` (B,
        M), with condition dropout ``cfg_uniforms`` (B, 1)."""
        M = self.mutation_dim if self.discrete_head else 0
        if t is None:
            t = torch.randint(0, self.schedule.num_steps, (batch,), generator=generator,
                              device=device)
        if noise is None:
            noise = torch.randn((batch, self.denoiser.data_dim - M), generator=generator,
                                device=device)
        out = {"t": t, "noise": noise}
        if M:
            if bit_uniforms is None:
                bit_uniforms = torch.rand((batch, M), generator=generator, device=device)
            out["bit_uniforms"] = bit_uniforms
        if self.cfg_dropout_prob > 0:
            if cfg_uniforms is None:
                cfg_uniforms = torch.rand((batch, 1), generator=generator, device=device)
            out["cfg_uniforms"] = cfg_uniforms
        return out

    def loss(self, x0: torch.Tensor, conditions: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             bit_uniforms: Optional[torch.Tensor] = None,
             cfg_uniforms: Optional[torch.Tensor] = None,
             ar_x0: Optional[torch.Tensor] = None,
             ar_conditions: Optional[torch.Tensor] = None, train: bool = False,
             shard: Optional[BatchShard] = None):
        """(total loss, metrics) on a clean batch ``x0`` (B, D) under
        ``conditions`` (B, C). ``t`` (B,) int, ``noise`` (B, D - M),
        ``bit_uniforms`` (B, M) and ``cfg_uniforms`` (B, 1) (CFG keeps a
        row's conditions where its uniform is >= ``cfg_dropout_prob``)
        replace the draws from ``generator`` (on ``x0``'s device); ``train``
        turns dropout on for this call. ``ar_x0``/``ar_conditions``: the
        rows the AR head's CE reads (the batch before augmentation; default
        ``x0``/``conditions``). The metrics are 0-dim tensors:
        ``diffusion_loss``, ``latent_sq``, ``mutation_ce`` (D3PM head),
        ``ar_ce``, ``sigma_nll``, ``lowrank_sigma_nll``, the four constraint
        terms (with a spec), ``loss`` and ``sel_loss`` (the loss without the
        AR head's terms, which best model, early stopping and the plateau
        schedule follow). With a ``shard``, the rows are this rank's of its
        global batch: every mean and batch statistic is the global batch's
        (all-reduced over the data group), so the loss is the global loss on
        every rank."""
        tables = self._loss_tables(x0.device)
        batch = x0.shape[0]
        M = self.mutation_dim if self.discrete_head else 0
        T = self.schedule.num_steps
        dev = x0.device
        d = self.denoiser
        clin_conditions = conditions
        drawn = self.loss_draws(batch, generator, dev, t=t, noise=noise,
                                bit_uniforms=bit_uniforms, cfg_uniforms=cfg_uniforms)
        t = drawn["t"].to(dev, torch.int64)
        mut0, cont0 = x0[:, :M], x0[:, M:]
        noise = drawn["noise"].to(dev, torch.float32)
        cont_t = self.q_sample(cont0, t, noise)
        if M:
            mut_t = q_sample_bits(mut0, tables.acp[t], generator, drawn["bit_uniforms"])
            x_t = torch.cat([2.0 * mut_t - 1.0, cont_t], dim=1)
        else:
            x_t = cont_t
        t_norm = t.to(torch.float32) / T

        was_training = d.training
        d.train(train)
        try:
            if self.latent_factor_dim > 0:
                # Factors of the clean vector, appended before the CFG
                # dropout so the unconditional score drops them too.
                h = self.encode_latents(x0)
                latent_sq = batch_mean(h * h, shard)
                conditions = torch.cat([conditions, h], dim=1)
            if self.cfg_dropout_prob > 0:
                keep = (drawn["cfg_uniforms"].to(dev) >= self.cfg_dropout_prob).to(
                    conditions.dtype)
                conditions = conditions * keep
            pred = d(x_t, t_norm, conditions=conditions)
        finally:
            d.train(was_training)
        pred, logvar = self._split_sigma(pred)
        mut_logits = pred[:, :M]
        cont_pred = pred[:, M:] if M else pred

        sqrt_acp = tables.sqrt_acp[t][:, None]
        sqrt_om = tables.sqrt_om[t][:, None]
        if self.parameterization == "x0":
            target = cont0
        elif self.parameterization == "v":
            target = sqrt_acp * noise - sqrt_om * cont0
        else:
            target = noise
        err = _elementwise_loss(cont_pred, target, self.loss_type)
        if tables.feature_weights is not None:
            err = err * tables.feature_weights[None, M:]
        mse = batch_mean(err, shard)
        metrics: Dict[str, torch.Tensor] = {"diffusion_loss": mse}
        total = mse
        if self.latent_factor_dim > 0:
            metrics["latent_sq"] = latent_sq
            total = total + 1e-3 * latent_sq
        if M:
            ce = batch_mean(bernoulli_cross_entropy(mut_logits, mut0), shard)
            metrics["mutation_ce"] = ce
            total = total + self.discrete_ce_weight * ce
        ar_term = None
        if self.ar_head and self.mutation_dim > 0:
            Ma = self.mutation_dim
            src = x0 if ar_x0 is None else ar_x0.to(dev)
            cond = clin_conditions if ar_conditions is None else ar_conditions.to(dev)
            logits = d.ar_logits(src[:, :Ma], self._ar_context_view(src[:, Ma:], cond))
            ar_ce = batch_mean(bernoulli_cross_entropy(logits, src[:, :Ma]), shard)
            metrics["ar_ce"] = ar_ce
            ar_term = self.ar_ce_weight * ar_ce
            if self.ar_l2 > 0:
                ar_term = ar_term + self.ar_l2 * torch.sum(torch.tril(d.ar_coupling, -1) ** 2)
            if self.ar_ctx_l2 > 0:
                ar_term = ar_term + self.ar_ctx_l2 * (
                    torch.sum(d.ar_ctx_fc1.weight ** 2) + torch.sum(d.ar_ctx_fc2.weight ** 2))
            total = total + ar_term

        x0_pred = cont_x0_pred = None
        if self.constraint_spec is not None or logvar is not None or self.low_rank_sigma_dim:
            cont_x0_pred = self._predict_x0(cont_pred, cont_t, sqrt_acp, sqrt_om)
            x0_pred = (torch.cat([torch.sigmoid(mut_logits), cont_x0_pred], dim=1) if M
                       else cont_x0_pred)
        if logvar is not None:
            # Gaussian NLL of the x0 residual against a detached mean.
            logvar_c = logvar[:, M:]
            resid = cont0 - cont_x0_pred.detach()
            nll = 0.5 * batch_mean(logvar_c + resid**2 * torch.exp(-logvar_c), shard)
            metrics["sigma_nll"] = nll
            total = total + self.sigma_loss_weight * nll
        if self.low_rank_sigma_dim:
            # Woodbury NLL under s(t)^2 (diag(d) + U U^T), detached mean;
            # logged per feature, added at the joint scale.
            U, logdiag, logs = self._lowrank_params()
            k = self.low_rank_sigma_dim
            Uc = U[M:] if M else U
            dg = torch.exp(logdiag[M:] if M else logdiag)
            resid = cont0 - cont_x0_pred.detach()
            r = resid / torch.exp(logs[t])[:, None]
            w = r / dg
            p = w @ Uc
            cap = torch.eye(k, device=dev) + (Uc / dg[:, None]).T @ Uc
            chol = torch.linalg.cholesky(cap)
            sol = torch.cholesky_solve(p.T, chol).T
            quad = torch.sum(r * w, dim=1) - torch.sum(p * sol, dim=1)
            Dc = r.shape[1]
            logdet = (torch.sum(torch.log(dg)) + 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
                      + 2.0 * Dc * logs[t])
            nll = 0.5 * batch_mean(logdet + quad, shard)
            metrics["lowrank_sigma_nll"] = nll / Dc
            total = total + self.low_rank_sigma_weight * nll
        if self.constraint_spec is not None:
            terms = constraint_losses(x0_pred, self.constraint_spec, tables.spec, shard)
            metrics.update(terms)
            total = (total
                     + self.pathway_coherence_weight * terms["pathway_coherence"]
                     + self.mutation_expression_weight * terms["mutation_expression"]
                     + self.mutual_exclusivity_weight * terms["mutual_exclusivity"]
                     + self.cooccurrence_weight * terms["cooccurrence"])
        metrics["loss"] = total
        metrics["sel_loss"] = total if ar_term is None else total - ar_term
        return total, metrics

    # ------------------------------------------------------------------
    def _int8_weights(self, quantize: str, device) -> Dict[str, List[tuple]]:
        """int8 parts of the products ``quantize`` marks, by module name
        (the decoders' fc1 split at [h | skip])."""
        d = self.denoiser
        q_in, q_blk, q_out = quant_flags(quantize)
        out = {}

        def pack(name, splits=None):
            w = d.get_submodule(name).weight.detach().float().cpu().T
            out[name] = int8_parts(w, device, splits)

        if q_in:
            pack("input_proj")
        if q_out:
            pack("output_proj")
        if q_blk:
            widths = []
            for name in d.encoder_names + ["bottleneck"]:
                pack(f"{name}.fc1")
                pack(f"{name}.fc2")
                widths.append(d.get_submodule(f"{name}.fc2").out_features)
            prev = widths.pop()
            for name in d.decoder_names:
                pack(f"{name}.fc1", [prev, widths.pop()])
                pack(f"{name}.fc2")
                prev = d.get_submodule(f"{name}.fc2").out_features
        return out

    def _denoise(self, x_in, t_norm, c_proj, int8: Optional[Dict[str, List[tuple]]]):
        """The denoiser's x0 prediction; with ``int8`` its marked products
        run through the plain int8 product on f32 activations."""
        d = self.denoiser
        if int8 is None:
            return d(x_in, t_norm, c_proj=c_proj)

        def dense(name, h):
            mod = d.get_submodule(name)
            if name in int8:
                return _int8_product(h.float(), int8[name], mod.bias)
            return mod(h).float()

        def block(name, h):
            blk = d.get_submodule(name)
            h = F.silu(blk.norm1(dense(f"{name}.fc1", h)))
            return F.silu(blk.norm2(dense(f"{name}.fc2", h)))

        t_sin = sinusoid(t_norm, d.time_dim)
        h = dense("input_proj", x_in) + d.time_proj(t_sin).float() + c_proj.float()
        skips = []
        for name in d.encoder_names:
            h = block(name, h)
            skips.append(h)
        h = block("bottleneck", h)
        for name in d.decoder_names:
            h = block(name, torch.cat([h, skips.pop()], dim=-1))
        return dense("output_proj", h) + d.skip_gain(t_sin) * x_in

    def _loop(self, conditions, generator, ddim_steps, x_init, noise,
              bit_uniforms=None, quantize=None) -> torch.Tensor:
        if not supports_fused(self):
            raise ValueError("the kernel sampler's plain loop does not take this model; "
                             "use scan_sample / scan_sample_ddim")
        d = self.denoiser
        dev = next(d.parameters()).device
        T = self.schedule.num_steps
        M = self.mutation_dim if self.discrete_head else 0
        ts = reverse_timesteps(T, ddim_steps)
        table = torch.from_numpy(coefficient_table(self.schedule, np.zeros(len(ts)), ddim_steps,
                                                   M > 0))
        int8 = self._int8_weights(quantize, dev) if quantize else None
        batch = conditions.shape[0]
        shape = (batch, d.data_dim)
        if x_init is None:
            x_init = x_prior(batch, d.data_dim, M, generator)
        x = x_init.to(dev, torch.bfloat16)
        c_proj = d.embed_conditions(conditions.to(dev, torch.float32))
        for s, t in enumerate(ts):
            xf = x.float()
            x_in = mutation_transform(xf, M)
            pred = self._denoise(x_in, torch.full((batch,), t / T, device=dev), c_proj, int8)
            x0 = torch.clamp(pred, -self.clip_value, self.clip_value)
            c0, c1, sv = (float(v) for v in table[s, :3])
            xn = c0 * x0 + c1 * xf
            if sv or (M and ddim_steps is None):
                if noise is not None:
                    z = noise[s].to(dev, torch.float32)
                    u = z * (1.0 / (2.0 * math.sqrt(3.0))) + 0.5
                else:
                    u = torch.rand(shape, generator=generator, device=generator.device).to(dev)
                    z = (u - 0.5) * (2.0 * math.sqrt(3.0))
                xn = xn + sv * z
            if M:
                if ddim_steps is None:
                    u = u[:, :M]
                elif bit_uniforms is not None:
                    u = bit_uniforms[s].to(dev, torch.float32)
                else:
                    u = torch.rand((batch, M), generator=generator,
                                   device=generator.device).to(dev)
                beta, acp_prev = table[s, 4].to(dev), table[s, 5].to(dev)
                p_prev = posterior_prob_one(xf[:, :M], torch.sigmoid(pred[:, :M]), beta, acp_prev)
                xn[:, :M] = (u < p_prev).float()
            x = xn.to(torch.bfloat16)
        return x.float()

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: torch.Generator,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               quantize: Optional[str] = None) -> torch.Tensor:
        """DDPM over all T steps. ``noise`` (T, B, D) replaces the
        uniform draws from ``generator`` (its mutation columns give the
        bit uniforms z/(2sqrt3) + 1/2); ``x_init`` replaces x_T."""
        return self._loop(conditions, generator, None, x_init, noise, quantize=quantize)

    @torch.no_grad()
    def sample_ddim(self, conditions: torch.Tensor, generator: torch.Generator,
                    num_sampling_steps: int = 50,
                    x_init: Optional[torch.Tensor] = None,
                    bit_uniforms: Optional[torch.Tensor] = None,
                    quantize: Optional[str] = None) -> torch.Tensor:
        """Deterministic (eta = 0) DDIM over ``num_sampling_steps``
        strided timesteps. With the D3PM head the bits still draw one
        uniform per step and mutation column: ``bit_uniforms``
        (n_steps, B, M) replaces the draws from ``generator``."""
        return self._loop(conditions, generator, num_sampling_steps, x_init, None,
                          bit_uniforms, quantize)

    # ------------------------------------------------------------------
    # The scan samplers (the JAX package's lax.scan samplers)
    # ------------------------------------------------------------------
    def _denoise_fn(self, conditions: torch.Tensor, guidance_scale: float) -> Callable:
        """The per-step denoiser with the condition projection hoisted; CFG
        runs the conditional and the unconditional pass as one doubled
        batch and guides the prediction only (a learned log-variance is
        the conditional branch's)."""
        d = self.denoiser
        c_proj = d.embed_conditions(conditions)
        if guidance_scale == 1.0:
            return lambda x, t: d(x, t, c_proj=c_proj)
        both = torch.cat([c_proj, d.embed_conditions(torch.zeros_like(conditions))])
        D = d.data_dim

        def denoise_cfg(x, t):
            cond, uncond = d(torch.cat([x, x]), torch.cat([t, t]), c_proj=both).chunk(2)
            if self.learn_sigma:
                mean_u = uncond[:, :D]
                return torch.cat([mean_u + guidance_scale * (cond[:, :D] - mean_u), cond[:, D:]],
                                 dim=-1)
            return uncond + guidance_scale * (cond - uncond)

        return denoise_cfg

    def _x_prior(self, draw: _Draws, batch: int, M: int, dtype) -> torch.Tensor:
        """x_T (``draws["x_T"]``, (B, D)): Gaussian in ``dtype``, with
        Bernoulli(1/2) bits on the first M columns."""
        if "x_T" in draw.given:
            return draw.take(draw.given["x_T"].to(draw.device, dtype))
        x = draw("x_T", "normal", (batch, self.denoiser.data_dim - M), dtype)
        if not M:
            return x
        bits = (draw("x_T_bits", "unit", (batch, M)) < 0.5).to(dtype)
        return torch.cat([bits, x], dim=1)

    def _clip(self, x0: torch.Tensor) -> torch.Tensor:
        if self.clip_denoised:
            return torch.clamp(x0, -self.clip_value, self.clip_value)
        return x0

    @torch.no_grad()
    def scan_sample(self, conditions: torch.Tensor, generator: Optional[torch.Generator] = None,
                    guidance_scale: float = 1.0,
                    draws: Optional[Mapping[str, torch.Tensor]] = None,
                    rows: Optional[RowBlock] = None) -> torch.Tensor:
        """Ancestral DDPM over all T steps, as JAX ``sample`` (:752-937): steps
        T-1 .. 1 in a loop with transition noise, then t = 0 outside it
        (the clipped x0 prediction, plus learned sigma's residual or low-rank
        sigma's draw, and the D3PM bits from the predicted x0). The carry is
        stored in ``sample_dtype`` and each step's arithmetic runs in f32
        (one rounding of the carry a step, as in the kernel sampler); the
        step noise is ``noise_type`` (uniform U(-sqrt3, sqrt3), else
        normal), drawn in the carry dtype. Returns (B, D) float32 on the
        denoiser's device.

        ``draws`` replaces draws from ``generator``: "x_T" (B, D); per loop
        step s (rows in reverse-time order, T - 1 of them) "z" (T-1, B, D-M),
        "lr_eps" (T-1, B, D-M) and "lr_epsk" (T-1, B, k) (low-rank sigma),
        "bits" (T-1, B, M) (D3PM uniforms); at t = 0 "final_z" (B, D-M)
        (learned sigma), "final_lr_eps" and "final_lr_epsk", "final_bits"
        (B, M).

        ``rows``: sample only that block of the cohort (the rank's rows of a
        sharded generator); every draw is the whole cohort's, so the block
        equals those rows of the unsharded cohort."""
        d = self.denoiser
        dev = next(d.parameters()).device
        sched = self.schedule
        T = sched.num_steps
        M = self.mutation_dim if self.discrete_head else 0
        cd = DTYPES[self.sample_dtype]
        if rows is not None:
            conditions = rows.take(conditions)
        batch = conditions.shape[0]
        Dc = d.data_dim - M
        draw = _Draws(draws, generator, dev, rows)
        x = self._x_prior(draw, batch, M, cd)
        denoise = self._denoise_fn(conditions.to(dev, torch.float32), guidance_scale)

        ts = np.arange(T - 1, 0, -1)

        def f32(a):
            return np.asarray(a, np.float32)

        sqrt_acp = f32(sched.sqrt_alphas_cumprod)
        sqrt_om = f32(sched.sqrt_one_minus_alphas_cumprod)
        inv_sqrt_acp = np.float32(1.0) / sqrt_acp
        rows = np.stack([sqrt_acp[ts], inv_sqrt_acp[ts], sqrt_om[ts],
                         f32(sched.posterior_coef_x0)[ts], f32(sched.posterior_coef_xt)[ts],
                         np.sqrt(f32(sched.posterior_variance)[ts]),
                         f32(sched.betas)[ts], f32(sched.alphas_cumprod)[ts - 1]], axis=1)
        t_norm = ts.astype(np.float32) / np.float32(T)
        LR = self.low_rank_sigma_dim
        if LR:
            U, logdiag, logs = self._lowrank_params()
            Uc = U[M:] if M else U
            dsqrt = torch.exp(0.5 * (logdiag[M:] if M else logdiag))
            lr_scale = f32(sched.posterior_coef_x0)[ts] * torch.exp(logs).cpu().numpy()[ts]

        def predict_x0(xc, pred, sa, isa, so):
            return self._clip(self._predict_x0(pred, xc, float(sa), float(so), float(isa)))

        def split(x):
            if not M:
                return None, x, x
            xm, xc = x[:, :M], x[:, M:]
            return xm, xc, torch.cat([2.0 * xm - 1.0, xc], dim=1)

        for s in range(len(ts)):
            sa, isa, so, c0, c1, sv, beta, acp_prev = rows[s]
            xm, xc, x_in = split(x.float())
            pred, _ = self._split_sigma(denoise(x_in, torch.full((batch,), t_norm[s], device=dev)))
            x0 = predict_x0(xc, pred[:, M:], sa, isa, so)
            z = draw("z", "uniform" if self.noise_type == "uniform" else "normal",
                     (batch, Dc), cd, step=s)
            xc = float(c0) * x0 + float(c1) * xc + float(sv) * z.float()
            if LR:
                eps = draw("lr_eps", "normal", (batch, Dc), step=s)
                epsk = draw("lr_epsk", "normal", (batch, LR), step=s)
                xc = xc + float(lr_scale[s]) * (dsqrt * eps + epsk @ Uc.T)
            if M:
                p_prev = posterior_prob_one(xm, torch.sigmoid(pred[:, :M]),
                                            _scalar(beta), _scalar(acp_prev))
                u = draw("bits", "unit", (batch, M), step=s)
                xc = torch.cat([(u < p_prev).float(), xc], dim=1)
            x = xc.to(cd)

        xm, xc, x_in = split(x.float())
        pred, logvar = self._split_sigma(denoise(x_in, torch.zeros(batch, device=dev)))
        x0 = predict_x0(xc, pred[:, M:], sqrt_acp[0], inv_sqrt_acp[0], sqrt_om[0])
        if logvar is not None:
            z = draw("final_z", "normal", (batch, Dc))
            x0 = x0 + torch.exp(0.5 * logvar[:, M:]) * z
        if LR:
            eps = draw("final_lr_eps", "normal", (batch, Dc))
            epsk = draw("final_lr_epsk", "normal", (batch, LR))
            x0 = x0 + torch.exp(logs[0]) * (dsqrt * eps + epsk @ Uc.T)
        if M:
            u = draw("final_bits", "unit", (batch, M))
            bits = (u < torch.sigmoid(pred[:, :M])).float()
            x0 = torch.cat([bits, x0], dim=1)
        return x0

    @torch.no_grad()
    def scan_sample_ddim(self, conditions: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         num_sampling_steps: int = 50, guidance_scale: float = 1.0,
                         draws: Optional[Mapping[str, torch.Tensor]] = None,
                         rows: Optional[RowBlock] = None) -> torch.Tensor:
        """Deterministic (eta = 0) DDIM over ``num_sampling_steps`` strided
        timesteps, as JAX ``sample_ddim`` (:942-1063): an f32 carry, x0 from
        the parameterization (clipped when ``clip_denoised``), eps consistent
        with it, learned sigma's residual on the last step only, and the
        D3PM bits over the same strided steps. ``draws``: "x_T" (B, D),
        "final_z" (B, D-M) (learned sigma), "bits" (n_steps, B, M); ``rows``
        as in :meth:`scan_sample`."""
        return self.ddim_chain(conditions, generator, num_sampling_steps, guidance_scale, draws,
                               rows)

    def ddim_chain(self, conditions: torch.Tensor, generator: Optional[torch.Generator] = None,
                   num_sampling_steps: int = 50, guidance_scale: float = 1.0,
                   draws: Optional[Mapping[str, torch.Tensor]] = None,
                   rows: Optional[RowBlock] = None) -> torch.Tensor:
        """:meth:`scan_sample_ddim` with autograd on: the chain that
        sample-path fine-tuning differentiates through, as JAX differentiates
        through ``sample_ddim``'s ``lax.scan`` (training/finetune.py:84-98
        there). The denoiser runs in the mode its caller set. The x0 clip is
        ``torch.clamp``, whose gradient at the bound itself is 1 where
        ``jnp.clip``'s is 1/2."""
        d = self.denoiser
        dev = next(d.parameters()).device
        T = self.schedule.num_steps
        M = self.mutation_dim if self.discrete_head else 0
        if rows is not None:
            conditions = rows.take(conditions)
        batch = conditions.shape[0]
        Dc = d.data_dim - M
        draw = _Draws(draws, generator, dev, rows)
        x = self._x_prior(draw, batch, M, torch.float32)
        denoise = self._denoise_fn(conditions.to(dev, torch.float32), guidance_scale)

        ts = ddim_timesteps(T, num_sampling_steps)[::-1].copy()
        prev = np.concatenate([ts[1:], [-1]])
        acp = np.asarray(self.schedule.alphas_cumprod, np.float32)
        acp_t = acp[ts]
        acp_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], np.float32(1.0))
        one = np.float32(1.0)
        rows = np.stack([np.sqrt(acp_t), np.sqrt(one - acp_t), np.sqrt(acp_prev),
                         np.sqrt(np.maximum(one - acp_prev, np.float32(0.0))),
                         one - acp_t / acp_prev, acp_prev], axis=1).astype(np.float32)
        t_norm = ts.astype(np.float32) / np.float32(T)
        for s in range(len(ts)):
            sa, so, sap, dir_coef, beta_eff, a_prev = (float(v) for v in rows[s])
            xm, xc = (x[:, :M], x[:, M:]) if M else (None, x)
            x_in = torch.cat([2.0 * xm - 1.0, xc], dim=1) if M else x
            pred, logvar = self._split_sigma(
                denoise(x_in, torch.full((batch,), t_norm[s], device=dev)))
            x0 = self._clip(self._predict_x0(pred[:, M:], xc, sa, so))
            eps = (xc - sa * x0) / max(so, 1e-8)
            x_prev = sap * x0 + dir_coef * eps
            if logvar is not None and s == len(ts) - 1:
                z = draw("final_z", "normal", (batch, Dc))
                x_prev = x_prev + torch.exp(0.5 * logvar[:, M:]) * z
            if M:
                p_prev = posterior_prob_one(xm, torch.sigmoid(pred[:, :M]),
                                            _scalar(beta_eff), _scalar(a_prev))
                u = draw("bits", "unit", (batch, M), step=s)
                x_prev = torch.cat([(u < p_prev).float(), x_prev], dim=1)
            x = x_prev
        return x


def _scalar(value) -> torch.Tensor:
    """An f32 table entry as a 0-dim f32 tensor, so the D3PM posterior's
    arithmetic on it stays in f32 as in the JAX scan."""
    return torch.tensor(float(value), dtype=torch.float32)
