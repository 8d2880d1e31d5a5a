"""Conditional DDPM over the flat patient vector (the slice's model).

Counterpart of osteosarcoma_diffusionmodel_tpu/models/diffusion.py
`ConditionalDiffusion` for the configurations the port trains and
samples: x0 parameterization, predicted x0 clipped to +-30, uniform
U(-sqrt3, sqrt3) in-loop noise (`_step_noise`, :451), a bf16 carry, DDPM
(`sample`, :752) and eta = 0 DDIM (`sample_ddim`, :942), with or without
the binary D3PM mutation head (`discrete_head`, :151, :308-311).

:meth:`ConditionalDiffusion.loss` is the training objective (`loss`,
:481-705): the l1/l2/huber x0 loss on the continuous block (optionally
block-balanced), the D3PM head's BCE on the mutation bits, and the four
constraint losses on the predicted x0. Its random draws (t, the Gaussian
noise, the bit-flip uniforms) come from a ``torch.Generator`` or are
passed in, so a test can feed it the JAX key's draws.

:meth:`ConditionalDiffusion.sample` and :meth:`sample_ddim` are plain
PyTorch loops over the ``nn.Module`` denoiser: the plain version of the
whole kernel sampler (``ops/fused_sampler.py``), with the same tables,
the same bf16 carry (f32 arithmetic, one bf16 rounding per step), the
same D3PM algebra (denoiser input 2b - 1 on the mutation columns, the
clip on the continuous columns only, bits drawn from the step's
uniforms) and the same ``x_init``/``noise`` seams. ``quantize`` routes
the products that the mode marks through the plain versions of K5/K6,
the TPU's int8 ``mm`` (:327-350). Other configurations raise
NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

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
    x_prior,
)
from ..ops.sampler_kernels import gemm_s8_plain, mutation_transform, rowquant_s8_plain
from ..ops.schedules import DiffusionSchedule
from .constraints import ConstraintSpec, SpecTensors, constraint_losses
from .networks import DiffusionDenoiser, sinusoid

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUANTIZE_MODES = ("none", "out", "io", "all")
LOSS_TYPES = ("l1", "l2", "huber")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not implemented in the PyTorch port yet (ROADMAP.md, "
        "'Modules to port'); use the JAX package for it"
    )


def check_supported(config: Config, dims: FrozenDims, training: bool = False) -> None:
    """Raise for every configuration outside the slice the port implements,
    and ValueError for an unknown ``generation.fused_quantize``, loss type
    or block weighting. ``training`` adds the training section's checks."""
    mc, dc, gen = config.model, config.model.diffusion, config.generation
    if gen.fused_quantize not in QUANTIZE_MODES + (None,):
        raise ValueError(f"generation.fused_quantize must be one of {QUANTIZE_MODES}, "
                         f"got {gen.fused_quantize!r}")
    if dc.loss_type not in LOSS_TYPES:
        raise ValueError(f"Unknown loss_type: {dc.loss_type}")
    if dc.block_loss_weighting not in ("balanced", "none"):
        raise ValueError(f"unknown block_loss_weighting {dc.block_loss_weighting!r}")
    if training:
        tc = config.training
        aug = tc.augmentation
        for bad, what in [
            (aug.cross_cancer_pretrain and bool(aug.pretrain_datasets),
             "cross-cancer pretraining"),
            (tc.sample_path_finetune.enabled, "sample-path fine-tuning"),
            ((tc.num_devices or 1) > 1, "data-parallel training over several devices"),
        ]:
            if bad:
                raise _unsupported(what)
    if mc.architecture != "diffusion":
        raise _unsupported(f"architecture {mc.architecture!r}")
    if dc.parameterization != "x0":
        raise _unsupported(f"parameterization {dc.parameterization!r}")
    checks = [
        (dc.learn_sigma, "learned sigma"),
        (dc.low_rank_sigma_dim > 0, "low-rank sigma"),
        (dc.latent_factor_dim > 0, "latent-factor conditioning"),
        (dc.ar_mutation_head and dims.mutation_dim > 0, "the AR mutation head"),
        (mc.cfg_dropout_prob > 0, "classifier-free guidance"),
        (not dc.clip_denoised, "sampling without the x0 clip"),
        (not mc.denoiser_input_skip, "a denoiser without the input skip"),
        (gen.noise_type != "uniform", f"noise_type {gen.noise_type!r}"),
        (gen.sampler not in ("ddpm", "ddim"), f"sampler {gen.sampler!r}"),
        (gen.sample_dtype != "bfloat16", f"a {gen.sample_dtype!r} sampler carry"),
    ]
    for bad, what in checks:
        if bad:
            raise _unsupported(what)
    if mc.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {mc.compute_dtype!r}")


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

    @staticmethod
    def from_config(config: Config, dims: FrozenDims,
                    constraint_spec: Optional[ConstraintSpec] = None) -> "ConditionalDiffusion":
        """The model of ``config``; its denoiser is in eval mode (no
        dropout), the mode every sampler runs it in."""
        check_supported(config, dims)
        mc = config.model
        denoiser = DiffusionDenoiser(
            data_dim=dims.data_dim,
            condition_dim=dims.condition_dim,
            time_dim=mc.latent_dim,
            condition_embed_dim=mc.latent_dim // 2,
            hidden_dims=tuple(mc.hidden_dims),
            compute_dtype=_DTYPES[mc.compute_dtype],
            input_skip=mc.denoiser_input_skip,
            dropout=mc.gnn.dropout,
        ).eval()
        schedule = DiffusionSchedule.create(mc.diffusion.beta_schedule, mc.diffusion.num_steps)
        feature_weights = None
        if mc.diffusion.block_loss_weighting == "balanced":
            blocks = [dims.mutation_dim, dims.expression_dim, dims.pathway_dim]
            feature_weights = np.concatenate([
                np.full(b, dims.data_dim / (len(blocks) * b), np.float32) for b in blocks if b > 0
            ])
        cc = mc.constraints
        use_constraints = cc.enabled and constraint_spec is not None

        def weight(w):
            return float(w) if use_constraints else 0.0

        return ConditionalDiffusion(
            denoiser, schedule, float(mc.diffusion.denoised_clip_value),
            discrete_head=bool(mc.diffusion.discrete_mutation_head and dims.mutation_dim > 0),
            mutation_dim=dims.mutation_dim,
            loss_type=mc.diffusion.loss_type,
            discrete_ce_weight=float(mc.diffusion.discrete_ce_weight),
            feature_loss_weights=feature_weights,
            constraint_spec=constraint_spec if use_constraints else None,
            pathway_coherence_weight=weight(cc.pathway_coherence_weight),
            mutation_expression_weight=weight(cc.mutation_expression_weight),
            mutual_exclusivity_weight=weight(cc.gene_network_weight),
            cooccurrence_weight=weight(cc.cooccurrence_weight),
        )

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _loss_tables(self, device: torch.device) -> _LossTables:
        cached = getattr(self, "_tables", None)
        if cached is None or cached.sqrt_acp.device != device:
            sch = self.schedule

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            cached = _LossTables(
                f32(sch.sqrt_alphas_cumprod), f32(sch.sqrt_one_minus_alphas_cumprod),
                f32(sch.alphas_cumprod),
                None if self.feature_loss_weights is None else f32(self.feature_loss_weights),
                None if self.constraint_spec is None else self.constraint_spec.tensors(device),
            )
            self._tables = cached
        return cached

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) in closed form."""
        tables = self._loss_tables(x0.device)
        return tables.sqrt_acp[t][:, None] * x0 + tables.sqrt_om[t][:, None] * noise

    def loss(self, x0: torch.Tensor, conditions: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             bit_uniforms: Optional[torch.Tensor] = None, train: bool = False):
        """(total loss, metrics) on a clean batch ``x0`` (B, D) under
        ``conditions`` (B, C). ``t`` (B,) int, ``noise`` (B, D - M) and
        ``bit_uniforms`` (B, M) replace the draws from ``generator``
        (on ``x0``'s device); ``train`` turns dropout on for this call.
        The metrics are 0-dim tensors: ``diffusion_loss``, ``mutation_ce``
        (D3PM head), the four constraint terms (with a spec), ``loss``
        and ``sel_loss`` (the selection loss; equal to ``loss`` here, as
        the port has no AR head)."""
        tables = self._loss_tables(x0.device)
        batch = x0.shape[0]
        M = self.mutation_dim if self.discrete_head else 0
        T = self.schedule.num_steps
        dev = x0.device
        if t is None:
            t = torch.randint(0, T, (batch,), generator=generator, device=dev)
        t = t.to(dev, torch.int64)
        mut0, cont0 = x0[:, :M], x0[:, M:]
        if noise is None:
            noise = torch.randn(cont0.shape, generator=generator, device=dev)
        cont_t = self.q_sample(cont0, t, noise.to(dev, torch.float32))
        if M:
            mut_t = q_sample_bits(mut0, tables.acp[t], generator, bit_uniforms)
            x_t = torch.cat([2.0 * mut_t - 1.0, cont_t], dim=1)
        else:
            x_t = cont_t
        t_norm = t.to(torch.float32) / T

        d = self.denoiser
        was_training = d.training
        d.train(train)
        try:
            pred = d(x_t, t_norm, conditions=conditions)
        finally:
            d.train(was_training)
        mut_logits = pred[:, :M]
        cont_pred = pred[:, M:] if M else pred

        err = _elementwise_loss(cont_pred, cont0, self.loss_type)
        if tables.feature_weights is not None:
            err = err * tables.feature_weights[None, M:]
        mse = err.mean()
        metrics: Dict[str, torch.Tensor] = {"diffusion_loss": mse}
        total = mse
        if M:
            ce = bernoulli_cross_entropy(mut_logits, mut0).mean()
            metrics["mutation_ce"] = ce
            total = total + self.discrete_ce_weight * ce
        if self.constraint_spec is not None:
            # x0 parameterization: the continuous prediction is x0.
            x0_pred = torch.cat([torch.sigmoid(mut_logits), cont_pred], dim=1) if M else cont_pred
            terms = constraint_losses(x0_pred, self.constraint_spec, tables.spec)
            metrics.update(terms)
            total = (total
                     + self.pathway_coherence_weight * terms["pathway_coherence"]
                     + self.mutation_expression_weight * terms["mutation_expression"]
                     + self.mutual_exclusivity_weight * terms["mutual_exclusivity"]
                     + self.cooccurrence_weight * terms["cooccurrence"])
        metrics["loss"] = total
        metrics["sel_loss"] = total
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
