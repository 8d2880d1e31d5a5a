"""Conditional DDPM over the flat patient vector (the slice's model).

Counterpart of osteosarcoma_diffusionmodel_tpu/models/diffusion.py
`ConditionalDiffusion` for the configurations the port samples: x0
parameterization, predicted x0 clipped to +-30, uniform U(-sqrt3, sqrt3)
in-loop noise (`_step_noise`, :451), a bf16 carry, DDPM (`sample`, :752)
and eta = 0 DDIM (`sample_ddim`, :942), with or without the binary D3PM
mutation head (`discrete_head`, :151, :308-311).

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
from ..ops.discrete import posterior_prob_one
from ..ops.fused_sampler import (
    coefficient_table,
    int8_parts,
    quant_flags,
    reverse_timesteps,
    x_prior,
)
from ..ops.sampler_kernels import gemm_s8_plain, mutation_transform, rowquant_s8_plain
from ..ops.schedules import DiffusionSchedule
from .networks import DiffusionDenoiser, sinusoid

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUANTIZE_MODES = ("none", "out", "io", "all")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not implemented in the PyTorch port yet (ROADMAP.md, "
        "'Modules to port'); use the JAX package for it"
    )


def check_supported(config: Config, dims: FrozenDims) -> None:
    """Raise for every configuration outside the slice the port implements,
    and ValueError for an unknown ``generation.fused_quantize``."""
    mc, dc, gen = config.model, config.model.diffusion, config.generation
    if gen.fused_quantize not in QUANTIZE_MODES + (None,):
        raise ValueError(f"generation.fused_quantize must be one of {QUANTIZE_MODES}, "
                         f"got {gen.fused_quantize!r}")
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


@dataclass
class ConditionalDiffusion:
    denoiser: DiffusionDenoiser
    schedule: DiffusionSchedule
    clip_value: float = 30.0
    discrete_head: bool = False
    mutation_dim: int = 0

    @staticmethod
    def from_config(config: Config, dims: FrozenDims) -> "ConditionalDiffusion":
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
        )
        schedule = DiffusionSchedule.create(mc.diffusion.beta_schedule, mc.diffusion.num_steps)
        return ConditionalDiffusion(
            denoiser, schedule, float(mc.diffusion.denoised_clip_value),
            discrete_head=bool(mc.diffusion.discrete_mutation_head and dims.mutation_dim > 0),
            mutation_dim=dims.mutation_dim,
        )

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
