"""Conditional DDPM over the flat patient vector (the slice's model).

Counterpart of osteosarcoma_diffusionmodel_tpu/models/diffusion.py
`ConditionalDiffusion` for the configuration on the main path: x0
parameterization, predicted x0 clipped to +-30, uniform U(-sqrt3, sqrt3)
in-loop noise (`_step_noise`, :451), a bf16 carry, DDPM (`sample`, :752)
and eta = 0 DDIM (`sample_ddim`, :942).

:meth:`ConditionalDiffusion.sample` and :meth:`sample_ddim` are plain
PyTorch loops over the ``nn.Module`` denoiser: the plain version of the
whole kernel sampler (``ops/fused_sampler.py``), with the same tables,
the same bf16 carry (f32 arithmetic, one bf16 rounding per step) and the
same ``x_init``/``noise`` seams. Other configurations raise
NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import Config, FrozenDims
from ..ops.fused_sampler import coefficient_table, reverse_timesteps
from ..ops.schedules import DiffusionSchedule
from .networks import DiffusionDenoiser

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not implemented in the PyTorch port yet (ROADMAP.md, "
        "'Modules to port'); use the JAX package for it"
    )


def check_supported(config: Config, dims: FrozenDims) -> None:
    """Raise for every configuration outside the slice the port implements."""
    mc, dc, gen = config.model, config.model.diffusion, config.generation
    if mc.architecture != "diffusion":
        raise _unsupported(f"architecture {mc.architecture!r}")
    if dc.parameterization != "x0":
        raise _unsupported(f"parameterization {dc.parameterization!r}")
    checks = [
        (dc.learn_sigma, "learned sigma"),
        (dc.low_rank_sigma_dim > 0, "low-rank sigma"),
        (dc.latent_factor_dim > 0, "latent-factor conditioning"),
        (dc.discrete_mutation_head and dims.mutation_dim > 0, "the D3PM mutation head"),
        (dc.ar_mutation_head and dims.mutation_dim > 0, "the AR mutation head"),
        (mc.cfg_dropout_prob > 0, "classifier-free guidance"),
        (not dc.clip_denoised, "sampling without the x0 clip"),
        (not mc.denoiser_input_skip, "a denoiser without the input skip"),
        (gen.noise_type != "uniform", f"noise_type {gen.noise_type!r}"),
        (gen.sampler not in ("ddpm", "ddim"), f"sampler {gen.sampler!r}"),
        (gen.sample_dtype != "bfloat16", f"a {gen.sample_dtype!r} sampler carry"),
        (gen.fused_quantize not in ("none", None),
         f"the {gen.fused_quantize!r} quantized sampler"),
    ]
    for bad, what in checks:
        if bad:
            raise _unsupported(what)
    if mc.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {mc.compute_dtype!r}")


@dataclass
class ConditionalDiffusion:
    denoiser: DiffusionDenoiser
    schedule: DiffusionSchedule
    clip_value: float = 30.0

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
        return ConditionalDiffusion(denoiser, schedule, float(mc.diffusion.denoised_clip_value))

    # ------------------------------------------------------------------
    def _loop(self, conditions, generator, ddim_steps, x_init, noise) -> torch.Tensor:
        d = self.denoiser
        dev = next(d.parameters()).device
        T = self.schedule.num_steps
        ts = reverse_timesteps(T, ddim_steps)
        table = coefficient_table(self.schedule, torch.zeros(len(ts)).numpy(), ddim_steps)
        batch = conditions.shape[0]
        shape = (batch, d.data_dim)
        if x_init is None:
            x_init = torch.randn(shape, generator=generator, device=generator.device)
        x = x_init.to(dev, torch.bfloat16)
        c_proj = d.embed_conditions(conditions.to(dev, torch.float32))
        for s, t in enumerate(ts):
            pred = d(x.float(), torch.full((batch,), t / T, device=dev), c_proj=c_proj)
            x0 = torch.clamp(pred, -self.clip_value, self.clip_value)
            c0, c1, sv = (float(v) for v in table[s, :3])
            xn = c0 * x0 + c1 * x.float()
            if sv:
                if noise is not None:
                    z = noise[s].to(dev, torch.float32)
                else:
                    u = torch.rand(shape, generator=generator, device=generator.device)
                    z = (u.to(dev) - 0.5) * (2.0 * math.sqrt(3.0))
                xn = xn + sv * z
            x = xn.to(torch.bfloat16)
        return x.float()

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: torch.Generator,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDPM over all T steps. ``noise`` (T, B, D) replaces the
        uniform draws from ``generator``; ``x_init`` replaces x_T."""
        return self._loop(conditions, generator, None, x_init, noise)

    @torch.no_grad()
    def sample_ddim(self, conditions: torch.Tensor, generator: torch.Generator,
                    num_sampling_steps: int = 50,
                    x_init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic (eta = 0) DDIM over ``num_sampling_steps``
        strided timesteps."""
        return self._loop(conditions, generator, num_sampling_steps, x_init, None)
