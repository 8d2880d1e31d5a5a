"""Diffusion noise schedules, precomputed on the host in float64.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/schedules.py: the same
linear, cosine and sigmoid betas, posterior tables and DDIM timesteps.
The tables are host-side constants (the sampler turns the rows it needs
into one small f32 device table), so they are numpy float64 here; the
JAX package computes the same formulas in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def linear_beta_schedule(num_steps: int) -> np.ndarray:
    return np.linspace(1e-4, 0.02, num_steps, dtype=np.float64)


def cosine_beta_schedule(num_steps: int) -> np.ndarray:
    steps = np.arange(num_steps + 1, dtype=np.float64) / num_steps
    alphas_cumprod = np.cos((steps + 0.008) / 1.008 * np.pi / 2) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0001, 0.9999)


def sigmoid_beta_schedule(num_steps: int) -> np.ndarray:
    x = np.linspace(-6.0, 6.0, num_steps, dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-x)) * (0.02 - 1e-4) + 1e-4


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def get_beta_schedule(schedule_type: str, num_steps: int) -> np.ndarray:
    try:
        return _SCHEDULES[schedule_type](num_steps)
    except KeyError:
        raise ValueError(f"Unknown schedule: {schedule_type}") from None


@dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep coefficients, each a (T,) float64 array.

    Ancestral posterior: x_{t-1} = c0 * x0_pred + c1 * x_t + sqrt(var) * z.
    """

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    posterior_coef_x0: np.ndarray
    posterior_coef_xt: np.ndarray
    posterior_variance: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, schedule_type: str, num_steps: int) -> "DiffusionSchedule":
        betas = get_beta_schedule(schedule_type, num_steps)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        one_minus = 1.0 - alphas_cumprod
        return cls(
            betas=betas,
            alphas=alphas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=np.sqrt(one_minus),
            posterior_coef_x0=np.sqrt(alphas_cumprod_prev) * betas / one_minus,
            posterior_coef_xt=np.sqrt(alphas) * (1.0 - alphas_cumprod_prev) / one_minus,
            posterior_variance=(1.0 - alphas_cumprod_prev) / one_minus * betas,
        )


def ddim_timesteps(num_train_steps: int, num_sampling_steps: int) -> np.ndarray:
    """Strided timestep subsequence for DDIM sampling (ascending)."""
    num_sampling_steps = min(num_sampling_steps, num_train_steps)
    stride = num_train_steps / num_sampling_steps
    ts = (np.arange(num_sampling_steps) * stride).round().astype(np.int64)
    return np.unique(ts)
