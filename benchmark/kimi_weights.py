"""Seeded weights for the hybrid transformer denoiser (models/dit.py with
KDA layers, models/kda.py), drawn on the device, one tensor at a time, in
each tensor's own dtype: ``benchmark/dit_weights.py``'s draws, and KDA's
decay as published."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.dit_weights import BIAS_SPREAD, NORM_SPREAD, fan_in

A_RANGE = (1.0, 16.0)  # A = exp(A_log) ~ U(1, 16), one a head
DT_RANGE = (1e-3, 1e-1)  # dt ~ logU(0.001, 0.1), one a key channel, at least 1e-4


@torch.no_grad()
def seeded_kimi_weights(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict, from one generator on ``device`` seeded with
    ``seed``, one ``torch.rand`` a tensor in the state dict's order, u =
    U(-1, 1): every projection's, convolution's and expert's weight and
    every bias u/sqrt(fan_in) (a convolution's fan-in its taps), every
    RMSNorm scale 1 + 0.2·u, each routed layer's ``e_score_correction_bias``
    0.1·u (f32), each KDA layer's ``A_log`` the log of A ~ U(1, 16) and its
    ``dt_bias`` softplus⁻¹(dt), dt ~ logU(0.001, 0.1) (both f32: the
    published initialisation, fast and slow channels side by side).
    ``module`` may live on the meta device: only its shapes and dtypes are
    read."""
    state = module.state_dict()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        u = torch.rand(t.shape, generator=gen, device=device, dtype=t.dtype)
        if name.endswith("A_log"):
            u = torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u)
        elif name.endswith("dt_bias"):
            lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
            dt = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
            u = dt + torch.log(-torch.expm1(-dt))
        else:
            u.mul_(2.0).sub_(1.0)
            if name.endswith("norm.weight"):
                u.mul_(NORM_SPREAD).add_(1.0)
            elif name.endswith("e_score_correction_bias"):
                u.mul_(BIAS_SPREAD)
            else:
                u.mul_(fan_in(name, state) ** -0.5)
        out[name] = u
    return out
