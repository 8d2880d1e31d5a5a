"""Seeded weights for the transformer denoiser (models/dit.py), drawn on
the device, one tensor at a time, in each tensor's own dtype."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

NORM_SPREAD = 0.2  # RMSNorm scales 1 + 0.2·U(-1, 1), as a trained net's
BIAS_SPREAD = 0.1  # the router's correction bias 0.1·U(-1, 1): it moves some choices


def fan_in(name: str, state: Dict[str, torch.Tensor]) -> int:
    """The input width of a weight (out, in) or (experts, in, out), or of
    a bias's weight."""
    w = state[name[: -len("bias")] + "weight"] if name.endswith(".bias") else state[name]
    return w.shape[1]


@torch.no_grad()
def seeded_dit_weights(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every projection's and expert's weight and every bias ~
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), every RMSNorm scale 1 + 0.2·U(-1,
    1), each routed layer's ``e_score_correction_bias`` 0.1·U(-1, 1) (f32):
    the state dict, from one generator on ``device`` seeded with ``seed``,
    one ``torch.rand`` a tensor in the state dict's order. ``module`` may
    live on the meta device: only its shapes and dtypes are read."""
    state = module.state_dict()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        u = torch.rand(t.shape, generator=gen, device=device, dtype=t.dtype).mul_(2.0).sub_(1.0)
        if name.endswith("norm.weight"):
            u.mul_(NORM_SPREAD).add_(1.0)
        elif name.endswith("e_score_correction_bias"):
            u.mul_(BIAS_SPREAD)
        else:
            u.mul_(fan_in(name, state) ** -0.5)
        out[name] = u
    return out
