"""Seeded weights for the port's denoiser, made on the device in one draw."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

SKIP_GAIN_SCALE = 0.1  # a small nonzero g(t), so the g(t)·x path carries signal
GN_SPREAD = 0.2  # GroupNorm scale 1 + 0.2·U(-1, 1) and bias 0.2·U(-1, 1), as a trained net's


@torch.no_grad()
def seeded_weights(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every Linear's weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    every GroupNorm's scale 1 + 0.2·U(-1, 1) and bias 0.2·U(-1, 1), the
    skip gain's weight scaled by 0.1: the float32 state dict, from one
    ``torch.rand`` on ``device`` seeded with ``seed``."""
    params = []
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            gain = SKIP_GAIN_SCALE if name == "skip_gain" else 1.0
            params += [(f"{name}.weight", mod.weight, bound * gain, 0.0),
                       (f"{name}.bias", mod.bias, bound, 0.0)]
        elif isinstance(mod, nn.GroupNorm):
            params += [(f"{name}.weight", mod.weight, GN_SPREAD, 1.0),
                       (f"{name}.bias", mod.bias, GN_SPREAD, 0.0)]
    total = sum(p.numel() for _, p, _, _ in params)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for key, p, scale, shift in params:
        out[key] = flat[at:at + p.numel()].view(p.shape).mul_(scale).add_(shift)
        at += p.numel()
    missing = set(module.state_dict()) - set(out)
    if missing:
        raise ValueError(f"no seeded init for {sorted(missing)}")
    return out
