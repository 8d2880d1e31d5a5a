"""The reverse diffusion loop through the hand-written kernels K1-K3.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py
`FusedSampler`. The TPU kernel keeps the weights and a state tile on chip
for the whole loop; an H100 SM cannot hold them, so this is design (a)
of the roadmap: per-step kernels. Each reverse step is

    h   = x·W_in + t_add[s] + c_proj                          (K1)
    5 blocks of fc1 (K1) -> GN+SiLU (K2) -> fc2 (K1) -> GN+SiLU (K2)
    acc = h·W_out                                             (K1)
    x  <- c0·clip(acc + b_out + g_s·x) + c1·x + sv·z          (K3)

with the carry x in bf16, products in bf16 with f32 accumulation and the
group statistics in f32 -- the TPU kernel's ``gn_mode="f32"`` numerics.
Decoder inputs ``[h | skip]`` live in preallocated bf16 buffers that the
encoder blocks write their skip halves into, so no concatenation is
copied. The host tables follow FusedSampler.__init__ (:661-724): reverse
timesteps, ``t_add`` (time embedding + input bias, f32), the (n_loop, 6)
coefficient table (c0, c1, sv, g, 0, 0) whose last DDPM row is (1, 0, 0)
and the linearized eta = 0 DDIM table.

Noise: "philox" (in-kernel, the DDPM default), "buffer" (a given
(n_loop, B, D) tensor: the parity hook) or "none" (DDIM). On CPU tensors
the same loop runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.networks import sinusoid
from .sampler_kernels import gemm_bf16_f32acc, groupnorm8_silu, x0_posterior_step
from .schedules import DiffusionSchedule, ddim_timesteps


def reverse_timesteps(num_steps: int, ddim_steps: Optional[int] = None) -> np.ndarray:
    """Timesteps in reverse order (last row t = 0)."""
    if ddim_steps is None:
        return np.arange(num_steps - 1, -1, -1)
    return ddim_timesteps(num_steps, ddim_steps)[::-1].copy()


def coefficient_table(schedule: DiffusionSchedule, gains: np.ndarray,
                      ddim_steps: Optional[int] = None) -> np.ndarray:
    """(n_loop, 6) f32 rows (c0, c1, sv, g, 0, 0) in reverse-time order.

    DDPM: the ancestral posterior, with the t = 0 row (1, 0, 0) returning
    clip(x0) and no noise. DDIM (eta = 0): x_prev = sqrt(acp_prev)·x0 +
    sqrt(1 - acp_prev)·eps with eps from the clipped x0, linearized into
    c0·x0 + c1·x_t."""
    ts = reverse_timesteps(schedule.num_steps, ddim_steps)
    if ddim_steps is None:
        c0 = schedule.posterior_coef_x0[ts].copy()
        c1 = schedule.posterior_coef_xt[ts].copy()
        sv = np.sqrt(schedule.posterior_variance[ts])
        c0[-1], c1[-1], sv[-1] = 1.0, 0.0, 0.0
    else:
        acp = schedule.alphas_cumprod
        acp_t = acp[ts]
        prev = np.concatenate([ts[1:], [-1]])
        acp_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], 1.0)
        c1 = np.sqrt((1.0 - acp_prev) / (1.0 - acp_t))
        c0 = np.sqrt(acp_prev) - c1 * np.sqrt(acp_t)
        sv = np.zeros_like(c0)
    gains = np.asarray(gains, np.float64).reshape(-1)
    if gains.shape != c0.shape:
        raise ValueError(f"gains must have {c0.shape[0]} rows, got {gains.shape}")
    zeros = np.zeros_like(c0)
    return np.stack([c0, c1, sv, gains, zeros, zeros], axis=1).astype(np.float32)


def _bf16(w: torch.Tensor, device) -> torch.Tensor:
    return w.to(device=device, dtype=torch.bfloat16).contiguous()


def _f32(w: torch.Tensor, device) -> torch.Tensor:
    return w.to(device=device, dtype=torch.float32).contiguous()


class _Block:
    """One DenoiserBlock's weights in kernel layout (K, N) bf16 + f32 vectors."""

    def __init__(self, sd, name: str, device):
        self.w1 = _bf16(sd[f"{name}.fc1.weight"].T, device)
        self.b1 = _f32(sd[f"{name}.fc1.bias"], device)
        self.g1 = _f32(sd[f"{name}.norm1.weight"], device)
        self.n1 = _f32(sd[f"{name}.norm1.bias"], device)
        self.w2 = _bf16(sd[f"{name}.fc2.weight"].T, device)
        self.b2 = _f32(sd[f"{name}.fc2.bias"], device)
        self.g2 = _f32(sd[f"{name}.norm2.weight"], device)
        self.n2 = _f32(sd[f"{name}.norm2.bias"], device)
        self.features = self.w1.shape[1]

    def run(self, a: torch.Tensor, out: torch.Tensor, pre: torch.Tensor,
            mid: torch.Tensor) -> None:
        gemm_bf16_f32acc(a, self.w1, out=pre, bias=self.b1)
        groupnorm8_silu(pre, self.g1, self.n1, out=mid)
        gemm_bf16_f32acc(mid, self.w2, out=pre, bias=self.b2)
        groupnorm8_silu(pre, self.g2, self.n2, out=out)


class FusedSampler:
    """Host tables and weight layout built once per (model, device); each
    :meth:`sample` call runs the reverse loop through K1-K3."""

    def __init__(self, model, device, ddim_steps: Optional[int] = None):
        d = model.denoiser
        self.model = model
        self.device = torch.device(device)
        self.ddim_steps = ddim_steps
        self.clip_value = float(model.clip_value)
        self.data_dim = d.data_dim
        self.hidden = list(d.hidden_dims)
        T = model.schedule.num_steps
        self.ts = reverse_timesteps(T, ddim_steps)
        self.n_loop = len(self.ts)

        sd = {k: v.detach().float().cpu() for k, v in d.state_dict().items()}
        t_norm = torch.from_numpy(self.ts.astype(np.float64) / T)
        sin = sinusoid(t_norm, d.time_dim).numpy().astype(np.float32)
        t_emb = sin @ sd["time_proj.weight"].numpy().T + sd["time_proj.bias"].numpy()
        gains = sin @ sd["skip_gain.weight"].numpy().T + sd["skip_gain.bias"].numpy()
        self.t_add = torch.from_numpy(
            (t_emb + sd["input_proj.bias"].numpy()).astype(np.float32)
        ).to(self.device)
        self.coeffs = torch.from_numpy(
            coefficient_table(model.schedule, gains[:, 0], ddim_steps)
        ).to(self.device)

        self.w_in = _bf16(sd["input_proj.weight"].T, self.device)
        self.encoders = [_Block(sd, n, self.device) for n in d.encoder_names]
        self.bottleneck = _Block(sd, "bottleneck", self.device)
        self.decoders = [_Block(sd, n, self.device) for n in d.decoder_names]
        self.w_out = _bf16(sd["output_proj.weight"].T, self.device)
        self.b_out = _f32(sd["output_proj.bias"], self.device)

    # ------------------------------------------------------------------
    def _buffers(self, batch: int):
        """Per-call activations. ``cats[j]`` is decoder j's [h | skip]
        input; encoder i writes its output into the skip half of
        ``cats[L-1-i]``."""
        dev, bf = self.device, torch.bfloat16
        feats = [b.features for b in self.encoders]
        prev = [self.bottleneck.features] + [b.features for b in self.decoders[:-1]]
        skips = feats[::-1]
        cats = [torch.empty(batch, p + s, dtype=bf, device=dev) for p, s in zip(prev, skips)]
        width = max([self.hidden[0]] + [b.features for b in
                     self.encoders + [self.bottleneck] + self.decoders])
        return {
            "h_in": torch.empty(batch, self.hidden[0], dtype=bf, device=dev),
            "cats": cats,
            "pre": torch.empty(batch * width, dtype=torch.float32, device=dev),
            "mid": torch.empty(batch * width, dtype=bf, device=dev),
            "h_last": torch.empty(batch, self.decoders[-1].features if self.decoders
                                  else self.bottleneck.features, dtype=bf, device=dev),
            "acc": torch.empty(batch, self.data_dim, dtype=torch.float32, device=dev),
        }

    def _step(self, s: int, x: torch.Tensor, c_proj: torch.Tensor, buf, mode: str,
              noise: Optional[torch.Tensor], seed: int) -> None:
        batch = x.shape[0]
        cats: List[torch.Tensor] = buf["cats"]
        n_enc = len(self.encoders)

        def scratch(f):
            return (buf["pre"][: batch * f].view(batch, f),
                    buf["mid"][: batch * f].view(batch, f))

        gemm_bf16_f32acc(x, self.w_in, out=buf["h_in"], bias=self.t_add[s], row_add=c_proj)
        h = buf["h_in"]
        for i, blk in enumerate(self.encoders):
            cat = cats[n_enc - 1 - i]
            out = cat[:, cat.shape[1] - blk.features:]
            blk.run(h, out, *scratch(blk.features))
            h = out
        dst = cats[0][:, : self.bottleneck.features] if cats else buf["h_last"]
        self.bottleneck.run(h, dst, *scratch(self.bottleneck.features))
        for j, blk in enumerate(self.decoders):
            dst = cats[j + 1][:, : blk.features] if j + 1 < len(cats) else buf["h_last"]
            blk.run(cats[j], dst, *scratch(blk.features))
        gemm_bf16_f32acc(buf["h_last"], self.w_out, out=buf["acc"])
        x0_posterior_step(buf["acc"], x, self.b_out, self.coeffs, s, mode,
                          noise=noise, seed=seed, clip=self.clip_value)

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: torch.Generator,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Samples (B, D) float32 on the sampler's device. ``x_init``: the
        x_T prior (B, D), drawn from ``generator`` when omitted; ``noise``:
        (n_loop, B, D) per-step transition noise replacing the in-kernel
        Philox stream (DDPM only)."""
        dev = self.device
        batch, D = conditions.shape[0], self.data_dim
        if self.ddim_steps is not None:
            if noise is not None:
                raise ValueError("eta = 0 DDIM takes no transition noise")
            mode = "none"
        else:
            mode = "philox" if noise is None else "buffer"
        if noise is not None:
            if tuple(noise.shape) != (self.n_loop, batch, D):
                raise ValueError(f"noise must be ({self.n_loop}, {batch}, {D}), "
                                 f"got {tuple(noise.shape)}")
            noise = noise.to(device=dev, dtype=torch.float32).contiguous()
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        if x_init is None:
            x_init = torch.randn((batch, D), generator=generator, device=generator.device)
        x = x_init.to(device=dev, dtype=torch.bfloat16).contiguous().clone()

        # Loop-invariant condition projection (plain torch, as the JAX
        # sampler computes it outside its kernel), rounded to bf16 (:890).
        d = self.model.denoiser
        home = next(d.parameters()).device
        c_proj = d.embed_conditions(conditions.to(home, torch.float32))
        c_proj = c_proj.to(dev, torch.bfloat16).float().contiguous()

        buf = self._buffers(batch)
        for s in range(self.n_loop):
            self._step(s, x, c_proj, buf, mode, noise, seed)
        return x.float()
