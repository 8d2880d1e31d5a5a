"""Plain reference of the denoiser's reverse chain, in PyTorch ops only.

Written from the model's published description (config/config.yaml: an
MLP denoiser with hidden 256/512/256, Linear -> GroupNorm(8) -> SiLU
blocks whose decoders take [h | skip], a learned time gain g(t) adding
g(t)·x_t to the output, x0 parameterization clipped to +-clip, the
cosine schedule, DDPM over T steps or eta = 0 DDIM over a strided
subsequence) at the precision the configuration states: bfloat16
operands with float32 accumulation for every product, float32 group
statistics, a bfloat16 carry and bfloat16 activations between products.
Products run as float32 matrix products of the bf16-rounded operands
with TF32 off (a product of two bf16 values is exact in float32).

The DDPM transition noise is the uniform noise U(-sqrt3, sqrt3) drawn
from Philox4x32-10 keyed by (seed, step index) with counter
row * D + col, top 24 bits of the first word (the generator that the
configuration's ``noise_type: uniform`` sampler is specified to use), so
any subset of rows can be run alone: rows are independent in the chain.

Weights come as a dict of float32 tensors under the checkpoint names
(``input_proj.weight`` (H0, D), ``enc_0.fc1.weight``, ...). Nothing here
imports the measured program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

GN_GROUPS = 8
GN_EPS = 1e-6
UNIFORM_SCALE = 2.0 * math.sqrt(3.0)

_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


# ----------------------------------------------------------------------
# Schedule (float64 on the host)
# ----------------------------------------------------------------------
def betas(schedule: str, num_steps: int) -> np.ndarray:
    if schedule == "cosine":
        s = np.arange(num_steps + 1, dtype=np.float64) / num_steps
        acp = np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2
        acp = acp / acp[0]
        return np.clip(1.0 - acp[1:] / acp[:-1], 0.0001, 0.9999)
    if schedule == "linear":
        return np.linspace(1e-4, 0.02, num_steps, dtype=np.float64)
    if schedule == "sigmoid":
        x = np.linspace(-6.0, 6.0, num_steps, dtype=np.float64)
        return 1.0 / (1.0 + np.exp(-x)) * (0.02 - 1e-4) + 1e-4
    raise ValueError(f"unknown schedule {schedule!r}")


def reverse_steps(num_steps: int, ddim_steps: Optional[int]) -> np.ndarray:
    """The timesteps the chain visits, last one t = 0."""
    if ddim_steps is None:
        return np.arange(num_steps - 1, -1, -1)
    n = min(ddim_steps, num_steps)
    ts = np.unique((np.arange(n) * (num_steps / n)).round().astype(np.int64))
    return ts[::-1].copy()


def transition_table(schedule: str, num_steps: int, ddim_steps: Optional[int]) -> np.ndarray:
    """(n_loop, 3) float64 rows (c0, c1, sv): x_prev = c0·x0 + c1·x_t + sv·z.
    DDPM: the ancestral posterior, whose last row returns x0 without
    noise; DDIM (eta = 0): sqrt(acp_prev)·x0 + sqrt(1 - acp_prev)·eps with
    eps from the clipped x0, written in x0 and x_t."""
    b = betas(schedule, num_steps)
    acp = np.cumprod(1.0 - b)
    ts = reverse_steps(num_steps, ddim_steps)
    if ddim_steps is None:
        acp_prev = np.concatenate([[1.0], acp[:-1]])[ts]
        a_t, bt = acp[ts], b[ts]
        c0 = np.sqrt(acp_prev) * bt / (1.0 - a_t)
        c1 = np.sqrt(1.0 - bt) * (1.0 - acp_prev) / (1.0 - a_t)
        sv = np.sqrt((1.0 - acp_prev) / (1.0 - a_t) * bt)
        c0[-1], c1[-1], sv[-1] = 1.0, 0.0, 0.0
    else:
        prev = np.concatenate([ts[1:], [-1]])
        acp_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], 1.0)
        a_t = acp[ts]
        c1 = np.sqrt((1.0 - acp_prev) / (1.0 - a_t))
        c0 = np.sqrt(acp_prev) - c1 * np.sqrt(a_t)
        sv = np.zeros_like(c0)
    return np.stack([c0, c1, sv], axis=1)


def sinusoid(t_norm: np.ndarray, dim: int) -> np.ndarray:
    """[sin | cos] of t_norm times dim/2 log-spaced frequencies (float64)."""
    half = dim // 2
    freqs = np.exp(np.arange(half, dtype=np.float64) * (-math.log(10000.0) / (half - 1)))
    args = np.asarray(t_norm, np.float64)[:, None] * freqs[None, :]
    return np.concatenate([np.sin(args), np.cos(args)], axis=1)


# ----------------------------------------------------------------------
# Philox4x32-10
# ----------------------------------------------------------------------
def philox_first_word(counter: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """The first output word of Philox4x32-10 for 64-bit counters
    (c0, c1 = low, high word; c2 = c3 = 0) under key (k0, k1). int64
    tensors hold the uint32 words; a uint32 product fits in the 64 bits
    that int64 arithmetic keeps modulo 2**64."""
    c0, c1 = counter & _M32, (counter >> 32) & _M32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = k0 & _M32, k1 & _M32
    for _ in range(10):
        p0 = c0 * _PHILOX_M0
        p1 = c2 * _PHILOX_M1
        c0, c1, c2, c3 = ((p1 >> 32) & _M32) ^ c1 ^ k0, p1 & _M32, \
            ((p0 >> 32) & _M32) ^ c3 ^ k1, p0 & _M32
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0


def uniform_noise(seed: int, step: int, rows: torch.Tensor, cols: int) -> torch.Tensor:
    """z = (u - 1/2)·2sqrt3 for the given global row indices, u the top 24
    bits of the first Philox word at counter row·cols + col."""
    idx = rows.to(torch.int64)[:, None] * cols + torch.arange(cols, device=rows.device)[None, :]
    u = (philox_first_word(idx, seed, step) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u - 0.5) * UNIFORM_SCALE


# ----------------------------------------------------------------------
# The denoiser at the configured precision
# ----------------------------------------------------------------------
def _mm(a: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """bf16 a (M, K) times bf16 w_t (K, N), exact products summed in f32."""
    return a.float() @ w_t.float()


def _gn_silu(pre: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    m, f = pre.shape
    g = pre.reshape(m, GN_GROUPS, f // GN_GROUPS)
    mean = g.mean(dim=2, keepdim=True)
    var = torch.clamp((g * g).mean(dim=2, keepdim=True) - mean * mean, min=0.0)
    y = ((g - mean) * torch.rsqrt(var + GN_EPS)).reshape(m, f) * scale + bias
    return torch.nn.functional.silu(y).to(torch.bfloat16)


class Denoiser:
    """The denoiser's weights in the layout this reference computes with:
    each product's (K, N) matrix rounded to bf16, vectors in f32."""

    def __init__(self, weights: Dict[str, torch.Tensor], hidden: Sequence[int], device):
        self.device = torch.device(device)

        def w(name):
            return weights[name].detach().to(self.device, torch.float32)

        def mat(name):
            return w(name).T.contiguous().to(torch.bfloat16)

        self.hidden = list(hidden)
        self.w_in, self.b_in = mat("input_proj.weight"), w("input_proj.bias")
        self.w_out, self.b_out = mat("output_proj.weight"), w("output_proj.bias")
        n_enc = len(self.hidden) - 1
        self.enc = [self._block(f"enc_{i}", mat, w) for i in range(n_enc)]
        self.mid = self._block("bottleneck", mat, w)
        self.dec = [self._block(f"dec_{j}", mat, w) for j in range(n_enc)]
        self.raw = {k: w(k) for k in weights}

    @staticmethod
    def _block(name, mat, w):
        return tuple(f(f"{name}.{p}") for f, p in (
            (mat, "fc1.weight"), (w, "fc1.bias"), (w, "norm1.weight"), (w, "norm1.bias"),
            (mat, "fc2.weight"), (w, "fc2.bias"), (w, "norm2.weight"), (w, "norm2.bias")))

    @staticmethod
    def _run_block(a: torch.Tensor, blk) -> torch.Tensor:
        w1, b1, g1, n1, w2, b2, g2, n2 = blk
        h = _gn_silu(_mm(a, w1) + b1, g1, n1)
        return _gn_silu(_mm(h, w2) + b2, g2, n2)

    def hidden_stack(self, h: torch.Tensor) -> torch.Tensor:
        skips: List[torch.Tensor] = []
        for blk in self.enc:
            h = self._run_block(h, blk)
            skips.append(h)
        h = self._run_block(h, self.mid)
        for blk in self.dec:
            h = self._run_block(torch.cat([h, skips.pop()], dim=1), blk)
        return h

    def condition_projection(self, cond: torch.Tensor) -> torch.Tensor:
        """The condition MLP (Linear -> SiLU -> Linear -> Linear), each
        layer a bf16 linear with a bf16 result, as float32."""
        r = self.raw
        bf = torch.bfloat16

        def lin(x, name):
            return torch.nn.functional.linear(x.to(bf), r[f"{name}.weight"].to(bf),
                                              r[f"{name}.bias"].to(bf))

        h = torch.nn.functional.silu(lin(cond.to(self.device), "condition_embed.fc1"))
        h = lin(h, "condition_embed.fc2")
        return lin(h, "cond_proj").float()

    def step_tables(self, ts: np.ndarray, num_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per reverse step: the time embedding plus the input bias (f32
        rows) and the skip gain g(t), from float64 on the host."""
        r = {k: v.double().cpu().numpy() for k, v in self.raw.items()
             if k.startswith(("time_proj", "skip_gain"))}
        sin = sinusoid(ts / num_steps, r["time_proj.weight"].shape[1])
        t_emb = sin @ r["time_proj.weight"].T + r["time_proj.bias"]
        gain = sin @ r["skip_gain.weight"].T + r["skip_gain.bias"]
        t_add = torch.from_numpy(t_emb).float().to(self.device) + self.b_in
        return t_add, torch.from_numpy(gain[:, 0]).float().to(self.device)


@torch.no_grad()
def reverse_chain(den: Denoiser, x_init: torch.Tensor, cond: torch.Tensor, rows: torch.Tensor,
                  *, schedule: str, num_steps: int, ddim_steps: Optional[int], clip: float,
                  philox_seed: int) -> torch.Tensor:
    """The reverse chain from ``x_init`` (R, D) for the cohort rows
    ``rows`` (their global indices key the Philox noise) under ``cond``
    (R, C). Returns the final bf16 carry as float32."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = den.device
        ts = reverse_steps(num_steps, ddim_steps)
        table = transition_table(schedule, num_steps, ddim_steps)
        t_add, gain = den.step_tables(ts, num_steps)
        c_proj = den.condition_projection(cond)
        rows = rows.to(dev)
        d = x_init.shape[1]
        x = x_init.to(dev, torch.bfloat16)
        for s in range(len(ts)):
            c0, c1, sv = (float(v) for v in table[s])
            h = (_mm(x, den.w_in) + t_add[s] + c_proj).to(torch.bfloat16)
            h = den.hidden_stack(h)
            xf = x.float()
            x0 = torch.clamp(_mm(h, den.w_out) + den.b_out + gain[s] * xf, -clip, clip)
            xn = c0 * x0 + c1 * xf
            if sv != 0.0:
                xn = xn + sv * uniform_noise(philox_seed, s, rows, d)
            x = xn.to(torch.bfloat16)
        return x.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
