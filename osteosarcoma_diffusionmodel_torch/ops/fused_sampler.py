"""The reverse diffusion loop through the hand-written kernels K1-K3, K5, K6.

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
copied. The 5142-wide carry, acc and K1's copy of W_out have rows padded
to 5152 columns (16-byte multiples), so K1 and K3 work on views that TMA
can address. The host tables follow FusedSampler.__init__ (:661-724): reverse
timesteps, ``t_add`` (time embedding + input bias, f32), the (n_loop, 6)
coefficient table (c0, c1, sv, g, beta, acp_prev) whose last DDPM row is
(1, 0, 0) and the linearized eta = 0 DDIM table.

With the D3PM head (``model.discrete_head``) the first ``mutation_dim``
columns of the carry are bits: the x_T prior draws Bernoulli(1/2) there,
K1 reads them as 2b - 1 in the input product and K3 draws the binary
posterior from the step's uniforms (columns 4-5 of the table).

``quantize`` ("out", "io", "all"; the TPU's ``_quant_flags``, :108-124)
routes the marked products through K5 (per-row int8 activations) and K6
(s8·s8 -> s32, dequantized with the per-column weight scales of
:func:`sampler_kernels.pack_int8`). The decoder's fc1 is then two
products over the [h | skip] halves, each with its own scales, summed in
f32, as the TPU computes it. K5 quantizes the bf16 activations that K2
stores, where the TPU quantizes f32 ones.

Noise: "philox" (in-kernel, the DDPM default), "buffer" (a given
(n_loop, B, D) tensor: the parity hook) or "none" (DDIM). On CPU tensors
the same loop runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.networks import sinusoid
from .sampler_kernels import (
    gemm_bf16_f32acc,
    gemm_s8,
    groupnorm8_silu,
    kmajor_int8,
    pack_int8,
    pad16,
    rowquant_s8,
    x0_posterior_step,
)
from .schedules import DiffusionSchedule, ddim_timesteps

_QUANT_FLAGS = {
    None: (False, False, False),
    "out": (False, False, True),
    "io": (True, False, True),
    "all": (True, True, True),
}


def quant_flags(quantize: Optional[str]) -> Tuple[bool, bool, bool]:
    """(input product, block products, output product) int8 flags of a
    ``quantize`` mode (the TPU's ``_quant_flags``)."""
    if quantize not in _QUANT_FLAGS:
        raise ValueError(f"quantize must be None/'out'/'io'/'all', got {quantize!r}")
    return _QUANT_FLAGS[quantize]


def reverse_timesteps(num_steps: int, ddim_steps: Optional[int] = None) -> np.ndarray:
    """Timesteps in reverse order (last row t = 0)."""
    if ddim_steps is None:
        return np.arange(num_steps - 1, -1, -1)
    return ddim_timesteps(num_steps, ddim_steps)[::-1].copy()


def coefficient_table(schedule: DiffusionSchedule, gains: np.ndarray,
                      ddim_steps: Optional[int] = None, discrete: bool = False) -> np.ndarray:
    """(n_loop, 6) f32 rows (c0, c1, sv, g, beta, acp_prev) in reverse-time
    order.

    DDPM: the ancestral posterior, with the t = 0 row (1, 0, 0) returning
    clip(x0) and no noise. DDIM (eta = 0): x_prev = sqrt(acp_prev)·x0 +
    sqrt(1 - acp_prev)·eps with eps from the clipped x0, linearized into
    c0·x0 + c1·x_t. Columns 4-5 drive the D3PM bits when ``discrete``
    (zeros otherwise): DDPM the one-step (beta_t, acp_{t-1}) pair, with
    acp_prev = 1 on the last row; DDIM the strided jump's effective
    beta = 1 - acp_t/acp_prev (the uniform chain composes exactly)."""
    ts = reverse_timesteps(schedule.num_steps, ddim_steps)
    acp = schedule.alphas_cumprod
    if ddim_steps is None:
        c0 = schedule.posterior_coef_x0[ts].copy()
        c1 = schedule.posterior_coef_xt[ts].copy()
        sv = np.sqrt(schedule.posterior_variance[ts])
        c0[-1], c1[-1], sv[-1] = 1.0, 0.0, 0.0
        beta = schedule.betas[ts]
        acp_prev = np.where(ts >= 1, acp[np.maximum(ts - 1, 0)], 1.0)
    else:
        acp_t = acp[ts]
        prev = np.concatenate([ts[1:], [-1]])
        acp_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], 1.0)
        c1 = np.sqrt((1.0 - acp_prev) / (1.0 - acp_t))
        c0 = np.sqrt(acp_prev) - c1 * np.sqrt(acp_t)
        sv = np.zeros_like(c0)
        beta = 1.0 - acp_t / acp_prev
    gains = np.asarray(gains, np.float64).reshape(-1)
    if gains.shape != c0.shape:
        raise ValueError(f"gains must have {c0.shape[0]} rows, got {gains.shape}")
    if not discrete:
        beta = acp_prev = np.zeros_like(c0)
    return np.stack([c0, c1, sv, gains, beta, acp_prev], axis=1).astype(np.float32)


def x_prior(batch: int, data_dim: int, mut_dim: int, generator: torch.Generator) -> torch.Tensor:
    """x_T on the generator's device: Gaussian, with Bernoulli(1/2) bits on
    the first ``mut_dim`` columns (the TPU's ``_x_init``, :847-861)."""
    dev = generator.device
    if not mut_dim:
        return torch.randn((batch, data_dim), generator=generator, device=dev)
    cont = torch.randn((batch, data_dim - mut_dim), generator=generator, device=dev)
    bits = (torch.rand((batch, mut_dim), generator=generator, device=dev) < 0.5).float()
    return torch.cat([bits, cont], dim=1)


def _bf16(w: torch.Tensor, device) -> torch.Tensor:
    return w.to(device=device, dtype=torch.bfloat16).contiguous()


def padded_rows(rows: int, cols: int, dtype, device) -> torch.Tensor:
    """A zeroed (rows, pad16(cols)) buffer's (rows, cols) view: its row
    stride is a multiple of 16 elements, so K1 reads and writes it
    through TMA (16-byte-aligned rows) at every width, 5142 included."""
    return torch.zeros(rows, pad16(cols), dtype=dtype, device=device)[:, :cols]


def _f32(w: torch.Tensor, device) -> torch.Tensor:
    return w.to(device=device, dtype=torch.float32).contiguous()


def int8_parts(w: torch.Tensor, device, splits: Optional[Sequence[int]] = None) -> List[tuple]:
    """A (K, N) weight as int8 parts (lo, hi, codes, column scales), one per
    row range of ``splits`` (the TPU's ``_block_weights`` splits the
    decoder's fc1 at its [h | skip] boundary, :141-161). The codes are
    K-major, (pad16(N), pad16(hi - lo)), as K6 takes them."""
    parts, lo = [], 0
    for size in splits or [w.shape[0]]:
        q, scale = pack_int8(w[lo:lo + size].numpy())
        parts.append((lo, lo + size, kmajor_int8(q).to(device), scale.to(device)))
        lo += size
    if lo != w.shape[0]:
        raise ValueError(f"splits {list(splits)} do not cover {w.shape[0]} rows")
    return parts


class _Weight:
    """One product's (K, N) weight in kernel layout: for K1 bf16 with its
    rows padded to pad16(N) (a view of the first N columns; W_out's 5142),
    or the :func:`int8_parts` for K5 + K6."""

    def __init__(self, w: torch.Tensor, device, quant: bool,
                 splits: Optional[Sequence[int]] = None):
        self.parts = int8_parts(w, device, splits) if quant else []
        self.max_kp = max((q.shape[1] for _, _, q, _ in self.parts), default=0)
        if not quant:
            self.w = padded_rows(*w.shape, torch.bfloat16, device)
            self.w.copy_(w)

    def __call__(self, a: torch.Tensor, out: torch.Tensor, scratch, bias=None, row_add=None,
                 mut_cols: int = 0) -> None:
        """out = a·W + bias + row_add (``mut_cols``: 2a - 1 on A's first
        columns)."""
        if not self.parts:
            gemm_bf16_f32acc(a, self.w, out=out, bias=bias, row_add=row_add, a_mut_cols=mut_cols)
            return
        q_buf, s_buf = scratch
        m, last = a.shape[0], len(self.parts) - 1
        for i, (lo, hi, q, scale) in enumerate(self.parts):
            kp = pad16(hi - lo)
            qa, rs = rowquant_s8(a[:, lo:hi], out=q_buf[: m * kp].view(m, kp), scale=s_buf[:m],
                                 mut_cols=mut_cols if lo == 0 else 0)
            gemm_s8(qa, rs, q, scale, out=out, bias=bias if i == last else None,
                    row_add=row_add if i == last else None, accumulate=i > 0)


class _Block:
    """One DenoiserBlock's weights in kernel layout + f32 vectors."""

    def __init__(self, sd, name: str, device, quant: bool, in_splits: Sequence[int]):
        self.fc1 = _Weight(sd[f"{name}.fc1.weight"].T, device, quant, in_splits)
        self.b1 = _f32(sd[f"{name}.fc1.bias"], device)
        self.g1 = _f32(sd[f"{name}.norm1.weight"], device)
        self.n1 = _f32(sd[f"{name}.norm1.bias"], device)
        self.fc2 = _Weight(sd[f"{name}.fc2.weight"].T, device, quant)
        self.b2 = _f32(sd[f"{name}.fc2.bias"], device)
        self.g2 = _f32(sd[f"{name}.norm2.weight"], device)
        self.n2 = _f32(sd[f"{name}.norm2.bias"], device)
        self.features = self.b1.shape[0]
        self.max_kp = max(self.fc1.max_kp, self.fc2.max_kp)

    def run(self, a: torch.Tensor, out: torch.Tensor, pre: torch.Tensor,
            mid: torch.Tensor, scratch) -> None:
        self.fc1(a, pre, scratch, bias=self.b1)
        groupnorm8_silu(pre, self.g1, self.n1, out=mid)
        self.fc2(mid, pre, scratch, bias=self.b2)
        groupnorm8_silu(pre, self.g2, self.n2, out=out)


class FusedSampler:
    """Host tables and weight layout built once per (model, device); each
    :meth:`sample` call runs the reverse loop through the kernels."""

    def __init__(self, model, device, ddim_steps: Optional[int] = None,
                 quantize: Optional[str] = None):
        q_in, q_blk, q_out = quant_flags(quantize)
        d = model.denoiser
        self.model = model
        self.device = dev = torch.device(device)
        self.ddim_steps = ddim_steps
        self.quantize = quantize
        self.clip_value = float(model.clip_value)
        self.data_dim = d.data_dim
        self.mut_dim = model.mutation_dim if model.discrete_head else 0
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
        ).to(dev)
        self.coeffs = torch.from_numpy(
            coefficient_table(model.schedule, gains[:, 0], ddim_steps, self.mut_dim > 0)
        ).to(dev)

        self.w_in = _Weight(sd["input_proj.weight"].T, dev, q_in)
        self.encoders, width = [], self.hidden[0]
        for name in d.encoder_names:
            self.encoders.append(_Block(sd, name, dev, q_blk, [width]))
            width = self.encoders[-1].features
        self.bottleneck = _Block(sd, "bottleneck", dev, q_blk, [width])
        width = self.bottleneck.features
        self.decoders = []
        for name, enc in zip(d.decoder_names, self.encoders[::-1]):
            self.decoders.append(_Block(sd, name, dev, q_blk, [width, enc.features]))
            width = self.decoders[-1].features
        self.w_out = _Weight(sd["output_proj.weight"].T, dev, q_out)
        self.b_out = _f32(sd["output_proj.bias"], dev)
        self.max_kp = max(w.max_kp for w in [self.w_in, self.w_out, self.bottleneck]
                          + self.encoders + self.decoders)

    # ------------------------------------------------------------------
    def _buffers(self, batch: int):
        """Per-call activations. ``cats[j]`` is decoder j's [h | skip]
        input; encoder i writes its output into the skip half of
        ``cats[L-1-i]``. ``acc`` (the output product) has padded rows.
        ``quant`` is K5's scratch (codes, row scales)."""
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
            "acc": padded_rows(batch, self.data_dim, torch.float32, dev),
            "quant": (torch.empty(batch * self.max_kp, dtype=torch.int8, device=dev),
                      torch.empty(batch, dtype=torch.float32, device=dev)),
        }

    def run_stack(self, buf) -> None:
        """The block stack from ``buf["h_in"]`` to ``buf["h_last"]`` (K1 and K2,
        or K5 and K6 under int8): the stack of every reverse step, and of the
        latent-tail sampler's steps on its 256-wide state."""
        batch = buf["h_in"].shape[0]
        cats: List[torch.Tensor] = buf["cats"]
        n_enc = len(self.encoders)
        scratch = buf["quant"]

        def scratch_rows(f):
            return (buf["pre"][: batch * f].view(batch, f),
                    buf["mid"][: batch * f].view(batch, f))

        h = buf["h_in"]
        for i, blk in enumerate(self.encoders):
            cat = cats[n_enc - 1 - i]
            out = cat[:, cat.shape[1] - blk.features:]
            blk.run(h, out, *scratch_rows(blk.features), scratch)
            h = out
        dst = cats[0][:, : self.bottleneck.features] if cats else buf["h_last"]
        self.bottleneck.run(h, dst, *scratch_rows(self.bottleneck.features), scratch)
        for j, blk in enumerate(self.decoders):
            dst = cats[j + 1][:, : blk.features] if j + 1 < len(cats) else buf["h_last"]
            blk.run(cats[j], dst, *scratch_rows(blk.features), scratch)

    def _step(self, s: int, x: torch.Tensor, c_proj: torch.Tensor, buf, mode: str,
              noise: Optional[torch.Tensor], seed: int) -> None:
        scratch = buf["quant"]
        self.w_in(x, buf["h_in"], scratch, bias=self.t_add[s], row_add=c_proj,
                  mut_cols=self.mut_dim)
        self.run_stack(buf)
        self.w_out(buf["h_last"], buf["acc"], scratch)
        x0_posterior_step(buf["acc"], x, self.b_out, self.coeffs, s, mode,
                          noise=noise, seed=seed, clip=self.clip_value, mut_dim=self.mut_dim)

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: torch.Generator,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               stop_after: Optional[int] = None) -> torch.Tensor:
        """Samples (B, D) float32 on the sampler's device. ``x_init``: the
        x_T prior (B, D), drawn from ``generator`` when omitted; ``noise``:
        (n_loop, B, D) per-step transition noise replacing the in-kernel
        Philox stream (DDPM only; with the D3PM head its mutation columns
        give the bit uniforms z/(2sqrt3) + 1/2). ``stop_after``: run only
        the first N reverse rows and return the carry x_{t(N)} (its bf16
        values, as float32): the data-space head of the latent-tail sampler
        (the JAX ``stop_after``, fused_sampler.py:879-883); ``noise`` keeps
        its full shape."""
        dev = self.device
        batch, D = conditions.shape[0], self.data_dim
        n_run = self.n_loop if stop_after is None else int(stop_after)
        if not 0 <= n_run <= self.n_loop:
            raise ValueError(f"stop_after must be in [0, {self.n_loop}], got {stop_after}")
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
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))
        if x_init is None:
            x_init = x_prior(batch, D, self.mut_dim, generator)
        x = padded_rows(batch, D, torch.bfloat16, dev)  # the bf16 carry, TMA-readable rows
        x.copy_(x_init.to(device=dev, dtype=torch.bfloat16))

        # Loop-invariant condition projection (plain torch, as the JAX
        # sampler computes it outside its kernel), rounded to bf16 (:890).
        d = self.model.denoiser
        home = next(d.parameters()).device
        c_proj = d.embed_conditions(conditions.to(home, torch.float32))
        c_proj = c_proj.to(dev, torch.bfloat16).float().contiguous()

        buf = self._buffers(batch)
        for s in range(n_run):
            self._step(s, x, c_proj, buf, mode, noise, seed)
        return x.float().contiguous()
