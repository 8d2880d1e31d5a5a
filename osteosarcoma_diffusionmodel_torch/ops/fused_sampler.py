"""The reverse diffusion loop through the hand-written kernels K1-K3, K5, K6.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py
`FusedSampler`. The TPU kernel keeps the weights and a state tile on chip
for the whole loop; an H100 SM cannot hold them, so this is design (a)
of the roadmap: per-step kernels, with K2's and K3's work as epilogues of
the products before them. Each reverse step is 12 launches:

    h   = x·W_in + t_add[s] + c_proj                              (K1)
    5 blocks of fc1 -> GN+SiLU, fc2 -> GN+SiLU                    (K1 + K2 epilogue, x2)
    x  <- c0·clip(h·W_out + b_out + g_s·x) + c1·x + sv·z          (K1 + K3 epilogue)

with the carry x in bf16, products in bf16 with f32 accumulation and the
group statistics in f32 -- the TPU kernel's ``gn_mode="f32"`` numerics.
A block whose GroupNorm groups no tile width holds whole
(:func:`sampler_kernels.gn_widths`) runs its products and K2 apart,
through an f32 pre-activation buffer; no configuration of the repo does.
Decoder inputs ``[h | skip]`` live in preallocated bf16 buffers that the
encoder blocks write their skip halves into, so no concatenation is
copied. The 5142-wide carry and K1's copy of W_out have rows padded
to 5152 columns (16-byte multiples), so K1 works on views that TMA
can address. The host tables follow FusedSampler.__init__ (:661-724): reverse
timesteps, ``t_add`` (time embedding + input bias, f32), the (n_loop, 6)
coefficient table (c0, c1, sv, g, beta, acp_prev) whose last DDPM row is
(1, 0, 0) and the linearized eta = 0 DDIM table.

With the D3PM head (``model.discrete_head``) the first ``mutation_dim``
columns of the carry are bits: the x_T prior draws Bernoulli(1/2) there,
K1 reads them as 2b - 1 in the input product and K3 draws the binary
posterior from the step's uniforms (columns 4-5 of the table).

``quantize`` ("out", "io", "all"; the TPU's ``_quant_flags``, :108-124)
routes the marked products through K6 (per-row int8 activations times
per-column int8 weights, s8·s8 -> s32, dequantized with the weight scales
of :func:`sampler_kernels.pack_int8`), with the same fused epilogues. A
product whose K is at most 1024 (every block product and the output
product) quantizes its bf16 activations in K6's own prologue
(:func:`sampler_kernels.gemm_s8q` and its fused forms); the input product
(the 5142-wide carry) takes K5's codes first. The decoder's fc1 is two
products over the [h | skip] halves, each with its own scales, summed in
f32, as the TPU computes it: the first into the f32 pre-activation
buffer, the second reading it back in its GN epilogue. The activations
quantized are the bf16 ones that the GN epilogue stores, where the TPU
quantizes f32 ones. A step launches 15 kernels under "all", 13 under
"io" and 12 under "out".

Noise: "philox" (in-kernel, the DDPM default), "buffer" (a given
(n_loop, B, D) tensor: the parity hook) or "none" (DDIM). On CPU tensors
the same loop runs the kernels' plain versions.

:meth:`FusedSampler.sample_sharded` is the JAX ``sample_sharded``
(:923-1001) on a ``DeviceMesh``: each rank of the data axis runs the same
kernels on its block of the cohort's rows (the cohort padded to a multiple
of the axis; rows are independent), with its own Philox seed, and the
blocks are all-gathered.

The sampler takes the models of :func:`supports_fused` (the JAX
package's predicate, :50-66): x0, the x0 clip, the input skip, uniform
noise, no sigma head. The AR head and latent factors do not change its
loop: a latent-factor model's conditions arrive widened with the prior's
draws, and their ``c_proj`` is computed outside the kernels, as the JAX
sampler does (:890); the AR head draws the bits after calibration.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.networks import sinusoid
from ..parallel.batch import RowBlock, gather_rows
from ..parallel.mesh import DATA_AXIS, axis_group, axis_rank, axis_size
from ..utils.profiling import COUNTERS, span
from .sampler_kernels import (
    QUANT_PROLOGUE_MAX_K,
    gemm_bf16_f32acc,
    gemm_bf16_gn_silu,
    gemm_bf16_posterior,
    gemm_s8,
    gemm_s8_gn_silu,
    gemm_s8_posterior,
    gemm_s8q,
    gemm_s8q_gn_silu,
    gemm_s8q_posterior,
    gn_widths,
    groupnorm8_silu,
    kmajor_int8,
    pack_int8,
    pad16,
    rowquant_s8,
)
from .schedules import DiffusionSchedule, ddim_timesteps

NUM_GROUPS = 8


def supports_fused(model) -> bool:
    """The configurations the kernel sampler implements (the JAX package's
    ``supports_fused``, fused_sampler.py:50-66): it reads neither the AR
    head, latent factors nor CFG training, and keeps its bf16 carry
    whatever ``sample_dtype`` says."""
    d = model.denoiser
    return (
        model.parameterization == "x0"
        and not model.learn_sigma
        and model.low_rank_sigma_dim == 0
        and d.input_skip
        and model.noise_type == "uniform"
        and model.clip_denoised
        and all(h % NUM_GROUPS == 0 for h in d.hidden_dims)
        and d.hidden_dims[0] % 128 == 0
    )


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
    """x_T on the generator's device: float32 Gaussian, with Bernoulli(1/2)
    bits on the first ``mut_dim`` columns (the TPU's ``_x_init``,
    :847-861). :class:`FusedSampler` hands it a generator on the card when
    it runs there (:meth:`FusedSampler._prior_generator`)."""
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
    or the :func:`int8_parts` for K6. ``prologue`` (the block and output
    products, where every part's K fits): K6 takes A's bf16 part and
    quantizes it itself; else (the input product, the carry with its D3PM
    view) K5 quantizes each part first."""

    def __init__(self, w: torch.Tensor, device, quant: bool,
                 splits: Optional[Sequence[int]] = None, prologue: bool = True):
        self.parts = int8_parts(w, device, splits) if quant else []
        self.prologue = prologue and bool(self.parts) and all(
            hi - lo <= QUANT_PROLOGUE_MAX_K for lo, hi, _, _ in self.parts)
        self.max_kp = max((q.shape[1] for _, _, q, _ in self.parts), default=0)
        if not quant:
            self.w = padded_rows(*w.shape, torch.bfloat16, device)
            self.w.copy_(w)

    def _quantized(self, a: torch.Tensor, scratch, mut_cols: int = 0):
        """(i, last, A's operands for part i, the part's weight codes and
        column scales) for each int8 part in turn. The operands are A's
        bf16 part (K6's prologue quantizes it: the ``gemm_s8q`` wrappers),
        or K5's codes and row scales of it (the ``gemm_s8`` ones)."""
        q_buf, s_buf = scratch
        m, last = a.shape[0], len(self.parts) - 1
        for i, (lo, hi, q, scale) in enumerate(self.parts):
            if self.prologue:
                yield i, last, (a[:, lo:hi],), q, scale
                continue
            kp = pad16(hi - lo)
            qa, rs = rowquant_s8(a[:, lo:hi], out=q_buf[: m * kp].view(m, kp), scale=s_buf[:m],
                                 mut_cols=mut_cols if lo == 0 else 0)
            yield i, last, (qa, rs), q, scale

    def __call__(self, a: torch.Tensor, out: torch.Tensor, scratch, bias=None, row_add=None,
                 mut_cols: int = 0) -> None:
        """out = a·W + bias + row_add (``mut_cols``: 2a - 1 on A's first
        columns)."""
        if not self.parts:
            gemm_bf16_f32acc(a, self.w, out=out, bias=bias, row_add=row_add, a_mut_cols=mut_cols)
            return
        product = gemm_s8q if self.prologue else gemm_s8
        for i, last, ops, q, scale in self._quantized(a, scratch, mut_cols):
            product(*ops, q, scale, out=out, bias=bias if i == last else None,
                    row_add=row_add if i == last else None, accumulate=i > 0)

    def gn_silu(self, a: torch.Tensor, out: torch.Tensor, scratch, pre, bias, gn_scale,
                gn_bias) -> None:
        """out = bf16(SiLU(GroupNorm8(a·W + bias)·gn_scale + gn_bias)), GN in
        the product's epilogue. A split int8 weight sums its earlier parts
        into the f32 ``pre``, which the last part's epilogue reads."""
        if not self.parts:
            gemm_bf16_gn_silu(a, self.w, bias, gn_scale, gn_bias, out=out)
            return
        product, fused = ((gemm_s8q, gemm_s8q_gn_silu) if self.prologue
                          else (gemm_s8, gemm_s8_gn_silu))
        for i, last, ops, q, scale in self._quantized(a, scratch):
            if i < last:
                product(*ops, q, scale, out=pre, accumulate=i > 0)
            else:
                fused(*ops, q, scale, bias, gn_scale, gn_bias, out=out,
                      acc_into=pre if last else None)

    def posterior(self, a: torch.Tensor, x: torch.Tensor, scratch, **step) -> None:
        """The output product with the reverse step as its epilogue, on the
        carry ``x`` in place (``step``: the arguments of
        :func:`sampler_kernels.x0_posterior_step` after ``x``)."""
        if not self.parts:
            gemm_bf16_posterior(a, self.w, x, **step)
            return
        fused = gemm_s8q_posterior if self.prologue else gemm_s8_posterior
        for _, _, ops, q, scale in self._quantized(a, scratch):
            fused(*ops, q, scale, x, **step)


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
        # GN in the products' epilogue where a tile width holds whole groups.
        self.fused = bool(gn_widths(self.features))
        self.needs_pre = not self.fused or len(self.fc1.parts) > 1

    def run(self, a: torch.Tensor, out: torch.Tensor, mid: torch.Tensor,
            pre: Optional[torch.Tensor], scratch) -> None:
        if self.fused:
            self.fc1.gn_silu(a, mid, scratch, pre, self.b1, self.g1, self.n1)
            self.fc2.gn_silu(mid, out, scratch, pre, self.b2, self.g2, self.n2)
            return
        self.fc1(a, pre, scratch, bias=self.b1)
        groupnorm8_silu(pre, self.g1, self.n1, out=mid, mode="unfused_block")
        self.fc2(mid, pre, scratch, bias=self.b2)
        groupnorm8_silu(pre, self.g2, self.n2, out=out, mode="unfused_block")


class FusedSampler:
    """Host tables and weight layout built once per (model, device); each
    :meth:`sample` call runs the reverse loop through the kernels."""

    def __init__(self, model, device, ddim_steps: Optional[int] = None,
                 quantize: Optional[str] = None):
        if not supports_fused(model):
            raise ValueError("the kernel sampler does not take this model configuration "
                             "(supports_fused); the scan sampler runs it")
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

        self.w_in = _Weight(sd["input_proj.weight"].T, dev, q_in, prologue=False)
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
        ``cats[L-1-i]``. ``pre`` (f32) exists only where a block needs it
        (:attr:`_Block.needs_pre`: a split int8 fc1, or GN run apart).
        ``quant`` is K5's scratch (codes, row scales)."""
        dev, bf = self.device, torch.bfloat16
        blocks = self.encoders + [self.bottleneck] + self.decoders
        feats = [b.features for b in self.encoders]
        prev = [self.bottleneck.features] + [b.features for b in self.decoders[:-1]]
        skips = feats[::-1]
        cats = [torch.empty(batch, p + s, dtype=bf, device=dev) for p, s in zip(prev, skips)]
        width = max([self.hidden[0]] + [b.features for b in blocks])
        pre = max([b.features for b in blocks if b.needs_pre], default=0)
        return {
            "h_in": torch.empty(batch, self.hidden[0], dtype=bf, device=dev),
            "cats": cats,
            "pre": torch.empty(batch * pre, dtype=torch.float32, device=dev) if pre else None,
            "mid": torch.empty(batch * width, dtype=bf, device=dev),
            "h_last": torch.empty(batch, self.decoders[-1].features if self.decoders
                                  else self.bottleneck.features, dtype=bf, device=dev),
            "quant": (torch.empty(batch * self.max_kp, dtype=torch.int8, device=dev),
                      torch.empty(batch, dtype=torch.float32, device=dev)),
        }

    def run_stack(self, buf) -> None:
        """The block stack from ``buf["h_in"]`` to ``buf["h_last"]`` (K1 with
        the GN epilogue, or K5 and K6 with it under int8): the stack of every
        reverse step, and of the latent-tail sampler's steps on its 256-wide
        state."""
        batch = buf["h_in"].shape[0]
        cats: List[torch.Tensor] = buf["cats"]
        n_enc = len(self.encoders)
        scratch = buf["quant"]

        def scratch_rows(f):
            pre = buf["pre"]
            return (buf["mid"][: batch * f].view(batch, f),
                    None if pre is None else pre[: batch * f].view(batch, f))

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
        self.w_out.posterior(buf["h_last"], x, scratch, b_out=self.b_out, coeffs=self.coeffs,
                             step=s, mode=mode, noise=noise, seed=seed, clip=self.clip_value,
                             mut_dim=self.mut_dim)

    def _mode(self, noise: Optional[torch.Tensor]) -> str:
        if self.ddim_steps is not None:
            if noise is not None:
                raise ValueError("eta = 0 DDIM takes no transition noise")
            return "none"
        return "philox" if noise is None else "buffer"

    def _check_noise(self, noise: Optional[torch.Tensor], batch: int) -> Optional[torch.Tensor]:
        if noise is None:
            return None
        if tuple(noise.shape) != (self.n_loop, batch, self.data_dim):
            raise ValueError(f"noise must be ({self.n_loop}, {batch}, {self.data_dim}), "
                             f"got {tuple(noise.shape)}")
        return noise.to(device=self.device, dtype=torch.float32).contiguous()

    def _c_proj(self, conditions: torch.Tensor) -> torch.Tensor:
        """The loop-invariant condition projection (plain torch, as the JAX
        sampler computes it outside its kernel), rounded to bf16 (:890)."""
        d = self.model.denoiser
        home = next(d.parameters()).device
        c_proj = d.embed_conditions(conditions.to(home, torch.float32))
        return c_proj.to(self.device, torch.bfloat16).float().contiguous()

    def _run(self, x_init: torch.Tensor, c_proj: torch.Tensor, mode: str,
             noise: Optional[torch.Tensor], seed: int, n_run: int) -> torch.Tensor:
        """The first ``n_run`` reverse rows from ``x_init`` through the
        kernels; the bf16 carry's values as float32."""
        batch = x_init.shape[0]
        x = padded_rows(batch, self.data_dim, torch.bfloat16, self.device)  # TMA-readable rows
        x.copy_(x_init)
        buf = self._buffers(batch)
        with span("sampler.steps", self.device):
            for s in range(n_run):
                self._step(s, x, c_proj, buf, mode, noise, seed)
            COUNTERS["sampler.steps"] += n_run
        return x.float().contiguous()

    def _prior_generator(self, generator: torch.Generator) -> torch.Generator:
        """The generator x_T is drawn from, counted in
        ``COUNTERS["sampler.prior_device"]`` or ``["sampler.prior_host"]``.
        A sampler on a CUDA device handed a host generator takes one 63-bit
        key from it and draws on the card, from a CUDA generator seeded with
        that key, so no host draw and no copy of x_T hold the card back;
        otherwise (a CPU sampler, a generator already on a card) the
        request's own generator, from which nothing is drawn here."""
        if self.device.type == "cuda" and generator.device.type != "cuda":
            key = int(torch.randint(0, 2**63 - 1, (1,), generator=generator))
            generator = torch.Generator(device=self.device).manual_seed(key)
        COUNTERS["sampler.prior_device" if generator.device.type == "cuda"
                 else "sampler.prior_host"] += 1
        return generator

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: torch.Generator,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               stop_after: Optional[int] = None) -> torch.Tensor:
        """Samples (B, D) float32 on the sampler's device. ``x_init``: the
        x_T prior (B, D); when omitted it is drawn after the Philox seed,
        from ``generator`` itself on the CPU, and on a CUDA sampler on the
        card, from a card generator seeded with one 63-bit key taken from a
        host ``generator`` (:meth:`_prior_generator`: the same law as a host
        draw, another stream); ``noise``:
        (n_loop, B, D) per-step transition noise replacing the in-kernel
        Philox stream (DDPM only; with the D3PM head its mutation columns
        give the bit uniforms z/(2sqrt3) + 1/2). ``stop_after``: run only
        the first N reverse rows and return the carry x_{t(N)} (its bf16
        values, as float32): the data-space head of the latent-tail sampler
        (the JAX ``stop_after``, fused_sampler.py:879-883); ``noise`` keeps
        its full shape."""
        batch = conditions.shape[0]
        n_run = self.n_loop if stop_after is None else int(stop_after)
        if not 0 <= n_run <= self.n_loop:
            raise ValueError(f"stop_after must be in [0, {self.n_loop}], got {stop_after}")
        mode = self._mode(noise)
        noise = self._check_noise(noise, batch)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))
        if x_init is None:
            with span("sampler.prior"):
                x_init = x_prior(batch, self.data_dim, self.mut_dim,
                                 self._prior_generator(generator))
        return self._run(x_init, self._c_proj(conditions), mode, noise, seed, n_run)

    @torch.no_grad()
    def sample_sharded(self, mesh, conditions: torch.Tensor, generator: torch.Generator,
                       x_init: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       keep_bf16: bool = False) -> torch.Tensor:
        """:meth:`sample` over the data axis of ``mesh`` (a ``DeviceMesh``
        from ``parallel.make_mesh``), the JAX ``sample_sharded``: every rank
        computes ``c_proj`` for the whole cohort and draws the whole
        ``x_init`` as :meth:`sample` does (every rank takes the same key
        from ``generator``, so all ranks hold the same x_T: on the CPU, and
        on identical cards, whose CUDA generators give one stream for one
        key), pads the cohort to a multiple of the axis, runs the kernels
        on its block of rows with its own Philox seed (one of ``world``
        drawn after rank 0's seed and the x_T key, as the JAX
        ``jax.random.bits(seed_rng, (n_dev, 1))``), and all-gathers the
        blocks. ``noise`` (n_loop, B, D) is sliced on its batch axis. In
        "none" and "buffer" modes the cohort is :meth:`sample`'s on the
        same generator (or ``x_init``) and noise, bit for bit where every
        rank's products take the whole cohort's kernel plans (one rank; the
        plain versions on the CPU), and else up to the bf16 carry's
        rounding, since K1's split-K plan follows a block's row count; on
        one rank in "philox" mode too. Returns (B, D) float32 on every rank
        (bf16 with ``keep_bf16``)."""
        world, rank = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
        batch = conditions.shape[0]
        mode = self._mode(noise)
        noise = self._check_noise(noise, batch)
        # Rank 0's seed and x_init are the draws :meth:`sample` makes from
        # the same generator; the other ranks' seeds come after them.
        seeds = [torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device)]
        if x_init is None:
            with span("sampler.prior"):
                x_init = x_prior(batch, self.data_dim, self.mut_dim,
                                 self._prior_generator(generator))
        seeds.append(torch.randint(0, 2**31 - 1, (world - 1,), generator=generator,
                                   device=generator.device))
        seeds = torch.cat(seeds)
        rows = RowBlock.of(batch, world, rank)
        local = self._run(rows.take(x_init.to(self.device)), rows.take(self._c_proj(conditions)),
                          mode, None if noise is None else rows.take(noise, dim=1).contiguous(),
                          int(seeds[rank]), self.n_loop)
        out = gather_rows(axis_group(mesh, DATA_AXIS), local, batch)
        return out.to(torch.bfloat16) if keep_bf16 else out
