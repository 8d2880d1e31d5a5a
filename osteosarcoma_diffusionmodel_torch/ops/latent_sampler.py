"""Latent-tail DDPM sampling: the reverse loop's tail in hidden space.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/latent_sampler.py
(`supports_latent`, `LatentTailSampler`, `LatentFusedSampler`,
`calibrate_head_steps`). The denoiser touches data space only through
affine maps (``input_proj`` in; ``output_proj`` and the time-gain skip
out) and the x0-param posterior step is affine in (x_t, x0_pred, z), so
while the x0 clip does not bind a reverse step is linear in the state and
can run in the ``hidden_dims[0]``-wide latent s = x·K_in:

    s <- A_t·s + c0_t·(h_t·M2 + m_b) + sv_t·(zeta_t·Lᵀ)

with A_t = c1_t + c0_t·g_t, M2 = K_out·K_in, m_b = b_out·K_in and
L = chol(K_inᵀK_in). The loop accumulates H_acc = Σ w_t h_t and
xi = Σ v_t zeta_t (suffix-product weights, host float64) and the cohort
is reconstructed once:

    x_1 = c_x·x_head + H_acc·K_out + c_beta·b_out + xi·Cᵀ
          + sqrt(v2)·(eta - (eta·K_in)·R)

then x_0 = clip(h0·K_out + b_out + g·x_1). The first ``head_steps`` rows,
where the clip can bind, run in data space (the kernel sampler's
``stop_after`` head); :func:`calibrate_head_steps` probes for that
switch point. The tail drops the clip (latent_sampler.py:41-45, :279), so
the hybrid equals the data-space sampler only where the probe says the
clip does not bind.

:class:`LatentTailSampler` is the plain PyTorch reference in f32 (the
JAX "XLA reference"); :class:`LatentFusedSampler` runs the data-space
head on the kernel sampler's step (K1, with K2's and K3's work as
epilogues) and each latent step in 11 launches: the hidden stack (K1 with
the GN epilogue, 10) and one K1 launch that computes the step's two
256-wide products with K7's work as its epilogue
(``gemm_bf16_latent_step``), after one priming draw of zeta_0 a call
(K7's ``latent_draw``). The
one-time reconstruction is plain f32 ``torch.matmul`` in full f32 (no
TF32: eta - (eta·K_in)·R cancels), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.networks import sinusoid
from .fused_sampler import FusedSampler, _bf16
from .precision import full_f32_matmul  # the projection eta - (eta·K_in)·R cancels
from .sampler_kernels import UNIFORM_SCALE, gemm_bf16_latent_step, latent_draw


def supports_latent(model) -> bool:
    """The configurations the latent tail implements (JAX :72-82): x0, no
    sigma head, the input-skip gain, the x0 clip, no D3PM mutation head."""
    return (
        model.parameterization == "x0"
        and not model.learn_sigma
        and model.low_rank_sigma_dim == 0
        and bool(model.denoiser.input_skip)
        and model.clip_denoised
        and not (model.discrete_head and model.mutation_dim)
    )


def _uniform_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U(-sqrt3, sqrt3) draws from ``generator`` (on its device), moved to
    ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((u - 0.5) * UNIFORM_SCALE).to(device)


class LatentTailSampler:
    """Host tables of the latent algebra, built once per (model, head
    length) in float64 numpy and cast once to f32 on ``device``;
    :meth:`sample` runs the hybrid head + latent tail as plain PyTorch
    over the denoiser module, which it moves to ``device`` (as the
    generator does)."""

    def __init__(self, model, head_steps: int = 1, device="cuda"):
        if not supports_latent(model):
            raise ValueError("model configuration not supported by the latent-tail sampler; "
                             "use the data-space FusedSampler")
        d = model.denoiser
        self.model = model
        self.device = dev = torch.device(device)
        self.data_dim = d.data_dim
        sched = model.schedule
        self.T = T = int(sched.num_steps)
        if not 1 <= head_steps <= T - 1:
            raise ValueError(f"head_steps must be in [1, {T - 1}], got {head_steps}")
        self.head_steps = int(head_steps)
        self.clip_value = float(model.clip_value)
        d.to(dev)
        p = {k: v.detach().cpu().double().numpy() for k, v in d.state_dict().items()}

        # Per-row tables in reverse time (row T-1 is t = 0), as JAX :125-149:
        # the sinusoid rounded to f32 (its TimeEmbedding), then float64.
        ts = np.arange(T - 1, -1, -1)
        sin = sinusoid(torch.from_numpy(ts / T), d.time_dim).numpy()
        sin = sin.astype(np.float32).astype(np.float64)
        t_emb = sin @ p["time_proj.weight"].T + p["time_proj.bias"]
        gains = (sin @ p["skip_gain.weight"].T + p["skip_gain.bias"])[:, 0]
        c0 = np.asarray(sched.posterior_coef_x0, np.float64)[ts].copy()
        c1 = np.asarray(sched.posterior_coef_xt, np.float64)[ts].copy()
        sv = np.sqrt(np.asarray(sched.posterior_variance, np.float64))[ts].copy()
        c0[-1], c1[-1], sv[-1] = 1.0, 0.0, 0.0  # t = 0: x0 = clip(out), no noise
        self.c0, self.c1, self.sv, self.gains = c0, c1, sv, gains

        # The latent algebra (JAX :151-168), float64 on the host.
        K_in = p["input_proj.weight"].T  # (D, H0)
        K_out = p["output_proj.weight"].T  # (H_last, D)
        b_out = p["output_proj.bias"]
        G = K_in.T @ K_in
        L = np.linalg.cholesky(G + 1e-9 * np.eye(G.shape[0]))
        R = np.linalg.solve(G, K_in.T)  # G^-1 K_inᵀ
        C = K_in @ np.linalg.solve(G, L)  # K_in G^-1 L

        f32 = self._f32
        self.t_add = f32(t_emb + p["input_proj.bias"])
        self.gains_f32, self.c0_f32, self.c1_f32, self.sv_f32 = (f32(a) for a in (gains, c0, c1, sv))
        self.K_in, self.K_out, self.b_out = f32(K_in), f32(K_out), f32(b_out)
        self.L_T, self.C_T, self.R = f32(L.T), f32(C.T), f32(R)
        self.M2 = f32(K_out @ K_in)  # (H_last, H0)
        self.m_b = f32(b_out @ K_in)  # (H0,)
        self._set_segment(self.head_steps)

    def _f32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def _set_segment(self, head_steps: int) -> None:
        """Tables of the latent segment, rows [head_steps, T-2] (JAX
        :173-192): suffix products of A in float64, cast once to f32 (early
        rows may underflow to 0 in f32, as they do in JAX)."""
        rows = np.arange(head_steps, self.T - 1)
        A = self.c1[rows] + self.c0[rows] * self.gains[rows]
        # P[k] = prod of A over the segment's rows after k.
        P = (np.concatenate([np.cumprod(A[::-1])[::-1][1:], np.array([1.0])])
             if len(rows) else np.zeros((0,)))
        self.seg_rows = rows
        self.A = self._f32(A)
        self.w = self._f32(self.c0[rows] * P)
        self.v = self._f32(self.sv[rows] * P)
        self.seg_sv = self._f32(self.sv[rows])
        self.seg_c0 = self._f32(self.c0[rows])
        self.c_x = float(np.prod(A)) if len(rows) else 1.0
        self.c_beta = float(np.sum(self.c0[rows] * P))
        self.v2 = float(np.sum((self.sv[rows] * P) ** 2))

    # ------------------------------------------------------------------
    def _hidden(self, h_in: torch.Tensor) -> torch.Tensor:
        return self.model.denoiser.hidden_forward(h_in).float()

    def _c_proj(self, conditions: torch.Tensor) -> torch.Tensor:
        d = self.model.denoiser
        home = next(d.parameters()).device
        return d.embed_conditions(conditions.to(home, torch.float32)).to(
            self.device, torch.float32).contiguous()

    def _x_init(self, batch: int, generator, x_init) -> torch.Tensor:
        if x_init is None:
            x_init = torch.randn((batch, self.data_dim), generator=generator,
                                 device=generator.device)
        return x_init.to(self.device, torch.float32)

    def _data_step(self, x, row: int, c_proj, z) -> Tuple[torch.Tensor, torch.Tensor]:
        """One full-width f32 reverse step; returns (x_next, max|out|)."""
        h = self._hidden(x @ self.K_in + self.t_add[row] + c_proj)
        out = h @ self.K_out + self.b_out + self.gains_f32[row] * x
        x0 = torch.clamp(out, -self.clip_value, self.clip_value)
        x_next = self.c0_f32[row] * x0 + self.c1_f32[row] * x + self.sv_f32[row] * z
        return x_next, out.abs().max()

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: torch.Generator,
               x_init: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Hybrid head + latent tail (JAX :216-339), (B, D) f32 on the
        sampler's device. ``x_init``: x_T (drawn from ``generator`` when
        omitted). ``noise``: (T, B, D) per-row transition noise replacing
        every draw after x_T; the tail then consumes each row through its
        K_in projection and adds the accumulated wide sum, so the output
        equals the data-space loop's up to f32 association."""
        T, D, n_head = self.T, self.data_dim, self.head_steps
        batch = conditions.shape[0]
        dev = self.device
        if noise is not None:
            if tuple(noise.shape) != (T, batch, D):
                raise ValueError(f"noise must be ({T}, {batch}, {D}), got {tuple(noise.shape)}")
            noise = noise.to(dev, torch.float32)
        with full_f32_matmul():
            x = self._x_init(batch, generator, x_init)
            c_proj = self._c_proj(conditions)
            for row in range(n_head):
                z = noise[row] if noise is not None else _uniform_noise((batch, D), generator, dev)
                x, _ = self._data_step(x, row, c_proj, z)

            n_lat = T - 1 - n_head
            if n_lat == 0:  # the head covers every loop row
                h0 = self._hidden(x @ self.K_in + self.t_add[T - 1] + c_proj)
                out0 = h0 @ self.K_out + self.b_out + self.gains_f32[T - 1] * x
                return torch.clamp(out0, -self.clip_value, self.clip_value)

            H0 = self.K_in.shape[1]
            s = x @ self.K_in
            h_acc = torch.zeros(batch, self.K_out.shape[0], device=dev)
            tail = torch.zeros(batch, D if noise is not None else H0, device=dev)
            for k in range(n_lat):
                row = n_head + k
                h = self._hidden(s + self.t_add[row] + c_proj)
                o_lat = h @ self.M2 + self.m_b
                if noise is not None:
                    n_inj = noise[row] @ self.K_in
                    tail = tail + self.v[k] * noise[row]
                else:
                    zeta = _uniform_noise((batch, H0), generator, dev)
                    n_inj = zeta @ self.L_T
                    tail = tail + self.v[k] * zeta
                s = self.A[k] * s + self.seg_c0[k] * o_lat + self.seg_sv[k] * n_inj
                h_acc = h_acc + self.w[k] * h

            x1 = self.c_x * x + h_acc @ self.K_out + self.c_beta * self.b_out
            if noise is not None:
                x1 = x1 + tail  # the exact accumulated wide noise
            else:
                eta = torch.randn((batch, D), generator=generator, device=generator.device).to(dev)
                resid = eta - (eta @ self.K_in) @ self.R
                x1 = x1 + tail @ self.C_T + math.sqrt(self.v2) * resid
            h0 = self._hidden(s + self.t_add[T - 1] + c_proj)
            out0 = h0 @ self.K_out + self.b_out + self.gains_f32[T - 1] * x1
            return torch.clamp(out0, -self.clip_value, self.clip_value)


class LatentFusedSampler:
    """Data-space head on the kernel sampler (``FusedSampler.sample``
    with ``stop_after``), then the latent segment, one step at a time: the
    stack on K1 with the GN epilogue, then the step's products and K7's
    work in one launch (``gemm_bf16_latent_step``), then the one-time wide
    reconstruction (JAX :476-697).
    Tables come from :class:`LatentTailSampler`. Runs on ``device``."""

    def __init__(self, model, head_steps: int = 1, device="cuda"):
        self.tables = t = LatentTailSampler(model, head_steps, device)
        self.head = FusedSampler(model, t.device)
        self.device = t.device
        self.head_steps = t.head_steps
        self.n_lat = len(t.seg_rows)
        self.H0 = t.K_in.shape[1]
        if t.K_out.shape[0] != self.H0:
            raise ValueError("the latent tail needs the stack's output width to equal hidden_dims[0]")
        self.m2 = _bf16(t.M2, self.device)
        self.m_b = t.m_b
        self.l_t = _bf16(t.L_T, self.device)
        # (n_lat, 5): A, c0, sv (segment rows), w, v (JAX :558-565); K7
        # reads row k, so the loop can later be captured in a CUDA graph.
        self.coeffs = torch.stack([t.A, t.seg_c0, t.seg_sv, t.w, t.v], dim=1).contiguous()
        # The segment's t_add rows plus the final (t = 0) row (JAX :568).
        self.tadd_seg = t.t_add[self.head_steps:].contiguous()

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: torch.Generator,
               x_init: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
               zeta: Optional[torch.Tensor] = None,
               eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, D) f32 on the sampler's device. Seams: ``x_init`` (B, D)
        x_T; ``noise`` (T, B, D) the head's transition noise (full shape,
        as the kernel sampler takes it); ``zeta`` (n_lat, B, H0) the latent
        draws (K7 "buffer" mode; in-kernel Philox when omitted); ``eta``
        (B, D) the reconstruction's residual draw. Outside the seams the
        randomness comes from ``generator``."""
        t, dev = self.tables, self.device
        batch, D, H0 = conditions.shape[0], t.data_dim, self.H0
        mode = "philox" if zeta is None else "buffer"
        if zeta is not None:
            if tuple(zeta.shape) != (self.n_lat, batch, H0):
                raise ValueError(f"zeta must be ({self.n_lat}, {batch}, {H0}), "
                                 f"got {tuple(zeta.shape)}")
            zeta = zeta.to(dev, torch.float32).contiguous()

        x_head = self.head.sample(conditions, generator, x_init=x_init, noise=noise,
                                  stop_after=self.head_steps)
        c_proj = t._c_proj(conditions)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))
        buf = self.head._buffers(batch)
        h_in, h = buf["h_in"], buf["h_last"]
        with full_f32_matmul():
            s = (x_head @ t.K_in).contiguous()
        h_in.copy_(s + self.tadd_seg[0] + c_proj)
        h_acc = torch.zeros(batch, H0, device=dev)
        xi = torch.zeros(batch, H0, device=dev)
        # zeta_k lives in zeta_bf[k % 2]: step k's launch reads all of it as a
        # product's operand while it draws zeta_{k+1} into the other buffer.
        zeta_bf = [torch.empty(batch, H0, dtype=torch.bfloat16, device=dev) for _ in range(2)]
        if self.n_lat:  # zeta_0 and xi += v_0·zeta_0 (step 0 adds w_0·h_0)
            latent_draw(None, None, xi, zeta_bf[0], self.coeffs, 0, mode, zeta=zeta, seed=seed)
        for k in range(self.n_lat):
            self.head.run_stack(buf)
            gemm_bf16_latent_step(h, self.m2, self.m_b, zeta_bf[k % 2], self.l_t, s, c_proj,
                                  self.tadd_seg, self.coeffs, k, h_in, h_acc, xi,
                                  zeta_bf[(k + 1) % 2], mode, zeta=zeta, seed=seed)
        self.head.run_stack(buf)  # h0 from the last latent state and the t = 0 row
        h0 = h.float()

        if eta is None:
            eta = torch.randn((batch, D), generator=generator, device=generator.device)
        eta = eta.to(dev, torch.float32)
        with full_f32_matmul():
            x1 = t.c_x * x_head + h_acc @ t.K_out + t.c_beta * t.b_out
            resid = eta - (eta @ t.K_in) @ t.R
            x1 = x1 + xi @ t.C_T + math.sqrt(t.v2) * resid
            out0 = h0 @ t.K_out + t.b_out + t.gains_f32[t.T - 1] * x1
        return torch.clamp(out0, -t.clip_value, t.clip_value)


@torch.no_grad()
def calibrate_head_steps(model, conditions: torch.Tensor, generator: torch.Generator,
                         margin: float = 0.5, min_head: int = 1,
                         device="cuda") -> Tuple[int, np.ndarray]:
    """Probe a data-space trajectory for x0-clip headroom and pick the
    latent switch point (JAX :701-751), in plain PyTorch.

    Runs the full-width f32 reverse loop once on ``conditions`` (a few
    hundred rows suffice), recording each row's max |x0_pred| before the
    clip. A loop row is unsafe when that exceeds ``margin·clip_value``; the
    head must cover every unsafe row, so it is (last unsafe row + 1),
    floored at ``min_head``. The final row's clip is always exact (data
    space), so it never forces the head. Returns (head_steps, (T,) profile)."""
    sampler = LatentTailSampler(model, 1, device)
    T, dev = sampler.T, sampler.device
    batch = conditions.shape[0]
    peaks = []
    with full_f32_matmul():
        x = sampler._x_init(batch, generator, None)
        c_proj = sampler._c_proj(conditions)
        for row in range(T):
            z = _uniform_noise((batch, sampler.data_dim), generator, dev)
            x, peak = sampler._data_step(x, row, c_proj, z)
            peaks.append(peak)
    profile = torch.stack(peaks).cpu().numpy()
    unsafe = np.nonzero(profile[: T - 1] > margin * sampler.clip_value)[0]
    head = int(unsafe[-1]) + 1 if unsafe.size else min_head
    return max(head, min_head), profile
