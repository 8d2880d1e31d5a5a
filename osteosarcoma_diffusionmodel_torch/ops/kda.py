"""Kimi Delta Attention's chunked forward (``models/kda.py``): the gated
delta rule with a decay per key channel, beside its plain chunked twin.

Per head, token t (q and k L2-normalised, ``g`` the log decay ≤ 0 of each
key channel, ``beta`` the write strength)::

    S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ,   S_0 = 0,
    o_t = scale · S_tᵀ q_t.

Both versions cut the sequence into chunks and, within a chunk of rows i,
j (Γ the cumulative log decay from the chunk's start, inclusive; S_0 the
state at its start), form

- ``A_ij = β_i Σ_c k_ic k_jc exp(Γ_ic − Γ_jc)`` (j < i) and
  ``P_ij = scale Σ_c q_ic k_jc exp(Γ_ic − Γ_jc)`` (j ≤ i);
- the WY/UT transform ``[W | U] = (I + A)⁻¹ [β·k·exp(Γ) | β·v]``;
- ``u = U − W S_0``, the output ``scale·(q·exp(Γ)) S_0 + P u`` and the
  state ``Diag(exp Γ_end) S_0 + (k·exp(Γ_end − Γ))ᵀ u`` handed to the next
  chunk in f32.

Every exponent is a difference ≤ 0, never ``exp(±Γ)`` alone: a channel at
the published initialisation can decay by e^-10 a token, e^-640 over a
chunk of 64.

:func:`kda_chunk` takes the hand-written kernel of ``csrc/kda_chunk.cu``
(chunk 64, head widths 128, one launch a layer call) for CUDA tensors, with
autograd too: its backward recomputes the forward through
:func:`kda_chunk_plain` and differentiates that. CPU tensors take
:func:`kda_chunk_plain`, and autograd follows it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import LIBRARY, check
from .sampler_kernels import Kernel, _on_cuda, _stream

_SOURCE = "osteosarcoma_diffusionmodel_torch/csrc/kda_chunk.cu"
KDA = Kernel("kda_chunk", _SOURCE,
             "none (the hybrid transformer denoiser's KDA layers; the JAX package has no "
             "linear attention)")
CHUNK = 64
WIDTH = 128  # the kernel's key and value width of a head


def kda_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    beta: torch.Tensor, scale: float, chunk: int = CHUNK) -> torch.Tensor:
    """(B, L, H, Dv) f32: the chunked algebra above in f32 over ``q``, ``k``,
    ``g`` (B, L, H, Dk), ``v`` (B, L, H, Dv) and ``beta`` (B, L, H), one
    chunk after another; the sequence's end padded with rows that neither
    decay nor write."""
    b, length, heads, dk = q.shape
    dv = v.shape[-1]
    n = -(-length // chunk)
    pad = n * chunk - length

    def chunks(x: torch.Tensor) -> torch.Tensor:  # (B, L, H, ...) -> (B, H, n, C, ...)
        x = F.pad(x.float(), (0, 0) * (x.dim() - 2) + (0, pad))
        x = x.view(b, n, chunk, heads, *x.shape[3:])
        return x.permute(0, 3, 1, 2, *range(4, x.dim()))

    qc, kc, vc, bc = chunks(q), chunks(k), chunks(v), chunks(beta)
    gamma = chunks(g).cumsum(dim=3)
    lower = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    strict = lower.tril(-1)
    eye = torch.eye(chunk, device=q.device)
    state = q.new_zeros(b, heads, dk, dv, dtype=torch.float32)
    outs = []
    for c in range(n):
        qi, ki, vi, bi, gi = qc[:, :, c], kc[:, :, c], vc[:, :, c], bc[:, :, c], gamma[:, :, c]
        diff = gi[..., :, None, :] - gi[..., None, :, :]  # Γ_i − Γ_j, (B, H, C, C, Dk)
        e = torch.exp(diff.masked_fill(~lower[..., None], float("-inf")))
        ke = ki[..., None, :, :] * e
        a = ((ki[..., :, None, :] * ke).sum(-1) * bi[..., :, None]).masked_fill(~strict, 0.0)
        p = (qi[..., :, None, :] * ke).sum(-1) * scale
        decay = torch.exp(gi)
        rhs = torch.cat([bi[..., None] * ki * decay, bi[..., None] * vi], dim=-1)
        wu = torch.linalg.solve_triangular(eye + a, rhs, upper=False, unitriangular=True)
        w, u = wu.split([dk, dv], dim=-1)
        u = u - w @ state
        outs.append((qi * decay * scale) @ state + p @ u)
        end = gi[..., -1, :]
        state = (torch.exp(end)[..., :, None] * state
                 + (ki * torch.exp(end[..., None, :] - gi)).transpose(-1, -2) @ u)
    o = torch.stack(outs, dim=2)  # (B, H, n, C, Dv)
    return o.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, heads, dv)[:, :length]


def _check(t: torch.Tensor, name: str, shape) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")


class _KernelForward(torch.autograd.Function):
    """``launch``'s output forward; backward the gradient of
    :func:`kda_chunk_plain` of the saved inputs, recomputed (the kernel
    keeps no intermediates)."""

    @staticmethod
    def forward(ctx, launch, q, k, v, g, beta, scale):
        ctx.save_for_backward(q, k, v, g, beta)
        ctx.scale = scale
        return launch(q, k, v, g, beta, scale)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[1:6]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = kda_chunk_plain(*inputs, ctx.scale)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
        return (None, *(next(grads) if n else None for n in need), None)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
            beta: torch.Tensor, scale: float) -> torch.Tensor:
    b, length, heads, _ = q.shape
    out = torch.empty_like(v)
    check(LIBRARY.get().osdm_kda_chunk(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                       beta.data_ptr(), out.data_ptr(), b, length, heads,
                                       float(scale), _stream(q)), KDA.name)
    KDA.count()
    return out


def kda_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              beta: torch.Tensor, scale: float) -> torch.Tensor:
    """:func:`kda_chunk_plain` of ``q``, ``k``, ``v``, ``g`` (B, L, H, D) and
    ``beta`` (B, L, H), contiguous f32: on the card one launch of
    ``kda_chunk_kernel`` (D = 128), the same algebra in another order of f32
    sums, and under autograd the twin's gradient of the same inputs."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, L, H, D), got shape {tuple(q.shape)}")
    b, length, heads, dk = q.shape
    for t, name in ((q, "q"), (k, "k"), (g, "g")):
        _check(t, name, q.shape)
    _check(v, "v", (b, length, heads, v.shape[-1]))
    _check(beta, "beta", (b, length, heads))
    if not _on_cuda(q, k, v, g, beta):
        return kda_chunk_plain(q, k, v, g, beta, scale)
    if dk != WIDTH or v.shape[-1] != WIDTH:
        raise ValueError(f"the KDA kernel takes heads of width {WIDTH}, got {dk} and "
                         f"{v.shape[-1]}")
    if b * heads >= 2 ** 31 or any(t.data_ptr() % 16 for t in (q, k, v, g)):
        raise ValueError("the KDA kernel takes B·H below 2^31 and 16-byte aligned rows")
    return _KernelForward.apply(_launch, q, k, v, g, beta, scale)
