"""The grouped expert products of a DeepSeekMoE layer (``models/dit.py``)
and the routing's permutation around them, beside their plain versions.

A layer's T tokens each choose k experts. :func:`expert_plan` sorts the
T·k token copies by expert (a stable sort of the flattened choices, so
copies of one expert keep their token order) and keeps, on the device, the
prefix sums of each expert's rows and of its 64-row tiles; the host never
reads the routing. Then, in one launch each (csrc/moe_grouped.cu, on the
sm90 mainloop of K1):

- :func:`grouped_swiglu`: ``bf16(SiLU(a·W_gate) · (a·W_up))`` for every
  expert's rows of the permuted activations, the gate and up products in
  one accumulator, f32 arithmetic;
- :func:`grouped_down`: ``(h·W_down)·row_scale`` in f32, each row stored
  at its ``dest`` row: the routing weight and the inverse permutation in
  the epilogue, so the caller's combine is a sum over the k copies.

Weights: ``w_gate_up`` (E, K, 2I) holds each expert's [gate | up] as one
(K, 2I) row-major matrix (the transposes of Moonlight's ``gate_proj`` and
``up_proj``); ``w_down`` (E, I, N) the transposes of ``down_proj``.

A wrapper launches the kernel for CUDA tensors and counts the launch by
mode ("swiglu", "down"); for CPU tensors it runs the plain version.
:func:`expert_swiglu` and :func:`expert_down` are the two products with a
backward (training, sample-path fine-tuning): the activations' gradients
are grouped products of the transposed weights, in the "down" mode of the
same kernel (the SwiGLU's gate and up recomputed there, not kept), and
each expert's weight gradient is one product over that expert's rows
(:func:`grouped_weight_grad`, one read of the row counts a call).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._build import LIBRARY, check
from .sampler_kernels import Kernel, _on_cuda, _stream

TILE_ROWS = 64
EPILOGUES = {"swiglu": 0, "down": 1}

MOE_GROUPED = Kernel(
    "moe_grouped",
    "osteosarcoma_diffusionmodel_torch/csrc/moe_grouped.cu",
    "none: the JAX package has no transformer denoiser",
    modes=tuple(EPILOGUES),
)


class ExpertPlan(NamedTuple):
    """Where each expert's rows lie in the permuted activations:
    ``row_off`` and ``tile_off`` (E + 1) int32 prefix sums on the device,
    ``rows`` the total, ``max_tiles`` a bound on the tiles that the host
    knows without reading the routing."""

    row_off: torch.Tensor
    tile_off: torch.Tensor
    rows: int
    max_tiles: int

    @property
    def experts(self) -> int:
        return self.row_off.shape[0] - 1


def plan_from_counts(counts: torch.Tensor, rows: int) -> ExpertPlan:
    """The plan of experts with ``counts`` (E,) rows each, ``rows`` in all."""
    zero = torch.zeros(1, dtype=torch.int64, device=counts.device)
    row_off = torch.cat([zero, counts.cumsum(0)]).to(torch.int32)
    tiles = (counts + TILE_ROWS - 1) // TILE_ROWS
    tile_off = torch.cat([zero, tiles.cumsum(0)]).to(torch.int32)
    experts = counts.shape[0]
    return ExpertPlan(row_off, tile_off, rows, -(-rows // TILE_ROWS) + experts)


def expert_plan(choice: torch.Tensor, experts: int):
    """(plan, order, counts) of the (T, k) expert choices: ``order`` (T·k,)
    int64 the flattened selections sorted by expert (stable), so permuted
    row r is selection ``order[r]`` of token ``order[r] // k``; ``counts``
    (E,) int64 the rows of each expert."""
    flat = choice.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(experts, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return plan_from_counts(counts, flat.numel()), order, counts


def grouped_swiglu_plain(a: torch.Tensor, w_gate_up: torch.Tensor,
                         plan: ExpertPlan) -> torch.Tensor:
    """Each expert's rows of ``a`` (R, K) times its (K, 2I) weight, exact
    products summed in f32, then SiLU(gate)·up in f32, in ``a``'s dtype."""
    inter = w_gate_up.shape[2] // 2
    off = plan.row_off.tolist()
    outs = []
    for e in range(w_gate_up.shape[0]):
        gu = a[off[e]:off[e + 1]].float() @ w_gate_up[e].float()
        outs.append((F.silu(gu[:, :inter]) * gu[:, inter:]).to(a.dtype))
    return torch.cat(outs)


def grouped_down_plain(h: torch.Tensor, w_down: torch.Tensor, plan: ExpertPlan,
                       row_scale: Optional[torch.Tensor] = None,
                       dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each expert's rows of ``h`` (R, I) times its (I, N) weight in f32,
    times ``row_scale`` (R,), row r stored at row ``dest[r]`` (R,)."""
    off = plan.row_off.tolist()
    y = torch.cat([h[off[e]:off[e + 1]].float() @ w_down[e].float()
                   for e in range(w_down.shape[0])])
    if row_scale is not None:
        y = y * row_scale[:, None]
    if dest is not None:
        y = torch.zeros_like(y).index_copy(0, dest.long(), y)
    return y


def _check_operands(a: torch.Tensor, w: torch.Tensor, plan: ExpertPlan, name: str) -> None:
    if a.dim() != 2 or w.dim() != 3 or a.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: a (R, K) and w (E, K, N) expected, got {tuple(a.shape)} "
                         f"and {tuple(w.shape)}")
    if a.shape[0] != plan.rows or w.shape[0] != plan.experts:
        raise ValueError(f"{name}: the plan holds {plan.rows} rows of {plan.experts} experts, "
                         f"got {a.shape[0]} rows and {w.shape[0]} experts")


def _check_kernel_operands(a: torch.Tensor, w: torch.Tensor, n_out: int, name: str) -> None:
    for t, what in ((a, "a"), (w, "w")):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous bf16, got {t.dtype}")
    if a.shape[1] % 64 or n_out % 64:
        raise ValueError(f"{name}: K = {a.shape[1]} and the output width {n_out} must be "
                         "multiples of 64")


def _launch(a, w, out, n_out: int, epi: str, plan: ExpertPlan, row_scale=None, dest=None):
    status = LIBRARY.get().osdm_moe_grouped(
        a.data_ptr(), a.stride(0), a.shape[0], w.data_ptr(), w.shape[2], w.shape[2],
        w.shape[0], a.shape[1], out.data_ptr(), out.stride(0), n_out, EPILOGUES[epi],
        plan.row_off.data_ptr(), plan.tile_off.data_ptr(), plan.max_tiles,
        row_scale.data_ptr() if row_scale is not None else None,
        dest.data_ptr() if dest is not None else None, _stream(a))
    check(status, MOE_GROUPED.name)
    MOE_GROUPED.count(epi)


def grouped_swiglu(a: torch.Tensor, w_gate_up: torch.Tensor, plan: ExpertPlan) -> torch.Tensor:
    """``bf16(SiLU(g)·u)`` (R, I) with ``[g | u]`` each expert's rows of
    ``a`` (R, K) times its slice of ``w_gate_up`` (E, K, 2I). On the card:
    bf16 operands, K and I multiples of 64, one launch."""
    _check_operands(a, w_gate_up, plan, "grouped_swiglu")
    if not _on_cuda(a, w_gate_up, plan.row_off):
        return grouped_swiglu_plain(a, w_gate_up, plan)
    inter = w_gate_up.shape[2] // 2
    _check_kernel_operands(a, w_gate_up, inter, "grouped_swiglu")
    out = torch.empty(a.shape[0], inter, dtype=torch.bfloat16, device=a.device)
    _launch(a, w_gate_up, out, inter, "swiglu", plan)
    return out


def grouped_down(h: torch.Tensor, w_down: torch.Tensor, plan: ExpertPlan,
                 row_scale: Optional[torch.Tensor] = None,
                 dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, N) f32: each expert's rows of ``h`` (R, I) times its (I, N)
    slice of ``w_down``, times ``row_scale`` (R,) f32, row r stored at row
    ``dest[r]`` (a permutation of the R rows). On the card: bf16 operands,
    I and N multiples of 64, one launch."""
    _check_operands(h, w_down, plan, "grouped_down")
    if not _on_cuda(h, w_down, plan.row_off, row_scale, dest):
        return grouped_down_plain(h, w_down, plan, row_scale, dest)
    n = w_down.shape[2]
    _check_kernel_operands(h, w_down, n, "grouped_down")
    if row_scale is not None and (row_scale.dtype != torch.float32 or not row_scale.is_contiguous()):
        raise ValueError("grouped_down: row_scale must be contiguous f32")
    if dest is not None:
        dest = dest.to(torch.int32).contiguous()
    out = torch.empty(h.shape[0], n, dtype=torch.float32, device=h.device)
    _launch(h, w_down, out, n, "down", plan, row_scale, dest)
    return out


def grouped_weight_grad(a: torch.Tensor, d: torch.Tensor, plan: ExpertPlan) -> torch.Tensor:
    """(E, K, N) f32: each expert's rows of ``a`` (R, K) transposed times
    its rows of ``d`` (R, N), f32 products (an expert with no rows: 0)."""
    off = plan.row_off.tolist()
    out = torch.zeros(plan.experts, a.shape[1], d.shape[1], dtype=torch.float32,
                      device=a.device)
    for e in range(plan.experts):
        if off[e + 1] > off[e]:
            out[e] = a[off[e]:off[e + 1]].float().T @ d[off[e]:off[e + 1]].float()
    return out


def _transposed(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(1, 2).contiguous()


class _ExpertSwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w_gate_up, plan):
        ctx.save_for_backward(a, w_gate_up)
        ctx.plan = plan
        return grouped_swiglu(a, w_gate_up, plan)

    @staticmethod
    def backward(ctx, dh):
        a, w = ctx.saved_tensors
        plan = ctx.plan
        g, u = grouped_down(a, w, plan).chunk(2, dim=1)  # [gate | up] recomputed, f32
        sig = torch.sigmoid(g)
        dh = dh.float()
        dgu = torch.cat([dh * u * sig * (1.0 + g * (1.0 - sig)), dh * g * sig], dim=1).to(a.dtype)
        da = grouped_down(dgu, _transposed(w), plan).to(a.dtype) if ctx.needs_input_grad[0] else None
        dw = grouped_weight_grad(a, dgu, plan).to(w.dtype) if ctx.needs_input_grad[1] else None
        return da, dw, None


class _ExpertDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w_down, plan, row_scale, dest):
        ctx.save_for_backward(h, w_down, row_scale, dest)
        ctx.plan = plan
        return grouped_down(h, w_down, plan, row_scale, dest)

    @staticmethod
    def backward(ctx, dy):
        h, w, row_scale, dest = ctx.saved_tensors
        plan = ctx.plan
        dy = dy.float()
        if dest is not None:
            dy = dy[dest.long()]  # row r's gradient, in the permuted order
        dz = dy if row_scale is None else dy * row_scale[:, None]
        dz = dz.to(h.dtype)
        dh = grouped_down(dz, _transposed(w), plan).to(h.dtype) if ctx.needs_input_grad[0] else None
        dw = grouped_weight_grad(h, dz, plan).to(w.dtype) if ctx.needs_input_grad[1] else None
        ds = None
        if row_scale is not None and ctx.needs_input_grad[3]:
            ds = (dy * grouped_down(h, w, plan)).sum(dim=1)
        return dh, dw, None, ds, None


def expert_swiglu(a: torch.Tensor, w_gate_up: torch.Tensor, plan: ExpertPlan) -> torch.Tensor:
    """:func:`grouped_swiglu`, with a backward."""
    return _ExpertSwiGLU.apply(a, w_gate_up, plan)


def expert_down(h: torch.Tensor, w_down: torch.Tensor, plan: ExpertPlan,
                row_scale: Optional[torch.Tensor] = None,
                dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`grouped_down`, with a backward (to ``h``, ``w_down`` and
    ``row_scale``)."""
    return _ExpertDown.apply(h, w_down, plan, row_scale, dest)
