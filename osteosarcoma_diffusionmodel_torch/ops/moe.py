"""The grouped expert products of a DeepSeekMoE layer (``models/dit.py``)
and the routing's permutation around them, beside their plain versions.

A layer's T tokens each choose k experts. :func:`expert_plan` sorts the
T·k token copies by expert (a stable sort of the flattened choices, so
copies of one expert keep their token order) and keeps, on the device,
where each expert's rows end; the host never reads the routing. Then one
``torch._grouped_mm`` each over the permuted rows, with autograd through
it:

- :func:`grouped_swiglu`: ``[g | u]`` each expert's rows of the permuted
  activations times its [gate | up] weight, in the operands' dtype, then
  ``SiLU(g)·u`` in f32, rounded once;
- :func:`grouped_down`: each expert's rows times its down weight, in the
  operands' dtype, then times ``row_scale`` in f32, each row stored at its
  ``dest`` row; with ``top_k`` the sum of each token's k copies.

A layer of an expert-parallel deployment holds a contiguous share of the
experts: :func:`held_plan` keeps only the copies routed to them (one read
of the device, their number), so the products see no other row, and the
sum over k adds 0 to k copies a token.

Without autograd, in bf16, the passes after the two products are the
hand-written kernels of ``csrc/moe_epilogue.cu``: :func:`silu_mul` (SiLU·up
in one pass) and :func:`combine` (gather, weight and the sum over k in one
pass), each beside its plain version, which the wrappers take for CPU
tensors. Under autograd the eager composition runs, and autograd follows
it. ``COUNTERS["moe.epilogue_fused"]`` and ``["moe.epilogue_eager"]`` count
the ``top_k`` calls of :func:`grouped_down` (a routed layer call each) by
the path their epilogues took.

Weights: ``w_gate_up`` (E, K, 2I) holds each expert's [gate | up] as one
(K, 2I) matrix (the transposes of Moonlight's ``gate_proj`` and
``up_proj``); ``w_down`` (E, I, N) the transposes of ``down_proj``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import COUNTERS
from ._build import LIBRARY, check
from .sampler_kernels import Kernel, _on_cuda, _stream

_SOURCE = "osteosarcoma_diffusionmodel_torch/csrc/moe_epilogue.cu"
SILU_MUL = Kernel("moe_silu_mul", _SOURCE,
                  "none (the transformer denoiser's routed SiLU·up; the JAX package has no DiT)")
COMBINE = Kernel("moe_combine", _SOURCE,
                 "none (the transformer denoiser's routed combine; the JAX package has no DiT)")
_MAX_ITEMS = 2 ** 31  # the kernels index elements of one output with 32 bits


class ExpertPlan(NamedTuple):
    """Where each expert's rows lie in the permuted activations: ``offs``
    (E,) int32 on the device, the end of each expert's rows (the offsets
    ``torch._grouped_mm`` takes), ``rows`` the total."""

    offs: torch.Tensor
    rows: int

    @property
    def experts(self) -> int:
        return self.offs.shape[0]

    def row_off(self) -> list:
        """The (E + 1) starts of each expert's rows and the total, on the
        host (one read of the device)."""
        return [0] + self.offs.tolist()


def plan_from_counts(counts: torch.Tensor, rows: int) -> ExpertPlan:
    """The plan of experts with ``counts`` (E,) rows each, ``rows`` in all."""
    return ExpertPlan(counts.cumsum(0).to(torch.int32), rows)


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


def held_plan(choice: torch.Tensor, first: int, held: int):
    """(plan, dest, counts) of the copies among the (T, k) expert choices
    (global ids) whose expert this layer holds, experts ``first`` …
    ``first + held − 1``: ``dest`` (R,) int64 the flat index t·k + j of
    each held copy, sorted by expert (stable), ``plan`` and ``counts``
    over the held experts. The one read of the device is the number of
    held copies R, which sizes the grouped products."""
    local = choice.reshape(-1) - first
    keep = ((local >= 0) & (local < held)).nonzero().squeeze(1)
    plan, order, counts = expert_plan(local[keep], held)
    return plan, keep[order], counts


def grouped_swiglu_plain(a: torch.Tensor, w_gate_up: torch.Tensor,
                         plan: ExpertPlan) -> torch.Tensor:
    """Each expert's rows of ``a`` (R, K) times its (K, 2I) weight, exact
    products summed in f32 and rounded to ``a``'s dtype, then SiLU(gate)·up
    in f32, in ``a``'s dtype."""
    inter = w_gate_up.shape[2] // 2
    off = plan.row_off()
    outs = []
    for e in range(w_gate_up.shape[0]):
        gu = (a[off[e]:off[e + 1]].float() @ w_gate_up[e].float()).to(a.dtype).float()
        outs.append((F.silu(gu[:, :inter]) * gu[:, inter:]).to(a.dtype))
    return torch.cat(outs)


def grouped_down_plain(h: torch.Tensor, w_down: torch.Tensor, plan: ExpertPlan,
                       row_scale: Optional[torch.Tensor] = None,
                       dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each expert's rows of ``h`` (R, I) times its (I, N) weight, exact
    products summed in f32 and rounded to ``h``'s dtype; in f32 times
    ``row_scale`` (R,), row r stored at row ``dest[r]`` (R,)."""
    off = plan.row_off()
    y = torch.cat([(h[off[e]:off[e + 1]].float() @ w_down[e].float()).to(h.dtype)
                   for e in range(w_down.shape[0])]).float()
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


def silu_mul_plain(gu: torch.Tensor) -> torch.Tensor:
    """``SiLU(g)·u`` (R, I) of ``gu`` (R, 2I) = ``[g | u]``: SiLU and the
    product in f32, rounded once to ``gu``'s dtype."""
    g, u = gu.float().chunk(2, dim=1)
    return (F.silu(g) * u).to(gu.dtype)


def _with_zero_row(y: torch.Tensor, row_scale: torch.Tensor, src: torch.Tensor):
    """``y`` and ``row_scale`` with a zero row of weight 0 appended, and
    ``src`` with each −1 (a copy whose expert is held elsewhere) pointing
    at it."""
    src = torch.where(src < 0, y.shape[0], src)
    return (torch.cat([y, y.new_zeros(1, y.shape[1])]),
            torch.cat([row_scale, row_scale.new_zeros(1)]), src)


def combine_plain(y: torch.Tensor, row_scale: torch.Tensor, src: torch.Tensor,
                  top_k: int) -> torch.Tensor:
    """(T, N) f32, token t the sum over j = 0 … k−1, left to right, of
    ``row_scale[r] · f32(y[r])`` with r = ``src[t·k + j]`` (``top_k`` = k);
    a copy with r = −1 (an expert held elsewhere) adds 0·0."""
    y, row_scale, src = _with_zero_row(y, row_scale, src)
    p = y.index_select(0, src).float() * row_scale.index_select(0, src)[:, None]
    p = p.view(-1, top_k, y.shape[1])
    out = p[:, 0].clone()
    for j in range(1, top_k):
        out += p[:, j]
    return out


def _check_tensor(t: torch.Tensor, name: str, dim: int, dtype: torch.dtype) -> None:
    if t.dim() != dim or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} tensor, got {t.dtype} "
                         f"of shape {tuple(t.shape)}, strides {t.stride()}")


def silu_mul(gu: torch.Tensor) -> torch.Tensor:
    """:func:`silu_mul_plain` of ``gu`` (R, 2I) bf16, contiguous: on the
    card one launch of ``moe_silu_mul_kernel``, the same bits."""
    _check_tensor(gu, "gu", 2, torch.bfloat16)
    rows, width = gu.shape
    if width < 2 or width % 2 or rows * (width // 2) >= _MAX_ITEMS:
        raise ValueError(f"gu must be (R, 2I) with R·I < 2^31, got {tuple(gu.shape)}")
    if not _on_cuda(gu):
        return silu_mul_plain(gu)
    out = torch.empty(rows, width // 2, dtype=gu.dtype, device=gu.device)
    check(LIBRARY.get().osdm_moe_silu_mul(gu.data_ptr(), out.data_ptr(), rows, width // 2,
                                          _stream(gu)), SILU_MUL.name)
    SILU_MUL.count()
    return out


def combine(y: torch.Tensor, row_scale: torch.Tensor, src: torch.Tensor,
            top_k: int) -> torch.Tensor:
    """:func:`combine_plain` of ``y`` (R, N) bf16, ``row_scale`` (R,) f32
    and ``src`` (T·k,) int64, each row of ``y`` named once and −1 for a
    copy whose expert is held elsewhere (R = T·k where every expert is
    held here: a permutation), all contiguous: on the card one launch of
    ``moe_combine_kernel``, the same bits."""
    _check_tensor(y, "y", 2, torch.bfloat16)
    _check_tensor(row_scale, "row_scale", 1, torch.float32)
    _check_tensor(src, "src", 1, torch.int64)
    rows, n = y.shape
    slots = src.shape[0]
    if top_k < 1 or slots % top_k or slots < rows or slots // top_k * n >= _MAX_ITEMS:
        raise ValueError(f"src must hold T·k >= {rows} slots with k = top_k = {top_k} and "
                         f"T·N < 2^31, got {slots} slots of width {n}")
    if row_scale.shape[0] != rows:
        raise ValueError(f"row_scale must hold {rows} rows, got {row_scale.shape[0]}")
    if not _on_cuda(y, row_scale, src):
        return combine_plain(y, row_scale, src, top_k)
    out = torch.empty(slots // top_k, n, dtype=torch.float32, device=y.device)
    check(LIBRARY.get().osdm_moe_combine(y.data_ptr(), src.data_ptr(), row_scale.data_ptr(),
                                         out.data_ptr(), slots // top_k, top_k, n, _stream(y)),
          COMBINE.name)
    COMBINE.count()
    return out


def _fused(t: torch.Tensor) -> bool:
    """Whether the epilogues after a product ``t`` take the kernels: bf16,
    and no autograd to follow them."""
    return t.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def grouped_swiglu(a: torch.Tensor, w_gate_up: torch.Tensor, plan: ExpertPlan) -> torch.Tensor:
    """``SiLU(g)·u`` (R, I) in ``a``'s dtype: ``[g | u]`` each expert's rows
    of ``a`` (R, K) times its slice of ``w_gate_up`` (E, K, 2I), one
    grouped product in ``a``'s dtype; SiLU and the product in f32, rounded
    once."""
    _check_operands(a, w_gate_up, plan, "grouped_swiglu")
    gu = torch._grouped_mm(a, w_gate_up, offs=plan.offs)
    if _fused(gu):
        return silu_mul(gu)
    g, u = gu.chunk(2, dim=1)
    return (F.silu(g.float()) * u).to(a.dtype)


def grouped_down(h: torch.Tensor, w_down: torch.Tensor, plan: ExpertPlan,
                 row_scale: Optional[torch.Tensor] = None,
                 dest: Optional[torch.Tensor] = None,
                 top_k: Optional[int] = None, tokens: Optional[int] = None) -> torch.Tensor:
    """(R, N) f32: each expert's rows of ``h`` (R, I) times its (I, N)
    slice of ``w_down``, one grouped product in ``h``'s dtype; times
    ``row_scale`` (R,) in f32; row r stored at row ``dest[r]``, which must
    be a permutation of the R rows. With ``top_k`` = k (``row_scale`` and
    ``dest`` given): (T, N) f32, row t the sum of rows t·k … t·k + k − 1 of
    that result, T = ``tokens`` (R / k by default); where R < T·k (the
    copies of experts held here only) ``dest`` places the R rows among the
    T·k copies and a copy it leaves out adds nothing."""
    _check_operands(h, w_down, plan, "grouped_down")
    if dest is not None and tuple(dest.shape) != (h.shape[0],):
        raise ValueError(f"grouped_down: dest must hold a row for each of the {h.shape[0]} "
                         f"rows, got shape {tuple(dest.shape)}")
    if top_k is not None and (row_scale is None or dest is None):
        raise ValueError("grouped_down: top_k needs row_scale and dest")
    if tokens is not None and (top_k is None or tokens * top_k < h.shape[0]):
        raise ValueError(f"grouped_down: tokens needs top_k and at least {h.shape[0]} copies")
    y = torch._grouped_mm(h, w_down, offs=plan.offs)
    if dest is not None:
        # Row i gathers row src[i] (src the inverse permutation): every row
        # read and written once, deterministic, and in the product's dtype
        # half the bytes of f32; on the card a gather runs faster than
        # index_copy's scatter.
        dest = dest.long()
        rows = dest.numel()
        slots = rows if tokens is None else tokens * top_k
        arange = torch.arange(rows, device=dest.device)
        src = (torch.empty_like(dest) if slots == rows
               else torch.full((slots,), -1, dtype=dest.dtype, device=dest.device))
        src.scatter_(0, dest, arange)
        if top_k is not None:
            fused = _fused(y)
            COUNTERS["moe.epilogue_fused" if fused else "moe.epilogue_eager"] += 1
            if fused:
                return combine(y, row_scale, src, top_k)
        if slots != rows:
            y, row_scale, src = _with_zero_row(y, row_scale, src)
        y = y.index_select(0, src)
        if row_scale is not None:
            row_scale = row_scale.index_select(0, src)
    y = y.float() if row_scale is None else y * row_scale.float()[:, None]
    return y if top_k is None else y.view(-1, top_k, y.shape[1]).sum(dim=1)
