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
  ``dest`` row, so the caller's combine is a sum over the k copies.

Weights: ``w_gate_up`` (E, K, 2I) holds each expert's [gate | up] as one
(K, 2I) matrix (the transposes of Moonlight's ``gate_proj`` and
``up_proj``); ``w_down`` (E, I, N) the transposes of ``down_proj``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


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


def grouped_swiglu(a: torch.Tensor, w_gate_up: torch.Tensor, plan: ExpertPlan) -> torch.Tensor:
    """``SiLU(g)·u`` (R, I) in ``a``'s dtype: ``[g | u]`` each expert's rows
    of ``a`` (R, K) times its slice of ``w_gate_up`` (E, K, 2I), one
    grouped product in ``a``'s dtype; SiLU and the product in f32, rounded
    once."""
    _check_operands(a, w_gate_up, plan, "grouped_swiglu")
    g, u = torch._grouped_mm(a, w_gate_up, offs=plan.offs).chunk(2, dim=1)
    if torch.is_grad_enabled():
        return (F.silu(g.float()) * u).to(a.dtype)
    # The same values without autograd: SiLU in place, the product rounded
    # as it is stored (two passes fewer over the f32 intermediate).
    out = torch.empty(u.shape, dtype=a.dtype, device=a.device)
    return torch.mul(F.silu(g.float(), inplace=True), u, out=out)


def grouped_down(h: torch.Tensor, w_down: torch.Tensor, plan: ExpertPlan,
                 row_scale: Optional[torch.Tensor] = None,
                 dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, N) f32: each expert's rows of ``h`` (R, I) times its (I, N)
    slice of ``w_down``, one grouped product in ``h``'s dtype; times
    ``row_scale`` (R,) in f32; row r stored at row ``dest[r]``, which must
    be a permutation of the R rows."""
    _check_operands(h, w_down, plan, "grouped_down")
    y = torch._grouped_mm(h, w_down, offs=plan.offs)
    if dest is not None:
        # Row i gathers row src[i] (src the inverse permutation): every row
        # read and written once, deterministic, and in the product's dtype
        # half the bytes of f32; on the card a gather runs faster than
        # index_copy's scatter.
        dest = dest.long()
        src = torch.empty_like(dest).scatter_(0, dest, torch.arange(dest.numel(),
                                                                    device=dest.device))
        y = y.index_select(0, src)
        if row_scale is not None:
            row_scale = row_scale.index_select(0, src)
    return y.float() if row_scale is None else y * row_scale.float()[:, None]
