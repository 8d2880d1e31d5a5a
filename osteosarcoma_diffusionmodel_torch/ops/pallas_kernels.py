"""The validator's RBF kernel sum (K4) and the MMD built on it.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/pallas_kernels.py
(`rbf_kernel_sum`, `mmd_rbf_pallas`, `mmd_rbf_auto`). The kernel is the
hand-written CUDA one in ``csrc/rbf_kernel_sum.cu``; for CPU tensors the
wrapper runs the plain float64 version.
"""

from __future__ import annotations

import torch

from ._build import LIBRARY, check
from .sampler_kernels import Kernel, _on_cuda, _stream

RBF = Kernel(
    "rbf_kernel_sum",
    "osteosarcoma_diffusionmodel_torch/csrc/rbf_kernel_sum.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/pallas_kernels.py:82",
)


def rbf_kernel_sum_plain(x: torch.Tensor, y: torch.Tensor, gamma: float) -> torch.Tensor:
    """sum_ij exp(-gamma ||x_i - y_j||^2) in float64 (0-d f64 tensor)."""
    x = x.double()
    y = y.double()
    sq = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * (x @ y.T)
    return torch.exp(-gamma * sq.clamp_min(0.0)).sum()


def rbf_kernel_sum(x: torch.Tensor, y: torch.Tensor, gamma: float) -> torch.Tensor:
    """sum_ij exp(-gamma ||x_i - y_j||^2) for x (n, d), y (m, d) f32,
    returned as a 0-d float64 tensor. The squared norms are plain torch,
    as in the JAX wrapper; the cross products, exp, mask and reduction
    run in the kernel."""
    for t, name in ((x, "x"), (y, "y")):
        if t.dim() != 2 or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")
    n, d = x.shape
    m = y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"feature dims differ: {d} vs {y.shape[1]}")
    if not _on_cuda(x, y):
        return rbf_kernel_sum_plain(x, y, gamma)
    lib = LIBRARY.get()
    xsq = (x * x).sum(1)
    ysq = (y * y).sum(1)
    partials = torch.empty(lib.osdm_rbf_grid_blocks(n, m), dtype=torch.float64, device=x.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
    out = torch.empty((), dtype=torch.float64, device=x.device)
    status = lib.osdm_rbf_kernel_sum(
        x.data_ptr(), y.data_ptr(), xsq.data_ptr(), ysq.data_ptr(), n, m, d, gamma,
        partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), _stream(x),
    )
    check(status, RBF.name)
    RBF.launches += 1
    return out


def mmd_rbf(x: torch.Tensor, y: torch.Tensor) -> float:
    """sqrt(max(E k(x,x) + E k(y,y) - 2 E k(x,y), 0)) with gamma = 1/d
    (pallas_kernels.py `mmd_rbf_pallas`, as the validator calls it)."""
    x = x.float().contiguous()
    y = y.float().contiguous()
    gamma = 1.0 / x.shape[1]
    n, m = x.shape[0], y.shape[0]
    xx = rbf_kernel_sum(x, x, gamma) / (n * n)
    yy = rbf_kernel_sum(y, y, gamma) / (m * m)
    xy = rbf_kernel_sum(x, y, gamma) / (n * m)
    return float(torch.sqrt(torch.clamp(xx + yy - 2.0 * xy, min=0.0)))
