"""The validator's RBF kernel sum (K4) and the MMD built on it; the
standalone posterior-update kernel (K8).

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/pallas_kernels.py
(`rbf_kernel_sum`, `mmd_rbf_pallas`, `mmd_rbf_auto`; `posterior_update`,
`posterior_update_traced`). The kernels are the hand-written CUDA ones in
``csrc/rbf_kernel_sum.cu`` and ``csrc/posterior_update.cu``; for CPU
tensors the wrappers run their plain versions. As in the JAX package, no
sampler calls the posterior-update kernel: it is a building block with its
own tests.
"""

from __future__ import annotations

import math

import torch

from ._build import LIBRARY, check
from .sampler_kernels import _M32, Kernel, _on_cuda, _stream, philox4x32_10

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
    RBF.count()
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


# ----------------------------------------------------------------------
# K8: one ancestral step with Box-Muller Gaussian noise
# ----------------------------------------------------------------------
POSTERIOR_UPDATE = Kernel(
    "posterior_update",
    "osteosarcoma_diffusionmodel_torch/csrc/posterior_update.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/pallas_kernels.py:196",
    modes=("static", "traced"),
)
TWO_PI = 2.0 * math.pi


def gaussian_noise(seed: int, rows: int, cols: int, device=None) -> torch.Tensor:
    """K8's noise for a (rows, cols) array: sqrt(-2 log u1)·cos(2π u2),
    u1 (floored at 1e-12) and u2 the top 24 bits of words 0 and 1 of
    Philox keyed by (seed, 0) at counter row·cols + col."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    idx = r * cols + c
    zero = torch.zeros_like(idx)
    w0, w1, _, _ = philox4x32_10(idx & _M32, (idx >> 32) & _M32, zero, zero, seed, 0)
    u1 = torch.clamp((w0 >> 8).to(torch.float32) * (1.0 / (1 << 24)), min=1e-12)
    u2 = (w1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def posterior_update_plain(x, x0_pred, seed: int, coef_x0, coef_xt, sqrt_var, add_noise,
                           clip_value):
    """clip(x0_pred) -> c0·x0 + c1·x + sv·z, or clip(x0_pred) when
    ``add_noise`` <= 0 (the kernel's f32 operations in its order). The
    coefficients are Python floats or 0-d f32 tensors."""
    x0 = torch.clamp(x0_pred, -clip_value, clip_value)
    z = gaussian_noise(seed, *x.shape, device=x.device)
    noisy = coef_x0 * x0 + coef_xt * x + sqrt_var * z
    return torch.where(torch.as_tensor(add_noise, device=x.device) > 0, noisy, x0)


def _check_update_args(x: torch.Tensor, x0_pred: torch.Tensor, seed: int) -> None:
    for t, name in ((x, "x"), (x0_pred, "x0_pred")):
        if t.dim() != 2 or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")
    if x.shape != x0_pred.shape:
        raise ValueError(f"x {tuple(x.shape)} and x0_pred {tuple(x0_pred.shape)} differ")
    if not 0 <= seed <= _M32:
        raise ValueError("seed must fit in 32 bits")


def _launch_update(x, x0_pred, seed: int, coefs, fixed, mode: str) -> torch.Tensor:
    out = torch.empty_like(x)
    lib = LIBRARY.get()
    status = lib.osdm_posterior_update(
        x.data_ptr(), x0_pred.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        coefs.data_ptr() if coefs is not None else None, *fixed, seed, _stream(x),
    )
    check(status, POSTERIOR_UPDATE.name)
    POSTERIOR_UPDATE.count(mode)
    return out


def posterior_update(x: torch.Tensor, x0_pred: torch.Tensor, seed: int, coef_x0: float,
                     coef_xt: float, sqrt_var: float, add_noise: float,
                     clip_value: float = 30.0) -> torch.Tensor:
    """Fused DDPM posterior update x_{t-1} from x_t and x0_pred, both (n, d)
    f32, with static coefficients: clip(x0_pred) -> c0·x0 + c1·x + sv·z
    with z ~ N(0, 1) drawn in the kernel (Philox keyed by (seed, 0)), or
    clip(x0_pred) when ``add_noise`` <= 0. Returns a new (n, d) f32 tensor."""
    _check_update_args(x, x0_pred, seed)
    if not _on_cuda(x, x0_pred):
        return posterior_update_plain(x, x0_pred, seed, coef_x0, coef_xt, sqrt_var, add_noise,
                                      clip_value)
    fixed = (coef_x0, coef_xt, sqrt_var, add_noise, clip_value)
    return _launch_update(x, x0_pred, seed, None, fixed, "static")


def posterior_update_traced(x: torch.Tensor, x0_pred: torch.Tensor, coefs: torch.Tensor,
                            seed: int) -> torch.Tensor:
    """:func:`posterior_update` with the coefficients in a (5,) f32 tensor
    on the device of ``x``: [coef_x0, coef_xt, sqrt_var, add_noise,
    clip_value], read by the kernel (no host synchronization)."""
    _check_update_args(x, x0_pred, seed)
    if coefs.shape != (5,) or coefs.dtype != torch.float32 or not coefs.is_contiguous():
        raise ValueError(f"coefs must be a contiguous (5,) float32 tensor, got {tuple(coefs.shape)}")
    if not _on_cuda(x, x0_pred, coefs):
        return posterior_update_plain(x, x0_pred, seed, *coefs.unbind())
    return _launch_update(x, x0_pred, seed, coefs, (0.0,) * 5, "traced")
