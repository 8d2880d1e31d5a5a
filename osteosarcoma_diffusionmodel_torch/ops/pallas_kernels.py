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

import functools
import math
from typing import NamedTuple, Optional

import torch

from ._build import LIBRARY, check
from .sampler_kernels import _M32, Kernel, _on_cuda, _sm_count, _stream, philox4x32_10

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


RBF_TILES = (64, 128)  # output tile sides: the "fma" and "tf32x3" routes (csrc/rbf_kernel_sum.cu)
RBF_CHUNK = 32  # columns of d a pipeline stage holds; splits own whole chunks
RBF_MIN_SPLIT_CHUNKS = 4  # a split walks at least this many chunks


class RbfPlan(NamedTuple):
    """A launch of K4: ``bm`` x ``bm`` output tiles, d cut into ``splits``
    ranges of whole chunks. The tile sets the route: 64, f32 FMA on the CUDA
    cores; 128, split-precision TF32 (three products) on the tensor cores."""
    bm: int
    splits: int

    @property
    def route(self) -> str:
        return "fma" if self.bm == 64 else "tf32x3"


@functools.lru_cache(maxsize=1024)
def rbf_plan(n: int, m: int, d: int, sms: int) -> RbfPlan:
    """K4's tile and split for x (n, d) against y (m, d) on a card with
    ``sms`` multiprocessors, cached by shape: 128 x 128 tiles on the tensor
    cores ("tf32x3") wherever the output spans more than one of them, else
    64 x 64 f32 FMA tiles ("fma"); where the tiles leave SMs idle, d is
    split so that tiles x splits comes as close to ``sms`` as it can, each
    split keeping RBF_MIN_SPLIT_CHUNKS chunks."""
    bm = 64 if -(-n // 128) * -(-m // 128) == 1 else 128
    tiles = -(-n // bm) * -(-m // bm)
    splits = 1
    if tiles < sms:
        splits = max(1, min(sms // tiles, -(-d // RBF_CHUNK) // RBF_MIN_SPLIT_CHUNKS))
    return RbfPlan(bm, splits)


class _RbfWorkspace:
    """K4's scratch, one per device, grown as launches need: the squared
    norms, the split slots, the per-tile tickets and done counter (zeroed
    once: each launch leaves them zero) and the per-tile f64 sums."""

    def __init__(self):
        self._bufs = {}

    def get(self, device, n: int, m: int, plan: RbfPlan):
        tiles = -(-n // plan.bm) * -(-m // plan.bm)
        need = {"norms": n + m, "slots": tiles * plan.splits * plan.bm ** 2 if plan.splits > 1
                else 0, "tickets": tiles + 1, "sums": tiles}
        bufs = self._bufs.setdefault(device, {})
        for key, size in need.items():
            if key not in bufs or bufs[key].numel() < size:
                dtype = {"sums": torch.float64, "tickets": torch.int32}.get(key, torch.float32)
                make = torch.zeros if key == "tickets" else torch.empty
                bufs[key] = make(max(size, 1), dtype=dtype, device=device)
        return bufs


_RBF_WORKSPACE = _RbfWorkspace()


def rbf_kernel_sum(x: torch.Tensor, y: torch.Tensor, gamma: float,
                   plan: Optional[RbfPlan] = None) -> torch.Tensor:
    """sum_ij exp(-gamma ||x_i - y_j||^2) for x (n, d), y (m, d) f32,
    returned as a 0-d float64 tensor. On the card one call launches the
    kernel's squared-norm pass (once when ``y`` is ``x``) and its tiles;
    ``plan``: the tile and split, :func:`rbf_plan`'s when omitted."""
    for t, name in ((x, "x"), (y, "y")):
        if t.dim() != 2 or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")
    n, d = x.shape
    m = y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"feature dims differ: {d} vs {y.shape[1]}")
    if not _on_cuda(x, y):
        return rbf_kernel_sum_plain(x, y, gamma)
    if plan is None:
        plan = rbf_plan(n, m, d, _sm_count(x.device.index))
    elif plan.bm not in RBF_TILES or not 1 <= plan.splits <= -(-d // RBF_CHUNK):
        raise ValueError(f"invalid plan {plan} for d = {d}")
    same = x.data_ptr() == y.data_ptr() and x.shape == y.shape
    ws = _RBF_WORKSPACE.get(x.device, n, m, plan)
    norms, tickets = ws["norms"], ws["tickets"]
    out = torch.empty((), dtype=torch.float64, device=x.device)
    status = LIBRARY.get().osdm_rbf_kernel_sum(
        x.data_ptr(), y.data_ptr(), n, m, d, gamma, int(same), plan.bm, plan.splits,
        norms.data_ptr(), norms[n:].data_ptr(), ws["slots"].data_ptr() if plan.splits > 1 else None,
        tickets.data_ptr(), ws["sums"].data_ptr(), tickets[-1:].data_ptr(), out.data_ptr(),
        _stream(x),
    )
    check(status, RBF.name)
    RBF.count()
    return out


def mmd_rbf(x: torch.Tensor, y: torch.Tensor, gamma: Optional[float] = None) -> float:
    """sqrt(max(E k(x,x) + E k(y,y) - 2 E k(x,y), 0)) with k(a, b) =
    exp(-gamma ||a - b||^2), gamma = 1/d unless given (pallas_kernels.py
    `mmd_rbf_pallas`)."""
    x = x.float().contiguous()
    y = y.float().contiguous()
    if gamma is None:
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
    """K8's noise for a (rows, cols) array, over the flat index i =
    row·cols + col: Philox keyed by (seed, 0) at counter j gives elements
    4j .. 4j+3. Words (0, 1) and (2, 3) are two pairs (u1, u2) of 24-bit
    uniforms (u1 floored at 1e-12); element 4j+q takes pair q // 2 and is
    sqrt(-2 log u1)·cos(2π u2) for even q, sqrt(-2 log u1)·sin(2π u2) for
    odd q. The radius is f32; the angle's cosine and sine are taken in
    float64 and rounded once (the kernel's sincospif is within an ulp)."""
    n = rows * cols
    j = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(j)
    words = philox4x32_10(j & _M32, (j >> 32) & _M32, zero, zero, seed, 0)
    pairs = []
    for w1, w2 in (words[:2], words[2:]):
        u1 = torch.clamp((w1 >> 8).to(torch.float32) * (1.0 / (1 << 24)), min=1e-12)
        angle = TWO_PI * ((w2 >> 8).to(torch.float64) * (1.0 / (1 << 24)))
        radius = torch.sqrt(-2.0 * torch.log(u1))
        pairs += [radius * torch.cos(angle).float(), radius * torch.sin(angle).float()]
    return torch.stack(pairs, dim=1).reshape(-1)[:n].reshape(rows, cols)


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
