"""Wrappers for the sampler's Hopper kernels K1-K3, beside their plain versions.

The three kernels together compute what the TPU's whole-loop sampler
(osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`)
computes in one Pallas kernel, one reverse step at a time:

- K1 ``gemm_bf16_f32acc``: every matrix product of the step;
- K2 ``groupnorm8_silu``: GroupNorm(8) with f32 statistics, then SiLU;
- K3 ``x0_posterior_step``: output epilogue, clip and the transition.

A wrapper launches its kernel for CUDA tensors and counts the launch; for
CPU tensors it runs the plain PyTorch version (the tests' path). Any
other device raises. There is no fallback from a CUDA tensor to the
plain version.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ._build import LIBRARY, check

GN_EPS = 1e-6
UNIFORM_SCALE = 2.0 * math.sqrt(3.0)  # U(-sqrt3, sqrt3): zero mean, unit variance
NOISE_MODES = {"none": 0, "buffer": 1, "philox": 2}

_M32 = 0xFFFFFFFF


class Kernel:
    """A hand-written kernel's wrapper: identity for reports plus its
    launch count (incremented once per kernel launch, nowhere else)."""

    route = "cuda"

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise or
    on mixed devices."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(t: torch.Tensor, name: str) -> None:
    """2-D with unit column stride (row stride may exceed the width)."""
    if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name} must be a 2-D row-major view, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _check_dtype(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


# ----------------------------------------------------------------------
# K1: C = A·B + bias (+ row_add)
# ----------------------------------------------------------------------
GEMM = Kernel(
    "gemm_bf16_f32acc",
    "osteosarcoma_diffusionmodel_torch/csrc/gemm_bf16.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py:347",
)


def gemm_bf16_f32acc_plain(a, b, bias=None, row_add=None):
    """bf16 x bf16 products accumulated in f32 (every bf16 product is
    exact in f32), then bias and the per-row add in that order."""
    acc = a.float() @ b.float()
    if bias is not None:
        acc = acc + bias
    if row_add is not None:
        acc = acc + row_add
    return acc


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gemm_tile(m: int, n: int, sms: int) -> int:
    """64x64 output tiles when they give each of the card's ``sms``
    multiprocessors work, else 32x32."""
    return 64 if math.ceil(m / 64) * math.ceil(n / 64) >= sms else 32


def gemm_bf16_f32acc(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = a @ b + bias + row_add`` with ``a`` (M, K) and ``b`` (K, N)
    in bf16, f32 accumulation, ``bias`` (N,) and ``row_add`` (M, N) f32.
    ``a``, ``row_add`` and ``out`` may be row-strided views. ``out`` is
    f32 (allocated when omitted) or bf16 (the rounding of the f32 result)."""
    _check_rows(a, "a")
    _check_dtype(a, torch.bfloat16, "a")
    _check_dtype(b, torch.bfloat16, "b")
    if not b.is_contiguous() or b.dim() != 2:
        raise ValueError("b must be a contiguous (K, N) matrix")
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)} b {tuple(b.shape)}")
    n = b.shape[1]
    if bias is not None:
        _check_dtype(bias, torch.float32, "bias")
        if bias.shape != (n,) or not bias.is_contiguous():
            raise ValueError(f"bias must be contiguous ({n},), got {tuple(bias.shape)}")
    if row_add is not None:
        _check_rows(row_add, "row_add")
        _check_dtype(row_add, torch.float32, "row_add")
        if row_add.shape != (m, n):
            raise ValueError(f"row_add must be ({m}, {n}), got {tuple(row_add.shape)}")
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _check_rows(out, "out")
    if out.shape != (m, n) or out.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out must be ({m}, {n}) f32/bf16, got {tuple(out.shape)} {out.dtype}")

    if not _on_cuda(a, b, bias, row_add, out):
        out.copy_(gemm_bf16_f32acc_plain(a, b, bias, row_add))
        return out
    lib = LIBRARY.get()
    status = lib.osdm_gemm_bf16_f32acc(
        a.data_ptr(), a.stride(0), b.data_ptr(), n, out.data_ptr(), out.stride(0),
        int(out.dtype == torch.bfloat16), m, n, k,
        bias.data_ptr() if bias is not None else None,
        row_add.data_ptr() if row_add is not None else None,
        row_add.stride(0) if row_add is not None else 0,
        gemm_tile(m, n, _sm_count(a.device.index)),
        _stream(a),
    )
    check(status, GEMM.name)
    GEMM.launches += 1
    return out


# ----------------------------------------------------------------------
# K2: GroupNorm(8) + SiLU
# ----------------------------------------------------------------------
GROUPNORM = Kernel(
    "groupnorm8_silu",
    "osteosarcoma_diffusionmodel_torch/csrc/groupnorm_silu.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py:167",
)


def groupnorm8_silu_plain(h, scale, bias):
    """The TPU kernel's "f32" gn_mode: mean and E[x^2] per group in f32,
    var = max(E[x^2] - mean^2, 0), then scale/bias and SiLU."""
    m, f = h.shape
    g = h.float().reshape(m, 8, f // 8)
    mean = g.mean(dim=2, keepdim=True)
    msq = (g * g).mean(dim=2, keepdim=True)
    inv = torch.rsqrt(torch.clamp(msq - mean * mean, min=0.0) + GN_EPS)
    y = ((g - mean) * inv).reshape(m, f) * scale + bias
    return torch.nn.functional.silu(y)


def groupnorm8_silu(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm with 8 groups of contiguous features on f32 ``h`` (M, F),
    written as bf16 into ``out`` (may be a row-strided view)."""
    _check_rows(h, "h")
    _check_dtype(h, torch.float32, "h")
    m, f = h.shape
    if f % 8:
        raise ValueError(f"features must divide into 8 groups, got {f}")
    for t, name in ((scale, "scale"), (bias, "bias")):
        _check_dtype(t, torch.float32, name)
        if t.shape != (f,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({f},)")
    if out is None:
        out = torch.empty((m, f), dtype=torch.bfloat16, device=h.device)
    _check_rows(out, "out")
    _check_dtype(out, torch.bfloat16, "out")
    if out.shape != (m, f):
        raise ValueError(f"out must be ({m}, {f}), got {tuple(out.shape)}")

    if not _on_cuda(h, scale, bias, out):
        out.copy_(groupnorm8_silu_plain(h, scale, bias))
        return out
    lib = LIBRARY.get()
    status = lib.osdm_groupnorm8_silu(
        h.data_ptr(), h.stride(0), out.data_ptr(), out.stride(0),
        scale.data_ptr(), bias.data_ptr(), m, f, GN_EPS, _stream(h),
    )
    check(status, GROUPNORM.name)
    GROUPNORM.launches += 1
    return out


# ----------------------------------------------------------------------
# K3: output epilogue + clip + transition
# ----------------------------------------------------------------------
POSTERIOR = Kernel(
    "x0_posterior_step",
    "osteosarcoma_diffusionmodel_torch/csrc/posterior_step.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py:449",
)

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 words (the plain
    version of the kernel's generator). Products of two uint32 fit in the
    low 64 bits that int64 arithmetic keeps."""
    k0, k1 = k0 & _M32, k1 & _M32
    for _ in range(10):
        p0 = c0 * _PHILOX_M0
        p1 = c2 * _PHILOX_M1
        hi0, lo0 = (p0 >> 32) & _M32, p0 & _M32
        hi1, lo1 = (p1 >> 32) & _M32, p1 & _M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def philox_uniform_noise(seed: int, step: int, rows: int, cols: int,
                         device=None) -> torch.Tensor:
    """The kernel's transition noise z ~ U(-sqrt3, sqrt3) for one step:
    Philox keyed by (seed, step), counter = row*cols + col, top 24 bits."""
    idx = torch.arange(rows * cols, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    r0, _, _, _ = philox4x32_10(idx & _M32, (idx >> 32) & _M32, zero, zero, seed, step)
    u = (r0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return ((u - 0.5) * UNIFORM_SCALE).reshape(rows, cols)


def x0_posterior_step_plain(acc, x, b_out, coeffs, step: int, mode: str,
                            noise=None, seed: int = 0, clip: float = 30.0):
    """Returns the new bf16 carry (the kernel updates ``x`` in place)."""
    c0, c1, sv, gain = (coeffs[step, i] for i in range(4))
    xf = x.float()
    x0 = torch.clamp(acc + b_out + gain * xf, -clip, clip)
    xn = c0 * x0 + c1 * xf
    if mode == "buffer":
        xn = xn + sv * noise[step]
    elif mode == "philox":
        xn = xn + sv * philox_uniform_noise(seed, step, *x.shape, device=x.device)
    return xn.to(torch.bfloat16)


def x0_posterior_step(acc: torch.Tensor, x: torch.Tensor, b_out: torch.Tensor,
                      coeffs: torch.Tensor, step: int, mode: str,
                      noise: Optional[torch.Tensor] = None, seed: int = 0,
                      clip: float = 30.0) -> torch.Tensor:
    """In place on the bf16 carry ``x`` (B, D): out = acc + b_out + g·x,
    x0 = clip(out), x <- c0·x0 + c1·x [+ sv·z], with (c0, c1, sv, g) from
    row ``step`` of the (n_loop, 6) f32 table. ``mode``: "none" (eta = 0
    DDIM), "buffer" (z = noise[step], noise (n_loop, B, D) f32) or
    "philox" (in-kernel noise keyed by (seed, step))."""
    if mode not in NOISE_MODES:
        raise ValueError(f"unknown noise mode {mode!r}")
    for t, name in ((acc, "acc"), (x, "x")):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    _check_dtype(acc, torch.float32, "acc")
    _check_dtype(x, torch.bfloat16, "x")
    if acc.shape != x.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and x {tuple(x.shape)} differ")
    b, d = x.shape
    _check_dtype(b_out, torch.float32, "b_out")
    _check_dtype(coeffs, torch.float32, "coeffs")
    if b_out.shape != (d,) or not b_out.is_contiguous():
        raise ValueError(f"b_out must be contiguous ({d},)")
    if coeffs.dim() != 2 or coeffs.shape[1] != 6 or not coeffs.is_contiguous():
        raise ValueError("coeffs must be a contiguous (n_loop, 6) table")
    if not 0 <= step < coeffs.shape[0]:
        raise IndexError(f"step {step} outside the {coeffs.shape[0]}-row table")
    if mode == "buffer":
        if noise is None or noise.shape != (coeffs.shape[0], b, d) or not noise.is_contiguous():
            raise ValueError(f"buffer mode needs contiguous noise ({coeffs.shape[0]}, {b}, {d})")
        _check_dtype(noise, torch.float32, "noise")
    if not 0 <= seed <= _M32:
        raise ValueError("seed must fit in 32 bits")

    if not _on_cuda(acc, x, b_out, coeffs, noise if mode == "buffer" else None):
        x.copy_(x0_posterior_step_plain(acc, x, b_out, coeffs, step, mode, noise, seed, clip))
        return x
    lib = LIBRARY.get()
    status = lib.osdm_x0_posterior_step(
        acc.data_ptr(), x.data_ptr(), b, d, b_out.data_ptr(), coeffs.data_ptr(),
        step, NOISE_MODES[mode], noise.data_ptr() if mode == "buffer" else None,
        seed, clip, _stream(x),
    )
    check(status, POSTERIOR.name)
    POSTERIOR.launches += 1
    return x

