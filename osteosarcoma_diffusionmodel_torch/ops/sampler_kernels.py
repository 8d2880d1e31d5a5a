"""Wrappers for the samplers' Hopper kernels K1-K3 and K5-K7, beside their
plain versions.

Together the kernels compute what the TPU's whole-loop sampler
(osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`)
computes in one Pallas kernel, one reverse step at a time:

- K1 ``gemm_bf16_f32acc``: the bf16 matrix products of the step, with
  the D3PM head's 2b-1 prologue on the input product; K1 and K6 share one
  wgmma/TMA mainloop (csrc/gemm_sm90.cuh) whose launch :func:`gemm_plan`
  chooses;
- K2 ``groupnorm8_silu``: GroupNorm(8) with f32 statistics, then SiLU;
- K3 ``x0_posterior_step``: output epilogue, clip and the transition,
  with the binary D3PM posterior on the mutation columns;
- K5 ``rowquant_s8`` and K6 ``gemm_s8``: the int8 products of the
  ``quantize`` modes (per-row dynamic activation scales, per-column
  weight scales, s8·s8 -> s32, dequantized in the epilogue);
- K7 ``latent_step`` (:func:`latent_draw`, :func:`latent_update`): the
  per-step elementwise work of the latent-tail sampler
  (osteosarcoma_diffusionmodel_tpu/ops/latent_sampler.py
  `_build_latent_kernel`), whose products and hidden stack run on K1/K2.

A wrapper launches its kernel for CUDA tensors and counts the launch, in
total and by mode; for CPU tensors it runs the plain PyTorch version (the
tests' path). Any other device raises. There is no fallback from a CUDA
tensor to the plain version.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._build import LIBRARY, check
from .discrete import posterior_prob_one

GN_EPS = 1e-6
UNIFORM_SCALE = 2.0 * math.sqrt(3.0)  # U(-sqrt3, sqrt3): zero mean, unit variance
NOISE_MODES = {"none": 0, "buffer": 1, "philox": 2}

_M32 = 0xFFFFFFFF


class Kernel:
    """A hand-written kernel's wrapper: identity for reports plus its
    launch counts, in total and by mode (both incremented by
    :meth:`count` once per kernel launch, nowhere else)."""

    route = "cuda"

    def __init__(self, name: str, source: str, replaces: str,
                 modes: Sequence[str] = ("default",)):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.modes = dict.fromkeys(modes, 0)

    def count(self, mode: str = "default") -> None:
        self.modes[mode] += 1
        self.launches += 1

    def reset(self) -> None:
        self.launches = 0
        self.modes = dict.fromkeys(self.modes, 0)


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


def _check_rows(t: torch.Tensor, name: str) -> int:
    """2-D with unit column stride (row stride may exceed the width);
    returns the row stride."""
    st = t.stride()
    if len(st) != 2 or st[1] != 1 or st[0] < t.shape[1]:
        raise ValueError(f"{name} must be a 2-D row-major view, got shape "
                         f"{tuple(t.shape)} strides {st}")
    return st[0]


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
    modes=("bf16", "mut_prologue", "unaligned"),
)


def mutation_transform(a: torch.Tensor, mut_cols: int) -> torch.Tensor:
    """f32 copy of ``a`` with 2a - 1 on its first ``mut_cols`` columns:
    the denoiser's view of the D3PM bits (TPU ``st_pre``, :371-385)."""
    x = a.float()
    if mut_cols:
        x = x.clone()
        x[:, :mut_cols] = 2.0 * x[:, :mut_cols] - 1.0
    return x


def gemm_bf16_f32acc_plain(a, b, bias=None, row_add=None, a_mut_cols: int = 0):
    """bf16 x bf16 products accumulated in f32 (every bf16 product is
    exact in f32), then bias and the per-row add in that order. With
    ``a_mut_cols`` the first columns of A enter as 2A - 1, rounded to
    bf16 as the TPU rounds its f32 input for the dot."""
    if a_mut_cols:
        a = mutation_transform(a, a_mut_cols).to(torch.bfloat16)
    acc = a.float() @ b.float()
    if bias is not None:
        acc = acc + bias
    if row_add is not None:
        acc = acc + row_add
    return acc


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


GEMM_BM = 64  # rows of a block tile: one m64 wgmma (csrc/gemm_sm90.cuh)
GEMM_WIDTHS = (256, 128, 64)  # block widths = wgmma N widths the kernels are built for
GEMM_STAGE_BYTES = 128  # bytes of k per pipeline stage: 64 bf16 or 128 int8
GEMM_MIN_SPLIT_KTILES = 8  # a split walks at least this many k-tiles
# The kernel's shared-memory ring (gemm_sm90.cuh stages/smem_bytes): a
# stage holds A's 64 rows and B's bn rows of 128 bytes; up to 200 KB of
# stages, no more than a split walks; an SM has 228 KB.
_RING_BYTES, _SM_SMEM = 200 * 1024, 228 * 1024


class GemmPlan(NamedTuple):
    """A launch of the shared mainloop: ``bm`` x ``bn`` block tiles, one
    wgmma of N = ``bn`` per k-step, K cut into ``splits`` ranges of whole
    k-tiles (split s owns k-tiles [s·kt/S, (s+1)·kt/S))."""
    bm: int
    bn: int
    splits: int


def k_tiles(k: int, kind: str) -> int:
    """k-tiles of one 128-byte stage over K (64 bf16 or 128 int8)."""
    return -(-k // (GEMM_STAGE_BYTES // (2 if kind == "bf16" else 1)))


def _ctas_per_sm(bn: int, walk: int) -> int:
    """CTAs of one launch that share an SM, by shared memory: the ring
    takes min(walk, the deepest ring) stages of (64 + bn) x 128 bytes."""
    stage = (GEMM_BM + bn) * GEMM_STAGE_BYTES
    ring = max(1, min(walk, _RING_BYTES // stage, 16))
    return max(1, _SM_SMEM // (1024 + ring * (stage + 8) + 16 + 1024))


@functools.lru_cache(maxsize=4096)
def gemm_plan(m: int, n: int, k: int, sms: int, kind: str) -> GemmPlan:
    """The block width and split count for an (m, k)·(k, n) product of
    ``kind`` ("bf16" or "int8") on a card with ``sms`` multiprocessors,
    cached by shape. Where the output tiles leave SMs idle, K is split so
    that tiles × splits comes as close to ``sms`` as it can without
    exceeding it, each split keeping at least GEMM_MIN_SPLIT_KTILES
    k-tiles. The products are latency-bound, so among the widths the plan
    takes the fewest rounds of CTAs (CTAs over the SMs times the CTAs
    that share one, by shared memory), then the fewest bytes a CTA moves
    (its k-tiles of A and B, plus, when split, its partial written and
    the last split's reads of all of them), then the wider tile."""
    if kind not in ("bf16", "int8"):
        raise ValueError(f"kind must be 'bf16' or 'int8', got {kind!r}")
    kt = k_tiles(k, kind)
    rows = -(-m // GEMM_BM)
    best = None
    for bn in GEMM_WIDTHS:
        tiles = rows * -(-n // bn)
        splits = 1
        if tiles < sms:
            splits = max(1, min(sms // tiles, kt // GEMM_MIN_SPLIT_KTILES))
        walk = -(-kt // splits)
        rounds = -(-tiles * splits // (sms * _ctas_per_sm(bn, walk)))
        moved = walk * (GEMM_BM + bn) * GEMM_STAGE_BYTES
        if splits > 1:
            moved += (1 + splits) * GEMM_BM * bn * 4
        if best is None or (rounds, moved) < best[0]:
            best = ((rounds, moved), GemmPlan(GEMM_BM, bn, splits))
    return best[1]


class _SplitWorkspace:
    """Split-K scratch, one per device, grown as plans need: the partial
    sums (f32 or s32: 4-byte words, tiles x splits x bm x bn) and one int32
    ticket per tile, zeroed once (the last split of a tile resets its own).
    Launches on one stream are ordered, so one workspace serves them all."""

    def __init__(self):
        self._bufs = {}

    def pointers(self, device, m: int, n: int, plan: GemmPlan) -> Tuple[int, int]:
        tiles = -(-m // plan.bm) * -(-n // plan.bn)
        words = tiles * plan.splits * plan.bm * plan.bn
        part, tick = self._bufs.get(device, (None, None))
        if part is None or part.numel() < words:
            part = torch.empty(words, dtype=torch.int32, device=device)
        if tick is None or tick.numel() < tiles:
            tick = torch.zeros(tiles, dtype=torch.int32, device=device)
        self._bufs[device] = (part, tick)
        return part.data_ptr(), tick.data_ptr()


_WORKSPACE = _SplitWorkspace()


def _tma_aligned(ptr: int, row_bytes: int) -> bool:
    return not (ptr | row_bytes) & 15


def tma_ready(t: torch.Tensor) -> bool:
    """A 2-D operand TMA can read: 16-byte-aligned base and row stride."""
    return _tma_aligned(t.data_ptr(), t.stride(0) * t.element_size())


def _check_plan(plan: GemmPlan, k: int, kind: str) -> None:
    if plan.bm != GEMM_BM or plan.bn not in GEMM_WIDTHS or not 1 <= plan.splits <= max(
            1, k_tiles(k, kind)):
        raise ValueError(f"invalid plan {plan} for K = {k}")


def _check_epilogue(m: int, n: int, bias, row_add, out, device) -> torch.Tensor:
    """Checks K1/K6's epilogue operands; returns ``out`` (f32, allocated
    when omitted)."""
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
        out = torch.empty((m, n), dtype=torch.float32, device=device)
    _check_rows(out, "out")
    if out.shape != (m, n) or out.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out must be ({m}, {n}) f32/bf16, got {tuple(out.shape)} {out.dtype}")
    return out


def gemm_bf16_f32acc(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     row_add: Optional[torch.Tensor] = None,
                     a_mut_cols: int = 0, plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """``out = a @ b + bias + row_add`` with ``a`` (M, K) and ``b`` (K, N)
    in bf16, f32 accumulation, ``bias`` (N,) and ``row_add`` (M, N) f32.
    ``a``, ``b``, ``row_add`` and ``out`` may be row-strided views. ``out``
    is f32 (allocated when omitted) or bf16 (the rounding of the f32
    result). ``a_mut_cols``: A's first columns are read as 2A - 1 (the
    D3PM prologue of the input product; ``a`` itself is not changed).
    ``plan``: the launch, :func:`gemm_plan`'s when omitted. On the card,
    ``a`` and ``b`` go through TMA when :func:`tma_ready`, else through
    the kernel's general path (mode "unaligned")."""
    lda = _check_rows(a, "a")
    ldb = _check_rows(b, "b")
    _check_dtype(a, torch.bfloat16, "a")
    _check_dtype(b, torch.bfloat16, "b")
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)} b {tuple(b.shape)}")
    if not 0 <= a_mut_cols <= k:
        raise ValueError(f"a_mut_cols must be in [0, {k}], got {a_mut_cols}")
    n = b.shape[1]
    out = _check_epilogue(m, n, bias, row_add, out, a.device)

    if not _on_cuda(a, b, bias, row_add, out):
        out.copy_(gemm_bf16_f32acc_plain(a, b, bias, row_add, a_mut_cols))
        return out
    if plan is None:
        plan = gemm_plan(m, n, k, _sm_count(a.device.index), "bf16")
    else:
        _check_plan(plan, k, "bf16")
    # tma_ready(a) and tma_ready(b), each pointer and stride read once: this
    # runs 12 times per sampler step, on the host's critical path.
    pa, pb = a.data_ptr(), b.data_ptr()
    tma = _tma_aligned(pa, 2 * lda) and _tma_aligned(pb, 2 * ldb)
    partials, tickets = (_WORKSPACE.pointers(a.device, m, n, plan) if plan.splits > 1
                         else (None, None))
    lib = LIBRARY.get()
    status = lib.osdm_gemm_bf16_f32acc(
        pa, lda, a_mut_cols, pb, ldb, out.data_ptr(), out.stride(0),
        int(out.dtype == torch.bfloat16), m, n, k,
        bias.data_ptr() if bias is not None else None,
        row_add.data_ptr() if row_add is not None else None,
        row_add.stride(0) if row_add is not None else 0,
        plan.bn, plan.splits, int(tma), partials, tickets, _stream(a),
    )
    check(status, GEMM.name)
    GEMM.count("unaligned" if not tma else "mut_prologue" if a_mut_cols else "bf16")
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
    GROUPNORM.count()
    return out


# ----------------------------------------------------------------------
# K3: output epilogue + clip + transition
# ----------------------------------------------------------------------
POSTERIOR = Kernel(
    "x0_posterior_step",
    "osteosarcoma_diffusionmodel_torch/csrc/posterior_step.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py:449",
    modes=tuple(NOISE_MODES) + tuple(f"d3pm_{m}" for m in NOISE_MODES),
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


def philox_uniform(seed: int, step: int, rows: int, cols: int, device=None,
                   width: Optional[int] = None) -> torch.Tensor:
    """The kernel's per-step uniforms u in [0, 1): Philox keyed by
    (seed, step), counter = row*cols + col, top 24 bits of the first
    word. ``width``: only the first ``width`` columns (the D3PM bit
    draws of eta = 0 DDIM)."""
    width = cols if width is None else width
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    idx = r * cols + c
    zero = torch.zeros_like(idx)
    r0, _, _, _ = philox4x32_10(idx & _M32, (idx >> 32) & _M32, zero, zero, seed, step)
    return (r0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


def philox_uniform_noise(seed: int, step: int, rows: int, cols: int,
                         device=None) -> torch.Tensor:
    """The kernel's transition noise z = (u - 1/2)·2sqrt3 ~ U(-sqrt3, sqrt3)
    for one step, from :func:`philox_uniform`."""
    return (philox_uniform(seed, step, rows, cols, device) - 0.5) * UNIFORM_SCALE


def x0_posterior_step_plain(acc, x, b_out, coeffs, step: int, mode: str,
                            noise=None, seed: int = 0, clip: float = 30.0,
                            mut_dim: int = 0):
    """Returns the new bf16 carry (the kernel updates ``x`` in place).
    The same f32 operations in the same order as the kernel."""
    c0, c1, sv, gain, beta, acp_prev = (coeffs[step, i] for i in range(6))
    xf = x.float()
    out = acc + b_out + gain * mutation_transform(x, mut_dim)
    x0 = torch.clamp(out, -clip, clip)
    xn = c0 * x0 + c1 * xf
    u = None
    if mode == "buffer":
        z = noise[step]
        xn = xn + sv * z
        u = z * (1.0 / UNIFORM_SCALE) + 0.5
    elif mode == "philox":
        u = philox_uniform(seed, step, *x.shape, device=x.device)
        xn = xn + sv * ((u - 0.5) * UNIFORM_SCALE)
    elif mut_dim:
        u = philox_uniform(seed, step, *x.shape, device=x.device, width=mut_dim)
    if mut_dim:
        m = mut_dim
        p_prev = posterior_prob_one(xf[:, :m], torch.sigmoid(out[:, :m]), beta, acp_prev)
        xn[:, :m] = (u[:, :m] < p_prev).float()
    return xn.to(torch.bfloat16)


def x0_posterior_step(acc: torch.Tensor, x: torch.Tensor, b_out: torch.Tensor,
                      coeffs: torch.Tensor, step: int, mode: str,
                      noise: Optional[torch.Tensor] = None, seed: int = 0,
                      clip: float = 30.0, mut_dim: int = 0) -> torch.Tensor:
    """In place on the bf16 carry ``x`` (B, D), a row-strided view like the
    f32 ``acc`` (B, D) may be: out = acc + b_out + g·x,
    x0 = clip(out), x <- c0·x0 + c1·x [+ sv·z], with (c0, c1, sv, g) from
    row ``step`` of the (n_loop, 6) f32 table. ``mode``: "none" (eta = 0
    DDIM), "buffer" (z = noise[step], noise (n_loop, B, D) f32) or
    "philox" (in-kernel noise keyed by (seed, step)).

    ``mut_dim`` > 0: the first columns hold D3PM bits. There the gain
    term is g·(2b - 1), p1 = sigmoid(out) of the unclipped logits, and
    the new bit is u < posterior_prob_one(b, p1, beta, acp_prev), with
    (beta, acp_prev) from columns 4-5 of the row and u the step's
    uniform on that column: Philox in "philox" and "none" mode,
    z/(2sqrt3) + 1/2 in "buffer" mode."""
    if mode not in NOISE_MODES:
        raise ValueError(f"unknown noise mode {mode!r}")
    _check_rows(acc, "acc")
    _check_rows(x, "x")
    _check_dtype(acc, torch.float32, "acc")
    _check_dtype(x, torch.bfloat16, "x")
    if acc.shape != x.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and x {tuple(x.shape)} differ")
    b, d = x.shape
    if not 0 <= mut_dim <= d:
        raise ValueError(f"mut_dim must be in [0, {d}], got {mut_dim}")
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
        x.copy_(x0_posterior_step_plain(acc, x, b_out, coeffs, step, mode, noise, seed, clip,
                                        mut_dim))
        return x
    lib = LIBRARY.get()
    status = lib.osdm_x0_posterior_step(
        acc.data_ptr(), acc.stride(0), x.data_ptr(), x.stride(0), b, d, mut_dim,
        b_out.data_ptr(), coeffs.data_ptr(),
        step, NOISE_MODES[mode], noise.data_ptr() if mode == "buffer" else None,
        seed, clip, _stream(x),
    )
    check(status, POSTERIOR.name)
    POSTERIOR.count(f"d3pm_{mode}" if mut_dim else mode)
    return x


# ----------------------------------------------------------------------
# K5: per-row dynamic int8 quantization of the activations
# ----------------------------------------------------------------------
ROWQUANT = Kernel(
    "rowquant_s8",
    "osteosarcoma_diffusionmodel_torch/csrc/rowquant_s8.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py:336",
    modes=("plain", "mut_transform"),
)

QUANT_ALIGN = 16  # int8 rows of K5's output and of the packed weights


def pad16(n: int) -> int:
    return -(-n // QUANT_ALIGN) * QUANT_ALIGN


def rowquant_s8_plain(a, mut_cols: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU's ``mm`` activation quantization (:336-339) on the f32 view
    of ``a`` (2a - 1 on its first ``mut_cols`` columns): per row,
    amax = max(max|x|, 1e-6), q = round_half_even(x·(127/amax)) as int8,
    zero-padded to a multiple of 16 columns, and the row scale
    amax·(1/127) in f32."""
    x = mutation_transform(a, mut_cols)
    amax = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-6)
    # A true division: ``127.0 / amax`` would be 127·(1/amax) in torch.
    q = torch.round(x * (amax.new_tensor(127.0) / amax)).to(torch.int8)
    q = torch.nn.functional.pad(q, (0, pad16(x.shape[1]) - x.shape[1]))
    return q, (amax * (1.0 / 127.0)).reshape(-1)


def rowquant_s8(a: torch.Tensor, out: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                mut_cols: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes of ``a`` (M, K), bf16 or f32, a row-strided view
    allowed: ``out`` (M, pad16(K)) int8 contiguous with zeros past K, and
    ``scale`` (M,) f32 such that a ~ out·scale. ``mut_cols``: the first
    columns are quantized as 2a - 1 (the D3PM input view)."""
    _check_rows(a, "a")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"a must be bf16 or f32, got {a.dtype}")
    m, k = a.shape
    if not 0 <= mut_cols <= k:
        raise ValueError(f"mut_cols must be in [0, {k}], got {mut_cols}")
    kp = pad16(k)
    if out is None:
        out = torch.empty((m, kp), dtype=torch.int8, device=a.device)
    if scale is None:
        scale = torch.empty(m, dtype=torch.float32, device=a.device)
    if out.shape != (m, kp) or out.dtype != torch.int8 or not out.is_contiguous():
        raise ValueError(f"out must be contiguous ({m}, {kp}) int8")
    if scale.shape != (m,) or scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous ({m},) f32")

    if not _on_cuda(a, out, scale):
        q, s = rowquant_s8_plain(a, mut_cols)
        out.copy_(q)
        scale.copy_(s)
        return out, scale
    lib = LIBRARY.get()
    status = lib.osdm_rowquant_s8(
        a.data_ptr(), a.stride(0), int(a.dtype == torch.bfloat16), m, k, mut_cols,
        out.data_ptr(), kp, scale.data_ptr(), _stream(a),
    )
    check(status, ROWQUANT.name)
    ROWQUANT.count("mut_transform" if mut_cols else "plain")
    return out, scale


# ----------------------------------------------------------------------
# K6: s8·s8 -> s32 product, dequantized, with K1's epilogue
# ----------------------------------------------------------------------
GEMM_S8 = Kernel(
    "gemm_s8",
    "osteosarcoma_diffusionmodel_torch/csrc/gemm_s8.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py:340",
    modes=("f32_out", "bf16_out", "accumulate"),
)


def pack_int8(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """One weight (K, N) as symmetric per-output-column int8 (the TPU's
    ``_pack_mat``, :127-138, in float32 numpy): sw = max(max|w|, 1e-8)/127
    per column, q = clip(round_half_even(w / sw), -127, 127). Returns the
    codes zero-padded to (pad16(K), pad16(N)) and the (N,) f32 scales."""
    w = np.asarray(w, np.float32)
    sw = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-8) / 127.0
    qw = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    k, n = w.shape
    padded = np.zeros((pad16(k), pad16(n)), np.int8)
    padded[:k, :n] = qw
    return torch.from_numpy(padded), torch.from_numpy(sw.reshape(-1).astype(np.float32))


def kmajor_int8(q: torch.Tensor) -> torch.Tensor:
    """:func:`pack_int8`'s (Kp, Np) codes as the (Np, Kp) K-major layout
    K6 takes (an 8-bit wgmma reads both operands K-major); made once per
    weight."""
    return q.t().contiguous()


def gemm_s8_plain(qa, row_scale, qb, col_scale, bias=None, row_add=None, acc_into=None):
    """The exact integer product of ``qa`` (M, Kp) and the K-major codes
    ``qb`` (Np, Kp) (float64 holds every partial sum: |sum| <= K·127^2 <
    2^53), one rounding to f32, then in f32 and in this order:
    ·row_scale, ·col_scale (the TPU's dequant, :344-346), + ``acc_into``
    (the earlier part of a split product), + bias, + row_add."""
    n = col_scale.shape[0]
    v = (qa.double() @ qb[:n].double().t()).float()
    v = v * row_scale[:, None] * col_scale[None, :]
    if acc_into is not None:
        v = acc_into + v
    if bias is not None:
        v = v + bias
    if row_add is not None:
        v = v + row_add
    return v


def gemm_s8(qa: torch.Tensor, row_scale: torch.Tensor, qb: torch.Tensor,
            col_scale: torch.Tensor, out: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None, row_add: Optional[torch.Tensor] = None,
            accumulate: bool = False, plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """``out (+)= (qa @ qbᵀ)·row_scale·col_scale + bias + row_add`` with
    ``qa`` (M, Kp) int8 from :func:`rowquant_s8`, ``qb`` (Np, Kp) int8
    K-major codes from :func:`kmajor_int8`, ``row_scale`` (M,),
    ``col_scale`` (N,) with N <= Np, and the epilogue of
    :func:`gemm_bf16_f32acc`. ``accumulate`` adds the result to the f32
    ``out`` (the second half of the decoder's split fc1). ``plan``: the
    launch, :func:`gemm_plan`'s when omitted."""
    for t, name in ((qa, "qa"), (qb, "qb")):
        _check_dtype(t, torch.int8, name)
        if t.dim() != 2 or not t.is_contiguous() or t.shape[1] % QUANT_ALIGN:
            raise ValueError(f"{name} must be contiguous 2-D with a multiple of "
                             f"{QUANT_ALIGN} columns, got {tuple(t.shape)}")
    m, kp = qa.shape
    if qb.shape[1] != kp:
        raise ValueError(f"inner dims differ: qa {tuple(qa.shape)} qb {tuple(qb.shape)}")
    n = col_scale.shape[0] if col_scale.dim() == 1 else -1
    for t, name, size in ((row_scale, "row_scale", m), (col_scale, "col_scale", n)):
        _check_dtype(t, torch.float32, name)
        if t.dim() != 1 or t.shape[0] != size or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({size},)")
    if not 0 < n <= qb.shape[0]:
        raise ValueError(f"col_scale has {n} entries for {qb.shape[0]} packed columns")
    if accumulate and (out is None or out.dtype != torch.float32):
        raise ValueError("accumulate needs an f32 out")
    out = _check_epilogue(m, n, bias, row_add, out, qa.device)

    if not _on_cuda(qa, row_scale, qb, col_scale, bias, row_add, out):
        out.copy_(gemm_s8_plain(qa, row_scale, qb, col_scale, bias, row_add,
                                out if accumulate else None))
        return out
    if qa.data_ptr() % 16 or qb.data_ptr() % 16:
        raise ValueError("qa and qb must be 16-byte aligned")
    if plan is None:
        plan = gemm_plan(m, n, kp, _sm_count(qa.device.index), "int8")
    else:
        _check_plan(plan, kp, "int8")
    partials, tickets = (_WORKSPACE.pointers(qa.device, m, n, plan) if plan.splits > 1
                         else (None, None))
    lib = LIBRARY.get()
    status = lib.osdm_gemm_s8(
        qa.data_ptr(), kp, qb.data_ptr(), kp, qb.shape[0], out.data_ptr(), out.stride(0),
        int(out.dtype == torch.bfloat16), m, n, kp, row_scale.data_ptr(), col_scale.data_ptr(),
        int(accumulate),
        bias.data_ptr() if bias is not None else None,
        row_add.data_ptr() if row_add is not None else None,
        row_add.stride(0) if row_add is not None else 0,
        plan.bn, plan.splits, partials, tickets, _stream(qa),
    )
    check(status, GEMM_S8.name)
    GEMM_S8.count("accumulate" if accumulate else
                  "bf16_out" if out.dtype == torch.bfloat16 else "f32_out")
    return out


# ----------------------------------------------------------------------
# K7: the latent-tail sampler's per-step elementwise work
# ----------------------------------------------------------------------
LATENT = Kernel(
    "latent_step",
    "osteosarcoma_diffusionmodel_torch/csrc/latent_step.cu",
    "osteosarcoma_diffusionmodel_tpu/ops/latent_sampler.py:442",
    modes=("draw_philox", "draw_buffer", "update"),
)
LATENT_COLS = 5  # the (n_lat, 5) table: A, c0, sv, w, v


def _check_latent_table(coeffs: torch.Tensor, step: int) -> None:
    _check_dtype(coeffs, torch.float32, "coeffs")
    if coeffs.dim() != 2 or coeffs.shape[1] != LATENT_COLS or not coeffs.is_contiguous():
        raise ValueError(f"coeffs must be a contiguous (n_lat, {LATENT_COLS}) table")
    if not 0 <= step < coeffs.shape[0]:
        raise IndexError(f"step {step} outside the {coeffs.shape[0]}-row table")


def _check_state(tensors, shape, dtype) -> None:
    for t, name in tensors:
        _check_dtype(t, dtype, name)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got {tuple(t.shape)}")


def latent_draw_plain(h, hacc, xi, coeffs, step: int, mode: str, zeta=None, seed: int = 0):
    """Returns (bf16 zeta_k, xi + v·zeta_k, H_acc + w·h): the kernel's f32
    operations in its order. zeta_k is Philox U(-sqrt3, sqrt3) keyed by
    (seed, step) ("philox") or ``zeta[step]`` ("buffer")."""
    w, v = coeffs[step, 3], coeffs[step, 4]
    if mode == "buffer":
        z = zeta[step]
    else:
        z = philox_uniform_noise(seed, step, *xi.shape, device=xi.device)
    return z.to(torch.bfloat16), xi + v * z, hacc + w * h.float()


def latent_draw(h: torch.Tensor, hacc: torch.Tensor, xi: torch.Tensor, zeta_bf: torch.Tensor,
                coeffs: torch.Tensor, step: int, mode: str,
                zeta: Optional[torch.Tensor] = None, seed: int = 0) -> None:
    """In place, for latent step ``step`` with (w, v) from row ``step`` of
    the (n_lat, 5) f32 table: ``zeta_bf`` <- bf16(zeta_k), ``xi`` += v·zeta_k,
    ``hacc`` += w·h. ``h`` (M, H) bf16 is the step's hidden stack output;
    ``hacc``/``xi`` (M, H) f32, ``zeta_bf`` (M, H) bf16. ``mode``: "philox"
    (in-kernel, keyed by (seed, step), counter = row·H + col) or "buffer"
    (``zeta`` (n_lat, M, H) f32)."""
    if mode not in ("philox", "buffer"):
        raise ValueError(f"unknown draw mode {mode!r}")
    if h.dim() != 2:
        raise ValueError("h must be 2-D")
    shape = tuple(h.shape)
    _check_state([(h, "h"), (zeta_bf, "zeta_bf")], shape, torch.bfloat16)
    _check_state([(hacc, "hacc"), (xi, "xi")], shape, torch.float32)
    _check_latent_table(coeffs, step)
    if mode == "buffer":
        if zeta is None or tuple(zeta.shape) != (coeffs.shape[0], *shape) or not zeta.is_contiguous():
            raise ValueError(f"buffer mode needs contiguous zeta ({coeffs.shape[0]}, {shape[0]}, "
                             f"{shape[1]})")
        _check_dtype(zeta, torch.float32, "zeta")
    if not 0 <= seed <= _M32:
        raise ValueError("seed must fit in 32 bits")

    if not _on_cuda(h, hacc, xi, zeta_bf, coeffs, zeta if mode == "buffer" else None):
        z, x_new, h_new = latent_draw_plain(h, hacc, xi, coeffs, step, mode, zeta, seed)
        zeta_bf.copy_(z)
        xi.copy_(x_new)
        hacc.copy_(h_new)
        return
    lib = LIBRARY.get()
    status = lib.osdm_latent_draw(
        h.data_ptr(), hacc.data_ptr(), xi.data_ptr(), zeta_bf.data_ptr(), shape[0], shape[1],
        coeffs.data_ptr(), step, NOISE_MODES[mode],
        zeta.data_ptr() if mode == "buffer" else None, seed, _stream(h),
    )
    check(status, LATENT.name)
    LATENT.count(f"draw_{mode}")


def latent_update_plain(s, o_lat, n_inj, c_proj, t_add, coeffs, step: int):
    """Returns (A·s + c0·o_lat + sv·n_inj, its bf16 next stack input
    s + t_add[step + 1] + c_proj): the kernel's f32 operations in its order."""
    a, c0, sv = coeffs[step, 0], coeffs[step, 1], coeffs[step, 2]
    s_new = a * s + c0 * o_lat + sv * n_inj
    return s_new, (s_new + t_add[step + 1] + c_proj).to(torch.bfloat16)


def latent_update(s: torch.Tensor, o_lat: torch.Tensor, n_inj: torch.Tensor,
                  c_proj: torch.Tensor, t_add: torch.Tensor, coeffs: torch.Tensor, step: int,
                  h_in: torch.Tensor) -> None:
    """In place, for latent step ``step`` with (A, c0, sv) from row ``step``
    of the (n_lat, 5) table: ``s`` <- A·s + c0·o_lat + sv·n_inj and
    ``h_in`` <- bf16(s + t_add[step + 1] + c_proj), the next hidden stack
    input. ``s``, ``o_lat``, ``n_inj``, ``c_proj`` (M, H) f32; ``t_add``
    (n_lat + 1, H) f32 (the segment's rows); ``h_in`` (M, H) bf16."""
    if s.dim() != 2:
        raise ValueError("s must be 2-D")
    shape = tuple(s.shape)
    _check_state([(s, "s"), (o_lat, "o_lat"), (n_inj, "n_inj"), (c_proj, "c_proj")], shape,
                 torch.float32)
    _check_state([(h_in, "h_in")], shape, torch.bfloat16)
    _check_latent_table(coeffs, step)
    _check_dtype(t_add, torch.float32, "t_add")
    if (t_add.dim() != 2 or t_add.shape[1] != shape[1] or t_add.shape[0] < step + 2
            or not t_add.is_contiguous()):
        raise ValueError(f"t_add must be contiguous with more than {step + 1} rows of {shape[1]}")

    if not _on_cuda(s, o_lat, n_inj, c_proj, t_add, coeffs, h_in):
        s_new, h_new = latent_update_plain(s, o_lat, n_inj, c_proj, t_add, coeffs, step)
        s.copy_(s_new)
        h_in.copy_(h_new)
        return
    lib = LIBRARY.get()
    status = lib.osdm_latent_update(
        s.data_ptr(), o_lat.data_ptr(), n_inj.data_ptr(), c_proj.data_ptr(), t_add.data_ptr(),
        coeffs.data_ptr(), step, h_in.data_ptr(), shape[0], shape[1], _stream(s),
    )
    check(status, LATENT.name)
    LATENT.count("update")
