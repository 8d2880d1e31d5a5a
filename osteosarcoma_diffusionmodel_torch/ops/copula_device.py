"""Joint-copula calibration on the card, in plain PyTorch ops.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/copula_device.py (an
XLA program there: matmuls, sorts, ``eigh`` and gathers, no Pallas
kernel), with the same function names. ``ops/copula.py`` is the float64
numpy estimator; this module runs the same pipeline on tensors that stay
on the card from the sampler to the calibrated cohort, which alone comes
back to the host.

Parity contract (tests/test_torch_copula_device.py): the per-column
marginals equal the numpy path's by construction (the same exact
per-gene bit counts; continuous values taken from the same real quantile
grid, so sorted columns match). The assignment of values to patients can
differ (an independent tie-break stream): the imposed joint is compared
by its correlation pattern.

Precision: the eigendecompositions run in float64, and so does the Gram
each of them reads (an f32 Gram would put rounding of the floor's order,
1e-6, on the eigenvalues the floor decides on), as the numpy path forms
it. Every other product is a float32 product with TF32 off, the
counterpart of the JAX module's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import COUNTERS, span
from .copula import nearest_corr_psd
from .precision import full_f32_matmul

_FLOOR = 1e-6  # eigenvalue floor, as in copula._whiten_exact


def _normal_scores(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per-column rank -> standard-normal scores with a random order among
    exact ties (copula._normal_scores with ``tie_rng``). A sort by a
    uniform key, then a stable sort of the values gathered in that order:
    equal values keep the key's random order."""
    n = x.shape[0]
    order = torch.rand(x.shape, generator=generator, device=x.device).argsort(dim=0)
    order = order.gather(0, x.gather(0, order).sort(dim=0, stable=True).indices)
    rows = torch.arange(n, device=x.device).unsqueeze(1).expand_as(order)
    ranks = torch.empty_like(order).scatter_(0, order, rows)
    del order
    return torch.special.ndtri((ranks.float() + 0.5) / n)


def _unit_std(u: torch.Tensor) -> torch.Tensor:
    """Columns scaled to unit (population) standard deviation, in place."""
    return u.div_(u.std(dim=0, correction=0, keepdim=True).clamp_min(1e-9))


def _inv_sqrt(eigval: torch.Tensor, floor: float) -> torch.Tensor:
    """1/sqrt(λ) above the floor, 0 below it: sub-floor directions carry no
    signal, and clamping would amplify their noise ~1000x."""
    return torch.where(eigval > floor, eigval.clamp_min(floor).rsqrt(), 0.0).float()


def _whiten_exact(u: torch.Tensor, floor: float = _FLOOR) -> torch.Tensor:
    """Exact eigen-whitening (copula._whiten_exact): the dual N x N Gram
    when N < D, the primal D x D Gram otherwise."""
    n, d = u.shape
    with span("calibrate.whiten", u.device):
        u64 = u.double()
        if n < d:
            eigval, q = torch.linalg.eigh(u64 @ u64.T / n)
            del u64
            q = q.float()
            w = (q * _inv_sqrt(eigval, floor)) @ (q.T @ u)
        else:
            eigval, v = torch.linalg.eigh(u64.T @ u64 / n)
            del u64
            v = v.float()
            w = (u @ (v * _inv_sqrt(eigval, floor))) @ v.T
        return _unit_std(w)


def _nearest_corr_psd(corr: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """copula.nearest_corr_psd on the card (float64 in, float64 out)."""
    w, v = torch.linalg.eigh(0.5 * (corr + corr.T))
    fixed = (v * w.clamp_min(eps)) @ v.T
    d = fixed.diagonal().clamp_min(eps).sqrt()
    fixed = fixed / torch.outer(d, d)
    return fixed.fill_diagonal_(1.0)


def _count_threshold_bits(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exactly k[g] ones in column g (up to exact ties, measure zero for a
    continuous z): the numpy path's partition at n - k."""
    n = z.shape[0]
    idx = (n - k).clamp(0, n - 1).unsqueeze(0)
    thresh = z.sort(dim=0).values.gather(0, idx)
    return (z >= thresh).float().masked_fill_((k <= 0).unsqueeze(0), 0.0)


def _tetra_resharpen(zm: torch.Tensor, tetra_chol: torch.Tensor, k: torch.Tensor,
                     generator: torch.Generator, ridge: float = 1e-3) -> torch.Tensor:
    """The second, exact-tetrachoric transplant of the mutation block
    (copula.correlation_transplant driven by the joint z): whiten by the
    ridged empirical correlation, recolor with the tetrachoric target's
    Cholesky factor, threshold at the exact counts. The m x m algebra runs
    in float64."""
    n, d = zm.shape
    u = _normal_scores(zm, generator)
    if n > d + 1:
        uc = u.double() - u.double().mean(dim=0, keepdim=True)
        rms = (uc * uc).mean(dim=0).clamp_min(1e-18).sqrt()
        emp = uc.T @ uc / n / torch.outer(rms, rms)
        eye = torch.eye(d, dtype=emp.dtype, device=emp.device)
        l_emp = torch.linalg.cholesky(_nearest_corr_psd(emp * (1.0 - ridge) + eye * ridge))
        w = torch.linalg.solve_triangular(l_emp, u.double().T, upper=False).T.float()
    else:
        w = u
    return _count_threshold_bits(_unit_std(w) @ tetra_chol.T, k)


def _quantile_map(cont: torch.Tensor, sorted_real: torch.Tensor) -> torch.Tensor:
    """Within-cohort ranks -> linear interpolation on the real per-feature
    quantile grid (the generator's ``_quantile_map_continuous``). The value
    at rank i is the same lerp of two grid rows in every column, so the
    rank-ordered table is built directly and scattered back through the
    sort order."""
    n, n_real = cont.shape[0], sorted_real.shape[0]
    order = cont.argsort(dim=0)
    pos = (torch.arange(n, dtype=torch.float32, device=cont.device) + 0.5) / n * (n_real - 1)
    lo = pos.floor().long()
    hi = (lo + 1).clamp_max(n_real - 1)
    frac = (pos - lo.float()).unsqueeze(1)
    vals = sorted_real[lo] * (1.0 - frac) + sorted_real[hi] * frac
    return torch.empty_like(vals).scatter_(0, order, vals)


def _pinned_blocks() -> Optional[int]:
    """The page-locked blocks PyTorch's caching host allocator has created
    in this process, where the build reports them."""
    return torch.cuda.host_memory_stats().get("num_host_alloc")


def to_host(*arrays: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Tensors on one device as host numpy arrays, the calibration layer's
    one way back.

    From a card, each array is copied into a page-locked block of
    PyTorch's caching host allocator (``torch.empty(..., pin_memory=True)``),
    every copy enqueued before one synchronize of the current stream: the
    copy runs at the link's rate, with no staging through a bounce buffer
    and no fresh pages to fault in. The returned arrays own
    their blocks, one each, so no two share memory and a later call never
    writes into a result a caller still holds. A block goes back to the
    allocator's cache when its array (and every view of it) is dropped,
    and the next array of the same size class reuses it. So a caller that
    keeps k results alive keeps k blocks per array, each rounded up to a
    power of two (a 333 MB cohort holds a 512 MB block), and the cache
    keeps a block page-locked after its array is dropped. Counted:
    ``COUNTERS["copy.d2h_pinned"]``, the arrays copied so;
    ``"copy.host_allocs"``, the new blocks that took, where the build
    reports them; ``"copy.d2h_pageable"``, the arrays of a call whose
    page-locked allocation failed, which falls back to ``.cpu()``.

    From the CPU, ``a.cpu().numpy()``: the tensor's own memory, no count.
    """
    if not arrays or arrays[0].device.type != "cuda":
        return tuple(a.cpu().numpy() for a in arrays)
    blocks = _pinned_blocks()
    try:
        out = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in arrays]
    except RuntimeError:  # the allocator could not page-lock the memory
        COUNTERS["copy.d2h_pageable"] += len(arrays)
        return tuple(a.cpu().numpy() for a in arrays)
    if blocks is not None:
        COUNTERS["copy.host_allocs"] += _pinned_blocks() - blocks
    for host, a in zip(out, arrays):
        host.copy_(a, non_blocking=True)
    torch.cuda.current_stream(arrays[0].device).synchronize()
    COUNTERS["copy.d2h_pinned"] += len(arrays)
    return tuple(host.numpy() for host in out)


class DeviceCalibrator:
    """Per-checkpoint calibration constants on ``device`` and the per-cohort
    pipelines.

    The target factors are fitted on the host in float64, once per
    checkpoint (``ops/copula.py``: ``fit_joint_copula``,
    ``fit_continuous_copula_chol``, and here the PSD repair and Cholesky
    factor of the tetrachoric target), and moved to the device once.

    ``MAX_ROWS``: above it callers take the numpy path (the generator asks
    :meth:`accepts`). It caps the N x D float32 intermediates (scores,
    whitened, recolored: ~674 MB each at the bound) and the dual branch's
    N x N Gram; at N >= D the primal branch's D x D Gram is fixed in size.
    """

    MAX_ROWS = 32768

    def __init__(self, m: int, sorted_real_cont: np.ndarray, freq: Optional[np.ndarray] = None,
                 joint_chol: Optional[np.ndarray] = None, tetra: Optional[np.ndarray] = None,
                 cont_chol: Optional[np.ndarray] = None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.m = int(m)

        def put(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a, np.float32)).to(device)

        self._sorted_real = put(sorted_real_cont)
        self._freq = None if freq is None else np.asarray(freq, np.float64)
        self._joint_chol = put(joint_chol)
        self._tetra_chol = None if tetra is None else put(
            np.linalg.cholesky(nearest_corr_psd(np.asarray(tetra, np.float64))))
        self._cont_chol = put(cont_chol)

    @classmethod
    def accepts(cls, n: int) -> bool:
        return n <= cls.MAX_ROWS

    def _input(self, raw) -> torch.Tensor:
        """The cohort as float32 on this calibrator's device. A numpy array or
        a tensor elsewhere is refused: moving a cohort is the caller's
        decision."""
        if not torch.is_tensor(raw):
            raise TypeError(f"DeviceCalibrator takes a tensor on {self.device}, got {type(raw)}")
        if raw.device != self.device:
            raise ValueError(f"DeviceCalibrator on {self.device} got a tensor on {raw.device}")
        return raw.float()

    def _download(self, *arrays: torch.Tensor) -> Tuple[np.ndarray, ...]:
        """The calibrated arrays as host numpy arrays (:func:`to_host`);
        their bytes are counted in ``COUNTERS["copy.d2h_bytes"]``."""
        with span("calibrate.download", self.device):
            out = to_host(*arrays)
            COUNTERS["copy.d2h_bytes"] += sum(a.nbytes for a in out)
        return out

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    @torch.no_grad()
    def joint(self, raw: torch.Tensor, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """copula_joint: one whiten/recolor over the full vector, the
        tetrachoric re-sharpening of the bits, the quantile map of the
        continuous block. ``raw``: (N, D) on the device. Returns host
        (bits (N, m), continuous (N, D - m)), float32."""
        if self._joint_chol is None or self._freq is None:
            raise ValueError("DeviceCalibrator built without joint target")
        raw = self._input(raw)
        n, m = raw.shape[0], self.m
        k = torch.from_numpy(np.clip(np.round(self._freq * n).astype(np.int64), 0, n)).to(self.device)
        g = self._generator(seed)
        with full_f32_matmul():
            w = _whiten_exact(_unit_std(_normal_scores(raw, g)))
            z = w @ self._joint_chol.T
            del w
            if self._tetra_chol is not None and n > m + 1:
                bits = _tetra_resharpen(z[:, :m], self._tetra_chol, k, g)
            else:
                bits = _count_threshold_bits(z[:, :m], k)
            cont = _quantile_map(z[:, m:], self._sorted_real)
            del z
        return self._download(bits, cont)

    @torch.no_grad()
    def continuous(self, cont_raw: torch.Tensor, seed: int) -> np.ndarray:
        """copula_full's continuous block: whiten/recolor with the
        continuous-only target, then the quantile map. ``cont_raw``:
        (N, D - m) on the device. Returns host (N, D - m) float32."""
        if self._cont_chol is None:
            raise ValueError("DeviceCalibrator built without cont target")
        cont_raw = self._input(cont_raw)
        g = self._generator(seed)
        with full_f32_matmul():
            w = _whiten_exact(_unit_std(_normal_scores(cont_raw, g)))
            z = w @ self._cont_chol.T
            del w
            out = _quantile_map(z, self._sorted_real)
        return self._download(out)[0]
