"""Plain reference of the ``copula_joint`` calibration.

The target fit is a frozen copy, in numpy float64, of the estimator that
the configuration names (``calibrate_marginals: copula_joint``): the
Gram of the training cohort's per-column scores (standardized mutation
bits, van der Waerden normal scores of the continuous block), shrunk
toward I until it is positive definite, its Cholesky factor, the
tetrachoric correlation of the mutation bits for the second stage, and
the per-gene frequencies.

The transplant runs in PyTorch on the cohort's device: rank normal
scores with ties ordered by uniform keys from a ``torch.Generator``
seeded with ``random_seed + 104729`` (the tie-break stream the
configuration's device calibration is specified to draw), exact eigen
whitening of the unit-variance scores through a float64 Gram, the
recolor with the target factor, the tetrachoric re-sharpening of the
mutation block (whiten by the ridged empirical correlation, recolor,
threshold at the exact per-gene counts), and the within-cohort ranks of
the continuous block mapped onto the real per-feature quantile grid.
Float32 products run with TF32 off unless ``tf32`` asks for the lower
precision (the calibration's control).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_SQRT2 = np.sqrt(2.0)
_SQRT2PI = np.sqrt(2.0 * np.pi)
TIE_SEED_OFFSET = 104729
_FLOOR = 1e-6


# ----------------------------------------------------------------------
# The target fit (numpy float64; frozen copy)
# ----------------------------------------------------------------------
def norm_ppf(p: np.ndarray) -> np.ndarray:
    """Standard normal inverse CDF (Acklam's rational approximation)."""
    p = np.asarray(p, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    p = np.clip(p, 1e-12, 1 - 1e-12)
    out = np.empty_like(p)
    lo = p < plow
    q = np.sqrt(-2 * np.log(p[lo]))
    out[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
        ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    mid = (~lo) & (p <= phigh)
    q = p[mid] - 0.5
    r = q * q
    out[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
        (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    hi = p > phigh
    q = np.sqrt(-2 * np.log(1 - p[hi]))
    out[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
        ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    return out


def _bvn_density(a, b, r):
    om = 1.0 - r * r
    return np.exp(-(a * a - 2.0 * r * a * b + b * b) / (2.0 * om)) / (2.0 * np.pi * np.sqrt(om))


def tetrachoric_pairs(p1, p2, p11, grid_size: int = 257, r_max: float = 0.999) -> np.ndarray:
    """rho with P(Z1 > ppf(1-p1), Z2 > ppf(1-p2); rho) = p11, by Plackett's
    identity tabled on a symmetric r grid and inverted by interpolation."""
    p1, p2, p11 = (np.asarray(v, np.float64) for v in (p1, p2, p11))
    a = norm_ppf(1.0 - p1)[:, None]
    b = norm_ppf(1.0 - p2)[:, None]
    r = np.linspace(-r_max, r_max, grid_size)[None, :]
    dens = _bvn_density(a, b, r)
    mid = grid_size // 2
    dr = r[0, 1] - r[0, 0]
    trap = 0.5 * (dens[:, 1:] + dens[:, :-1]) * dr
    cum = np.zeros_like(dens)
    cum[:, mid + 1:] = np.cumsum(trap[:, mid:], axis=1)
    cum[:, :mid] = -np.cumsum(trap[:, :mid][:, ::-1], axis=1)[:, ::-1]
    orthant = p1[:, None] * p2[:, None] + cum
    target = np.clip(p11, orthant[:, 0] + 1e-12, orthant[:, -1] - 1e-12)
    idx = np.clip(np.sum(orthant <= target[:, None], axis=1) - 1, 0, grid_size - 2)
    rows = np.arange(len(target))
    o0, o1 = orthant[rows, idx], orthant[rows, idx + 1]
    frac = np.where(o1 > o0, (target - o0) / np.maximum(o1 - o0, 1e-30), 0.0)
    rho = r[0, idx] + frac * dr
    degenerate = (p1 <= 1e-9) | (p1 >= 1 - 1e-9) | (p2 <= 1e-9) | (p2 >= 1 - 1e-9)
    return np.where(degenerate, 0.0, np.clip(rho, -r_max, r_max))


def nearest_corr_psd(corr: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    corr = 0.5 * (corr + corr.T)
    w, v = np.linalg.eigh(corr)
    fixed = (v * np.maximum(w, eps)) @ v.T
    d = np.sqrt(np.clip(np.diag(fixed), eps, None))
    fixed = fixed / np.outer(d, d)
    np.fill_diagonal(fixed, 1.0)
    return fixed


def _rank_scores(x: np.ndarray) -> np.ndarray:
    """Per-column van der Waerden scores, ties in row order."""
    n = x.shape[0]
    order = np.argsort(x, axis=0, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.broadcast_to(np.arange(n)[:, None], order.shape), axis=0)
    return norm_ppf((ranks + 0.5) / n)


def fit_joint(real_mut: np.ndarray, real_cont: np.ndarray, shrink: float = 0.02):
    """(freq, chol (float32), tetra) of the joint target."""
    real_mut = np.asarray(real_mut, np.float64)
    n, m = real_mut.shape
    freq = real_mut.mean(axis=0)
    iu, ju = np.triu_indices(m, k=1)
    joint = (real_mut.T @ real_mut) / n
    tetra = np.eye(m)
    rho = tetrachoric_pairs(freq[iu], freq[ju], joint[iu, ju])
    tetra[iu, ju] = rho
    tetra[ju, iu] = rho
    tetra = nearest_corr_psd(tetra)
    s_mut = (real_mut - freq) / np.sqrt(np.clip(freq * (1.0 - freq), 1e-9, None))
    u = _rank_scores(np.asarray(real_cont, np.float64))
    u /= np.maximum(u.std(axis=0, keepdims=True), 1e-9)
    scores = np.concatenate([s_mut, u], axis=1)
    gram = scores.T @ scores / n
    np.fill_diagonal(gram, 1.0)
    eye = np.eye(gram.shape[0])
    s = shrink
    while s < 1.0:
        try:
            chol = np.linalg.cholesky((1.0 - s) * gram + s * eye)
            return freq, chol.astype(np.float32), tetra
        except np.linalg.LinAlgError:
            s *= 2.0
    raise np.linalg.LinAlgError("joint copula target could not be made PD")


# ----------------------------------------------------------------------
# The transplant (PyTorch)
# ----------------------------------------------------------------------
def _scores(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Normal scores of per-column ranks, exact ties ordered by uniform
    keys: sort rows by key, then stably by value."""
    n = x.shape[0]
    by_key = torch.rand(x.shape, generator=gen, device=x.device).argsort(dim=0)
    order = by_key.gather(0, x.gather(0, by_key).sort(dim=0, stable=True).indices)
    ranks = torch.empty_like(order)
    ranks.scatter_(0, order, torch.arange(n, device=x.device)[:, None].expand_as(order))
    return torch.special.ndtri((ranks.float() + 0.5) / n)


def _unit(u: torch.Tensor) -> torch.Tensor:
    return u / u.std(dim=0, correction=0, keepdim=True).clamp_min(1e-9)


def _exact_counts(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """1 on the k[g] largest z of column g."""
    n = z.shape[0]
    thresh = z.sort(dim=0).values.gather(0, (n - k).clamp(0, n - 1)[None, :])
    return ((z >= thresh) & (k > 0)[None, :]).float()


def _psd_corr(c: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    w, v = torch.linalg.eigh(0.5 * (c + c.T))
    fixed = (v * w.clamp_min(eps)) @ v.T
    d = fixed.diagonal().clamp_min(eps).sqrt()
    fixed = fixed / torch.outer(d, d)
    return fixed.fill_diagonal_(1.0)


@torch.no_grad()
def calibrate_joint(raw: torch.Tensor, real: np.ndarray, m: int, tie_seed: int,
                    tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bits (N, m), continuous (N, D - m)) float32 on raw's device, from
    the raw cohort ``raw`` (N, D) and the training cohort ``real`` (n, D)."""
    dev = raw.device
    freq, chol, tetra = fit_joint(real[:, :m], real[:, m:])
    chol_t = torch.from_numpy(chol).to(dev)
    tetra_l = torch.from_numpy(np.linalg.cholesky(nearest_corr_psd(tetra))
                               .astype(np.float32)).to(dev)
    sorted_real = torch.from_numpy(np.sort(np.asarray(real, np.float32), axis=0)[:, m:]
                                   .copy()).to(dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        raw = raw.float()
        n, d = raw.shape
        k = torch.from_numpy(np.clip(np.round(freq * n).astype(np.int64), 0, n)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(int(tie_seed))
        u = _unit(_scores(raw, gen))
        u64 = u.double()
        if n < d:
            lam, q = torch.linalg.eigh(u64 @ u64.T / n)
            inv = torch.where(lam > _FLOOR, lam.clamp_min(_FLOOR).rsqrt(), 0.0).float()
            q = q.float()
            w = (q * inv) @ (q.T @ u)
        else:
            lam, v = torch.linalg.eigh(u64.T @ u64 / n)
            inv = torch.where(lam > _FLOOR, lam.clamp_min(_FLOOR).rsqrt(), 0.0).float()
            v = v.float()
            w = (u @ (v * inv)) @ v.T
        del u64
        z = _unit(w) @ chol_t.T
        del w
        zm = z[:, :m]
        if n > m + 1:
            um = _scores(zm, gen).double()
            uc = um - um.mean(dim=0, keepdim=True)
            rms = (uc * uc).mean(dim=0).clamp_min(1e-18).sqrt()
            emp = uc.T @ uc / n / torch.outer(rms, rms)
            eye = torch.eye(m, dtype=emp.dtype, device=dev)
            l_emp = torch.linalg.cholesky(_psd_corr(emp * (1.0 - 1e-3) + eye * 1e-3))
            wm = torch.linalg.solve_triangular(l_emp, um.T, upper=False).T.float()
            bits = _exact_counts(_unit(wm) @ tetra_l.T, k)
        else:
            bits = _exact_counts(zm, k)
        zc = z[:, m:]
        n_real = sorted_real.shape[0]
        pos = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n * (n_real - 1)
        lo = pos.floor().long()
        hi = (lo + 1).clamp_max(n_real - 1)
        frac = (pos - lo.float())[:, None]
        by_rank = sorted_real[lo] * (1.0 - frac) + sorted_real[hi] * frac
        cont = torch.empty_like(by_rank).scatter_(0, zc.argsort(dim=0), by_rank)
        return bits, cont
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
