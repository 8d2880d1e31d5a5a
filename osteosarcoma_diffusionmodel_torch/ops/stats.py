"""Statistics for cohort validation, as PyTorch ops on the cohort's device.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/stats.py: two-sample
KS (asymptotic, and the exact lattice-path DP in numpy, unchanged),
1-D Wasserstein, PCA by SVD, 2x2 chi-square with Yates correction over
binary pairs, and the correlation helpers. The JAX package computes
these in float32 with HIGHEST-precision dots; here the products run in
float64, which the H100 executes natively, so no TF32 setting can touch
them. The MMD lives in ``pallas_kernels.py`` (kernel K4).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_EPS = 1e-12
KS_EXACT_MAX_N = 10_000  # scipy's mode='auto' switch point


# ----------------------------------------------------------------------
# Kolmogorov-Smirnov
# ----------------------------------------------------------------------
def ks_statistics(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-column two-sample KS statistic D = sup |F_x - F_y| for
    (n, k) vs (m, k)."""
    xs = torch.sort(x.double(), dim=0).values
    ys = torch.sort(y.double(), dim=0).values
    both = torch.cat([xs, ys], dim=0)
    # searchsorted works along the last dimension: features as rows.
    xt, yt, bt = xs.T.contiguous(), ys.T.contiguous(), both.T.contiguous()
    cdf_x = torch.searchsorted(xt, bt, right=True).double() / xs.shape[0]
    cdf_y = torch.searchsorted(yt, bt, right=True).double() / ys.shape[0]
    return (cdf_x - cdf_y).abs().max(dim=1).values


def ks_pvalue_asymptotic(d: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Two-sided asymptotic Kolmogorov p-values Q_KS(sqrt(en) * d)."""
    en = n * m / (n + m)
    lam = (en ** 0.5 + 0.12 + 0.11 / en ** 0.5) * d.double()
    j = torch.arange(1, 101, dtype=torch.float64, device=d.device)
    terms = 2.0 * ((-1.0) ** (j - 1)) * torch.exp(-2.0 * (j[None, :] * lam[:, None]) ** 2)
    return torch.clamp(terms.sum(dim=1), 0.0, 1.0)


def ks_pvalue_exact(d_values: np.ndarray, n: int, m: int) -> np.ndarray:
    """Exact two-sample two-sided KS p-values (scipy method='exact'),
    vectorized over statistics: 1 - (#lattice paths staying inside the
    band |i*m - j*n| < round(d*n*m)) / C(n+m, n), with per-row rescaling."""
    from scipy.special import gammaln

    d_values = np.atleast_1d(np.asarray(d_values, np.float64))
    if n > m:
        n, m = m, n
    h = np.round(d_values * n * m).astype(np.int64)
    F = len(d_values)
    j_idx = np.arange(m + 1, dtype=np.int64)[:, None]
    B = np.zeros((m + 1, F), np.float64)
    B[0] = 1.0
    log_scale = np.zeros(F, np.float64)
    for i in range(n + 1):
        inside = np.abs(i * m - j_idx * n) < h[None, :]
        total = np.cumsum(np.where(inside, B, 0.0), axis=0)
        start_total = np.maximum.accumulate(np.where(inside, -np.inf, total), axis=0)
        start_total = np.where(np.isneginf(start_total), 0.0, start_total)
        B = np.where(inside, total - start_total, 0.0)
        mx = B.max(axis=0)
        mx = np.where(mx > 0, mx, 1.0)
        B /= mx
        log_scale += np.log(mx)
    log_paths = np.where(B[m] > 0, np.log(np.maximum(B[m], 1e-300)), -np.inf)
    log_paths = log_paths + log_scale
    log_total = gammaln(n + m + 1) - gammaln(n + 1) - gammaln(m + 1)
    p_inside = np.exp(np.clip(log_paths - log_total, -745.0, 0.0))
    p_inside = np.where(np.isneginf(log_paths), 0.0, p_inside)
    return np.clip(1.0 - p_inside, 0.0, 1.0)


def ks_test_features(x: torch.Tensor, y: torch.Tensor,
                     mode: str = "asymp") -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature KS (statistics, p-values) as numpy arrays. ``mode``:
    "asymp" | "exact" | "auto" (exact when max(n, m) <= 10000)."""
    n, m = x.shape[0], y.shape[0]
    stats = ks_statistics(x, y)
    if mode == "exact" or (mode == "auto" and max(n, m) <= KS_EXACT_MAX_N):
        stats_np = stats.cpu().numpy()
        return stats_np, ks_pvalue_exact(stats_np, n, m)
    return stats.cpu().numpy(), ks_pvalue_asymptotic(stats, n, m).cpu().numpy()


# ----------------------------------------------------------------------
# Wasserstein and PCA
# ----------------------------------------------------------------------
def wasserstein_columns(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column W1 for (n, k) vs (m, k) via the CDF integral."""
    us = torch.sort(u.double(), dim=0).values.T.contiguous()
    vs = torch.sort(v.double(), dim=0).values.T.contiguous()
    allv = torch.sort(torch.cat([us, vs], dim=1), dim=1).values
    deltas = torch.diff(allv, dim=1)
    grid = allv[:, :-1].contiguous()
    cdf_u = torch.searchsorted(us, grid, right=True).double() / us.shape[1]
    cdf_v = torch.searchsorted(vs, grid, right=True).double() / vs.shape[1]
    return ((cdf_u - cdf_v).abs() * deltas).sum(dim=1)


def pca_project(x_fit: torch.Tensor, x_other: torch.Tensor,
                n_components: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit PCA on ``x_fit`` (SVD of the centered matrix), project both.
    Component signs are arbitrary, which the Wasserstein distances on
    the projections do not see."""
    x_fit = x_fit.double()
    mean = x_fit.mean(dim=0, keepdim=True)
    xc = x_fit - mean
    _, _, vh = torch.linalg.svd(xc, full_matrices=False)
    comps = vh[:n_components]
    return xc @ comps.T, (x_other.double() - mean) @ comps.T


# ----------------------------------------------------------------------
# Chi-square on binary pairs
# ----------------------------------------------------------------------
def chi2_binary_pairs(a: torch.Tensor, pair_i: torch.Tensor,
                      pair_j: torch.Tensor) -> torch.Tensor:
    """2x2 chi-square with Yates correction (scipy chi2_contingency,
    correction=True) for each gene pair of a binary (samples, genes)
    matrix; degenerate tables give 0."""
    a = a.double()
    n = a.shape[0]
    counts11 = a.T @ a
    col = a.sum(dim=0)
    n11 = counts11[pair_i, pair_j]
    n10 = col[pair_i] - n11
    n01 = col[pair_j] - n11
    n00 = n - n11 - n10 - n01
    row1, row0 = n11 + n10, n01 + n00
    col1, col0 = n11 + n01, n10 + n00

    def cell(obs, exp):
        diff = torch.clamp((obs - exp).abs() - 0.5, min=0.0)
        return torch.where(exp > 0, diff * diff / torch.clamp(exp, min=_EPS),
                           torch.zeros_like(exp))

    chi2 = (cell(n11, row1 * col1 / n) + cell(n10, row1 * col0 / n)
            + cell(n01, row0 * col1 / n) + cell(n00, row0 * col0 / n))
    degenerate = (row1 == 0) | (row0 == 0) | (col1 == 0) | (col0 == 0)
    return torch.where(degenerate, torch.zeros_like(chi2), chi2)


# ----------------------------------------------------------------------
# Correlation
# ----------------------------------------------------------------------
def pearson_corr(x: torch.Tensor, y: torch.Tensor) -> float:
    x = x.double()
    y = y.double()
    xc = x - x.mean()
    yc = y - y.mean()
    denom = torch.sqrt((xc * xc).sum() * (yc * yc).sum())
    return float((xc * yc).sum() / torch.clamp(denom, min=_EPS))


def mean_pairwise_corr_within_groups(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean pairwise correlation among each mask column's member
    features: sum_{i,j in p} corr(i, j) = ||Z m_p||^2 / N with Z the
    batch-standardized matrix; groups with < 2 members give 0."""
    x = x.double()
    mask = mask.double()
    n = x.shape[0]
    z = (x - x.mean(dim=0, keepdim=True)) / (x.std(dim=0, unbiased=False, keepdim=True) + 1e-8)
    y = z @ mask
    corr_sum = (y * y).sum(dim=0) / n
    k = mask.sum(dim=0)
    return torch.where(k >= 2, (corr_sum - k) / torch.clamp(k * (k - 1.0), min=1.0),
                       torch.zeros_like(k))
