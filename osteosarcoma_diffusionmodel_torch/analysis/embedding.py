# Copy of osteosarcoma_diffusionmodel_tpu/analysis/embedding.py (pure numpy), kept
# here so the PyTorch port never imports the JAX package. Edit both together.
"""Native UMAP: fuzzy simplicial set + cross-entropy layout.

The reference notebook embeds real+synthetic cohorts with umap-learn
(reference notebooks/analysis.ipynb cells 11-12, requirements.txt:31).
That wheel is not in this image, so earlier rounds substituted PCA —
same plot semantics but a linear map that cannot show the local
manifold structure the notebook cell is there to inspect. This module
implements the UMAP algorithm itself (McInnes et al. 2018) in numpy:

1. exact k-NN graph (chunked distance computation, memory-bounded)
2. per-point (rho, sigma) calibration so each point's fuzzy
   membership sums to log2(k) — the local-connectivity constraint
3. probabilistic t-conorm symmetrization  P + P^T - P o P^T
4. PCA initialization (deterministic; umap-learn's init="pca" option)
5. the (a, b) low-dimensional similarity curve fitted from
   (min_dist, spread) by Gauss-Newton, as umap-learn's find_ab_params
6. cross-entropy layout: attractive updates along graph edges sampled
   by membership strength, m random negative samples per edge, grad
   clipping at +/-4 and a linearly decaying learning rate — the same
   objective and schedule as umap-learn, applied in synchronous
   vectorized sweeps instead of asynchronous per-edge SGD (the only
   intended divergence; it trades Hogwild races for determinism).

Analysis-path code: runs once per report on host, so plain numpy is
the right tool — no compile latency, no device round-trips (SURVEY §5
puts the hot path in generation/validation, not figures).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# k-NN graph
# ----------------------------------------------------------------------
def _knn(X: np.ndarray, k: int, chunk: int = 512):
    """Exact Euclidean k-NN (indices, distances), self excluded.

    Chunked so the full n^2 distance matrix never materializes
    (n=20k would be 1.6 GB); per chunk it is (chunk, n).
    """
    n = X.shape[0]
    sq = np.einsum("ij,ij->i", X, X)
    idx = np.empty((n, k), np.int64)
    dist = np.empty((n, k), np.float64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (X[s:e] @ X.T)
        np.maximum(d2, 0.0, out=d2)
        rows = np.arange(e - s)
        d2[rows, np.arange(s, e)] = np.inf  # exclude self
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = d2[rows[:, None], part]
        order = np.argsort(pd, axis=1)
        idx[s:e] = part[rows[:, None], order]
        dist[s:e] = np.sqrt(pd[rows[:, None], order])
    return idx, dist


# ----------------------------------------------------------------------
# Fuzzy simplicial set
# ----------------------------------------------------------------------
def _smooth_knn_dist(dist: np.ndarray, k: int, n_iter: int = 64):
    """Per-point (rho, sigma): rho is the nearest-neighbor distance
    (local connectivity = 1); sigma solves
    sum_j exp(-max(d_ij - rho, 0)/sigma) = log2(k) by bisection,
    vectorized over all points."""
    rho = dist[:, 0].copy()
    target = np.log2(k)
    lo = np.full(dist.shape[0], 1e-12)
    hi = np.full(dist.shape[0], np.inf)
    sigma = np.ones(dist.shape[0])
    shifted = np.maximum(dist - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-shifted / sigma[:, None]).sum(axis=1)
        too_big = psum > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(too_big, lo, sigma)
        sigma = np.where(
            np.isinf(hi), sigma * 2.0, 0.5 * (lo + hi)
        )
    # Degenerate rows (all-identical points): keep sigma bounded.
    mean_d = dist.mean() or 1.0
    sigma = np.maximum(sigma, 1e-3 * mean_d)
    return rho, sigma


def fuzzy_simplicial_set(
    X: np.ndarray, n_neighbors: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrized fuzzy graph as COO (rows, cols, vals), vals in (0,1]."""
    idx, dist = _knn(X, n_neighbors)
    rho, sigma = _smooth_knn_dist(dist, n_neighbors)
    vals = np.exp(
        -np.maximum(dist - rho[:, None], 0.0) / sigma[:, None]
    ).ravel()
    rows = np.repeat(np.arange(X.shape[0], dtype=np.int64), n_neighbors)
    cols = idx.ravel()

    # t-conorm symmetrization on sparse entries: P + P^T - P o P^T.
    n = X.shape[0]
    code = rows * n + cols
    code_t = cols * n + rows
    all_codes, inv = np.unique(
        np.concatenate([code, code_t]), return_inverse=True
    )
    p = np.zeros(len(all_codes))
    pt = np.zeros(len(all_codes))
    np.add.at(p, inv[: len(code)], vals)
    np.add.at(pt, inv[len(code):], vals)
    sym = p + pt - p * pt
    out_rows = (all_codes // n).astype(np.int64)
    out_cols = (all_codes % n).astype(np.int64)
    keep = sym > 0.0
    return out_rows[keep], out_cols[keep], sym[keep]


# ----------------------------------------------------------------------
# (a, b) curve from (min_dist, spread)
# ----------------------------------------------------------------------
def find_ab_params(min_dist: float = 0.1, spread: float = 1.0):
    """Fit 1/(1 + a d^{2b}) to the target curve
    f(d) = 1 if d <= min_dist else exp(-(d - min_dist)/spread)
    by Gauss-Newton on 300 grid points (umap-learn uses
    scipy.optimize.curve_fit on the same target)."""
    d = np.linspace(0.0, 3.0 * spread, 300)
    f = np.where(d <= min_dist, 1.0, np.exp(-(d - min_dist) / spread))
    a, b = 1.0, 1.0
    for _ in range(200):
        db = np.maximum(d, 1e-12) ** (2 * b)
        denom = 1.0 + a * db
        model = 1.0 / denom
        r = f - model
        # d model / d a, d model / d b
        ja = -db / denom**2
        jb = -2.0 * a * db * np.log(np.maximum(d, 1e-12)) / denom**2
        J = np.stack([ja, jb], axis=1)
        g = J.T @ r
        H = J.T @ J + 1e-9 * np.eye(2)
        step = np.linalg.solve(H, g)
        a = float(max(a + step[0], 1e-3))
        b = float(max(b + step[1], 1e-3))
        if np.abs(step).max() < 1e-9:
            break
    return a, b


# ----------------------------------------------------------------------
# Layout
# ----------------------------------------------------------------------
def _pca_init(X: np.ndarray, scale: float = 10.0) -> np.ndarray:
    c = X - X.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    emb = c @ vt[:2].T
    span = np.abs(emb).max() or 1.0
    return (emb / span * scale).astype(np.float64)


def optimize_layout(
    init: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    a: float,
    b: float,
    n_epochs: int = 200,
    neg_samples: int = 5,
    lr: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Sampled cross-entropy layout (synchronous vectorized sweeps)."""
    y = init.copy()
    n = y.shape[0]
    rng = np.random.default_rng(seed)
    p_edge = vals / vals.max()
    for epoch in range(n_epochs):
        alpha = lr * (1.0 - epoch / n_epochs)
        live = rng.random(len(rows)) < p_edge
        i, j = rows[live], cols[live]
        dy = y[i] - y[j]
        r2 = np.einsum("ij,ij->i", dy, dy)
        # attractive: grad log Phi. Coincident points (exact-duplicate
        # rows, the very case the cohort plot must expose) make
        # r2**(b-1) blow up with b<1 — zero force there, as umap-learn
        # does with its dist>0 branch.
        r2s = np.where(r2 > 0.0, r2, 1.0)
        coef = np.where(
            r2 > 0.0,
            (-2.0 * a * b * r2s ** (b - 1.0)) / (1.0 + a * r2s**b),
            0.0,
        )
        g = np.clip(coef[:, None] * dy, -4.0, 4.0)
        upd = np.zeros_like(y)
        np.add.at(upd, i, g)
        np.add.at(upd, j, -g)
        # repulsive: m negatives per live edge, from the i side
        for _ in range(neg_samples):
            k = rng.integers(0, n, len(i))
            dyn = y[i] - y[k]
            rn2 = np.einsum("ij,ij->i", dyn, dyn)
            coef = (2.0 * b) / ((1e-3 + rn2) * (1.0 + a * rn2**b))
            coef[k == i] = 0.0
            g = np.clip(coef[:, None] * dyn, -4.0, 4.0)
            np.add.at(upd, i, g)
        # Clip the ACCUMULATED per-point update too (round-4 ADVICE):
        # per-edge clipping alone lets a node's displacement scale with
        # its degree (up to 4*degree per axis) because this synchronous
        # sweep applies one summed update where umap-learn moves the
        # point after every edge — hubs would oscillate on denser
        # graphs. +/-4 matches the per-edge bound, i.e. a point moves
        # at most as far per epoch as one saturated edge would move it.
        y += alpha * np.clip(upd, -4.0, 4.0)
    return y


def umap_embed(
    X: np.ndarray,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_epochs: int = 200,
    seed: int = 0,
    init: Optional[np.ndarray] = None,
) -> np.ndarray:
    """2-D UMAP embedding of X (n, d). Deterministic under `seed`."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    k = int(min(n_neighbors, n - 1))
    if n < 4 or k < 2:
        # Too small for a neighbor graph — PCA is the honest answer.
        return _pca_init(X, scale=1.0)
    rows, cols, vals = fuzzy_simplicial_set(X, k)
    a, b = find_ab_params(min_dist)
    y0 = _pca_init(X) if init is None else np.asarray(init, np.float64)
    logger.info(
        "UMAP: n=%d k=%d edges=%d a=%.3f b=%.3f epochs=%d",
        n, k, len(rows), a, b, n_epochs,
    )
    return optimize_layout(
        y0, rows, cols, vals, a, b, n_epochs=n_epochs, seed=seed
    )
