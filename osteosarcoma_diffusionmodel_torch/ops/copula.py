# Copy of osteosarcoma_diffusionmodel_tpu/ops/copula.py (pure numpy), kept
# here so the PyTorch port never imports the JAX package. Edit both together.
"""Gaussian-copula modeling of the binary mutation block.

Closes the round-1 joint-structure gap: continuous diffusion +
per-gene thresholding reproduces mutation *marginals* but not the
pairwise co-occurrence structure (chi-square pattern correlation ~0.1
vs the reference's published 0.87 example, reference README.md:326;
validator counterpart utils/validation.py:89-121). The fix imposes the
real cohort's latent-Gaussian (tetrachoric) correlation on the
generated mutation block:

1. `fit_binary_copula` estimates, per gene pair, the correlation rho of
   a standard bivariate normal whose orthant probability above the
   marginal thresholds equals the empirical P(both mutated) — the
   tetrachoric correlation — via Plackett's identity
   dPhi2(a,b;r)/dr = phi2(a,b;r), vectorized over all pairs on a fixed
   r-grid (no scipy bivariate CDF, no per-pair loops).
2. `correlation_transplant` converts the model's raw mutation scores to
   per-gene normal scores (rank-based), whitens their empirical
   correlation, recolors with the target Cholesky factor, and
   thresholds at the exact per-gene marginal frequency. The transplant
   is driven by the model output (not fresh noise), so each patient's
   mutation configuration stays coupled to the expression/pathway
   profile generated alongside it.

All numpy: this runs once per generated cohort on (N, ~62) blocks —
host-side microseconds next to the on-device reverse diffusion.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_SQRT2 = np.sqrt(2.0)


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    """Standard normal inverse CDF (Acklam's rational approximation,
    |rel err| < 1.15e-9 — no scipy dependency on this path)."""
    p = np.asarray(p, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    p = np.clip(p, 1e-12, 1 - 1e-12)
    out = np.empty_like(p)

    lo = p < plow
    q = np.sqrt(-2 * np.log(p[lo]))
    out[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
               + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)

    mid = (~lo) & (p <= phigh)
    q = p[mid] - 0.5
    r = q * q
    out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
                 + a[5]) * q
                / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r
                   + 1))

    hi = p > phigh
    q = np.sqrt(-2 * np.log(1 - p[hi]))
    out[hi] = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                 + c[5])
                / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    return out


def _norm_cdf(x: np.ndarray) -> np.ndarray:
    from math import erf

    return 0.5 * (1.0 + np.vectorize(erf)(np.asarray(x, np.float64) / _SQRT2))


def _bvn_density(a: np.ndarray, b: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Standard bivariate normal density at (a, b) with correlation r.

    a, b broadcast against r; used as the integrand in Plackett's
    identity to build the orthant probability as a function of rho.
    """
    om = 1.0 - r * r
    return np.exp(-(a * a - 2.0 * r * a * b + b * b) / (2.0 * om)) / (
        2.0 * np.pi * np.sqrt(om)
    )


def tetrachoric_pairs(
    p1: np.ndarray,
    p2: np.ndarray,
    p11: np.ndarray,
    grid_size: int = 257,
    r_max: float = 0.999,
) -> np.ndarray:
    """Tetrachoric correlation for each pair.

    Given marginal mutation frequencies ``p1``, ``p2`` and joint
    frequency ``p11`` (all shape (n_pairs,)), return rho such that
    P(Z1 > a, Z2 > b; rho) = p11 with a = ppf(1-p1), b = ppf(1-p2).

    Uses P(rho) = p1*p2 + int_0^rho phi2(a, b; r) dr (Plackett), tabled
    on a fixed symmetric r-grid with cumulative trapezoid, then inverts
    per pair by monotone interpolation.
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    p11 = np.asarray(p11, np.float64)
    a = _norm_ppf(1.0 - p1)[:, None]
    b = _norm_ppf(1.0 - p2)[:, None]

    r = np.linspace(-r_max, r_max, grid_size)[None, :]  # (1, G)
    dens = _bvn_density(a, b, r)  # (P, G)

    # Cumulative integral from r=0 outward (grid symmetric around 0).
    mid = grid_size // 2
    dr = r[0, 1] - r[0, 0]
    trap = 0.5 * (dens[:, 1:] + dens[:, :-1]) * dr  # (P, G-1)
    cum = np.zeros_like(dens)
    cum[:, mid + 1:] = np.cumsum(trap[:, mid:], axis=1)
    cum[:, :mid] = -np.cumsum(trap[:, :mid][:, ::-1], axis=1)[:, ::-1]
    orthant = p1[:, None] * p2[:, None] + cum  # monotone in r

    # Invert: clamp p11 to the attainable range then interpolate r(p11).
    lo = orthant[:, 0]
    hi = orthant[:, -1]
    target = np.clip(p11, lo + 1e-12, hi - 1e-12)
    idx = np.sum(orthant <= target[:, None], axis=1) - 1
    idx = np.clip(idx, 0, grid_size - 2)
    rows = np.arange(len(target))
    o0 = orthant[rows, idx]
    o1 = orthant[rows, idx + 1]
    frac = np.where(o1 > o0, (target - o0) / np.maximum(o1 - o0, 1e-30), 0.0)
    rho = r[0, idx] + frac * dr

    # Degenerate marginals (freq 0 or 1) carry no pairwise information.
    degenerate = (
        (p1 <= 1e-9) | (p1 >= 1 - 1e-9) | (p2 <= 1e-9) | (p2 >= 1 - 1e-9)
    )
    return np.where(degenerate, 0.0, np.clip(rho, -r_max, r_max))


def nearest_corr_psd(corr: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Project a symmetric matrix to the nearest PSD correlation matrix
    (eigenvalue clipping + unit-diagonal renormalization)."""
    corr = 0.5 * (corr + corr.T)
    w, v = np.linalg.eigh(corr)
    w = np.maximum(w, eps)
    fixed = (v * w) @ v.T
    d = np.sqrt(np.clip(np.diag(fixed), eps, None))
    fixed = fixed / np.outer(d, d)
    np.fill_diagonal(fixed, 1.0)
    return fixed


def fit_binary_copula(binary: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fit a latent-Gaussian copula to a binary (n, D) matrix.

    Returns (freq, corr): per-column frequencies and the PSD tetrachoric
    correlation matrix of the latent Gaussian.
    """
    binary = np.asarray(binary, np.float64)
    n, d = binary.shape
    freq = binary.mean(axis=0)

    iu, ju = np.triu_indices(d, k=1)
    joint = (binary.T @ binary) / n  # (D, D) P(both = 1)
    rho_flat = tetrachoric_pairs(freq[iu], freq[ju], joint[iu, ju])

    corr = np.eye(d)
    corr[iu, ju] = rho_flat
    corr[ju, iu] = rho_flat
    return freq, nearest_corr_psd(corr)


def _normal_scores(
    x: np.ndarray, tie_rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Per-column rank -> standard-normal scores (van der Waerden).

    ``tie_rng``: randomizes the order WITHIN exact-value ties. Model
    outputs read back from bf16 kernels carry ~95% tied values per
    column at 10k cohorts; stable argsort would order every tie block
    by row index — the same arbitrary order in every column — which is
    a deterministic shared signal the downstream whitening then
    mistakes for cross-feature correlation."""
    n = x.shape[0]
    if tie_rng is not None:
        # Random secondary sort key: decides order among exact ties
        # only (primary float comparison wins everywhere else).
        sec = tie_rng.random(x.shape)
        order = np.lexsort((sec, x), axis=0)
    else:
        order = np.argsort(x, axis=0, kind="stable")
    ranks = np.empty_like(order)
    rows = np.arange(n)[:, None]
    np.put_along_axis(ranks, order, np.broadcast_to(rows, order.shape), axis=0)
    return _norm_ppf((ranks + 0.5) / n)


def correlation_transplant(
    scores: np.ndarray,
    target_corr: np.ndarray,
    target_freq: np.ndarray,
    ridge: float = 1e-3,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Impose (target_corr, target_freq) on raw mutation scores.

    scores: (N, D) raw continuous model outputs for the mutation block.
    Returns a binary (N, D) matrix whose per-gene mutation counts match
    ``target_freq`` exactly and whose latent pairwise structure follows
    ``target_corr``.

    Steps: rank->normal scores, whiten by the empirical correlation
    (ridge-regularized), recolor with chol(target_corr), threshold each
    column at its (1 - freq) empirical quantile.
    """
    scores = np.asarray(scores, np.float64)
    n, d = scores.shape
    u = _normal_scores(scores, tie_rng=rng)

    if n > d + 1:
        emp = np.corrcoef(u, rowvar=False)
        emp = nearest_corr_psd(emp * (1 - ridge) + np.eye(d) * ridge)
        l_emp = np.linalg.cholesky(emp)
        # Solve L_emp @ w.T = u.T  ->  w = u @ inv(L_emp).T
        w = np.linalg.solve(l_emp, u.T).T
    else:
        # Too few samples to whiten reliably; treat scores as already
        # independent and only recolor.
        w = u
    # Renormalize columns (whitening leaves unit variance only in
    # expectation).
    w = w / np.maximum(w.std(axis=0, keepdims=True), 1e-9)

    l_target = np.linalg.cholesky(nearest_corr_psd(target_corr))
    z = w @ l_target.T

    # Exact marginal counts: threshold at the per-column quantile.
    k = np.clip(np.round(np.asarray(target_freq) * n).astype(int), 0, n)
    out = np.zeros((n, d), np.float32)
    for g in range(d):
        if k[g] <= 0:
            continue
        if k[g] >= n:
            out[:, g] = 1.0
            continue
        thresh = np.partition(z[:, g], n - k[g])[n - k[g]]
        out[:, g] = (z[:, g] >= thresh).astype(np.float32)
    return out


def copula_calibrate_mutations(
    raw_scores: np.ndarray, real_binary: np.ndarray
) -> np.ndarray:
    """One-call wrapper: fit the copula on the real cohort and transplant
    it onto the generated mutation scores."""
    freq, corr = fit_binary_copula(real_binary)
    return correlation_transplant(raw_scores, corr, freq)


# ----------------------------------------------------------------------
# Continuous-block Gaussian copula (round-2 "copula_full" mode)
# ----------------------------------------------------------------------
def fit_continuous_copula_chol(
    real_cont: np.ndarray, shrink: float = 0.05
) -> np.ndarray:
    """Cholesky factor of the real continuous block's latent-Gaussian
    correlation.

    The normal-scores (van der Waerden) correlation is a Gram matrix —
    PSD by construction even at n << D (n=100, D~5080) — so a small
    identity shrink makes it PD with no eigendecomposition:
        C = (1-shrink) * U^T U / n + shrink * I
    Returns chol(C) as float32, (D, D).
    """
    u = _normal_scores(np.asarray(real_cont, np.float32)).astype(np.float32)
    u /= np.maximum(u.std(axis=0, keepdims=True), 1e-9)
    n, d = u.shape
    gram = (u.T @ u) / n
    c = (1.0 - shrink) * gram + shrink * np.eye(d, dtype=np.float32)
    return np.linalg.cholesky(c.astype(np.float64)).astype(np.float32)


def _whiten_exact(u: np.ndarray, floor: float = 1e-6) -> np.ndarray:
    """Exact (eigen) whitening of unit-variance scores.

    Round-3 measured fix: a mean-seeking denoiser emits STRONGLY
    correlated raw scores (within-pathway coherence 0.957 on the n=400
    probe). Ridge-regularized Cholesky whitening (the round-2 path)
    under-corrects by ~the ridge — leftover coherence up to 0.20 per
    pathway — and the recolor then ADDS the target on top, inflating
    synthetic coherence (0.48 vs real 0.38) and cratering the
    coherence-pattern correlation to 0.48 (DEMO_N400). Eigen-whitening
    removes the model structure exactly; directions at the eigenvalue
    floor carry no signal and become fresh-noise-equivalent.
    """
    n, d = u.shape
    if n < d:
        # Dual-space (kernel-trick) whitening: the D x D Gram shares
        # its nonzero spectrum with the N x N matrix u u^T / n, so a
        # small-cohort request (serving batches of 64 against D~5k)
        # pays an N^3 eigh instead of a D^3 one. Null-space components
        # of u are zero, so only the span needs whitening.
        k_mat = (u.astype(np.float64) @ u.astype(np.float64).T) / n
        eigval, q_vec = np.linalg.eigh(k_mat)
        inv_sqrt = np.where(
            eigval > floor, 1.0 / np.sqrt(np.maximum(eigval, floor)), 0.0
        )
        # W = Q Lam^{-1/2} Q^T U: then W^T W / n = V V^T (identity on
        # the span of U — verified in tests against the primal path).
        w = ((q_vec * inv_sqrt) @ (q_vec.T @ u.astype(np.float64))).astype(
            np.float32
        )
    else:
        gram = (u.astype(np.float64).T @ u.astype(np.float64)) / n
        eigval, eigvec = np.linalg.eigh(gram)
        # Discard (zero) sub-floor directions exactly like the dual
        # branch above: clamping instead would amplify their float
        # noise by 1/sqrt(floor) ~ 1000x into w, so the same cohort
        # got opposite treatment depending on which branch it hit.
        inv_sqrt = np.where(
            eigval > floor, 1.0 / np.sqrt(np.maximum(eigval, floor)), 0.0
        )
        w = (u @ (eigvec * inv_sqrt).astype(np.float32)) @ eigvec.T.astype(
            np.float32
        )
    return w / np.maximum(w.std(axis=0, keepdims=True), 1e-9)


def gaussian_transplant(
    scores: np.ndarray,
    target_chol: np.ndarray,
    ridge: float = 0.05,
    tie_rng: Optional[np.random.Generator] = None,
    whiten: str = "exact",
) -> np.ndarray:
    """Impose a target latent correlation on continuous scores.

    Rank -> normal scores, whiten the cohort's own normal-scores
    correlation away (``whiten``: "exact" eigen-whitening by default —
    see _whiten_exact for the measured round-2 failure of "ridge"),
    recolor with the target Cholesky. Returns the recolored Gaussian z,
    (N, D); callers quantile-map its per-column ranks onto the real
    marginals.
    """
    scores = np.asarray(scores, np.float32)
    n, d = scores.shape
    u = _normal_scores(scores, tie_rng=tie_rng).astype(np.float32)
    u /= np.maximum(u.std(axis=0, keepdims=True), 1e-9)

    if whiten == "exact":
        w = _whiten_exact(u)
    else:
        from scipy.linalg import solve_triangular

        # The ridge keeps the Gram PD even when n < d (per-scenario
        # cohorts can be smaller than the feature dim).
        gram = (u.T @ u) / n
        c = (1.0 - ridge) * gram + ridge * np.eye(d, dtype=np.float32)
        l_emp = np.linalg.cholesky(c.astype(np.float64)).astype(np.float32)
        w = solve_triangular(l_emp, u.T, lower=True).T.astype(np.float32)
        w /= np.maximum(w.std(axis=0, keepdims=True), 1e-9)
    return (w @ target_chol.T).astype(np.float32)


# ----------------------------------------------------------------------
# Joint full-vector copula with Pearson-matched continuous block
# (round-3 "copula_joint" mode)
# ----------------------------------------------------------------------
_SQRT2PI = np.sqrt(2.0 * np.pi)


def hermite_quantile_coeffs(
    sorted_real: np.ndarray, n_terms: int = 10, n_quad: int = 80
) -> np.ndarray:
    """Hermite expansion of each column's empirical quantile transform.

    ``sorted_real``: (n, D) per-column sorted real values (the quantile
    function on a uniform grid). Returns B of shape (n_terms, D) with
    B[k-1] = E[f(Z) He_k(Z)] / sqrt(k!) for k = 1..n_terms, so for a
    standard bivariate normal (Z1, Z2) with correlation rho:

        Cov(f_i(Z1), f_j(Z2)) = sum_{k>=1} B[k-1,i] B[k-1,j] rho^k

    This is the classical Hermite/NORTA identity that lets the latent
    correlation be chosen to reproduce a target *Pearson* covariance
    after quantile mapping (the rank-correlation transplant matches
    Spearman structure instead, which measurably inflates Pearson
    coherence on heavy-tailed marginals — round-2 DEMO_N400).
    """
    n, d = sorted_real.shape
    z, w = np.polynomial.hermite_e.hermegauss(n_quad)  # weight e^{-x^2/2}
    w = w / _SQRT2PI  # E[g(Z)] = sum_q w_q g(z_q)
    p = _norm_cdf(z)
    pos = np.clip(p * n - 0.5, 0.0, n - 1.0)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    frac = (pos - lo)[:, None]
    fz = sorted_real[lo] * (1 - frac) + sorted_real[hi] * frac  # (Q, D)

    out = np.zeros((n_terms, d))
    he_prev = np.ones_like(z)
    he = z.copy()
    fact = 1.0
    for k in range(1, n_terms + 1):
        fact *= k
        out[k - 1] = (w[:, None] * fz * he[:, None]).sum(axis=0) / np.sqrt(fact)
        he, he_prev = z * he - k * he_prev, he
    return out


def pearson_to_latent(
    target_cov: np.ndarray, coeffs: np.ndarray, n_iter: int = 8
) -> np.ndarray:
    """Invert sum_k b_ki b_kj rho^k = target_cov elementwise for rho.

    ``target_cov``: (D, D) real Pearson covariance to reproduce after
    quantile mapping. ``coeffs``: (K, D) from hermite_quantile_coeffs.
    Newton iteration vectorized over the full matrix; targets outside
    the attainable range (the Gaussian copula cannot exceed the
    comonotone/countermonotone covariance) are clamped to it. Returns
    a unit-diagonal matrix with entries in (-1, 1) — NOT guaranteed
    PSD (callers shrink toward I until Cholesky succeeds).
    """
    K, d = coeffs.shape
    Bf = coeffs.astype(np.float64)
    sd = np.sqrt(np.maximum((Bf ** 2).sum(axis=0), 1e-12))
    outers = [np.outer(Bf[k], Bf[k]) for k in range(K)]
    cmax = np.add.reduce(outers)
    cmin = np.add.reduce([o * (-1.0) ** (k + 1) for k, o in enumerate(outers)])
    lo = np.minimum(cmin, cmax)
    hi = np.maximum(cmin, cmax)
    target = np.clip(target_cov, lo + 1e-12, hi - 1e-12)

    rho = np.clip(target / np.outer(sd, sd), -0.99, 0.99)
    for _ in range(n_iter):
        s_val = np.zeros_like(rho)
        ds = np.zeros_like(rho)
        rp = np.ones_like(rho)
        for k in range(K):
            ds += (k + 1) * outers[k] * rp
            rp = rp * rho
            s_val += outers[k] * rp
        step = (s_val - target) / np.where(np.abs(ds) > 1e-12, ds, np.inf)
        rho = np.clip(rho - step, -0.999, 0.999)
    np.fill_diagonal(rho, 1.0)
    return rho


def polyserial_latent(
    binary: np.ndarray, cont_scores: np.ndarray, soft_threshold: float = 0.0
) -> np.ndarray:
    """Latent correlation between binary and continuous columns.

    For Y = 1{Z1 > a} and U the (unit-variance normal-scores proxy of)
    Z2, E[Y U] = rho * phi(a) exactly under the latent-Gaussian model,
    so rho = Cov(Y, U) / phi(a) — one matmul for all (M, Dc) pairs.

    ``soft_threshold``: shrink each estimate toward zero by that many
    standard errors (SE ~= sqrt(p(1-p))/(phi(a) sqrt(n))). At n << Dc
    the raw (M, Dc) block is a dense noise matrix whose operator norm
    ~ SE*(sqrt(M)+sqrt(Dc)) wrecks joint PSD-ness; soft-thresholding
    keeps the real couplings (driver->pathway rules sit at |rho|~0.5)
    and zeroes the sea of noise.
    """
    binary = np.asarray(binary, np.float64)
    n = binary.shape[0]
    p = binary.mean(axis=0)
    a = _norm_ppf(1.0 - np.clip(p, 1e-6, 1 - 1e-6))
    phi_a = np.exp(-0.5 * a * a) / _SQRT2PI
    centered = cont_scores - cont_scores.mean(axis=0)
    cov = (binary - p).T @ centered / n
    rho = cov / np.maximum(phi_a[:, None], 1e-9)
    if soft_threshold > 0:
        se = (
            np.sqrt(np.clip(p * (1.0 - p), 1e-12, None))
            / np.maximum(phi_a, 1e-9)
            / np.sqrt(n)
        )[:, None]
        rho = np.sign(rho) * np.maximum(
            np.abs(rho) - soft_threshold * se, 0.0
        )
    rho[(p <= 1e-9) | (p >= 1 - 1e-9)] = 0.0
    return np.clip(rho, -0.99, 0.99)


def fit_joint_copula(
    real_mut: np.ndarray,
    real_cont: np.ndarray,
    shrink: float = 0.02,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Joint latent-Gaussian correlation over [mutations | continuous].

    The target is the GRAM of per-column scores — standardized binary
    values for the mutation block, van der Waerden normal scores for
    the continuous block — which makes it PSD by construction even at
    n << D. Block-wise that is: phi coefficients (binary x binary),
    attenuated polyserial (binary x continuous, right sign/pattern,
    magnitude scaled by phi(a)/sqrt(p(1-p))), and rank correlation
    (continuous x continuous). Assembling "exact" per-block estimators
    instead (tetrachoric / full polyserial) measurably fails here: at
    n=400, D=5142 their block-consistency violations push lambda_min
    so low that the shrink needed to recover PD-ness (0.64) destroys
    the structure being transplanted (round-3 replay experiments).

    One joint factor preserves cross-block structure: separate
    per-block transplants garble mutation<->pathway coupling (the
    round-2 mutation_expression_violation_rate=0.5 regression at
    n=400). The attenuated mutation block is then sharpened by a
    SECOND, 62-dim exact-tetrachoric transplant driven by the joint
    z's mutation columns (joint_transplant with ``tetra``): measured
    on the real n=400 probe this keeps the cross-block couplings
    (TP53 -0.43, MYC +0.47) while lifting co-occurrence pattern
    correlation to 0.986.

    Returns (freq, L, tetra, shrink_used) with L = chol((1-s) G + s I)
    for the smallest doubling s >= ``shrink`` that is PD, and
    ``tetra`` the PSD tetrachoric correlation for the second stage.
    """
    real_mut = np.asarray(real_mut, np.float64)
    real_cont = np.asarray(real_cont, np.float64)
    n, m = real_mut.shape
    freq, tetra = fit_binary_copula(real_mut)

    s_mut = (real_mut - freq) / np.sqrt(
        np.clip(freq * (1.0 - freq), 1e-9, None)
    )
    u_cont = _normal_scores(real_cont)
    u_cont /= np.maximum(u_cont.std(axis=0, keepdims=True), 1e-9)
    scores = np.concatenate([s_mut, u_cont], axis=1)
    gram = (scores.T @ scores) / n
    np.fill_diagonal(gram, 1.0)

    d = gram.shape[0]
    s = shrink
    eye = np.eye(d)
    while s < 1.0:
        try:
            chol = np.linalg.cholesky((1.0 - s) * gram + s * eye)
            return freq, chol.astype(np.float32), tetra, s
        except np.linalg.LinAlgError:
            s *= 2.0
    raise np.linalg.LinAlgError("joint copula target could not be made PD")


def joint_transplant(
    raw: np.ndarray,
    chol: np.ndarray,
    freq: np.ndarray,
    m: int,
    ridge: float = 0.05,
    tie_rng: Optional[np.random.Generator] = None,
    whiten: str = "exact",
    tetra: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One whiten/recolor over the full [mutation | continuous] vector.

    ``raw``: (N, D) raw model outputs. Returns (bits (N, m), z_cont
    (N, D-m)): mutation bits thresholded at exact per-gene counts and
    the recolored continuous Gaussian, whose per-column ranks drive the
    downstream quantile mapping. Driven by the model's own scores (not
    fresh noise), so each patient's bits stay coupled to the
    expression/pathway profile generated alongside them.

    ``tetra``: optional exact tetrachoric correlation for the second
    stage (fit_joint_copula returns it): the joint Gram target's
    mutation block carries phi-attenuated correlations, so the
    mutation z is re-transplanted through a 62-dim exact-tetrachoric
    whiten/recolor before thresholding. Measured on the real n=400
    probe: co-occurrence pattern correlation 0.926 -> 0.986 with the
    cross-block couplings intact.
    """
    raw = np.asarray(raw, np.float32)
    n, d = raw.shape
    u = _normal_scores(raw, tie_rng=tie_rng).astype(np.float32)
    u /= np.maximum(u.std(axis=0, keepdims=True), 1e-9)
    if whiten == "exact":
        w = _whiten_exact(u)
    else:
        from scipy.linalg import solve_triangular

        gram = (u.T @ u) / n
        c = (1.0 - ridge) * gram + ridge * np.eye(d, dtype=np.float32)
        l_emp = np.linalg.cholesky(c.astype(np.float64)).astype(np.float32)
        w = solve_triangular(l_emp, u.T, lower=True).T.astype(np.float32)
        w /= np.maximum(w.std(axis=0, keepdims=True), 1e-9)
    z = (w @ chol.T).astype(np.float32)

    zm, zc = z[:, :m], z[:, m:]
    if tetra is not None and n > m + 1:
        bits = correlation_transplant(zm, tetra, freq, rng=tie_rng)
        return bits, zc
    k = np.clip(np.round(np.asarray(freq) * n).astype(int), 0, n)
    bits = np.zeros((n, m), np.float32)
    for g in range(m):
        if k[g] <= 0:
            continue
        if k[g] >= n:
            bits[:, g] = 1.0
            continue
        thresh = np.partition(zm[:, g], n - k[g])[n - k[g]]
        bits[:, g] = (zm[:, g] >= thresh).astype(np.float32)
    return bits, zc
