# Copy of osteosarcoma_diffusionmodel_tpu/analysis/survival.py (pure numpy), kept
# here so the PyTorch port never imports the JAX package. Edit both together.
"""Survival statistics: Kaplan-Meier with Greenwood CIs, log-rank test.

The reference notebook renders per-scenario survival with lifelines
(reference notebooks/analysis.ipynb cells 13-14, requirements.txt:35):
KaplanMeierFitter gives the product-limit curve plus its 95% band, and
scenario separation is usually argued with a log-rank test. lifelines
is not in this image; this module implements the same estimators
natively so the analysis step has the statistics, not a plot-only
substitute:

- `kaplan_meier_full`: product-limit S(t) with Greenwood variance and
  the exp(-exp) / log-minus-log 95% interval — the same transform
  lifelines uses by default, so the band stays inside [0, 1].
- `median_survival`: first time S(t) drops to <= 0.5 (NaN while S stays
  above it, matching lifelines' convention).
- `logrank_test`: two-sample log-rank chi-square with a 1-dof p-value
  (chi2 sf via erfc — no scipy dependency).

Pure-host analysis code (runs once per report): numpy, not jax.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

Z95 = 1.959963984540054  # Phi^{-1}(0.975)


class KMCurve(NamedTuple):
    times: np.ndarray       # distinct event times
    survival: np.ndarray    # S(t) right after each event time
    ci_low: np.ndarray      # 95% lower band (log-minus-log)
    ci_high: np.ndarray     # 95% upper band
    at_risk: np.ndarray     # n_i at each event time
    events: np.ndarray      # d_i at each event time


def kaplan_meier_full(times, events) -> KMCurve:
    """Product-limit estimator with Greenwood 95% confidence bands.

    Greenwood: Var[S(t)] = S(t)^2 * sum_{t_i<=t} d_i / (n_i (n_i-d_i)).
    Band on the log(-log S) scale: exp(-exp(log(-log S) -+ z*se_cll))
    with se_cll^2 = Var[S]/ (S log S)^2 — lifelines' default, keeps the
    interval in [0, 1] even near S=1 or S=0.
    """
    times = np.asarray(times, np.float64)
    events = np.asarray(events).astype(bool)
    uniq = np.unique(times[events]) if events.any() else np.array([])
    n_pts = len(uniq)
    surv = np.empty(n_pts)
    lo = np.empty(n_pts)
    hi = np.empty(n_pts)
    n_at = np.empty(n_pts, np.int64)
    d_at = np.empty(n_pts, np.int64)
    s = 1.0
    gw = 0.0  # running Greenwood sum
    for ix, t in enumerate(uniq):
        n_i = int(np.sum(times >= t))
        d_i = int(np.sum((times == t) & events))
        s *= 1.0 - d_i / n_i
        if n_i > d_i:
            gw += d_i / (n_i * (n_i - d_i))
        surv[ix] = s
        n_at[ix] = n_i
        d_at[ix] = d_i
        if 0.0 < s < 1.0 and gw > 0.0:
            se_cll = math.sqrt(gw) / abs(math.log(s))
            cll = math.log(-math.log(s))
            lo[ix] = math.exp(-math.exp(cll + Z95 * se_cll))
            hi[ix] = math.exp(-math.exp(cll - Z95 * se_cll))
        else:
            # S hit 0 or stayed at 1: the transform degenerates; the
            # estimate itself is the bound.
            lo[ix] = s
            hi[ix] = s
    return KMCurve(uniq, surv, lo, hi, n_at, d_at)


def kaplan_meier(times, events) -> Tuple[np.ndarray, np.ndarray]:
    """(event_times, S(t)) — the original two-array API."""
    curve = kaplan_meier_full(times, events)
    return curve.times, curve.survival


def median_survival(times, events) -> float:
    """First event time where S(t) <= 0.5; NaN if never reached."""
    curve = kaplan_meier_full(times, events)
    below = curve.survival <= 0.5
    if not below.any():
        return float("nan")
    return float(curve.times[np.argmax(below)])


def _chi2_sf_1dof(x: float) -> float:
    """P(Chi2_1 > x) = erfc(sqrt(x/2))."""
    return math.erfc(math.sqrt(max(x, 0.0) / 2.0))


class LogRankResult(NamedTuple):
    statistic: float
    p_value: float
    observed_a: float
    expected_a: float


def logrank_test(times_a, events_a, times_b, events_b) -> LogRankResult:
    """Two-sample log-rank (Mantel-Cox) test.

    At each distinct event time t (pooled): with n_a, n_b at risk and
    d = d_a + d_b events, E[d_a] = d * n_a / n and
    V[d_a] = d * (n_a/n) * (n_b/n) * (n - d)/(n - 1).
    Statistic = (sum d_a - sum E)^2 / sum V ~ Chi2_1 under H0.
    """
    ta = np.asarray(times_a, np.float64)
    ea = np.asarray(events_a).astype(bool)
    tb = np.asarray(times_b, np.float64)
    eb = np.asarray(events_b).astype(bool)
    pooled = np.unique(np.concatenate([ta[ea], tb[eb]]))
    o_sum = 0.0
    e_sum = 0.0
    v_sum = 0.0
    for t in pooled:
        n_a = np.sum(ta >= t)
        n_b = np.sum(tb >= t)
        n = n_a + n_b
        d_a = np.sum((ta == t) & ea)
        d_b = np.sum((tb == t) & eb)
        d = d_a + d_b
        if n < 2 or d == 0:
            continue
        e = d * n_a / n
        v = d * (n_a / n) * (n_b / n) * (n - d) / (n - 1)
        o_sum += d_a
        e_sum += e
        v_sum += v
    if v_sum <= 0.0:
        return LogRankResult(0.0, 1.0, float(o_sum), float(e_sum))
    stat = (o_sum - e_sum) ** 2 / v_sum
    return LogRankResult(
        float(stat), _chi2_sf_1dof(stat), float(o_sum), float(e_sum)
    )
