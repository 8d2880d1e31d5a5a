# Copy of osteosarcoma_diffusionmodel_tpu/serving/monitoring.py (numpy and the
# standard library only), kept here because that package's serving/__init__.py
# imports its server, which imports jax. Edit both together.
"""Production monitoring: PHI-safe request logging + condition drift.

The reference *documents* a monitoring stack but implements none of it
(reference docs/DEPLOYMENT.md:283-352 sketches a streamlit dashboard,
`detect_data_drift`, and a `SecureLogger` that whitelists fields so PHI
never reaches logs). This module implements the same capabilities with
the stdlib only:

- `SecureRequestLog` — rotating file log of generation requests where
  ONLY whitelisted scenario fields are ever written (allowlist, not
  blocklist: unknown keys are dropped and counted, never logged).
- `DriftMonitor` — streaming mean/variance of requested condition
  vectors (Welford) compared against the training cohort's condition
  distribution; the drift score is the mean absolute z-shift of the
  request means under the training stats, matching the doc's
  "drift > 0.1 -> consider retraining" framing.
- `render_dashboard` — the monitoring page as a dependency-free HTML
  document (the doc sketch used streamlit, which is not in this
  image); served by `server.py` at GET /dashboard.
"""

from __future__ import annotations

import json
import logging
import threading
from logging.handlers import RotatingFileHandler
from typing import Dict, Optional, Sequence

import numpy as np

# Scenario fields that are safe to log. Everything else (patient ids,
# names, freeform notes...) is dropped — allowlist semantics per the
# reference's SecureLogger sketch ("DO NOT log: patient_id, names").
SAFE_SCENARIO_FIELDS = (
    "survival_time",
    "event_occurred",
    "metastasis_at_diagnosis",
    "age_years",
)


class SecureRequestLog:
    """PHI-safe rotating request log (reference DEPLOYMENT.md:320-352)."""

    def __init__(
        self,
        path: str,
        max_bytes: int = 10 * 1024 * 1024,
        backup_count: int = 5,
    ):
        # A standalone Logger, NOT logging.getLogger(): registry
        # loggers are immortal, so a name keyed on id(self) can be
        # re-issued after GC and hand a new instance the previous
        # instance's handler (duplicate lines + a leaked descriptor
        # per instantiation).
        self.logger = logging.Logger("osdm.requests", logging.INFO)
        self.logger.propagate = False  # never leak into app logs
        self._handler = RotatingFileHandler(
            path, maxBytes=max_bytes, backupCount=backup_count
        )
        self._handler.setFormatter(
            logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        )
        self.logger.addHandler(self._handler)

    def close(self) -> None:
        self.logger.removeHandler(self._handler)
        self._handler.close()

    def log_generation(
        self, scenario: Optional[Dict], num_samples: int, sampler: str,
        seconds: float, cached: bool = False,
    ) -> Dict:
        """Log one generation request with PHI scrubbed.

        `cached` marks profile-cache hits so the audit trail stays
        complete when the server reuses a cohort instead of sampling.
        Returns the sanitized record (for tests/inspection)."""
        scenario = scenario or {}
        safe = {
            k: scenario[k]
            for k in SAFE_SCENARIO_FIELDS
            if k in scenario and isinstance(scenario[k], (int, float, bool))
        }
        dropped = len(scenario) - len(safe)
        record = {
            "num_samples": int(num_samples),
            "sampler": sampler,
            "seconds": round(float(seconds), 4),
            "conditions": safe,
            "fields_dropped": dropped,
        }
        if cached:
            record["cached"] = True
        self.logger.info("generation %s", json.dumps(record, sort_keys=True))
        return record


class DriftMonitor:
    """Streaming drift detection on requested condition vectors.

    Training stats come from the checkpoint (condition means/stds as
    the model saw them). Request-side means accumulate via Welford;
    `score()` is the mean |z| shift of the request means under the
    training distribution — 0 when requests look like training
    conditions, growing as they drift (reference DEPLOYMENT.md:300-304
    alerts above 0.1).
    """

    def __init__(
        self,
        train_mean: Sequence[float],
        train_std: Sequence[float],
        condition_names: Optional[Sequence[str]] = None,
    ):
        self.train_mean = np.asarray(train_mean, np.float64)
        std = np.asarray(train_std, np.float64)
        self.train_std = np.where(std > 1e-8, std, 1.0)
        self.names = list(
            condition_names
            or [f"c{i}" for i in range(len(self.train_mean))]
        )
        self.count = 0
        self._mean = np.zeros_like(self.train_mean)
        self._lock = threading.Lock()

    def update(self, conditions: np.ndarray) -> None:
        """Accumulate a (B, C) batch of requested condition rows
        (single vectorized mean merge, not per-row)."""
        conditions = np.asarray(conditions, np.float64)
        if conditions.ndim == 1:
            conditions = conditions[None, :]
        b = conditions.shape[0]
        batch_mean = conditions.mean(axis=0)
        with self._lock:
            new_count = self.count + b
            self._mean += (batch_mean - self._mean) * (b / new_count)
            self.count = new_count

    def per_feature(self) -> Dict[str, float]:
        if self.count == 0:
            return {n: 0.0 for n in self.names}
        z = np.abs(self._mean - self.train_mean) / self.train_std
        return {n: float(v) for n, v in zip(self.names, z)}

    def score(self) -> float:
        if self.count == 0:
            return 0.0
        return float(np.mean(list(self.per_feature().values())))


def render_dashboard(
    metrics: Dict[str, float],
    drift: Optional[DriftMonitor],
    model_info: Dict[str, object],
) -> str:
    """The monitoring dashboard as a self-contained HTML page."""
    rows = "".join(
        f"<tr><td>{k}</td><td>{v:.4g}</td></tr>"
        if isinstance(v, float) else f"<tr><td>{k}</td><td>{v}</td></tr>"
        for k, v in metrics.items()
    )
    drift_html = "<p>No drift monitor configured.</p>"
    if drift is not None:
        score = drift.score()
        alert = (
            '<p class="alert">&#9888; Data drift detected - consider '
            "retraining.</p>"
            if score > 0.1 and drift.count > 0
            else ""
        )
        per = "".join(
            f"<tr><td>{k}</td><td>{v:.4f}</td></tr>"
            for k, v in drift.per_feature().items()
        )
        drift_html = (
            f"<p>Drift score (mean |z| of requested-condition means vs "
            f"training): <b>{score:.4f}</b> over {drift.count} requested "
            f"patients</p>{alert}"
            f"<table><tr><th>condition</th><th>|z| shift</th></tr>{per}"
            f"</table>"
        )
    info = "".join(
        f"<tr><td>{k}</td><td>{v}</td></tr>" for k, v in model_info.items()
    )
    return f"""<!doctype html>
<html><head><title>Osteosarcoma Model Monitoring</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin: 1em 0; }}
td, th {{ border: 1px solid #ccc; padding: 4px 10px; text-align: left; }}
.alert {{ color: #b00; font-weight: bold; }}
</style></head><body>
<h1>Osteosarcoma Model Monitoring</h1>
<h2>Model</h2><table>{info}</table>
<h2>API usage</h2><table>{rows}</table>
<h2>Data drift</h2>{drift_html}
</body></html>"""
