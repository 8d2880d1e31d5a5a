"""Plain reference of the cohort's preparation and of a request's inputs:
the model-ready training matrix, the survival normalization and the
scenario conditions, from the raw cohort arrays and the configuration's
dict."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULTS = {"event_occurred": 0.0, "age": 15.0, "metastasis_at_diagnosis": 0.0}


def training_matrix(mutations: np.ndarray, expression: np.ndarray,
                    pathways: np.ndarray) -> np.ndarray:
    """[mutations | expression | pathway z-scores (sample std + 1e-8)]."""
    path = np.asarray(pathways, np.float64)
    path = (path - path.mean(axis=0)) / (path.std(axis=0, ddof=1) + 1e-8)
    return np.concatenate([mutations, expression, path.astype(np.float32)],
                          axis=1).astype(np.float32)


def survival_norm(days: np.ndarray) -> Tuple[float, float]:
    days = np.asarray(days, np.float64)
    return float(days.mean()), float(days.std(ddof=1) + 1e-8)


def scenario_conditions(scenario: Dict[str, float], condition_on: Sequence[str], rows: int,
                        survival: Tuple[float, float]) -> np.ndarray:
    """(rows, C) float32: survival z-scored with the training cohort's
    statistics, the other conditions as given (defaults where absent)."""
    mean, std = survival
    values: List[float] = []
    for name in condition_on:
        if name == "survival_time":
            values.append((scenario.get("survival_time", 800) - mean) / std)
        else:
            values.append(float(scenario.get(name, DEFAULTS.get(name, 0.0))))
    return np.tile(np.asarray(values, np.float32), (rows, 1))
