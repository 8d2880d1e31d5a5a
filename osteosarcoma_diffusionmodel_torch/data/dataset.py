"""Dataset assembly: aligned arrays, normalization, splits, mixup.

Counterpart of osteosarcoma_diffusionmodel_tpu/data/dataset.py without
JAX and pandas. :func:`prepare_arrays` (:210) reads the processed tables
with :func:`..utils.io.read_matrix_csv`, computes the pathway scores
from the expression table when ``pathway_scores.csv`` is missing (and
writes it), z-scores the pathway scores and the survival days with the
sample standard deviation (ddof 1, as pandas' ``.std()``), resolves the
condition columns and intersects the sample ids (:66-107).
:func:`train_val_split` (:280) is copied. :func:`mixup` (:290) takes its
lambda and permutation, or draws them.
"""

from __future__ import annotations

import csv
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, FrozenDims
from ..utils.io import read_matrix_csv, write_matrix_csv
from .pathways import pathway_scores_from_expression

logger = logging.getLogger(__name__)

# The numeric fallbacks when none of ``model.condition_on`` is present.
FALLBACK_CONDITIONS = ["survival_days_norm", "event_occurred", "age_years"]


@dataclass
class OsteosarcomaArrays:
    """Aligned, model-ready arrays plus the column metadata."""

    data: np.ndarray  # (N, mutation+expression+pathway) float32
    conditions: np.ndarray  # (N, C) float32, NaN -> 0
    survival: np.ndarray  # (N,) float32 raw survival_days
    sample_ids: List[str]
    mutation_genes: List[str]
    expression_genes: List[str]
    pathway_names: List[str]
    condition_names: List[str]
    survival_mean: float = 800.0
    survival_std: float = 500.0

    @property
    def n_samples(self) -> int:
        return self.data.shape[0]


def zscore_columns(values: np.ndarray) -> np.ndarray:
    """Column z-scores in float64 with the sample std: (x - mean) /
    (std(ddof=1) + 1e-8), as pandas computes ``(df - df.mean()) /
    (df.std() + 1e-8)``."""
    values = np.asarray(values, np.float64)
    return (values - values.mean(axis=0)) / (values.std(axis=0, ddof=1) + 1e-8)


def survival_stats(survival_days: np.ndarray) -> Tuple[float, float]:
    """(mean, sample std + 1e-8) of the survival days."""
    days = np.asarray(survival_days, np.float64)
    return float(days.mean()), float(days.std(ddof=1) + 1e-8)


def resolve_conditions(config: Config, columns: Sequence[str]) -> List[str]:
    """``model.condition_on`` mapped onto the clinical columns present,
    with the reference's fallback when none is."""
    names = config.resolve_condition_columns(list(columns))
    if not names:
        names = [f for f in FALLBACK_CONDITIONS if f in columns]
    return names


def _read_clinical(path: Path) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """The clinical table's ``submitter_id`` column and every column whose
    cells all parse as numbers (empty cells as NaN)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    ids = [r[header.index("submitter_id")] for r in rows]
    columns: Dict[str, np.ndarray] = {}
    for j, name in enumerate(header):
        if name == "submitter_id":
            continue
        try:
            columns[name] = np.array([float(r[j]) if r[j] != "" else np.nan for r in rows])
        except ValueError:
            continue  # a text column: never a condition
    return ids, columns


def prepare_arrays(config: Config) -> Tuple[OsteosarcomaArrays, FrozenDims]:
    """Model-ready arrays and frozen dims from ``data.processed_dir``."""
    processed = Path(config.data.processed_dir)
    mut = read_matrix_csv(processed / "mutation_matrix_aligned.csv")
    expr = read_matrix_csv(processed / "expression_matrix_aligned.csv")
    clin_ids, clinical = _read_clinical(processed / "clinical_aligned.csv")

    pathway_path = processed / "pathway_scores.csv"
    if pathway_path.exists():
        path = read_matrix_csv(pathway_path)
        path_values, path_names, path_ids = path.values, path.columns, path.index
    else:
        logger.info("Computing pathway scores (lazy)...")
        path_values, path_names = pathway_scores_from_expression(expr.values, expr.columns)
        path_ids = expr.index
        write_matrix_csv(pathway_path, path_values, path_names, index=path_ids, fmt="%r")
    path_values = zscore_columns(path_values)

    surv_mean, surv_std = survival_stats(clinical["survival_days"])
    clinical["survival_days_norm"] = (clinical["survival_days"] - surv_mean) / surv_std
    names = resolve_conditions(config, list(clinical))
    logger.info("Condition features: %s", names)

    # Sample ids in the mutation table's order, present in every table.
    others = [set(expr.index), set(path_ids), set(clin_ids)]
    common = [s for s in dict.fromkeys(mut.index) if all(s in o for o in others)]

    def rows(ids: Sequence[str]) -> np.ndarray:
        pos = {s: i for i, s in enumerate(ids)}
        return np.array([pos[s] for s in common], np.int64)

    data = np.concatenate([
        mut.values[rows(mut.index)].astype(np.float32),
        expr.values[rows(expr.index)].astype(np.float32),
        np.asarray(path_values)[rows(path_ids)].astype(np.float32),
    ], axis=1)
    clin_rows = rows(clin_ids)
    conditions = np.nan_to_num(
        np.stack([clinical[c][clin_rows].astype(np.float32) for c in names], axis=1)
        if names else np.zeros((len(common), 0), np.float32), nan=0.0)
    survival = np.nan_to_num(clinical["survival_days"][clin_rows], nan=0.0).astype(np.float32)
    logger.info("Dataset: %d samples, data dim %d, condition dim %d",
                len(common), data.shape[1], conditions.shape[1])
    arrays = OsteosarcomaArrays(
        data=data, conditions=conditions, survival=survival, sample_ids=common,
        mutation_genes=list(mut.columns), expression_genes=list(expr.columns),
        pathway_names=list(path_names), condition_names=names,
        survival_mean=surv_mean, survival_std=surv_std,
    )
    dims = config.freeze_dims(len(mut.columns), len(expr.columns), len(path_names),
                              condition_names=names, survival_mean=surv_mean,
                              survival_std=surv_std)
    return arrays, dims


def train_val_split(n_samples: int, val_split: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded random split (reference train.py:412-420)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    val_size = int(n_samples * val_split)
    return perm[val_size:], perm[:val_size]


def mixup(data: torch.Tensor, conditions: torch.Tensor, alpha: float = 0.0,
          lam: Optional[float] = None, perm: Optional[torch.Tensor] = None,
          rng: Optional[np.random.Generator] = None,
          generator: Optional[torch.Generator] = None,
          survival: Optional[torch.Tensor] = None) -> tuple:
    """Mixup with one lambda for the whole batch: lam * x + (1 - lam) *
    x[perm]. ``lam`` ~ Beta(alpha, alpha) is drawn from the numpy ``rng``
    and ``perm`` from ``generator`` (on the data's device) unless given.
    lambda and 1 - lambda are float32 values passed as scalars, so the
    step reads nothing from and copies nothing to the device for them.
    Returns (data, conditions), and the ``survival`` (B,) mixed with the
    same lambda and permutation third where it is given (the cVAE's
    target, JAX :290-308)."""
    if lam is None:
        lam = rng.beta(alpha, alpha)
    if perm is None:
        perm = torch.randperm(data.shape[0], generator=generator, device=data.device)
    lam = np.float32(lam)
    keep = float(np.float32(1.0) - lam)
    lam = float(lam)
    mixed = (lam * data + keep * data[perm], lam * conditions + keep * conditions[perm])
    if survival is None:
        return mixed
    return mixed + (lam * survival + keep * survival[perm],)
