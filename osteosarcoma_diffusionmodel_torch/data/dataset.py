"""Dataset assembly: aligned arrays, normalization, splits, mixup,
cross-cancer pretraining cohorts.

Counterpart of osteosarcoma_diffusionmodel_tpu/data/dataset.py without
JAX and pandas. :func:`prepare_arrays` (:210) reads the processed tables
with :func:`..utils.io.read_matrix_csv`, computes the pathway scores
from the expression table when ``pathway_scores.csv`` is missing (and
writes it), z-scores the pathway scores and the survival days with the
sample standard deviation (ddof 1, as pandas' ``.std()``), resolves the
condition columns, and :func:`build_arrays` (:66-107) intersects the
sample ids in the mutation table's order and assembles the flat patient
vector. :func:`load_pretrain_arrays` (:110-209) aligns each pretraining
cohort onto the primary cohort's features (unknown columns dropped,
missing ones zero-filled, a missing condition column 0.0), z-scores its
pathway scores and survival within the cohort, and pools the cohorts,
the pooled survival statistics with numpy's ddof 0 as there.
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
from ..utils.io import Matrix, read_matrix_csv, write_matrix_csv
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


def reindex_columns(table: Matrix, names: Sequence[str]) -> Matrix:
    """``table`` with the columns ``names``, in that order: a column it
    lacks is 0.0, a column it has that ``names`` lacks is dropped (pandas'
    ``reindex(columns=names, fill_value=0.0)``)."""
    pos = {c: j for j, c in enumerate(table.columns)}
    values = np.zeros((table.values.shape[0], len(names)), np.float64)
    for k, name in enumerate(names):
        if name in pos:
            values[:, k] = table.values[:, pos[name]]
    return Matrix(values, list(names), table.index)


def build_arrays(mutation: Matrix, expression: Matrix, pathways: Matrix,
                 clinical_ids: Sequence[str], clinical: Dict[str, np.ndarray],
                 condition_features: Sequence[str], survival_mean: float = 800.0,
                 survival_std: float = 500.0) -> OsteosarcomaArrays:
    """Intersect the sample ids (in the mutation table's order, each once)
    and assemble the flat patient vectors, the NaN-safe conditions and the
    survival days (NaN as 0)."""
    others = [set(expression.index), set(pathways.index), set(clinical_ids)]
    common = [s for s in dict.fromkeys(mutation.index) if all(s in o for o in others)]

    def rows(ids: Sequence[str]) -> np.ndarray:
        pos = {s: i for i, s in enumerate(ids)}
        return np.array([pos[s] for s in common], np.int64)

    data = np.concatenate([
        mutation.values[rows(mutation.index)].astype(np.float32),
        expression.values[rows(expression.index)].astype(np.float32),
        np.asarray(pathways.values)[rows(pathways.index)].astype(np.float32),
    ], axis=1)
    clin_rows = rows(clinical_ids)
    conditions = np.nan_to_num(
        np.stack([clinical[c][clin_rows].astype(np.float32) for c in condition_features], axis=1)
        if condition_features else np.zeros((len(common), 0), np.float32), nan=0.0)
    survival = np.nan_to_num(clinical["survival_days"][clin_rows], nan=0.0).astype(np.float32)
    logger.info("Dataset: %d samples, data dim %d, condition dim %d",
                len(common), data.shape[1], conditions.shape[1])
    return OsteosarcomaArrays(
        data=data, conditions=conditions, survival=survival, sample_ids=common,
        mutation_genes=list(mutation.columns), expression_genes=list(expression.columns),
        pathway_names=list(pathways.columns), condition_names=list(condition_features),
        survival_mean=survival_mean, survival_std=survival_std,
    )


def _pathway_table(directory: Path, expression: Matrix, write: bool) -> Matrix:
    """``pathway_scores.csv`` of ``directory``, or the scores computed from
    ``expression`` where it is missing (written there when ``write``)."""
    path = directory / "pathway_scores.csv"
    if path.exists():
        return read_matrix_csv(path)
    logger.info("Computing pathway scores (lazy)...")
    values, names = pathway_scores_from_expression(expression.values, expression.columns)
    if write:
        write_matrix_csv(path, values, names, index=expression.index, fmt="%r")
    return Matrix(values, names, expression.index)


def prepare_arrays(config: Config) -> Tuple[OsteosarcomaArrays, FrozenDims]:
    """Model-ready arrays and frozen dims from ``data.processed_dir``."""
    processed = Path(config.data.processed_dir)
    mut = read_matrix_csv(processed / "mutation_matrix_aligned.csv")
    expr = read_matrix_csv(processed / "expression_matrix_aligned.csv")
    clin_ids, clinical = _read_clinical(processed / "clinical_aligned.csv")
    path = _pathway_table(processed, expr, write=True)
    path = Matrix(zscore_columns(path.values), path.columns, path.index)

    surv_mean, surv_std = survival_stats(clinical["survival_days"])
    clinical["survival_days_norm"] = (clinical["survival_days"] - surv_mean) / surv_std
    names = resolve_conditions(config, list(clinical))
    logger.info("Condition features: %s", names)
    arrays = build_arrays(mut, expr, path, clin_ids, clinical, names, surv_mean, surv_std)
    dims = config.freeze_dims(len(mut.columns), len(expr.columns), len(path.columns),
                              condition_names=names, survival_mean=surv_mean,
                              survival_std=surv_std)
    return arrays, dims


def resolve_pretrain_dir(entry: str, config: Config) -> Path:
    """A ``pretrain_datasets`` entry is a processed directory, or a GDC
    project id that maps to ``data_dir/pretrain/<project>/processed``."""
    p = Path(entry)
    if p.is_dir():
        return p
    return Path(config.data.data_dir) / "pretrain" / entry / "processed"


def load_pretrain_arrays(config: Config,
                         primary: OsteosarcomaArrays) -> Optional[OsteosarcomaArrays]:
    """The cross-cancer pretraining cohorts on the primary cohort's feature
    space, pooled; None when the feature is off or no cohort is usable."""
    aug = config.training.augmentation
    if not (aug.cross_cancer_pretrain and aug.pretrain_datasets):
        return None
    datas, conds, survs, ids = [], [], [], []
    for entry in aug.pretrain_datasets:
        d = resolve_pretrain_dir(entry, config)
        needed = [d / "mutation_matrix_aligned.csv", d / "expression_matrix_aligned.csv",
                  d / "clinical_aligned.csv"]
        if not all(f.exists() for f in needed):
            logger.warning("Pretrain dataset %s: processed artifacts missing under %s — "
                           "skipping (run download/preprocess for it first)", entry, d)
            continue
        mut = reindex_columns(read_matrix_csv(needed[0]), primary.mutation_genes)
        expr = reindex_columns(read_matrix_csv(needed[1]), primary.expression_genes)
        clin_ids, clin = _read_clinical(needed[2])
        path = reindex_columns(_pathway_table(d, expr, write=False), primary.pathway_names)
        path = Matrix(zscore_columns(path.values), path.columns, path.index)

        surv_mean, surv_std = survival_stats(clin["survival_days"])
        clin["survival_days_norm"] = (clin["survival_days"] - surv_mean) / surv_std
        for col in primary.condition_names:
            clin.setdefault(col, np.zeros(len(clin_ids)))
        arrays = build_arrays(mut, expr, path, clin_ids, clin, primary.condition_names,
                              surv_mean, surv_std)
        if arrays.n_samples == 0:
            logger.warning("Pretrain dataset %s: no aligned samples", entry)
            continue
        datas.append(arrays.data)
        conds.append(arrays.conditions)
        survs.append(arrays.survival)
        ids.extend(f"{entry}:{s}" for s in arrays.sample_ids)
        logger.info("Pretrain dataset %s: %d samples", entry, arrays.n_samples)
    if not datas:
        return None
    pooled = np.concatenate(survs)
    return OsteosarcomaArrays(
        data=np.concatenate(datas, axis=0), conditions=np.concatenate(conds, axis=0),
        survival=pooled, sample_ids=ids, mutation_genes=list(primary.mutation_genes),
        expression_genes=list(primary.expression_genes),
        pathway_names=list(primary.pathway_names),
        condition_names=list(primary.condition_names),
        survival_mean=float(pooled.mean()), survival_std=float(pooled.std() + 1e-8),
    )


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
