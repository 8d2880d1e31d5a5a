"""The structured dummy cohort, built in memory with numpy.

Counterpart of osteosarcoma_diffusionmodel_tpu/data/dataset.py:311
`make_dummy_data` (structured, Hallmark-named): the same draws from the
same seeded generator in the same order, so the same arguments give the
same cohort. Mutation frequencies vary per gene, latent factors induce
co-occurrence, TP53/MDM2 are near-exclusive and TP53/MYC shift their
pathways. :func:`write_processed` writes it in the JAX CLI's processed
layout; :func:`cohort_arrays` builds the model-ready arrays as
`prepare_arrays` does (z-scored pathway scores and survival).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config, FrozenDims
from ..utils.io import write_matrix_csv
from .pathways import HALLMARK_GENE_SETS, pathway_scores_from_expression

DRIVERS = ["TP53", "RB1", "ATRX", "DLG2", "PTEN", "MDM2", "MYC"]


@dataclass
class DummyCohort:
    sample_ids: List[str]
    mutations: np.ndarray  # (n, m) float32 bits
    mutation_genes: List[str]
    expression: np.ndarray  # (n, e) float32
    expression_genes: List[str]
    pathways: np.ndarray  # (n, p) float32, raw (not z-scored)
    pathway_names: List[str]
    clinical: Dict[str, np.ndarray]  # survival_days, event_occurred, ...


def make_dummy_cohort(
    n_samples: int = 100,
    n_mutation_genes: int = 50,
    n_expression_genes: int = 100,
    n_pathways: int = 30,
    seed: int = 0,
) -> DummyCohort:
    rng = np.random.default_rng(seed)
    ids = [f"P{i:04d}" for i in range(n_samples)]
    mut_genes = (DRIVERS + [f"MUT{i}" for i in range(n_mutation_genes - len(DRIVERS))])
    mut_genes = mut_genes[:n_mutation_genes]
    m = len(mut_genes)

    freqs = rng.beta(1.2, 3.0, size=m).clip(0.05, 0.9)
    n_factors = max(2, m // 8)
    factor_load = rng.random((m, n_factors)) < 0.25
    factors = rng.random((n_samples, n_factors)) < 0.5
    bump = (factors @ factor_load.T).astype(bool)
    base = rng.random((n_samples, m)) < freqs[None, :]
    mut = (base | (bump & (rng.random((n_samples, m)) < 0.5))).astype(np.float32)
    gi = {g: k for k, g in enumerate(mut_genes)}
    if "TP53" in gi:
        mut[:, gi["TP53"]] = (rng.random(n_samples) < 0.6).astype(np.float32)
        if "MDM2" in gi:
            mdm2 = (rng.random(n_samples) < 0.15) & (mut[:, gi["TP53"]] < 0.5)
            mut[:, gi["MDM2"]] = mdm2.astype(np.float32)
    if "MYC" in gi:
        mut[:, gi["MYC"]] = (rng.random(n_samples) < 0.35).astype(np.float32)

    expr_genes: List[str] = []
    for genes in HALLMARK_GENE_SETS.values():
        for g in genes:
            if g not in expr_genes:
                expr_genes.append(g)
            if len(expr_genes) >= n_expression_genes:
                break
        if len(expr_genes) >= n_expression_genes:
            break
    while len(expr_genes) < n_expression_genes:
        expr_genes.append(f"EXPR{len(expr_genes)}")

    expr = rng.normal(size=(n_samples, n_expression_genes)).astype(np.float32)
    col_index = {g: k for k, g in enumerate(expr_genes)}
    for pathway, genes in HALLMARK_GENE_SETS.items():
        member_cols = [col_index[g] for g in genes if g in col_index]
        if not member_cols:
            continue
        factor = rng.normal(size=(n_samples, 1)).astype(np.float32)
        expr[:, member_cols] += 0.8 * factor
        if pathway == "HALLMARK_P53_PATHWAY" and "TP53" in gi:
            expr[:, member_cols] -= 1.2 * mut[:, [gi["TP53"]]]
        if pathway == "HALLMARK_MYC_TARGETS_V1" and "MYC" in gi:
            expr[:, member_cols] += 1.2 * mut[:, [gi["MYC"]]]

    path_names = (list(HALLMARK_GENE_SETS.keys())
                  + [f"PATHWAY_{i}" for i in range(n_pathways)])[:n_pathways]
    path = rng.normal(size=(n_samples, n_pathways)).astype(np.float32)
    derived, derived_names = pathway_scores_from_expression(expr, expr_genes)
    for j, name in enumerate(path_names):
        if name in derived_names:
            path[:, j] = derived[:, derived_names.index(name)].astype(np.float32)

    clinical = {
        "survival_days": rng.integers(100, 2000, n_samples),
        "event_occurred": rng.integers(0, 2, n_samples),
        "age_years": rng.uniform(10, 18, n_samples),
        "metastasis_at_diagnosis": rng.integers(0, 2, n_samples),
        "gender_bin": rng.integers(0, 2, n_samples),
    }
    return DummyCohort(ids, mut, mut_genes, expr, expr_genes, path, path_names, clinical)


def write_processed(cohort: DummyCohort, processed_dir: str | Path) -> None:
    """The four processed tables, in the layout the JAX CLI reads."""
    out = Path(processed_dir)
    out.mkdir(parents=True, exist_ok=True)
    ids = cohort.sample_ids
    f32 = "%.9g"  # round-trips float32
    write_matrix_csv(out / "mutation_matrix_aligned.csv", cohort.mutations,
                     cohort.mutation_genes, index=ids, fmt=f32)
    write_matrix_csv(out / "expression_matrix_aligned.csv", cohort.expression,
                     cohort.expression_genes, index=ids, fmt=f32)
    write_matrix_csv(out / "pathway_scores.csv", cohort.pathways,
                     cohort.pathway_names, index=ids, fmt=f32)
    cols = list(cohort.clinical)
    table = np.stack([np.asarray(cohort.clinical[c], np.float64) for c in cols], axis=1)
    write_matrix_csv(out / "clinical_aligned.csv", table, cols, index=ids,
                     index_label="submitter_id", fmt="%.17g")


def cohort_arrays(cohort: DummyCohort, config: Config) -> Tuple[np.ndarray, np.ndarray, FrozenDims]:
    """(data, conditions, dims) as `prepare_arrays` builds them: pathway
    scores and survival z-scored (sample std), conditions resolved from
    ``config.model.condition_on``."""
    path = cohort.pathways.astype(np.float64)
    path = (path - path.mean(axis=0)) / (path.std(axis=0, ddof=1) + 1e-8)
    surv = cohort.clinical["survival_days"].astype(np.float64)
    surv_mean = float(surv.mean())
    surv_std = float(surv.std(ddof=1) + 1e-8)
    columns = dict(cohort.clinical)
    columns["survival_days_norm"] = (surv - surv_mean) / surv_std
    names = config.resolve_condition_columns(list(columns))
    conditions = np.nan_to_num(
        np.stack([np.asarray(columns[c], np.float32) for c in names], axis=1), nan=0.0
    )
    data = np.concatenate(
        [cohort.mutations, cohort.expression, path.astype(np.float32)], axis=1
    ).astype(np.float32)
    dims = config.freeze_dims(
        len(cohort.mutation_genes), len(cohort.expression_genes), len(cohort.pathway_names),
        condition_names=names, survival_mean=surv_mean, survival_std=surv_std,
    )
    return data, conditions, dims
