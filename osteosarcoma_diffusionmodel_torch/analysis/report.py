"""Post-hoc analysis and reporting — the notebook, as library code.

Counterpart of osteosarcoma_diffusionmodel_tpu/analysis/report.py on
:class:`~..utils.io.Matrix` tables instead of DataFrames: the same
figures under the same file names (mutation-frequency scatter,
driver-gene bars, pathway score histograms, the 2-D embedding of the real
and synthetic cohorts, Kaplan-Meier curves per scenario with Greenwood
bands and the log-rank test, validation metric bars) and the same text
summary, graded PASS / REVIEW / FAIL at 0.85 / 0.70, with the novelty
verdict.

Columns are chosen as pandas chooses them: :func:`common_columns` is
``Index.intersection`` (the first table's order, each name once) and
:func:`select` is ``frame[names]`` (every column of a repeated name, where
the name is asked for).

The embedding is umap-learn where it is installed, else the native UMAP
of :mod:`.embedding` (PCA for cohorts too small for a neighbor graph), on
the host as in the JAX package. matplotlib is imported only inside
:func:`_matplotlib`; without it the figures are skipped and the text
summary is still written.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.io import Matrix
from .embedding import umap_embed
from .survival import kaplan_meier, kaplan_meier_full, logrank_test

__all__ = [
    "AnalysisReport", "embed_2d", "grade", "kaplan_meier",
    "novelty_verdict", "write_summary_report",
]

logger = logging.getLogger(__name__)

PASS_THRESHOLD = 0.85
REVIEW_THRESHOLD = 0.70


def _matplotlib():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def common_columns(a: Sequence[str], b: Sequence[str]) -> List[str]:
    """``pandas.Index(a).intersection(b)``: the names of ``a`` that ``b``
    holds, in ``a``'s order, each once."""
    present, seen, out = set(b), set(), []
    for name in a:
        if name in present and name not in seen:
            seen.add(name)
            out.append(name)
    return out


def select(table: Matrix, names: Sequence[str]) -> np.ndarray:
    """``frame[names].values``: for each name, every column of that name."""
    return table.values[:, [j for name in names
                            for j, col in enumerate(table.columns) if col == name]]


# ----------------------------------------------------------------------
# Embedding
# ----------------------------------------------------------------------
def embed_2d(real: np.ndarray, synthetic: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """2-D embedding of real + synthetic: umap-learn when installed,
    else the native UMAP (analysis/embedding.py; PCA only for cohorts
    too small for a neighbor graph)."""
    combined = np.concatenate([real, synthetic], axis=0)
    try:
        import umap  # noqa: F401

        reducer = umap.UMAP(n_components=2, random_state=0)
        emb = reducer.fit_transform(combined)
    except ImportError:
        emb = umap_embed(combined, seed=0)
    return emb[: len(real)], emb[len(real):]


# ----------------------------------------------------------------------
# Report
# ----------------------------------------------------------------------
def grade(score: float) -> str:
    if score >= PASS_THRESHOLD:
        return "PASS"
    if score >= REVIEW_THRESHOLD:
        return "REVIEW"
    return "FAIL"


def novelty_verdict(validation_results: Dict[str, float]) -> Optional[str]:
    """Memorization verdict from the novelty-audit metrics, or None
    when the audit wasn't run (the JAX function's thresholds: a duplicate
    rate above 1%, an NN distance ratio below 0.2, or a 5% quantile of
    the leave-one-out ratio below a quarter of its split-half floor)."""
    nn_ratio = validation_results.get("nn_distance_ratio")
    if nn_ratio is None:
        return None
    dup = validation_results.get("exact_duplicate_rate", 0.0)
    q05 = validation_results.get("nn_loo_ratio_q05")
    q05_floor = validation_results.get("nn_loo_ratio_q05_floor")
    q05_crushed = (
        q05 is not None and q05_floor is not None
        and q05 < 0.25 * q05_floor
    )
    if dup > 0.01 or nn_ratio < 0.2 or q05_crushed:
        return "MEMORIZATION SUSPECTED"
    if nn_ratio < 0.5:
        return "REVIEW (synthetic sits close to training patients)"
    return "NOVEL (synthetic patients are not re-renders)"


def write_summary_report(
    validation_results: Dict[str, float], output_path: Path
) -> str:
    """Text summary with the notebook's pass/review/fail grading."""
    lines = [
        "SYNTHETIC PATIENT VALIDATION SUMMARY",
        "=" * 50,
        "",
    ]
    for key in sorted(validation_results):
        lines.append(f"{key:45s} {validation_results[key]: .4f}")
    lines.append("")
    overall = validation_results.get("overall_biological_score")
    if overall is not None:
        lines.append(f"Overall biological score: {overall:.3f} -> {grade(overall)}")
        lines.append(
            f"(PASS >= {PASS_THRESHOLD}, REVIEW >= {REVIEW_THRESHOLD}, "
            f"FAIL below)"
        )
    verdict = novelty_verdict(validation_results)
    if verdict is not None:
        nn_ratio = validation_results["nn_distance_ratio"]
        dup = validation_results.get("exact_duplicate_rate", 0.0)
        q05 = validation_results.get("nn_loo_ratio_q05")
        q05_floor = validation_results.get("nn_loo_ratio_q05_floor")
        lines.append("")
        q05_txt = (
            f", nn_loo_ratio_q05={q05:.3f} (floor {q05_floor:.3f})"
            if q05 is not None and q05_floor is not None else ""
        )
        lines.append(
            f"Novelty audit: nn_distance_ratio={nn_ratio:.3f}, "
            f"exact_duplicate_rate={dup:.4f}{q05_txt} -> {verdict}"
        )
    report = "\n".join(lines)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(report)
    logger.info("Wrote summary report to %s", output_path)
    return report


class AnalysisReport:
    """Generate the notebook's figures + text report from pipeline outputs."""

    def __init__(self, config, figures_dir: Optional[Path] = None):
        self.config = config
        self.figures_dir = Path(figures_dir or config.output.figures_dir)
        self.figures_dir.mkdir(parents=True, exist_ok=True)

    def _save(self, fig, name: str) -> Optional[Path]:
        path = self.figures_dir / name
        fig.savefig(path, dpi=120, bbox_inches="tight")
        logger.info("Wrote figure %s", path)
        return path

    def mutation_frequency_scatter(
        self, real_mut: Matrix, synth_mut: Matrix
    ) -> Optional[Path]:
        plt = _matplotlib()
        if plt is None:
            return None
        common = common_columns(real_mut.columns, synth_mut.columns)
        rf = np.nanmean(select(real_mut, common), axis=0)
        sf = np.nanmean(select(synth_mut, common), axis=0)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(rf, sf, s=12, alpha=0.6)
        lim = max(float(rf.max()), float(sf.max()), 0.01)
        ax.plot([0, lim], [0, lim], "k--", lw=1)
        ax.set_xlabel("Real mutation frequency")
        ax.set_ylabel("Synthetic mutation frequency")
        ax.set_title("Mutation frequency: real vs synthetic")
        out = self._save(fig, "mutation_frequency_scatter.png")
        plt.close(fig)
        return out

    def driver_gene_bars(
        self, real_mut: Matrix, synth_mut: Matrix
    ) -> Optional[Path]:
        plt = _matplotlib()
        if plt is None:
            return None
        drivers = [g for g in self.config.evaluation.driver_genes
                   if g in real_mut.columns and g in synth_mut.columns]
        if not drivers:
            return None
        x = np.arange(len(drivers))
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.bar(x - 0.2, np.nanmean(select(real_mut, drivers), axis=0), width=0.4, label="real")
        ax.bar(x + 0.2, np.nanmean(select(synth_mut, drivers), axis=0), width=0.4,
               label="synthetic")
        ax.set_xticks(x, drivers, rotation=45)
        ax.set_ylabel("Mutation frequency")
        ax.set_title("Driver gene mutation rates")
        ax.legend()
        out = self._save(fig, "driver_gene_frequencies.png")
        plt.close(fig)
        return out

    def pathway_histograms(
        self, real_path: Matrix, synth_path: Matrix,
        max_pathways: int = 6,
    ) -> Optional[Path]:
        plt = _matplotlib()
        if plt is None:
            return None
        cols = list(real_path.columns[:max_pathways])
        fig, axes = plt.subplots(2, 3, figsize=(12, 6))
        for ax, col in zip(axes.ravel(), cols):
            ax.hist(real_path.column(col), bins=20, alpha=0.5, density=True,
                    label="real")
            if col in synth_path.columns:
                ax.hist(synth_path.column(col), bins=20, alpha=0.5, density=True,
                        label="synthetic")
            ax.set_title(col.replace("HALLMARK_", ""), fontsize=7)
        axes.ravel()[0].legend(fontsize=7)
        fig.suptitle("Pathway score distributions")
        out = self._save(fig, "pathway_histograms.png")
        plt.close(fig)
        return out

    def embedding_plot(
        self, real: np.ndarray, synthetic: np.ndarray
    ) -> Optional[Path]:
        plt = _matplotlib()
        if plt is None:
            return None
        r2, s2 = embed_2d(real, synthetic)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(r2[:, 0], r2[:, 1], s=10, alpha=0.7, label="real")
        ax.scatter(s2[:, 0], s2[:, 1], s=6, alpha=0.4, label="synthetic")
        ax.set_title("Cohort embedding (real vs synthetic)")
        ax.legend()
        out = self._save(fig, "cohort_embedding.png")
        plt.close(fig)
        return out

    def km_curves(
        self, scenario_survival: Dict[str, Tuple[np.ndarray, np.ndarray]]
    ) -> Optional[Path]:
        """Kaplan-Meier curves per scenario: {name: (times, events)}.

        Each curve carries its Greenwood 95% band; with exactly two
        scenarios that have events the log-rank p-value is annotated."""
        plt = _matplotlib()
        if plt is None:
            return None
        fig, ax = plt.subplots(figsize=(7, 5))
        for name, (times, events) in scenario_survival.items():
            curve = kaplan_meier_full(times, events)
            if len(curve.times) == 0:
                continue
            t = np.concatenate([[0], curve.times])
            ax.step(t, np.concatenate([[1.0], curve.survival]),
                    where="post", label=name)
            ax.fill_between(
                t,
                np.concatenate([[1.0], curve.ci_low]),
                np.concatenate([[1.0], curve.ci_high]),
                step="post", alpha=0.15,
            )
        groups = [
            (n, te) for n, te in scenario_survival.items()
            if np.asarray(te[1]).astype(bool).any()
        ]
        if len(groups) == 2:
            (na, (ta, ea)), (nb, (tb, eb)) = groups
            lr = logrank_test(ta, ea, tb, eb)
            ax.text(
                0.02, 0.04,
                f"log-rank {na} vs {nb}: "
                f"chi2={lr.statistic:.2f}, p={lr.p_value:.3g}",
                transform=ax.transAxes, fontsize=8,
            )
        ax.set_xlabel("Days")
        ax.set_ylabel("Survival probability")
        ax.set_title("Kaplan-Meier survival by scenario (95% CI)")
        ax.set_ylim(0, 1.05)
        ax.legend(fontsize=8)
        out = self._save(fig, "kaplan_meier.png")
        plt.close(fig)
        return out

    def validation_bars(
        self, validation_results: Dict[str, float]
    ) -> Optional[Path]:
        plt = _matplotlib()
        if plt is None:
            return None
        keys = [k for k in validation_results
                if "correlation" in k or "score" in k or "rate" in k]
        fig, ax = plt.subplots(figsize=(8, 4))
        vals = [validation_results[k] for k in keys]
        ax.barh(range(len(keys)), vals)
        ax.set_yticks(range(len(keys)), keys, fontsize=7)
        ax.axvline(PASS_THRESHOLD, color="g", ls="--", lw=1)
        ax.axvline(REVIEW_THRESHOLD, color="orange", ls="--", lw=1)
        ax.set_title("Validation metrics")
        out = self._save(fig, "validation_metrics.png")
        plt.close(fig)
        return out
