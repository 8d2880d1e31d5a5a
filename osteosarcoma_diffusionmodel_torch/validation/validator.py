"""Biological and statistical validation of synthetic cohorts.

Counterpart of osteosarcoma_diffusionmodel_tpu/validation/validator.py
(:82-487), with the same metrics under the same keys: mutation frequency
correlation, driver-gene frequency difference, mutual-exclusivity
violations, chi-square co-occurrence pattern correlation (seeded gene
sample), within-pathway coherence, mutation -> pathway direction rules,
KS (raw and size-matched), MMD (kernel K4), Wasserstein on 10 PCs, the
novelty audit and the overall score. Inputs are numpy matrices with
their column names (:class:`..utils.io.Matrix`) instead of DataFrames;
the numeric work runs as PyTorch ops on ``device``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.pallas_kernels import mmd_rbf
from ..ops.stats import (
    chi2_binary_pairs,
    ks_test_features,
    mean_pairwise_corr_within_groups,
    pca_project,
    pearson_corr,
    wasserstein_columns,
)
from ..utils.io import Matrix

logger = logging.getLogger(__name__)

SEED = 0  # gene sampling, KS resampling and split halves (as the JAX validator)
MAX_GENES = 50  # genes sampled for the chi-square pattern
MAX_PATHWAYS = 10  # pathways scored for coherence
MIN_PATHWAY_GENES = 3
MAX_KS_FEATURES = 100
N_PCA_COMPONENTS = 10


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xx = (x * x).sum(1)[:, None]
    yy = (y * y).sum(1)[None, :]
    return torch.clamp(xx + yy - 2.0 * (x @ y.T), min=0.0)


class BiologicalValidator:
    """Validate synthetic patients against biological knowledge."""

    def __init__(self, config: Config, device="cpu"):
        ev = config.evaluation
        self.config = config
        self.driver_genes = ev.driver_genes
        self.mutually_exclusive_pairs = ev.mutually_exclusive_pairs
        self.required_correlations = ev.required_correlations
        self.device = torch.device(device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def validate_mutation_cooccurrence(self, real: Matrix, synth: Matrix) -> Dict[str, float]:
        results: Dict[str, float] = {}
        synth_cols = set(synth.columns)
        common = [c for c in real.columns if c in synth_cols]
        r = self._t(real.values[:, [real.columns.index(c) for c in common]])
        s = self._t(synth.values[:, [synth.columns.index(c) for c in common]])

        rf, sf = r.mean(dim=0), s.mean(dim=0)
        results["mutation_frequency_correlation"] = pearson_corr(rf, sf)
        drivers = ([g for g in self.driver_genes if g in common]
                   if self.config.evaluation.check_driver_mutations else [])
        if drivers:
            didx = torch.as_tensor([common.index(g) for g in drivers], device=self.device)
            results["driver_gene_frequency_diff"] = float(
                (rf[didx].double() - sf[didx].double()).abs().mean())

        if self.mutually_exclusive_pairs:
            violations, total_pairs = 0.0, 0
            for gene1, gene2 in self.mutually_exclusive_pairs:
                if gene1 in synth_cols and gene2 in synth_cols:
                    both = (synth.column(gene1) == 1) & (synth.column(gene2) == 1)
                    violations += float(both.sum())
                    total_pairs += 1
            if total_pairs:
                results["mutual_exclusivity_violation_rate"] = (
                    violations / (synth.values.shape[0] * total_pairs))

        rng = np.random.default_rng(SEED)
        n_sample = min(MAX_GENES, len(common))
        sample_idx = rng.choice(len(common), size=n_sample, replace=False)
        pairs = [(int(sample_idx[i]), int(sample_idx[j]))
                 for i in range(n_sample) for j in range(i + 1, n_sample)]
        if pairs:
            pi = torch.as_tensor([p[0] for p in pairs], device=self.device)
            pj = torch.as_tensor([p[1] for p in pairs], device=self.device)
            results["cooccurrence_pattern_correlation"] = pearson_corr(
                chi2_binary_pairs(r, pi, pj), chi2_binary_pairs(s, pi, pj))
        for key, value in results.items():
            logger.info("%s: %.4f", key, value)
        return results

    # ------------------------------------------------------------------
    def validate_pathway_coherence(self, real: Matrix, synth: Matrix,
                                   pathway_gene_matrix: Matrix) -> Dict[str, float]:
        """Within-pathway mean pairwise correlation, real vs synthetic.
        ``pathway_gene_matrix``: genes (index) x pathways (columns)."""
        results: Dict[str, float] = {}
        genes_index = pathway_gene_matrix.index or []
        masks = []
        for p in range(min(MAX_PATHWAYS, len(pathway_gene_matrix.columns))):
            members = [g for g, v in zip(genes_index, pathway_gene_matrix.values[:, p])
                       if v == 1 and g in real.columns]
            if len(members) < MIN_PATHWAY_GENES:
                continue
            col = np.zeros(len(real.columns), np.float32)
            col[[real.columns.index(g) for g in members]] = 1.0
            masks.append(col)
        if not masks:
            return results
        mask = self._t(np.stack(masks, axis=1))
        synth_vals = synth.values[:, [synth.columns.index(c) for c in real.columns]]
        real_scores = mean_pairwise_corr_within_groups(self._t(real.values), mask)
        synth_scores = mean_pairwise_corr_within_groups(self._t(synth_vals), mask)
        results["real_pathway_coherence"] = float(real_scores.mean())
        results["synthetic_pathway_coherence"] = float(synth_scores.mean())
        if len(real_scores) > 1:
            results["pathway_coherence_correlation"] = pearson_corr(real_scores, synth_scores)
        return results

    # ------------------------------------------------------------------
    def validate_mutation_expression_correlation(self, mutations: Matrix,
                                                 pathway_scores: Matrix) -> Dict[str, float]:
        """Directional mutation -> pathway activity rules."""
        violations, total = 0, 0
        for rule in self.required_correlations:
            if rule.mutation not in mutations.columns or rule.pathway not in pathway_scores.columns:
                continue
            corr = pearson_corr(self._t(mutations.column(rule.mutation)),
                                self._t(pathway_scores.column(rule.pathway)))
            if (rule.direction == "positive" and corr < 0) or (
                    rule.direction == "negative" and corr > 0):
                violations += 1
            total += 1
            logger.info("%s vs %s: corr=%.3f (expected %s)",
                        rule.mutation, rule.pathway, corr, rule.direction)
        return {"mutation_expression_violation_rate": violations / total} if total else {}

    # ------------------------------------------------------------------
    def statistical_tests(self, real_data: np.ndarray,
                          synthetic_data: np.ndarray) -> Dict[str, float]:
        results: Dict[str, float] = {}
        real = self._t(real_data)
        synth = self._t(synthetic_data)
        mode = self.config.evaluation.ks_mode
        k = min(real.shape[1], MAX_KS_FEATURES)
        _, pvals = ks_test_features(real[:, :k], synth[:, :k], mode=mode)
        results["ks_test_mean_pvalue"] = float(pvals.mean())
        results["ks_test_fraction_significant"] = float((pvals < 0.05).mean())

        n_re = int(self.config.evaluation.ks_size_matched_resamples)
        if n_re > 0 and synth.shape[0] > real.shape[0]:
            sub_rng = np.random.default_rng(SEED)
            fracs, means = [], []
            for _ in range(n_re):
                idx = sub_rng.choice(synth.shape[0], size=real.shape[0], replace=False)
                _, p_m = ks_test_features(
                    real[:, :k], synth[torch.as_tensor(idx, device=self.device), :k], mode=mode)
                fracs.append(float((p_m < 0.05).mean()))
                means.append(float(p_m.mean()))
            results["ks_matched_fraction_significant"] = float(np.mean(fracs))
            results["ks_matched_mean_pvalue"] = float(np.mean(means))

        results["mmd"] = mmd_rbf(real, synth)

        n_comp = min(N_PCA_COMPONENTS, real.shape[0], real.shape[1])
        real_pca, synth_pca = pca_project(real, synth, n_comp)
        results["wasserstein_distance_mean"] = float(
            wasserstein_columns(real_pca, synth_pca).mean())
        for key, value in results.items():
            logger.info("%s: %.4f", key, value)
        return results

    # ------------------------------------------------------------------
    def novelty_metrics(self, real_data: np.ndarray,
                        synthetic_data: np.ndarray) -> Dict[str, float]:
        """Nearest-neighbour novelty audit (validator.py `novelty_metrics`):
        NN distance ratios, near and exact duplicate rates, and split-half
        floors of the per-row ratio quantiles."""
        real = np.asarray(real_data, np.float32)
        results = self._novelty_core(real, np.asarray(synthetic_data, np.float32))
        n = real.shape[0]
        if n >= 8:
            rng = np.random.default_rng(SEED)
            floors = {"nn_loo_ratio_median": [], "nn_loo_ratio_q05": []}
            for _ in range(3):
                perm = rng.permutation(n)
                a, b = perm[: n // 2], perm[n // 2:]
                core = self._novelty_core(real[b], real[a])
                for key in floors:
                    floors[key].append(core[key])
            for key, vals in floors.items():
                results[f"{key}_floor"] = float(np.mean(vals))
        for key, value in results.items():
            logger.info("%s: %.4f", key, value)
        return results

    def _novelty_core(self, real_np: np.ndarray, synth_np: np.ndarray) -> Dict[str, float]:
        real = self._t(real_np).double()
        synth = self._t(synth_np).double()
        d2_rr = _pairwise_sqdist(real, real)
        d2_rr.fill_diagonal_(float("inf"))
        loo_np = torch.sqrt(torch.clamp(d2_rr.min(dim=1).values, min=0.0)).cpu().numpy()
        nn_idx_np = _pairwise_sqdist(synth, real).argmin(dim=1).cpu().numpy()
        diff = synth_np.astype(np.float64) - real_np[nn_idx_np].astype(np.float64)
        nn_np = np.sqrt(np.einsum("ij,ij->i", diff, diff))

        loo_med = float(np.median(loo_np))
        nn_med = float(np.median(nn_np))
        scale = float(np.sqrt(max(float(np.mean((real_np.astype(np.float64) ** 2).sum(axis=1))),
                                  1e-30)))
        real_rows = {r.tobytes() for r in real_np}
        bit_dup = np.fromiter((s.tobytes() in real_rows for s in synth_np), bool,
                              synth_np.shape[0])
        ratios = nn_np / np.maximum(loo_np[nn_idx_np], 1e-12)
        return {
            "nn_distance_ratio": nn_med / max(loo_med, 1e-12),
            "duplicate_rate": float((nn_np < 0.05 * max(loo_med, 1e-12)).mean()),
            "exact_duplicate_rate": float((bit_dup | (nn_np < 1e-6 * scale)).mean()),
            "nn_loo_ratio_median": float(np.median(ratios)),
            "nn_loo_ratio_q05": float(np.quantile(ratios, 0.05)),
            "real_loo_nn_median": loo_med,
            "synthetic_nn_median": nn_med,
        }

    # ------------------------------------------------------------------
    def validate_all(self, real_mutations: Matrix, real_expression: Matrix,
                     real_pathways: Matrix, synth_mutations: Matrix,
                     synth_expression: Matrix, synth_pathways: Matrix,
                     pathway_gene_matrix: Optional[Matrix] = None) -> Dict[str, float]:
        all_results: Dict[str, float] = {}
        ev = self.config.evaluation
        if ev.check_mutation_cooccurrence:
            all_results.update(self.validate_mutation_cooccurrence(real_mutations,
                                                                   synth_mutations))
        if ev.check_pathway_coherence and pathway_gene_matrix is not None:
            all_results.update(self.validate_pathway_coherence(
                real_expression, synth_expression, pathway_gene_matrix))
        all_results.update(self.validate_mutation_expression_correlation(
            synth_mutations, synth_pathways))

        real_combined = np.concatenate(
            [real_mutations.values, real_expression.values, real_pathways.values], axis=1
        ).astype(np.float32)
        synth_combined = np.concatenate(
            [synth_mutations.values, synth_expression.values, synth_pathways.values], axis=1
        ).astype(np.float32)
        all_results.update(self.statistical_tests(real_combined, synth_combined))
        if ev.check_novelty and real_combined.shape[0] > 2:
            all_results.update(self.novelty_metrics(real_combined, synth_combined))

        components: List[float] = []
        for key, flip in (("mutation_frequency_correlation", False),
                          ("cooccurrence_pattern_correlation", False),
                          ("mutual_exclusivity_violation_rate", True),
                          ("mutation_expression_violation_rate", True)):
            if key in all_results:
                components.append(1 - all_results[key] if flip else all_results[key])
        if components:
            all_results["overall_biological_score"] = float(np.mean(components))
            logger.info("Overall Biological Score: %.3f", all_results["overall_biological_score"])
        return all_results
