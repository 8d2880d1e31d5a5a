"""(h) The validator's metrics dict against the JAX package's on
identical cohorts: the same keys, and values to 1e-4.

The JAX validator computes in float32 (HIGHEST-precision dots); the port
in float64 on the cohort's device. On O(1) statistics of 40-120 rows
that difference stays below 1e-4, the tolerance held here.
"""

import numpy as np
import pandas as pd
import pytest

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data
from osteosarcoma_diffusionmodel_tpu.data.pathways import PathwayFeatures
from osteosarcoma_diffusionmodel_tpu.validation.validator import (
    BiologicalValidator as JaxValidator,
)
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.ops import stats as port_stats
from osteosarcoma_diffusionmodel_torch.utils.io import Matrix, read_matrix_csv
from osteosarcoma_diffusionmodel_torch.validation.validator import BiologicalValidator

TOL = 1e-4


def _matrix(df: pd.DataFrame) -> Matrix:
    return Matrix(df.values.astype(np.float64), [str(c) for c in df.columns],
                  [str(i) for i in df.index])


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    proc = tmp_path_factory.mktemp("processed")
    make_dummy_data(proc, n_samples=40, n_mutation_genes=20, n_expression_genes=80,
                    n_pathways=20)
    real = {k: pd.read_csv(proc / f, index_col=0) for k, f in (
        ("mut", "mutation_matrix_aligned.csv"), ("expr", "expression_matrix_aligned.csv"),
        ("path", "pathway_scores.csv"))}
    rng = np.random.default_rng(1)
    n = 120
    idx = rng.integers(0, 40, n)
    synth = {
        "mut": pd.DataFrame((rng.random((n, real["mut"].shape[1])) < 0.3).astype(np.float32),
                            columns=real["mut"].columns),
        "expr": pd.DataFrame(real["expr"].values[idx] + 0.5 * rng.standard_normal(
            (n, real["expr"].shape[1])), columns=real["expr"].columns),
        "path": pd.DataFrame(real["path"].values[idx] + 0.3 * rng.standard_normal(
            (n, real["path"].shape[1])), columns=real["path"].columns),
    }
    gpm = PathwayFeatures().create_gene_pathway_matrix()
    return real, synth, gpm


def test_validate_all_matches_jax(cohorts):
    real, synth, gpm = cohorts
    ref = JaxValidator(JaxConfig()).validate_all(
        real["mut"], real["expr"], real["path"], synth["mut"], synth["expr"], synth["path"],
        pathway_gene_matrix=gpm)
    got = BiologicalValidator(Config(), device="cpu").validate_all(
        _matrix(real["mut"]), _matrix(real["expr"]), _matrix(real["path"]),
        _matrix(synth["mut"]), _matrix(synth["expr"]), _matrix(synth["path"]),
        pathway_gene_matrix=_matrix(gpm))
    assert set(got) == set(ref)
    assert {"mmd", "overall_biological_score", "pathway_coherence_correlation",
            "nn_loo_ratio_q05_floor", "ks_matched_fraction_significant"} <= set(got)
    for key in ref:
        assert got[key] == pytest.approx(float(ref[key]), abs=TOL), key


def test_validate_all_on_identical_cohorts(cohorts):
    """Real against itself: frequencies match exactly, MMD is 0, every
    synthetic row is an exact duplicate."""
    real, _, _ = cohorts
    m = [_matrix(real[k]) for k in ("mut", "expr", "path")]
    got = BiologicalValidator(Config(), device="cpu").validate_all(*m, *m)
    assert got["mutation_frequency_correlation"] == pytest.approx(1.0)
    assert got["mmd"] == pytest.approx(0.0, abs=1e-6)
    assert got["exact_duplicate_rate"] == 1.0


@pytest.mark.parametrize("mode", ["exact", "asymp"])
def test_ks_matches_scipy(mode):
    from scipy.stats import ks_2samp

    import torch

    rng = np.random.default_rng(2)
    x = rng.standard_normal((30, 4))
    y = rng.standard_normal((45, 4)) + 0.3
    stats, p = port_stats.ks_test_features(torch.from_numpy(x), torch.from_numpy(y), mode=mode)
    for j in range(4):
        ref = ks_2samp(x[:, j], y[:, j], method="exact" if mode == "exact" else "asymp")
        assert stats[j] == pytest.approx(ref.statistic, abs=1e-12)
        if mode == "exact":
            assert p[j] == pytest.approx(ref.pvalue, rel=1e-6, abs=1e-9)


def test_wasserstein_matches_scipy():
    from scipy.stats import wasserstein_distance

    import torch

    rng = np.random.default_rng(3)
    u, v = rng.standard_normal((25, 3)), rng.standard_normal((40, 3)) * 2
    got = port_stats.wasserstein_columns(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    for j in range(3):
        assert got[j] == pytest.approx(wasserstein_distance(u[:, j], v[:, j]), rel=1e-10)


def test_matrix_csv_round_trip(tmp_path):
    from osteosarcoma_diffusionmodel_torch.utils.io import write_matrix_csv

    values = np.array([[0.0, 1.5], [2.25, -3.0]])
    write_matrix_csv(tmp_path / "a.csv", values, ["g1", "g2"], index=["P0", "P1"])
    back = read_matrix_csv(tmp_path / "a.csv")
    assert back.columns == ["g1", "g2"] and back.index == ["P0", "P1"]
    np.testing.assert_array_equal(back.values, values)
    pdf = pd.read_csv(tmp_path / "a.csv", index_col=0)  # the JAX CLI's reader
    np.testing.assert_array_equal(pdf.values, values)
