"""The port's analysis modules against the JAX package's: the survival
statistics (1e-12), the native UMAP and ``embed_2d`` (1e-9; the same numpy
code, so in practice bit for bit), the grading and the text summary
(byte-equal), and the pandas column choice that the report step makes.

Every input is made from a seeded numpy generator in the test itself.
"""

import math

import numpy as np
import pandas as pd
import pytest

from osteosarcoma_diffusionmodel_tpu.analysis import embedding as jax_embedding
from osteosarcoma_diffusionmodel_tpu.analysis import report as jax_report
from osteosarcoma_diffusionmodel_tpu.analysis import survival as jax_survival
from osteosarcoma_diffusionmodel_torch.analysis import embedding, report, survival
from osteosarcoma_diffusionmodel_torch.utils.io import Matrix

SURVIVAL_TOL = 1e-12
EMBED_TOL = 1e-9


def _cohort(case: str, seed: int):
    """(times, events): integer days with ties and censoring, or one of the
    edge cases (no events, every patient an event, one patient)."""
    rng = np.random.default_rng(seed)
    n = 1 if case == "single" else 40
    times = rng.integers(50, 400, n).astype(np.float64)
    if case == "ties":
        times = rng.choice([100.0, 150.0, 200.0, 250.0], n)
    events = rng.random(n) < 0.6
    if case == "no_events":
        events[:] = False
    elif case == "all_events":
        events[:] = True
    return times, events.astype(np.int64)


CASES = ["ties", "censored", "no_events", "all_events", "single"]


def _close(a, b) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= SURVIVAL_TOL


@pytest.mark.parametrize("case", CASES)
def test_kaplan_meier_and_median_match_jax(case):
    times, events = _cohort(case, seed=CASES.index(case))
    got, want = survival.kaplan_meier_full(times, events), jax_survival.kaplan_meier_full(
        times, events)
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=0,
                                   atol=SURVIVAL_TOL, err_msg=field)
    t, s = survival.kaplan_meier(times, events)
    np.testing.assert_allclose(s, want.survival, rtol=0, atol=SURVIVAL_TOL)
    np.testing.assert_array_equal(t, want.times)
    assert _close(survival.median_survival(times, events),
                  jax_survival.median_survival(times, events))


@pytest.mark.parametrize("pair", [("ties", "censored"), ("censored", "all_events"),
                                  ("no_events", "no_events"), ("ties", "ties")])
def test_logrank_matches_jax(pair):
    (ta, ea), (tb, eb) = _cohort(pair[0], 10), _cohort(pair[1], 11)
    got, want = survival.logrank_test(ta, ea, tb, eb), jax_survival.logrank_test(ta, ea, tb, eb)
    for g, w in zip(got, want):
        assert _close(g, w), (got, want)


@pytest.mark.parametrize("n", [3, 60])
def test_umap_embed_matches_jax(n):
    """n = 3: the PCA branch (too few rows for a neighbor graph); n = 60
    x 20 in three clusters: the UMAP layout, seed 0."""
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=4.0, size=(3, 20))
    x = centers[np.arange(n) % 3] + rng.normal(size=(n, 20))
    got, want = embedding.umap_embed(x, seed=0), jax_embedding.umap_embed(x, seed=0)
    assert got.shape == (n, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)


@pytest.mark.parametrize("rows", [(2, 1), (24, 36)])
def test_embed_2d_matches_jax(rows):
    rng = np.random.default_rng(rows[0])
    real = rng.normal(size=(rows[0], 12))
    synth = rng.normal(loc=0.3, size=(rows[1], 12))
    got, want = report.embed_2d(real, synth), jax_report.embed_2d(real, synth)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=EMBED_TOL)
    assert got[0].shape == (rows[0], 2) and got[1].shape == (rows[1], 2)


@pytest.mark.parametrize("score", [0.0, 0.6999, 0.70, 0.8499, 0.85, 1.0])
def test_grade_matches_jax(score):
    assert report.grade(score) == jax_report.grade(score)
    assert (report.PASS_THRESHOLD, report.REVIEW_THRESHOLD) == (
        jax_report.PASS_THRESHOLD, jax_report.REVIEW_THRESHOLD)


_BASE = {"overall_biological_score": 0.8734, "mmd": 0.0612,
         "cooccurrence_pattern_correlation": 0.91, "mutation_frequency_correlation": 0.98,
         "n_tests": 12, "passed": True}
RESULTS = {
    "without_novelty": dict(_BASE),
    "without_overall": {"mmd": 0.2, "expression_mean_correlation": 0.5},
    "novel": {**_BASE, "nn_distance_ratio": 0.83, "exact_duplicate_rate": 0.0},
    "review": {**_BASE, "nn_distance_ratio": 0.41},
    "memorized_q05": {**_BASE, "nn_distance_ratio": 0.9, "exact_duplicate_rate": 0.0,
                      "nn_loo_ratio_q05": 0.05, "nn_loo_ratio_q05_floor": 0.4},
    "duplicates": {**_BASE, "nn_distance_ratio": 0.9, "exact_duplicate_rate": 0.02,
                   "nn_loo_ratio_q05": 0.3, "nn_loo_ratio_q05_floor": 0.4},
    "nan": {**_BASE, "mmd": float("nan")},
}


@pytest.mark.parametrize("name", list(RESULTS))
def test_summary_report_is_byte_equal(name, tmp_path):
    results = RESULTS[name]
    assert report.novelty_verdict(results) == jax_report.novelty_verdict(results)
    text = report.write_summary_report(results, tmp_path / "port" / "summary_report.txt")
    jax_text = jax_report.write_summary_report(results, tmp_path / "jax" / "summary_report.txt")
    assert text == jax_text
    assert ((tmp_path / "port" / "summary_report.txt").read_bytes()
            == (tmp_path / "jax" / "summary_report.txt").read_bytes())


@pytest.mark.parametrize("real_cols,synth_cols", [
    (["b", "a", "c", "d"], ["d", "c", "a", "z"]),
    (["b", "a", "b", "c"], ["c", "a", "b"]),  # a repeated name in the first table
    (["a", "b"], ["b", "a", "b"]),  # and in the second
    (["x"], ["y"]),
])
def test_column_choice_is_pandas(real_cols, synth_cols):
    """``Index.intersection`` (caller's order, each name once) and
    ``frame[names]`` (every column of a name) on both tables."""
    rng = np.random.default_rng(3)
    real = rng.normal(size=(4, len(real_cols)))
    synth = rng.normal(size=(5, len(synth_cols)))
    rf, sf = pd.DataFrame(real, columns=real_cols), pd.DataFrame(synth, columns=synth_cols)
    common = rf.columns.intersection(sf.columns)
    names = report.common_columns(real_cols, synth_cols)
    assert names == list(common)
    np.testing.assert_array_equal(report.select(Matrix(real, real_cols), names),
                                  rf[common].values)
    np.testing.assert_array_equal(report.select(Matrix(synth, synth_cols), names),
                                  sf[common].values)


def test_analysis_exports_match_jax():
    import osteosarcoma_diffusionmodel_torch.analysis as port_analysis
    import osteosarcoma_diffusionmodel_tpu.analysis as jax_analysis

    assert port_analysis.__all__ == jax_analysis.__all__
    assert report.__all__ == jax_report.__all__
