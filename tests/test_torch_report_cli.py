"""The port's report and doctor steps against the JAX CLI's on the same
directories.

One seeded processed directory (a repeated expression gene name among its
columns, which ``read_csv`` reads back as ``X`` and ``X.1``) and synthetic
tables in the JAX layout for two of the three scenarios, all written with
numpy, no training. The JAX ``analysis_report`` and the port's, each into
its own results and figures directory, must give the same
``summary_report.txt`` bytes, the same figure files, an equal returned
dict (types included) and the same inputs to the embedding and the
Kaplan-Meier figure; ``doctor`` must return the JAX dict in every case.
"""

import numpy as np
import pandas as pd
import pytest
import yaml

from osteosarcoma_diffusionmodel_tpu import cli as jax_cli
from osteosarcoma_diffusionmodel_tpu.analysis import report as jax_report
from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.analysis import report as port_report
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort, write_processed
from osteosarcoma_diffusionmodel_torch.training.checkpoint import save_metadata
from osteosarcoma_diffusionmodel_torch.utils.io import write_matrix_csv

SYNTH_ROWS = 6
FIGURES = {"mutation_frequency_scatter.png", "driver_gene_frequencies.png",
           "pathway_histograms.png", "cohort_embedding.png", "kaplan_meier.png",
           "validation_metrics.png"}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """processed/ (18 patients, 10/24/8, expression column 5 named as
    column 3), synthetic/ for the first two scenarios (columns reordered,
    one gene absent and one unknown to the real table), and
    validation_results.csv in the layout ``DataFrame.to_csv`` writes."""
    root = tmp_path_factory.mktemp("report")
    cohort = make_dummy_cohort(18, 10, 24, 8, seed=0)
    cohort.expression_genes[5] = cohort.expression_genes[3]
    write_processed(cohort, root / "processed")
    # Survival as float text, one event missing (pandas: NaN, read as True).
    clinical = pd.read_csv(root / "processed" / "clinical_aligned.csv")
    clinical["survival_days"] = clinical["survival_days"].astype(float)
    clinical["event_occurred"] = clinical["event_occurred"].astype(object)
    clinical.loc[2, "event_occurred"] = None
    clinical.to_csv(root / "processed" / "clinical_aligned.csv", index=False)

    expr_names = list(pd.read_csv(root / "processed" / "expression_matrix_aligned.csv",
                                  index_col=0, nrows=0).columns)
    assert expr_names[3] + ".1" in expr_names
    rng = np.random.default_rng(1)
    synth_expr = expr_names[::-1][1:] + ["NOT_IN_REAL"]
    scenarios = Config().generation.scenarios
    for scenario in scenarios[:2]:
        out = root / "synthetic" / scenario.name
        out.mkdir(parents=True)
        tables = {
            "mutations": ((rng.random((SYNTH_ROWS, 10)) < 0.3).astype(float),
                          cohort.mutation_genes),
            "expression": (rng.normal(size=(SYNTH_ROWS, len(synth_expr))), synth_expr),
            "pathways": (rng.normal(size=(SYNTH_ROWS, 8)), cohort.pathway_names),
            "conditions": (rng.normal(size=(SYNTH_ROWS, 3)), ["a", "b", "c"]),
        }
        for key, (values, columns) in tables.items():
            write_matrix_csv(out / f"{scenario.name}_{key}.csv", values, columns)
    results = {"overall_biological_score": 0.7731, "mmd": 0.0812345678901234,
               "cooccurrence_pattern_correlation": 0.6, "nn_distance_ratio": 0.44,
               "exact_duplicate_rate": 0.0, "n_tests": 12, "gate_passed": False}
    for pkg in ("jax", "port"):
        (root / f"results_{pkg}").mkdir()
        pd.DataFrame([results]).to_csv(root / f"results_{pkg}" / "validation_results.csv",
                                       index=False)
    return root, cohort


def _configs(root, pkg: str, save_dir=None, processed="processed", scenarios=None):
    """The same YAML loaded by both packages' Config."""
    raw = {
        "data": {"processed_dir": str(root / processed)},
        "training": {"save_dir": str(save_dir or root / "no_checkpoint")},
        "output": {"results_dir": str(root / f"results_{pkg}"),
                   "figures_dir": str(root / f"figures_{pkg}"),
                   "synthetic_data_dir": str(root / "synthetic")},
    }
    if scenarios is not None:
        raw["generation"] = {"scenarios": scenarios}
    path = root / f"config_{pkg}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return Config.from_yaml(path), JaxConfig.from_yaml(path), path


def _spy(monkeypatch, cls, calls):
    """Record the embedding's and the Kaplan-Meier figure's inputs."""
    embed, km = cls.embedding_plot, cls.km_curves

    def embedding_plot(self, real, synthetic):
        calls["embed"] = (np.array(real), np.array(synthetic))
        return embed(self, real, synthetic)

    def km_curves(self, scenario_survival):
        calls["km"] = {k: (np.asarray(t, float), np.asarray(e).astype(bool))
                       for k, (t, e) in scenario_survival.items()}
        return km(self, scenario_survival)

    monkeypatch.setattr(cls, "embedding_plot", embedding_plot)
    monkeypatch.setattr(cls, "km_curves", km_curves)


def test_report_matches_jax(workspace, monkeypatch):
    root, _ = workspace
    port_cfg, _, _ = _configs(root, "port")
    _, jax_cfg, _ = _configs(root, "jax")
    port_calls, jax_calls = {}, {}
    _spy(monkeypatch, port_report.AnalysisReport, port_calls)
    _spy(monkeypatch, jax_report.AnalysisReport, jax_calls)

    got = cli.analysis_report(port_cfg)
    want = jax_cli.analysis_report(jax_cfg)

    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert ((root / "results_port" / "summary_report.txt").read_bytes()
            == (root / "results_jax" / "summary_report.txt").read_bytes())
    port_figures = {p.name for p in (root / "figures_port").iterdir()}
    assert port_figures == {p.name for p in (root / "figures_jax").iterdir()} == FIGURES
    # The embedding's columns: the real table's order, the repeated name's
    # columns both, the gene the synthetic tables lack left out.
    for g, w in zip(port_calls["embed"], jax_calls["embed"]):
        np.testing.assert_array_equal(g, w)
    assert port_calls["embed"][0].shape == (18, 23)
    assert port_calls["embed"][1].shape == (2 * SYNTH_ROWS, 23)
    assert list(port_calls["km"]) == list(jax_calls["km"]) == ["real_cohort"] + [
        s.name for s in Config().generation.scenarios[:2]]
    for name, (t, e) in port_calls["km"].items():
        np.testing.assert_array_equal(t, jax_calls["km"][name][0])
        np.testing.assert_array_equal(e, jax_calls["km"][name][1])


def test_report_common_columns_are_jax_columns(workspace):
    """The expression columns the port chooses are the names pandas
    chooses, in pandas' order."""
    root, _ = workspace
    real = pd.read_csv(root / "processed" / "expression_matrix_aligned.csv", index_col=0)
    synth = pd.concat([pd.read_csv(p) for p in sorted((root / "synthetic").rglob(
        "*_expression.csv"))], ignore_index=True)
    want = list(real.columns.intersection(synth.columns))
    assert port_report.common_columns(list(real.columns), list(synth.columns)) == want


def test_report_without_synthetic_data_raises_as_jax(workspace, tmp_path):
    root, _ = workspace
    port_cfg, jax_cfg, _ = _configs(root, "port")
    for cfg in (port_cfg, jax_cfg):
        cfg.output.synthetic_data_dir = str(tmp_path / "none")
    for fn, cfg in ((cli.analysis_report, port_cfg), (jax_cli.analysis_report, jax_cfg)):
        with pytest.raises(FileNotFoundError, match="run generate first"):
            fn(cfg)


def _metadata(root, cohort, name: str, expression_extra: int = 0):
    save_dir = root / name
    cfg = Config()
    dims = cfg.freeze_dims(len(cohort.mutation_genes),
                           len(cohort.expression_genes) + expression_extra,
                           len(cohort.pathway_names),
                           ["survival_days_norm", "event_occurred", "metastasis_at_diagnosis"])
    save_metadata(save_dir, cfg, dims)
    return save_dir


DOCTOR_CASES = ["all_ok", "dims_mismatch", "no_metadata", "unknown_condition", "no_data"]


@pytest.mark.parametrize("case", DOCTOR_CASES)
def test_doctor_matches_jax(workspace, case):
    root, cohort = workspace
    save_dir, scenarios, processed = None, None, "processed"
    if case in ("all_ok", "unknown_condition", "no_data"):
        save_dir = _metadata(root, cohort, "ckpt_ok")
    elif case == "dims_mismatch":
        save_dir = _metadata(root, cohort, "ckpt_mismatch", expression_extra=1)
    if case == "unknown_condition":
        scenarios = [{"name": "typical", "conditions": {"survival_time": 800}},
                     {"name": "staged", "conditions": {"stage": 3, "age": 12}}]
    if case == "no_data":
        processed = "missing_processed"
    port_cfg, jax_cfg, _ = _configs(root, "port", save_dir, processed, scenarios)
    got, want = cli.doctor(port_cfg), jax_cli.doctor(jax_cfg)
    assert got == want
    assert list(got) == list(want)
    if case == "all_ok":
        assert all(v.startswith("OK") for v in got.values()), got
        assert set(got) == {"data", "conditions", "checkpoint", "checkpoint_vs_data"}
    if case == "no_data":
        assert got["data"].startswith("MISSING [Errno 2]")


def test_cli_steps_report_doctor(workspace, capsys):
    """``--steps report doctor`` runs on the host (no --device), and the two
    steps stay outside ``all``."""
    root, cohort = workspace
    save_dir = _metadata(root, cohort, "ckpt_ok")
    _, _, path = _configs(root, "port", save_dir)
    summary = root / "results_port" / "summary_report.txt"
    summary.unlink(missing_ok=True)
    cli.main(["--config", str(path), "--steps", "report", "doctor"])
    assert summary.read_text().startswith("SYNTHETIC PATIENT VALIDATION SUMMARY")
    assert "report" not in cli.ALL_STEPS and "doctor" not in cli.ALL_STEPS
    assert set(cli.HOST_STEPS) >= {"report", "doctor"}
    assert list(cli.ALL_STEPS) == jax_cli.ALL_STEPS
