"""The port's quality protocols at tiny size on the CPU against the JAX
scripts they stand for.

- scripts/demo_full_scale_torch.py: the record's keys are those of
  DEMO_FULL_SCALE.json, plus ``demo_seed`` (which the JAX script has written
  since that record) and ``device`` (the port's stamp in place of
  ``platform``); the ``DEMO_*`` knobs set what the JAX script sets.
- scripts/demo_held_out_torch.py: the keys of DEMO_HELD_OUT.json plus
  ``device``; the fit and holdout tables equal those of the JAX
  ``_split_csvs`` (loaded from scripts/demo_held_out.py) on the same cohort;
  the real-vs-real floor equals the JAX validator's on the same halves
  within tests/test_torch_validator.py's 1e-4.
- scripts/replay_calibration_torch.py on the full-scale run's
  ``OSDM_DUMP_RAW`` dump: every metric equals the one the JAX
  scripts/replay_calibration.py prints for the same dump and work
  directory, to its printed three decimals (|diff| <= 6e-4). Both run the
  same float64 numpy copula with the same seeds (the port's host
  calibration equals JAX's bit for bit, tests/test_torch_generator.py), so
  no draw needs injecting.

Every run: 10/40/14 features, 2 epochs, DDIM over 3 steps, 30 patients,
``--device cpu``.
"""

import ast
import importlib.util
import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv
from osteosarcoma_diffusionmodel_torch.utils.quality import apply_demo_knobs, apply_gate

REPO = Path(__file__).resolve().parent.parent
DIMS = (10, 40, 14)
TINY = {"dims": DIMS, "epochs": 2, "synthetic": 30, "ddim_steps": 3}
MODES = ["copula_joint", "copula_full", "quantile"]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_scale(tmp_path_factory, threads):
    """The full-scale protocol with the raw cohort dumped."""
    work = tmp_path_factory.mktemp("full_scale")
    mp = pytest.MonkeyPatch()
    mp.setenv("OSDM_DUMP_RAW", str(work / "raw.npz"))
    try:
        out = _script("demo_full_scale_torch").run(work, "cpu", n_samples=24, env={}, **TINY)
    finally:
        mp.undo()
    return work, out


def test_full_scale_record(full_scale):
    work, out = full_scale
    ref = json.loads((REPO / "DEMO_FULL_SCALE.json").read_text())
    assert set(out) == set(ref) | {"demo_seed", "device"}
    assert set(out["validation"]) >= {"overall_biological_score", "mmd",
                                      "cooccurrence_pattern_correlation", "nn_distance_ratio"}
    assert all(math.isfinite(v) for v in out["validation"].values())
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "nvidia_smi": None,
                             "torch": torch.__version__}
    assert out["n_samples"] == 24 and out["demo_seed"] == 0 and out["train_epochs"] == 2
    assert out["patients_per_sec_e2e"] == pytest.approx(30 / out["generate_10k_sec"])
    assert sorted(p.name for p in (work / "results" / "synthetic").iterdir()) == sorted(
        s.name for s in Config().generation.scenarios)
    n_pathways = len(read_matrix_csv(work / "processed" / "pathway_scores.csv").columns)
    with np.load(work / "raw.npz") as f:  # one batched cohort, dumped once
        assert f["samples"].shape == (30, DIMS[0] + DIMS[1] + n_pathways)
        assert f["conditions"].shape == (30, 3)
    assert not (work / "raw_s1.npz").exists()


def test_demo_main_refuses_without_a_card(monkeypatch):
    """Each script raises before any work when no card is present and
    ``--device cpu`` is not given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("demo_full_scale_torch", []), ("demo_held_out_torch", []),
                       ("replay_calibration_torch", ["raw.npz", "work"])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            _script(name).main(argv)


@pytest.mark.parametrize("env,field,value", [
    ({"DEMO_CALIBRATE": "false"}, "generation.calibrate_marginals", False),
    ({"DEMO_CALIBRATE": "quantile"}, "generation.calibrate_marginals", "quantile"),
    ({"DEMO_PARAM": "v"}, "model.diffusion.parameterization", "v"),
    ({"DEMO_LEARN_SIGMA": "1"}, "model.diffusion.learn_sigma", True),
    ({"DEMO_DISCRETE": "1"}, "model.diffusion.discrete_mutation_head", True),
    ({"DEMO_LATENT_K": "8"}, "model.diffusion.latent_factor_dim", 8),
    ({"DEMO_LATENT_INPUT": "mutations"}, "model.diffusion.latent_encoder_input", "mutations"),
    ({"DEMO_LOWRANK_K": "8"}, "model.diffusion.low_rank_sigma_dim", 8),
    ({"DEMO_LOWRANK_SCOPE": "mutations"}, "model.diffusion.low_rank_sigma_scope", "mutations"),
    ({"DEMO_AR": "1"}, "model.diffusion.ar_mutation_head", True),
    ({"DEMO_AR": "0"}, "model.diffusion.ar_mutation_head", False),  # env_flag
    ({"DEMO_AR_CONTEXT": "none"}, "model.diffusion.ar_context", "none"),
    ({"DEMO_AR_LR": "0.5"}, "model.diffusion.ar_lr", 0.5),
    ({"DEMO_AR_L2": "0.25"}, "model.diffusion.ar_l2", 0.25),
    ({"DEMO_AR_CTX_L2": "0.125"}, "model.diffusion.ar_ctx_l2", 0.125),
    ({"DEMO_FINETUNE": "1"}, "training.sample_path_finetune.steps", 300),
    ({"DEMO_FINETUNE": "1", "DEMO_FT_STEPS": "7"}, "training.sample_path_finetune.steps", 7),
    ({"DEMO_SAMPLER": "ddim"}, "generation.sampler", "ddim"),
    ({"DEMO_BLOCK": "25"}, "training.epochs_per_dispatch", 25),
    ({"DEMO_SAMPLING_STEPS": "20"}, "generation.sampling_steps", 20),
])
def test_demo_knobs(env, field, value):
    """Each knob sets the field scripts/demo_full_scale.py sets; no other
    field moves."""
    cfg = apply_demo_knobs(Config(), env)
    node = cfg
    for name in field.split("."):
        node = getattr(node, name)
    assert node == value
    base, got = Config().to_dict(), cfg.to_dict()
    changed = {f"{s}.{k}" for s in base for k in base[s] if base[s][k] != got[s][k]}
    assert changed <= {field, "model.diffusion", "training.sample_path_finetune"}
    if "DEMO_FINETUNE" in env:
        assert cfg.training.sample_path_finetune.enabled


def test_gate(capsys):
    assert apply_gate({"overall_biological_score": 0.85, "mmd": 0.1499}) == 0
    assert "QUALITY GATE PASSED: overall=0.8500 mmd=0.1499" in capsys.readouterr().out
    assert apply_gate({"overall_biological_score": 0.8499, "mmd": 0.15}) == 1
    assert capsys.readouterr().out.startswith("QUALITY GATE FAILED: overall_biological_score")


# ----------------------------------------------------------------------
# Held-out protocol
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def held_out(tmp_path_factory, threads):
    work = tmp_path_factory.mktemp("held_out")
    return work, _script("demo_held_out_torch").run(work, "cpu", n_half=12, env={}, **TINY)


def test_held_out_record(held_out):
    _, out = held_out
    ref = json.loads((REPO / "DEMO_HELD_OUT.json").read_text())
    assert set(out) == set(ref) | {"device"}
    assert out["split"] == {"fit": 12, "holdout": 12} and out["n_per_half"] == 12
    for key in ("validation_vs_fit", "validation_vs_holdout", "real_vs_real_floor"):
        assert {"overall_biological_score", "mmd", "nn_distance_ratio"} <= set(out[key])
        assert all(math.isfinite(v) for v in out[key].values())
    assert out["validation_vs_fit"] != out["validation_vs_holdout"]


def test_held_out_split_matches_jax(held_out, tmp_path):
    """The JAX ``_split_csvs`` on the same full cohort gives the same rows,
    ids, columns and values in each half."""
    work, _ = held_out
    jax_script = _script("demo_held_out")
    assert jax_script._split_csvs(work / "full", tmp_path / "fit", tmp_path / "holdout") == (12, 12)
    for half in ("fit", "holdout"):
        for name in ("mutation_matrix_aligned", "expression_matrix_aligned", "clinical_aligned"):
            ref = pd.read_csv(tmp_path / half / f"{name}.csv", index_col=0)
            got = read_matrix_csv(work / half / f"{name}.csv")
            assert got.index == [str(i) for i in ref.index]
            assert got.columns == list(ref.columns)
            assert got.index_name == (ref.index.name or "")
            # pandas' default float parser may land one ulp off a correctly
            # rounded parse (the clinical ages), hence rtol 1e-15.
            np.testing.assert_allclose(got.values, ref.values.astype(np.float64), rtol=1e-15,
                                       atol=0)


def test_held_out_floor_matches_jax(held_out):
    """The real-vs-real floor against JAX ``validate_all`` on the same two
    halves (the fit half as synthetic)."""
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_tpu.validation.validator import (
        BiologicalValidator as JaxValidator,
    )

    work, out = held_out
    read = lambda half, name: pd.read_csv(work / half / f"{name}.csv", index_col=0)  # noqa: E731
    ref = JaxValidator(JaxConfig()).validate_all(
        real_mutations=read("holdout", "mutation_matrix_aligned"),
        real_expression=read("holdout", "expression_matrix_aligned"),
        real_pathways=read("holdout", "pathway_scores"),
        synth_mutations=read("fit", "mutation_matrix_aligned"),
        synth_expression=read("fit", "expression_matrix_aligned"),
        synth_pathways=read("fit", "pathway_scores"),
        pathway_gene_matrix=read("holdout", "gene_pathway_matrix"))
    assert set(out["real_vs_real_floor"]) == set(ref)
    for key, value in ref.items():
        assert out["real_vs_real_floor"][key] == pytest.approx(float(value), abs=1e-4), key


# ----------------------------------------------------------------------
# Calibration replay
# ----------------------------------------------------------------------
LINE = re.compile(r"\[(\S+)\] coherence synth=(\S+) \(real (\S+)\) pattern_corr=(\S+) "
                  r"cooc=(\S+) rules=(\{.*\}) \(")


def test_replay_matches_jax(full_scale, capsys, monkeypatch):
    work, _ = full_scale
    monkeypatch.delenv("OSDM_DUMP_RAW", raising=False)
    replay = _script("replay_calibration_torch")
    got = dict(replay.replay(work / "raw.npz", work, MODES, "cpu"))
    monkeypatch.setattr(sys, "argv", ["replay_calibration.py", str(work / "raw.npz"), str(work),
                                      *MODES])
    capsys.readouterr()
    _script("replay_calibration").main()
    printed = [LINE.match(line) for line in capsys.readouterr().out.splitlines()]
    ref = {m.group(1): m for m in printed if m}
    assert list(ref) == MODES
    for mode in MODES:
        r, m = got[mode], ref[mode]
        for key, group in (("coherence_synthetic", 2), ("coherence_real", 3),
                           ("coherence_pattern_corr", 4), ("cooccurrence_pattern_corr", 5)):
            assert abs(r[key] - float(m.group(group))) <= 6e-4, (mode, key)
        assert r["rules"] == ast.literal_eval(m.group(6)), mode
        assert LINE.match(replay.line(mode, r)).group(1) == mode
    assert got["copula_joint"]["rows"] == 30
