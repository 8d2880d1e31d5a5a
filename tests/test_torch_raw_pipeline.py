"""The port's CLI from raw files on the CPU: ``--steps preprocess pathways
train generate validate --device cpu`` on a raw TARGET-OS-layout fixture
(tests/test_torch_preprocess.py's), with cross-cancer pretraining on a
local processed directory and on a GDC project id whose raw files sit
under ``data_dir/pretrain/<project>/raw``, and sample-path fine-tuning on;
then ``--resume-training``; and the step order of ``all``, the default.
"""

import math

import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort, write_processed
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv
from test_torch_preprocess import _clinical, _maf, _star


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _raw(root, seed):
    _maf(root)
    _star(root, "names", np.random.default_rng(seed), gap=False)
    _clinical(root, "names")


def _config(tmp_path):
    _raw(tmp_path / "data" / "raw", 4)
    _raw(tmp_path / "data" / "pretrain" / "TARGET-TEST" / "raw", 5)
    write_processed(make_dummy_cohort(24, 5, 30, 4, seed=2), tmp_path / "local_cohort")
    raw = {
        "data": {"data_dir": str(tmp_path / "data"), "raw_dir": str(tmp_path / "data" / "raw"),
                 "processed_dir": str(tmp_path / "data" / "processed")},
        "model": {"hidden_dims": [32, 64, 32], "latent_dim": 16, "compute_dtype": "float32",
                  "diffusion": {"num_steps": 8}},
        "training": {
            "save_dir": str(tmp_path / "ckpt"), "num_epochs": 2, "pretrain_epochs": 2,
            "batch_size": 4, "save_frequency": 1,
            "augmentation": {"cross_cancer_pretrain": True,
                             "pretrain_datasets": [str(tmp_path / "local_cohort"),
                                                   "TARGET-TEST", "TARGET-NO-RAW"]},
            "sample_path_finetune": {"enabled": True, "steps": 2, "sample_batch": 8},
        },
        "generation": {"num_synthetic_samples": 30, "sampler": "ddim", "sampling_steps": 4},
        "output": {"results_dir": str(tmp_path / "results"),
                   "synthetic_data_dir": str(tmp_path / "synthetic")},
    }
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def test_cli_runs_from_raw_files_on_cpu(tmp_path, caplog):
    path = _config(tmp_path)
    cli.main(["--config", str(path), "--steps", "preprocess", "pathways", "train", "generate",
              "validate", "--device", "cpu"])
    processed = tmp_path / "data" / "processed"
    for name in ("mutation_matrix.csv", "expression_matrix.csv", "clinical.csv",
                 "mutation_matrix_aligned.csv", "expression_matrix_aligned.csv",
                 "clinical_aligned.csv", "pathway_scores.csv", "pathway_mutation_scores.csv",
                 "gene_pathway_matrix.csv"):
        assert (processed / name).exists(), name
    pre = tmp_path / "data" / "pretrain" / "TARGET-TEST" / "processed"
    assert (pre / "mutation_matrix_aligned.csv").exists()
    assert any("TARGET-NO-RAW has no raw data" in r.getMessage() for r in caplog.records)

    expr = read_matrix_csv(processed / "expression_matrix_aligned.csv")
    meta = ckpt.load_metadata(tmp_path / "ckpt")
    dims = ckpt.metadata_to_dims(meta)
    assert dims.expression_dim == len(expr.columns) and dims.mutation_dim == 3
    assert (tmp_path / "ckpt" / "pretrain" / "best_model.npz").exists()
    before = ckpt.load_weights(tmp_path / "ckpt", "best_model_prefinetune")
    after = ckpt.load_weights(tmp_path / "ckpt")
    assert any(not torch.equal(before[k], after[k]) for k in before)

    results = np.genfromtxt(tmp_path / "results" / "validation_results.csv", delimiter=",",
                            names=True)
    assert math.isfinite(float(results["overall_biological_score"]))
    assert "synthetic_pathway_coherence" in results.dtype.names  # the matrix was read
    mut = read_matrix_csv(tmp_path / "synthetic" / "typical_patient" /
                          "typical_patient_mutations.csv", index_col=None)
    assert mut.values.shape == (10, 3) and np.isin(mut.values, (0.0, 1.0)).all()

    # --resume-training, the JAX flag, resumes from the latest checkpoint.
    raw = yaml.safe_load(path.read_text())
    raw["training"]["num_epochs"] = 3
    raw["training"]["augmentation"]["cross_cancer_pretrain"] = False
    raw["training"]["sample_path_finetune"]["enabled"] = False
    path.write_text(yaml.safe_dump(raw))
    cli.main(["--config", str(path), "--steps", "train", "--resume-training", "--device", "cpu"])
    history = np.genfromtxt(tmp_path / "results" / "training_history.csv", delimiter=",",
                            names=True)
    assert history.shape == ()  # epoch 2 alone: one row


def test_all_is_the_jax_step_order(tmp_path, monkeypatch):
    """No ``--steps``: ``all``, i.e. download, preprocess, pathways, train,
    generate, validate, in that order; the host steps get no device."""
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({}))
    ran = []
    for name in ("download", "preprocess", "pathways"):
        monkeypatch.setitem(cli.STEP_FUNCTIONS, name, lambda cfg, n=name: ran.append((n, None)))
    monkeypatch.setitem(cli.STEP_FUNCTIONS, "generate", lambda cfg, device, profile: ran.append(
        ("generate", device) if not profile else ("generate profiled", device)))
    monkeypatch.setitem(cli.STEP_FUNCTIONS, "validate",
                        lambda cfg, device: ran.append(("validate", device)))
    monkeypatch.setattr(cli, "train_model", lambda cfg, device, resume, profile: ran.append(
        ("train", device) if not profile else ("train profiled", device)))
    cli.main(["--config", str(path), "--device", "cpu"])
    assert ran == [("download", None), ("preprocess", None), ("pathways", None),
                   ("train", "cpu"), ("generate", "cpu"), ("validate", "cpu")]
    assert cli.ALL_STEPS == ("download", "preprocess", "pathways", "train", "generate",
                             "validate")


@pytest.mark.parametrize("name", ["config.yaml", "production.yaml"])
def test_config_keys_match_jax_and_round_trip(name, tmp_path):
    """The data section, ``pretrain_epochs`` and the fine-tuning section
    load from the shipped YAML as in the JAX package, with its defaults,
    and survive ``metadata.json``."""
    from pathlib import Path

    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_torch.config import Config

    path = Path(__file__).resolve().parent.parent / "config" / name
    port, want = Config.from_yaml(path), JaxConfig.from_yaml(path)
    for key in ("gdc_project", "data_dir", "raw_dir", "processed_dir", "min_samples_per_gene",
                "min_var_expression", "pathway_database"):
        assert getattr(port.data, key) == getattr(want.data, key), key
    for key in ("mutations", "rna_seq", "clinical", "copy_number"):
        assert getattr(port.data.download, key) == getattr(want.data.download, key), key
    assert port.training.pretrain_epochs == want.training.pretrain_epochs
    for key in ("enabled", "steps", "ddim_steps", "sample_batch", "learning_rate", "soft_tau",
                "cooccurrence_weight", "anchor_weight"):
        assert (getattr(port.training.sample_path_finetune, key)
                == getattr(want.training.sample_path_finetune, key)), key
    port.data.download.copy_number = True
    port.training.sample_path_finetune.steps = 7
    dims = port.freeze_dims(2, 3, 1, ["a"])
    ckpt.save_metadata(tmp_path, port, dims)
    back = Config.from_dict(ckpt.load_metadata(tmp_path)["config"])
    assert back.data == port.data and back.training == port.training
