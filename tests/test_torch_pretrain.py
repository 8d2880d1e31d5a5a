"""Cross-cancer pretraining in the port: ``load_pretrain_arrays`` against
the JAX package's on the cohorts of tests/test_pretrain.py, and the CLI's
STEP 4a (the main training starts from the pre-trainer's final weights,
with a fresh optimizer).

Tiny cohorts (30 primary patients at 8/32/4; pretraining cohorts of 24
and 18), written once with pandas and read by both packages.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data import dataset as jdata
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data import dataset as pdata
from osteosarcoma_diffusionmodel_torch.training import trainer as trainer_module
from test_pretrain import _write_pretrain_cohort


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _configs(tmp_path, entries):
    out = []
    for cfg in (JaxConfig(), Config()):
        cfg.data.data_dir = str(tmp_path / "data")
        cfg.data.processed_dir = str(tmp_path / "processed")
        cfg.training.augmentation.cross_cancer_pretrain = True
        cfg.training.augmentation.pretrain_datasets = list(entries)
        out.append(cfg)
    return out


def _second_cohort(d):
    """18 patients: other genes, a pathway table with one primary pathway,
    one unknown pathway and one of them missing, no age column."""
    _write_pretrain_cohort(d, n=18, genes=("RB1", "ATRX", "OTHERMUT"),
                           expr_genes=("MDM2", "CDKN1A", "TP53", "ZZZ"))
    ids = list(pd.read_csv(d / "clinical_aligned.csv")["submitter_id"])
    rng = np.random.default_rng(9)
    clin = pd.read_csv(d / "clinical_aligned.csv").drop(columns=["age_years"])
    clin.to_csv(d / "clinical_aligned.csv", index=False)
    pd.DataFrame(rng.normal(size=(18, 2)), index=ids,
                 columns=["HALLMARK_P53_PATHWAY", "NOT_A_PATHWAY"]).to_csv(d / "pathway_scores.csv")


@pytest.fixture()
def cohorts(tmp_path):
    jdata.make_dummy_data(tmp_path / "processed", n_samples=30, n_mutation_genes=8,
                          n_expression_genes=32, n_pathways=4)
    _write_pretrain_cohort(tmp_path / "pre_a")
    _second_cohort(tmp_path / "pre_b")
    return tmp_path


@pytest.mark.parametrize("entries", [["pre_a"], ["pre_a", "pre_b"], ["pre_b", "missing"]])
def test_load_pretrain_arrays_matches_jax(cohorts, entries):
    """Absent genes zero-filled, unknown columns dropped, the missing
    pathway file computed from the aligned expression, the missing
    condition column 0.0, cohorts pooled in order; arrays within 1e-6,
    ids, order and survival statistics equal."""
    paths = [str(cohorts / e) for e in entries]
    jcfg, pcfg = _configs(cohorts, paths)
    jprimary, _ = jdata.prepare_arrays(jcfg)
    pprimary, _ = pdata.prepare_arrays(pcfg)
    want = jdata.load_pretrain_arrays(jcfg, jprimary)
    got = pdata.load_pretrain_arrays(pcfg, pprimary)
    assert got.sample_ids == want.sample_ids
    assert got.sample_ids[0].startswith(paths[0] + ":")
    for name in ("mutation_genes", "expression_genes", "pathway_names", "condition_names"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("data", "conditions", "survival"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        assert getattr(got, name).dtype == np.float32
    assert got.survival_mean == pytest.approx(want.survival_mean, rel=1e-6)
    assert got.survival_std == pytest.approx(want.survival_std, rel=1e-6)
    assert "metastasis_at_diagnosis" in got.condition_names
    meta = got.condition_names.index("metastasis_at_diagnosis")
    assert (got.conditions[:, meta] == 0).all()


def test_load_pretrain_arrays_off_or_missing(cohorts):
    _, pcfg = _configs(cohorts, ["TCGA-DOES-NOT-EXIST"])
    primary, _ = pdata.prepare_arrays(pcfg)
    assert pdata.resolve_pretrain_dir("TCGA-DOES-NOT-EXIST", pcfg) == (
        cohorts / "data" / "pretrain" / "TCGA-DOES-NOT-EXIST" / "processed")
    assert pdata.load_pretrain_arrays(pcfg, primary) is None  # nothing usable
    pcfg.training.augmentation.cross_cancer_pretrain = False
    pcfg.training.augmentation.pretrain_datasets = [str(cohorts / "pre_a")]
    assert pdata.load_pretrain_arrays(pcfg, primary) is None  # flag off


@pytest.mark.parametrize("arch", ["diffusion", "cvae"])
def test_cli_pretrains_then_trains_from_final_weights(cohorts, monkeypatch, arch):
    """STEP 4a: ``save_dir/pretrain`` written by a pre-trainer of
    ``pretrain_epochs`` epochs; the main training's first step starts from
    the pre-trainer's final weights (BatchNorm statistics included), not
    its initial or best ones, with a fresh AdamW."""
    _, cfg = _configs(cohorts, [str(cohorts / "pre_a")])
    cfg.model.architecture = arch
    cfg.model.hidden_dims = [32, 64, 32]
    cfg.model.latent_dim = 16
    cfg.model.diffusion.num_steps = 8
    cfg.model.compute_dtype = "float32"
    cfg.training.num_epochs, cfg.training.pretrain_epochs = 2, 3
    cfg.training.batch_size = 8
    cfg.training.save_dir = str(cohorts / "ckpt")
    cfg.output.results_dir = str(cohorts / "results")

    seen = []
    original = trainer_module.Trainer.train

    def spy(self, resume=False):
        def state():
            return {k: v.detach().clone() for k, v in self.module.state_dict().items()}
        entry = {"save_dir": self.save_dir, "state": state(),
                 "fresh": all(not o.state for o in self.optimizers)}
        log = original(self, resume)
        entry["final"] = state()
        seen.append(entry)
        return log

    monkeypatch.setattr(trainer_module.Trainer, "train", spy)
    history = cli.train_model(cfg, device="cpu")
    pre, main = seen
    assert pre["save_dir"].endswith("pretrain") and main["save_dir"] == cfg.training.save_dir
    assert (cohorts / "ckpt" / "pretrain" / "best_model.npz").exists()
    assert (cohorts / "ckpt" / "pretrain" / "metadata.json").exists()
    assert len(history.pretrain.train_loss) == 3 and len(history.train_loss) == 2
    assert main["fresh"]
    for key, value in pre["final"].items():
        assert torch.equal(main["state"][key], value), key
    assert any(not torch.equal(pre["state"][k], v) for k, v in pre["final"].items())
    if arch == "cvae":
        assert "encoder.bn_0.mean" in main["state"]
