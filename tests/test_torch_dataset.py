"""The port's training data path and runtime against the JAX package:
``prepare_arrays`` on a processed directory, the plateau and
early-stopping schedules, dropout, the trainer's checkpoints and resume,
the training section of the YAML configs, and the CLI's train step.

Tiny shapes (data 10/40/14, hidden 64-256), seeded inputs; the CLI runs
with ``--device cpu``.
"""

import math
import shutil

import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data
from osteosarcoma_diffusionmodel_tpu.data.dataset import prepare_arrays as jax_prepare_arrays
from osteosarcoma_diffusionmodel_tpu.training.trainer import EarlyStopping as JaxEarlyStopping
from osteosarcoma_diffusionmodel_tpu.training.trainer import PlateauLR as JaxPlateauLR
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dataset import (
    OsteosarcomaArrays,
    mixup,
    prepare_arrays,
)
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import (
    ConditionalDiffusion,
    check_supported,
    visible_devices,
)
from osteosarcoma_diffusionmodel_torch.models.networks import DenoiserBlock, init_flax
from osteosarcoma_diffusionmodel_torch.parallel.mesh import make_mesh
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.training.trainer import EarlyStopping, PlateauLR, Trainer
from torch_parity import BATCH, TRAIN_DUMMY, constraint_specs, train_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops run fastest on one thread (GroupNorm on 8 threads
    takes milliseconds here); restored after the module."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cohort():
    """The tiny structured cohort: (DummyCohort, data, conditions, dims)."""
    c = make_dummy_cohort(**TRAIN_DUMMY)
    data, conditions, dims = cohort_arrays(c, Config())
    return c, data, conditions, dims


# ----------------------------------------------------------------------
# (e) prepare_arrays
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pathways", ["written", "lazy"])
def test_prepare_arrays_matches_jax(tmp_path, pathways):
    """On make_dummy_data's tables (and without pathway_scores.csv, which
    both then compute from the expression table and write): the data,
    conditions, survival, names and frozen dims equal the JAX
    prepare_arrays' within 1 float32 ulp (CSV text, pandas' sums)."""
    make_dummy_data(tmp_path / "jax", **TRAIN_DUMMY)
    if pathways == "lazy":
        (tmp_path / "jax" / "pathway_scores.csv").unlink()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jc, pc = JaxConfig(), Config()
    jc.data.processed_dir = str(tmp_path / "jax")
    pc.data.processed_dir = str(tmp_path / "port")
    want, jdims = jax_prepare_arrays(jc)
    got, pdims = prepare_arrays(pc)
    for name in ("data", "conditions", "survival"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=2e-7,
                                   atol=1e-7, err_msg=name)
        assert getattr(got, name).dtype == np.float32
    for name in ("sample_ids", "mutation_genes", "expression_genes", "pathway_names",
                 "condition_names"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.survival_mean == pytest.approx(want.survival_mean, rel=1e-12)
    assert got.survival_std == pytest.approx(want.survival_std, rel=1e-12)
    for name in ("mutation_dim", "expression_dim", "pathway_dim", "condition_dim",
                 "condition_names"):
        assert getattr(pdims, name) == getattr(jdims, name), name
    assert (tmp_path / "port" / "pathway_scores.csv").exists()
    if pathways == "lazy":
        again, _ = prepare_arrays(pc)  # now from the file the first call wrote
        np.testing.assert_allclose(again.data, got.data, rtol=1e-7, atol=1e-7)


def test_cohort_arrays_equal_prepare_arrays(tmp_path, cohort):
    """The in-memory cohort's arrays and prepare_arrays on its processed
    tables: the same arithmetic (1e-6: CSV text)."""
    c, data, conditions, dims = cohort
    write_processed(c, tmp_path)
    cfg = Config()
    cfg.data.processed_dir = str(tmp_path)
    arrays, pdims = prepare_arrays(cfg)
    np.testing.assert_allclose(arrays.data, data, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(arrays.conditions, conditions, rtol=1e-6, atol=1e-6)
    assert pdims == dims


def test_mixup_draws_and_injection(cohort):
    """Given lambda and permutation, mixup is lam x + (1 - lam) x[perm]
    in float32; without them it draws from its generators repeatably."""
    _, data, conditions, _ = cohort
    x, c = torch.from_numpy(data[:BATCH]), torch.from_numpy(conditions[:BATCH])
    perm = torch.arange(BATCH).flip(0)
    mx, mc = mixup(x, c, lam=0.3, perm=perm)
    lam = np.float32(0.3)
    np.testing.assert_array_equal(mx.numpy(), lam * data[:BATCH] + (np.float32(1) - lam)
                                  * data[:BATCH][::-1])
    np.testing.assert_array_equal(mc.numpy(), lam * conditions[:BATCH] + (np.float32(1) - lam)
                                  * conditions[:BATCH][::-1])
    runs = [mixup(x, c, 0.2, rng=np.random.default_rng(s),
                  generator=torch.Generator().manual_seed(s))[0] for s in (4, 4, 5)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# ----------------------------------------------------------------------
# (d) schedules
# ----------------------------------------------------------------------
SEQUENCES = [
    [1.0, 0.9, 0.91, 0.92, 0.93, 0.8, 0.85, 0.86, 0.87, 0.88, 0.89],
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6],
    list(np.linspace(2.0, 1.0, 30) + 0.05 * np.sin(np.arange(30))),
]


@pytest.mark.parametrize("seq", range(len(SEQUENCES)))
def test_plateau_and_early_stopping_match_jax(seq):
    losses = SEQUENCES[seq]
    for patience, delta in ((2, 0.0), (3, 0.05)):
        p, j = PlateauLR(1e-3, 0.5, patience), JaxPlateauLR(1e-3, 0.5, patience)
        assert [p.step(v) for v in losses] == [j.step(v) for v in losses]
        e, k = EarlyStopping(patience, delta), JaxEarlyStopping(patience, delta)
        for v in losses:
            e(v)
            k(v)
            assert (e.early_stop, e.counter, e.best_loss) == (k.early_stop, k.counter, k.best_loss)


# ----------------------------------------------------------------------
# (f) dropout
# ----------------------------------------------------------------------
def test_dropout_rate_scale_and_eval_identity():
    """Train mode zeroes about 20% of the first SiLU's outputs and scales
    the rest by 1/0.8; eval mode passes them through; the block's other
    parts see no dropout. 200k draws: the share within 0.005 of 0.2."""
    torch.manual_seed(0)
    block = DenoiserBlock(64, 256, torch.float32, dropout=0.2)
    h = torch.ones(800, 256)
    out = block.drop(h)
    share = float((out == 0).float().mean())
    assert abs(share - 0.2) < 0.005
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.8))
    block.eval()
    assert torch.equal(block.drop(h), h)
    x = torch.randn(8, 64)
    block0 = DenoiserBlock(64, 256, torch.float32, dropout=0.0)
    block0.load_state_dict(block.state_dict())
    torch.testing.assert_close(block(x), block0(x), rtol=0, atol=0)


def test_sampling_model_runs_in_eval_mode(cohort):
    """from_config returns the denoiser in eval mode; the loss turns
    dropout on only for its own call."""
    c, data, conditions, dims = cohort
    _, pspec = constraint_specs(c, data)
    pmodel = ConditionalDiffusion.from_config(train_config(Config(), dropout=0.2), dims, pspec)
    init_flax(pmodel.denoiser, torch.Generator().manual_seed(0))
    assert not pmodel.denoiser.training
    x0, cond = torch.from_numpy(data[:BATCH]), torch.from_numpy(conditions[:BATCH])
    draws = dict(t=torch.arange(BATCH) % 20, noise=torch.zeros(BATCH, 64))
    with torch.no_grad():
        a = pmodel.loss(x0, cond, **draws, train=False)[0]
        b = pmodel.loss(x0, cond, **draws, train=False)[0]
        c = pmodel.loss(x0, cond, **draws, train=True)[0]
    assert float(a) == float(b) != float(c)
    assert not pmodel.denoiser.training


# ----------------------------------------------------------------------
# (g) checkpoints and resume
# ----------------------------------------------------------------------
def test_checkpoint_resume_round_trip(cohort, tmp_path):
    """Train 4 epochs with a checkpoint every 2, lower the LR, save; a
    fresh trainer's resume() restores the same params, AdamW moments,
    step and LR, and starts at the next epoch."""
    c, data, conditions, dims = cohort
    pc = train_config(Config(), dropout=0.2)
    pc.training.save_dir = str(tmp_path / "ckpt")
    pc.training.num_epochs = 4
    pc.training.save_frequency = 2
    arrays = OsteosarcomaArrays(data, conditions, np.zeros(len(data), np.float32),
                                list(c.sample_ids), c.mutation_genes, c.expression_genes,
                                c.pathway_names, dims.condition_names)
    _, pspec = constraint_specs(c, data)
    tr = Trainer(ConditionalDiffusion.from_config(pc, dims, pspec), arrays, dims, pc, "cpu")
    history = tr.train()
    assert len(history.train_loss) == 4 and history.steps_per_sec > 0
    assert ckpt.latest_epoch(pc.training.save_dir) == 3
    assert (tmp_path / "ckpt" / "checkpoint_epoch_1").is_dir()
    for name in ("best_model.npz", "metadata.json", "data_stats.npz"):
        assert (tmp_path / "ckpt" / name).exists()
    tr.set_learning_rate(2.5e-5)
    tr.save_checkpoint(3, history.val_loss[-1])

    again = Trainer(ConditionalDiffusion.from_config(pc, dims, pspec), arrays, dims, pc, "cpu")
    assert again.resume()
    assert again.start_epoch == 4
    assert again.plateau.lr == 2.5e-5
    assert again.optimizer.param_groups[0]["lr"] == 2.5e-5
    want, got = tr.model.denoiser.state_dict(), again.model.denoiser.state_dict()
    for name in want:
        assert torch.equal(want[name], got[name]), name
    for p, q in zip(tr.params, again.params):
        s, r = tr.optimizer.state[p], again.optimizer.state[q]
        assert float(s["step"]) == float(r["step"]) == 8.0
        assert torch.equal(s["exp_avg"], r["exp_avg"])
        assert torch.equal(s["exp_avg_sq"], r["exp_avg_sq"])
    more = again.train()  # epochs 4..num_epochs: none left
    assert more.train_loss == []


def test_trainer_rejects_what_is_not_ported(cohort, caplog, monkeypatch):
    """Several devices train on one with the JAX trainer's warning where
    fewer are visible (one CPU; no card here). Where that many cards are
    visible (device_count faked to 4) nothing is refused and nothing warns:
    the trainer builds its mesh, which needs one process per card, so
    without a process group the mesh raises the JAX ValueError instead of
    training on one card (the mesh itself: tests/test_torch_trainer_mesh.py);
    cross-cancer pretraining and sample-path fine-tuning are ported and
    pass."""
    c, data, conditions, dims = cohort
    for change in ("pretrain", "finetune", "devices"):
        pc = train_config(Config())
        if change == "pretrain":
            pc.training.augmentation.cross_cancer_pretrain = True
            pc.training.augmentation.pretrain_datasets = ["TARGET-NBL"]
        elif change == "finetune":
            pc.training.sample_path_finetune.enabled = True
        else:
            pc.training.num_devices = 2
        check_supported(pc, dims)  # sampling does not read the training section
        if change == "devices":
            for device, visible in (("cpu", 1), ("cuda", torch.cuda.device_count())):
                caplog.clear()
                with caplog.at_level("WARNING"):
                    check_supported(pc, dims, training=True, device=device)
                assert (f"training.num_devices=2 but only {visible} devices visible; "
                        "training single-device") in caplog.text
            monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
            caplog.clear()
            with caplog.at_level("WARNING"):
                check_supported(pc, dims, training=True, device="cuda")
            assert "devices visible" not in caplog.text
            assert visible_devices("cuda") == 4
            with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 devices "
                                                 "are visible"):
                make_mesh(pc.training.num_devices)
            check_supported(pc, dims, training=True, device="cpu")  # one CPU: warns
        else:
            check_supported(pc, dims, training=True)


@pytest.mark.parametrize("name", ["config.yaml", "production.yaml"])
def test_yaml_training_settings_match_jax(name):
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "config" / name
    p, j = Config.from_yaml(path), JaxConfig.from_yaml(path)
    for field in ("batch_size", "num_epochs", "learning_rate", "weight_decay", "patience",
                  "min_delta", "val_split", "random_seed", "save_dir", "save_frequency",
                  "lr_plateau_factor", "lr_plateau_patience", "grad_clip_norm", "num_devices",
                  "epochs_per_dispatch"):
        assert getattr(p.training, field) == getattr(j.training, field), field
    for field in ("mixup_alpha", "pathway_noise", "cross_cancer_pretrain", "pretrain_datasets"):
        assert getattr(p.training.augmentation, field) == getattr(j.training.augmentation, field)
    assert p.training.sample_path_finetune.enabled == j.training.sample_path_finetune.enabled
    assert p.model.gnn.dropout == j.model.gnn.dropout
    for field in ("loss_type", "block_loss_weighting", "discrete_ce_weight"):
        assert getattr(p.model.diffusion, field) == getattr(j.model.diffusion, field)
    for field in ("pathway_coherence_weight", "mutation_expression_weight",
                  "survival_prediction_weight", "gene_network_weight", "cooccurrence_weight",
                  "enabled"):
        assert getattr(p.model.constraints, field) == getattr(j.model.constraints, field)


# ----------------------------------------------------------------------
# (h) the CLI's train step
# ----------------------------------------------------------------------
def _cli_yaml(root, c):
    write_processed(c, root / "processed")
    raw = {
        "data": {"processed_dir": str(root / "processed")},
        "model": {"hidden_dims": [64, 128, 64], "latent_dim": 32,
                  "diffusion": {"num_steps": 8}},
        "training": {"save_dir": str(root / "ckpt"), "num_epochs": 3, "save_frequency": 2},
        "generation": {"num_synthetic_samples": 30, "sampler": "ddim", "sampling_steps": 4},
        "output": {"results_dir": str(root / "results"),
                   "synthetic_data_dir": str(root / "synthetic")},
    }
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def test_cli_train_generate_validate_on_cpu(cohort, tmp_path):
    c = cohort[0]
    path = _cli_yaml(tmp_path, c)
    cli.main(["--config", str(path), "--steps", "train", "generate", "validate",
              "--device", "cpu"])
    history = np.genfromtxt(tmp_path / "results" / "training_history.csv", delimiter=",",
                            names=True)
    assert history.shape == (3,) and np.isfinite(history["train_loss"]).all()
    meta = ckpt.load_metadata(tmp_path / "ckpt")
    assert meta["config"]["model"]["hidden_dims"] == [64, 128, 64]
    assert ckpt.metadata_to_dims(meta).data_dim == 64
    assert not (tmp_path / "config" / "config_updated.yaml").exists()
    results = np.genfromtxt(tmp_path / "results" / "validation_results.csv", delimiter=",",
                            names=True)
    assert math.isfinite(float(results["overall_biological_score"]))
    mut = np.genfromtxt(tmp_path / "synthetic" / "typical_patient" /
                        "typical_patient_mutations.csv", delimiter=",", skip_header=1)
    assert mut.shape == (10, 10) and np.isin(mut, (0.0, 1.0)).all()
    # --resume goes on from the latest checkpoint: the periodic one of epoch
    # 1, or epoch 2's where epoch 2 was best (k = 1 writes one at each best
    # epoch; the trainer's seeded dropout decides which).
    latest = ckpt.latest_epoch(tmp_path / "ckpt")
    assert latest in (1, 2)
    raw = yaml.safe_load(path.read_text())
    raw["training"]["num_epochs"] = 4
    path.write_text(yaml.safe_dump(raw))
    cli.main(["--config", str(path), "--steps", "train", "--resume", "--device", "cpu"])
    history = np.genfromtxt(tmp_path / "results" / "training_history.csv", delimiter=",",
                            names=True)
    assert np.atleast_1d(history).shape == (3 - latest,)  # epochs latest + 1 .. 3


def test_cli_num_devices_trains_on_one_device(cohort, tmp_path, caplog, monkeypatch):
    """``training.num_devices: 4`` with one CPU device and no launcher's
    environment: the CLI joins no process group, the trainer warns as the
    JAX trainer does and trains on one device; generate runs under the same
    config (the JAX CLI's generate builds no mesh then). Four ranks under a
    launcher: tests/test_torch_trainer_mesh.py."""
    import torch.distributed as dist

    path = _cli_yaml(tmp_path, cohort[0])
    raw = yaml.safe_load(path.read_text())
    raw["training"].update(num_devices=4, num_epochs=1)
    path.write_text(yaml.safe_dump(raw))
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with caplog.at_level("WARNING"):
        cli.main(["--config", str(path), "--steps", "train", "generate", "--device", "cpu"])
    assert not dist.is_initialized()  # no launcher: no process group, no mesh
    assert ("training.num_devices=4 but only 1 devices visible; training single-device"
            in caplog.text)
    assert (tmp_path / "ckpt" / "best_model.npz").exists()
    scenarios = Config.from_yaml(path).generation.scenarios
    assert all((tmp_path / "synthetic" / s.name / f"{s.name}_expression.csv").exists()
               for s in scenarios)


def test_cli_train_raises_without_a_card(cohort, tmp_path, monkeypatch):
    path = _cli_yaml(tmp_path, cohort[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", str(path), "--steps", "train"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train_model(Config.from_yaml(path))
    assert not (tmp_path / "ckpt").exists()


# ----------------------------------------------------------------------
# The card scripts' protocols, on the CPU at tiny size
# ----------------------------------------------------------------------
def _script(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_production_run_protocol_at_tiny_size(tmp_path):
    """scripts/production_run_torch.py's protocol at 10/40/14 with hidden
    64/128/64: the pathways step leaves the recomputed pathway columns
    and the membership matrix, every step runs, the result carries the
    history, step seconds and finite metrics, and the gate reads them."""
    prod = _script("production_run_torch")
    cfg = Config.from_yaml(prod.REPO / "config" / "production.yaml")
    cfg.model.hidden_dims, cfg.model.latent_dim = [64, 128, 64], 32
    cfg.model.diffusion.num_steps, cfg.generation.sampling_steps = 20, 5
    out = prod.run(tmp_path, "cpu", epochs=3, samples=30, dims=(10, 40, 14), config=cfg)
    assert out["train_epochs"] == 3 and out["training"]["steps_per_sec"] > 0
    assert set(out["step_seconds"]) == {"train", "generate", "validate"}
    assert all(math.isfinite(v) for v in out["validation"].values())
    assert (tmp_path / "processed" / "gene_pathway_matrix.csv").exists()
    assert "real_pathway_coherence" in out["validation"]  # the membership matrix was read
    passing = {"overall_biological_score": 0.85, "mmd": 0.1499}
    assert prod.gate_failures(passing) == []
    assert len(prod.gate_failures({"overall_biological_score": 0.8499, "mmd": 0.15})) == 2


def test_train_profile_at_tiny_size(tmp_path):
    """scripts/profile_torch_train.py's measurement on the CPU: the
    epoch and step timings and the operator count are filled; the device
    counts are 0 without a card."""
    prof = _script("profile_torch_train")
    cfg = Config()
    cfg.model.hidden_dims, cfg.model.latent_dim = [64, 128, 64], 32
    cfg.model.diffusion.num_steps = 20
    out = prof.run(prof.make_trainer(tmp_path, "cpu", dims=(10, 40, 14), config=cfg), 2)
    assert out["steps_per_epoch"] == 5 and out["train_steps_per_sec"] > 0
    assert out["aten_ops_per_step"] > 0 and out["kernel_launches_per_step"] == 0
    assert (tmp_path / "best_model.npz").exists()
