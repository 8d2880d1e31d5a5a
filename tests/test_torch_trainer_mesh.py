"""Data-parallel training with the JAX package's global-batch numerics,
and the CLI under a launcher's environment.

One world of 4 gloo ranks on the CPU (tests/torch_dist.py
``trainer_world``, spawned once for the module) trains each case with
``training.num_devices: 4`` (the trainer builds its mesh from the process
group) for 2 epochs, against the port's single-process trainer on the same
seed, with the bounds of JAX ``tests/test_trainer_mesh.py:68-75`` (losses
rtol 1e-4 / atol 1e-5, parameters rtol 1e-3 / atol 1e-4):

- the diffusion model with the constraint losses on and dropout 0.2 (the
  constraint terms' batch statistics and the dropout masks are the global
  batch's), and with the D3PM head (the bit-flip draws);
- the cVAE with constraints on (BatchNorm's moments and running
  statistics over the global batch), and the flow (its z draws);
- batch 10 over 4 ranks: the training batches are replicated on every
  rank, the 8-row validation batch is split, and epoch blocks fall back to
  per-epoch dispatch with the JAX warning.

It also takes one step on injected draws, against the JAX trainer's step
on ``make_mesh(4)`` with the JAX keys' draws (the bounds of
tests/test_torch_train.py's step against the JAX trainer).

A second world (``cli_world``) runs ``cli.main(... --steps train generate
--device cpu)`` on 4 ranks that join the group from torchrun's
environment variables: rank 0's checkpoint equals a single-process run's
within the training bounds, its CSVs within
tests/test_sharded_generation.py's (rtol 1e-3, atol 5e-3), and the other
ranks create or write no file. The products are float32 there, as in the
JAX mesh tests whose bounds these are.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import OsteosarcomaArrays as JaxArrays
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.parallel.mesh import make_mesh as jax_make_mesh
from osteosarcoma_diffusionmodel_tpu.training.trainer import Trainer as JaxTrainer
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv
from torch_dist import results, spawn
from torch_parity import BATCH, TRAIN_DUMMY, constraint_specs, train_config

WORLD = 4
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5  # tests/test_trainer_mesh.py:68
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-4  # tests/test_trainer_mesh.py:73-75
STEP_LR = 1e-3
GEN_RTOL, GEN_ATOL = 1e-3, 5e-3  # tests/test_sharded_generation.py
GATE_WARNING = ("epochs_per_dispatch>1 needs the effective batch size divisible by the mesh "
                "data axis; falling back to per-epoch dispatch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cohort():
    c = make_dummy_cohort(**TRAIN_DUMMY)
    data, conditions, dims = cohort_arrays(c, Config())
    return c, data, conditions, dims


def _arrays(cls, c, data, conditions, dims):
    return cls(data=data, conditions=conditions,
               survival=np.asarray(c.clinical["survival_days"], np.float32),
               sample_ids=list(c.sample_ids), mutation_genes=c.mutation_genes,
               expression_genes=c.expression_genes, pathway_names=c.pathway_names,
               condition_names=dims.condition_names, survival_mean=dims.survival_mean,
               survival_std=dims.survival_std)


def _case(cohort, arch="diffusion", batch=BATCH, dropout=0.2, blocks=1, discrete=False):
    """(model, arrays, dims, config) of a training case: constraints on,
    ``training.num_devices`` 4, 2 epochs."""
    c, data, conditions, dims = cohort
    cfg = train_config(Config(), dropout=dropout, discrete=discrete)
    cfg.model.architecture = arch
    cfg.training.batch_size = batch
    cfg.training.num_epochs = 2
    cfg.training.num_devices = WORLD
    cfg.training.epochs_per_dispatch = blocks
    _, pspec = constraint_specs(c, data)
    model = build_model(cfg, dims, pspec)
    return model, _arrays(OsteosarcomaArrays, c, data, conditions, dims), dims, cfg


CASES = {
    "diffusion": dict(),
    "d3pm": dict(discrete=True),
    "cvae": dict(arch="cvae"),
    "flow": dict(arch="flow"),
    "uneven": dict(batch=10, blocks=2),
}


def _jax_step(cohort, tmp_path):
    """The JAX trainer's step on make_mesh(4) and the port's inputs for the
    same step: (port case, its initial state, global batch, draws), JAX's
    (params after the step, loss)."""
    c, data, conditions, dims = cohort
    jc = train_config(JaxConfig())
    jc.training.learning_rate = STEP_LR
    jc.training.save_dir = str(tmp_path / "jax")
    jdims = jc.freeze_dims(10, 40, 14, dims.condition_names, dims.survival_mean,
                           dims.survival_std)
    jspec, _ = constraint_specs(c, data)
    jtr = JaxTrainer(JaxDiffusion.from_config(jc, jdims, jspec),
                     _arrays(JaxArrays, c, data, conditions, dims), jdims, jc,
                     mesh=jax_make_mesh(WORLD))
    model, arrays, pdims, pc = _case(cohort, dropout=0.0)
    pc.training.learning_rate = STEP_LR
    rows = jtr.train_idx[:BATCH]
    rng = jax.random.PRNGKey(100)
    mix_rng, noise_rng, loss_rng = jax.random.split(rng, 3)
    lam_rng, perm_rng = jax.random.split(mix_rng)
    t_rng, n_rng = jax.random.split(loss_rng, 5)[:2]
    draws = {
        "lam": float(np.float32(jax.random.beta(lam_rng, 0.2, 0.2))),
        "perm": torch.from_numpy(np.array(jax.random.permutation(perm_rng, BATCH))),
        "pathway_noise": torch.from_numpy(np.array(
            jax.random.normal(noise_rng, (BATCH, 14), jnp.float32))),
        "t": torch.from_numpy(np.array(jax.random.randint(t_rng, (BATCH,), 0, 20))),
        "noise": torch.from_numpy(np.array(jax.random.normal(n_rng, (BATCH, 64), jnp.float32))),
    }
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    state = flax_params_to_state_dict(params)
    data_s, cond_s, surv_s = jtr._gather_batch(rows)
    new_params, _, _, metrics = jtr._train_step(jtr.params, jtr.opt_state, {}, data_s, cond_s,
                                                surv_s, rng)
    batch = tuple(torch.from_numpy(np.array(a)) for a in (data[rows], conditions[rows]))
    want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, new_params))
    return (model, arrays, pdims, pc, state, batch, draws), want, float(metrics["loss"])


@pytest.fixture(scope="module")
def world(cohort, tmp_path_factory):
    work = tmp_path_factory.mktemp("trainer_world")
    cases = {name: _case(cohort, **kw) for name, kw in CASES.items()}
    step, want, want_loss = _jax_step(cohort, work)
    torch.save({"cases": copy.deepcopy(cases), "step": step}, work / "inputs.pt")
    spawn("trainer_world", WORLD, work, timeout=240)
    return results(work, WORLD), cases, (want, want_loss), work


def _single(case, save_dir):
    model, arrays, dims, cfg = copy.deepcopy(case)
    cfg.training.save_dir = str(save_dir)
    trainer = Trainer(model, arrays, dims, cfg, "cpu")
    history = trainer.train()
    return history, trainer.module.state_dict()


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_training_matches_one_device(world, name, tmp_path):
    out, cases, _, work = world
    history, state = _single(cases[name], tmp_path / "single")
    for r, res in enumerate(out):
        got = res[name]
        assert got["mesh"] == {"data": WORLD, "model": 1}
        np.testing.assert_allclose(got["train"], history.train_loss, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(got["val"], history.val_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert set(got["state"]) == set(state)
        for key, value in state.items():
            np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{key} rank {r}")
        assert (GATE_WARNING in got["warnings"]) == (name == "uneven")
    if name == "cvae":  # BatchNorm's running statistics moved, alike on every rank
        assert not torch.equal(out[0][name]["state"]["encoder.bn_0.mean"],
                               torch.zeros_like(state["encoder.bn_0.mean"]))
    assert (work / f"ckpt_{name}" / "best_model.npz").exists()  # rank 0 wrote it


def test_data_parallel_step_matches_jax_mesh_step(world):
    """One step on the JAX keys' draws (mixup 0.2, pathway jitter 0.05,
    constraints on, lr 1e-3): the loss within rtol 1e-5; every parameter
    within 2 lr of the JAX mesh step's, all but 1e-3 of them within 2e-6
    (AdamW's first step is lr * g / (|g| + 1e-8): rounding moves the
    parameters whose gradient is near 0 by up to 2 lr)."""
    out, _, (want, want_loss), _ = world
    for res in out:
        got = res["step"]
        assert got["metrics"]["loss"] == pytest.approx(want_loss, rel=1e-5)
        diffs = {k: np.abs(got["state"][k].numpy() - v.numpy()) for k, v in want.items()}
        assert max(float(d.max()) for d in diffs.values()) <= 2 * STEP_LR
        wide = sum(int((d > 2e-6).sum()) for d in diffs.values())
        assert wide / sum(d.size for d in diffs.values()) < 1e-3, wide


# ----------------------------------------------------------------------
# The CLI under a launcher
# ----------------------------------------------------------------------
def _cli_config(root, c, num_devices):
    write_processed(c, root / "processed")
    raw = {
        "data": {"processed_dir": str(root / "processed")},
        "model": {"hidden_dims": [64, 128, 64], "latent_dim": 32, "compute_dtype": "float32",
                  "diffusion": {"num_steps": 8}},
        "training": {"save_dir": str(root / "ckpt"), "num_epochs": 2, "save_frequency": 2,
                     "num_devices": num_devices},
        "generation": {"num_synthetic_samples": 30, "sampler": "ddim", "sampling_steps": 4,
                       "calibrate_marginals": False},
        "output": {"results_dir": str(root / "results"),
                   "synthetic_data_dir": str(root / "synthetic")},
    }
    (root / "config.yaml").write_text(yaml.safe_dump(raw))
    return root / "config.yaml"


def test_cli_under_a_launcher_matches_one_process(cohort, tmp_path):
    c = cohort[0]
    work = tmp_path / "world"
    work.mkdir()
    _cli_config(work, c, WORLD)
    spawn("cli_world", WORLD, work, timeout=240, mode="launcher")
    single = tmp_path / "single"
    single.mkdir()
    cli.main(["--config", str(_cli_config(single, c, 1)), "--steps", "train", "generate",
              "--device", "cpu"])
    for rank in range(1, WORLD):
        assert json.loads((work / f"writes{rank}.json").read_text()) == []
    got, want = (np.load(root / "ckpt" / "best_model.npz") for root in (work, single))
    assert set(got.files) == set(want.files)
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)
    scenarios = Config.from_yaml(work / "config.yaml").generation.scenarios
    for s in scenarios:
        for part in ("mutations", "expression", "pathways", "conditions"):
            name = f"{s.name}/{s.name}_{part}.csv"
            a = read_matrix_csv(work / "synthetic" / name, index_col=None)
            b = read_matrix_csv(single / "synthetic" / name, index_col=None)
            assert a.columns == b.columns
            np.testing.assert_allclose(a.values, b.values, rtol=GEN_RTOL, atol=GEN_ATOL,
                                       err_msg=name)
    history = np.genfromtxt(work / "results" / "training_history.csv", delimiter=",",
                            names=True)
    assert history.shape == (2,)
