"""(i) The slice as a whole: the port's CLI, ``--steps generate validate``,
on a ``make_dummy_data`` directory with weights converted from a Flax
init, writing the JAX CLI's file layout; plus the port's checkpoint
format, the JAX exporter script and the in-memory dummy cohort.
"""

import json
import math

import jax
import numpy as np
import pandas as pd
import pytest
import yaml

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data, prepare_arrays
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.training import checkpoint as jax_ckpt
from osteosarcoma_diffusionmodel_tpu.validation.validator import (
    BiologicalValidator as JaxValidator,
)
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import flatten_params, flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.training import checkpoint as port_ckpt

DUMMY = dict(n_samples=40, n_mutation_genes=10, n_expression_genes=40, n_pathways=14)


def _small(cfg):
    cfg.model.hidden_dims = [128, 256, 128]
    cfg.model.latent_dim = 32
    cfg.model.diffusion.num_steps = 8
    return cfg


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A JAX processed dir and a port checkpoint dir with Flax weights."""
    root = tmp_path_factory.mktemp("slice")
    proc, ckpt = root / "processed", root / "checkpoints"
    make_dummy_data(proc, **DUMMY)
    jc = _small(JaxConfig())
    jc.data.processed_dir = str(proc)
    arrays, dims = prepare_arrays(jc)
    model = JaxDiffusion.from_config(jc, dims)
    params = jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(0), 3))
    jax_ckpt.save_data_stats(ckpt, arrays)
    jax_ckpt.save_metadata(ckpt, jc, dims)
    np.savez(ckpt / "best_model.npz", **flatten_params(params))
    return root, proc, ckpt, params


def _write_yaml(root, proc, ckpt, sampler):
    raw = {
        "data": {"processed_dir": str(proc)},
        "training": {"save_dir": str(ckpt)},
        "generation": {"num_synthetic_samples": 60, "sampler": sampler, "sampling_steps": 4},
        "output": {"results_dir": str(root / f"results_{sampler}"),
                   "synthetic_data_dir": str(root / f"synthetic_{sampler}")},
    }
    path = root / f"config_{sampler}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_cli_generate_validate_writes_jax_layout(workspace, sampler):
    root, proc, ckpt, _ = workspace
    path = _write_yaml(root, proc, ckpt, sampler)
    cli.main(["--config", str(path), "--steps", "generate", "validate", "--device", "cpu"])

    synth_dir = root / f"synthetic_{sampler}"
    cfg = Config.from_yaml(path)
    frames = {}
    for scenario in cfg.generation.scenarios:
        for key, width in (("mutations", 10), ("expression", 40), ("pathways", 14),
                           ("conditions", 3)):
            df = pd.read_csv(synth_dir / scenario.name / f"{scenario.name}_{key}.csv")
            assert df.shape == (20, width), (scenario.name, key)
            assert np.isfinite(df.values).all()
            frames.setdefault(key, []).append(df)
    real_mut = pd.read_csv(proc / "mutation_matrix_aligned.csv", index_col=0)
    assert list(frames["mutations"][0].columns) == list(real_mut.columns)

    results = pd.read_csv(root / f"results_{sampler}" / "validation_results.csv").iloc[0]
    assert all(math.isfinite(v) for v in results.values)
    # The JAX validator on the same files: same keys, same values.
    ref = JaxValidator(JaxConfig()).validate_all(
        real_mut, pd.read_csv(proc / "expression_matrix_aligned.csv", index_col=0),
        pd.read_csv(proc / "pathway_scores.csv", index_col=0),
        *(pd.concat(frames[k], ignore_index=True) for k in ("mutations", "expression", "pathways")))
    assert set(results.index) == set(ref)
    for key in ref:
        assert results[key] == pytest.approx(float(ref[key]), abs=1e-4), key


def test_port_checkpoint_round_trip(workspace, tmp_path):
    _, _, ckpt, params = workspace
    state = port_ckpt.load_weights(ckpt)
    expected = flax_params_to_state_dict(params)
    assert set(state) == set(expected)
    port_ckpt.save_weights(tmp_path, state)
    again = port_ckpt.load_weights(tmp_path)
    for key in expected:
        np.testing.assert_array_equal(again[key].numpy(), expected[key].numpy())
    meta = port_ckpt.load_metadata(ckpt)
    dims = port_ckpt.metadata_to_dims(meta)
    assert (dims.mutation_dim, dims.expression_dim, dims.pathway_dim) == (10, 40, 14)
    stats = port_ckpt.load_data_stats(ckpt)
    assert {"feature_sorted", "data_matrix", "mutation_matrix", "mutation_freq"} <= set(stats)


def test_exporter_writes_port_checkpoint(workspace, tmp_path):
    """scripts/export_jax_checkpoint.py: Orbax checkpoint -> port files."""
    import importlib.util
    from pathlib import Path

    _, _, ckpt, params = workspace
    orbax_dir = tmp_path / "orbax"
    orbax_dir.mkdir()
    for fname in (jax_ckpt.METADATA_FILE, jax_ckpt.DATA_STATS_FILE):
        (orbax_dir / fname).write_bytes((ckpt / fname).read_bytes())
    manager = jax_ckpt.CheckpointManager(orbax_dir)
    manager.save("best_model", {"params": params, "batch_stats": {}, "epoch": 0}, wait=True)
    script = Path(__file__).resolve().parent.parent / "scripts" / "export_jax_checkpoint.py"
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.export(orbax_dir, tmp_path / "port")
    state = port_ckpt.load_weights(out)
    expected = flax_params_to_state_dict(params)
    for key in expected:
        np.testing.assert_array_equal(state[key].numpy(), expected[key].numpy())
    assert json.loads((out / "metadata.json").read_text())["dims"]["mutation_dim"] == 10


def test_dummy_cohort_matches_make_dummy_data(tmp_path):
    """Same seed, same draws: the in-memory cohort equals the JAX
    fixture, and its arrays equal prepare_arrays' (1e-6: CSV text)."""
    make_dummy_data(tmp_path / "jax", **DUMMY)
    cohort = make_dummy_cohort(**DUMMY)
    for fname, values, cols in (
            ("mutation_matrix_aligned.csv", cohort.mutations, cohort.mutation_genes),
            ("expression_matrix_aligned.csv", cohort.expression, cohort.expression_genes),
            ("pathway_scores.csv", cohort.pathways, cohort.pathway_names)):
        df = pd.read_csv(tmp_path / "jax" / fname, index_col=0)
        assert list(df.columns) == cols
        np.testing.assert_array_equal(df.values.astype(np.float32), values)
    clin = pd.read_csv(tmp_path / "jax" / "clinical_aligned.csv")
    for col, values in cohort.clinical.items():  # CSV text: last-digit rounding
        np.testing.assert_allclose(clin[col].values, values, rtol=1e-14)

    jc = JaxConfig()
    jc.data.processed_dir = str(tmp_path / "jax")
    arrays, jdims = prepare_arrays(jc)
    data, conditions, dims = cohort_arrays(cohort, Config())
    np.testing.assert_allclose(data, arrays.data, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(conditions, arrays.conditions, rtol=1e-6, atol=1e-6)
    assert dims.condition_names == jdims.condition_names
    assert dims.survival_std == pytest.approx(jdims.survival_std)

    write_processed(cohort, tmp_path / "port")
    for fname in ("mutation_matrix_aligned.csv", "pathway_scores.csv"):
        a = pd.read_csv(tmp_path / "port" / fname, index_col=0)
        b = pd.read_csv(tmp_path / "jax" / fname, index_col=0)
        assert list(a.columns) == list(b.columns) and list(a.index) == list(b.index)
        np.testing.assert_array_equal(a.values.astype(np.float32), b.values.astype(np.float32))


def test_cli_without_device_raises_without_a_card(workspace, monkeypatch):
    """The port runs on the card unless asked for the CPU: with no card
    and no ``--device``, the CLI raises before it writes anything."""
    import torch

    root, proc, ckpt, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = {
        "data": {"processed_dir": str(proc)},
        "training": {"save_dir": str(ckpt)},
        "output": {"results_dir": str(root / "results_nocard"),
                   "synthetic_data_dir": str(root / "synthetic_nocard")},
    }
    path = root / "config_nocard.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", str(path), "--steps", "generate", "validate"])
    assert not (root / "synthetic_nocard").exists()
    assert not (root / "results_nocard").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.generate_synthetic_patients(Config.from_yaml(path))
    assert not (root / "synthetic_nocard").exists()
