"""(g) The generator's post-processing and calibration against the JAX
package's host path, on identical raw samples.

Both sides run the same float64 numpy copula code (the port's
ops/copula.py is a copy) with the same tie-break seed, so the calibrated
cohorts are equal; the JAX generator takes its numpy path on the CPU
backend (calibration_backend "auto").
"""

import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data, prepare_arrays
from osteosarcoma_diffusionmodel_tpu.generation.generator import (
    SyntheticPatientGenerator as JaxGenerator,
)
from osteosarcoma_diffusionmodel_torch.generation.generator import (
    SyntheticPatientGenerator,
    seeded_generator,
)
from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays
from torch_parity import _configure, make_pair

MODES = ["copula_joint", "copula_full", "copula", "quantile", "moment", False]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_torch.config import Config

    proc = tmp_path_factory.mktemp("processed")
    make_dummy_data(proc, n_samples=40, n_mutation_genes=10, n_expression_genes=40,
                    n_pathways=14)
    jc = _configure(JaxConfig(), 6, "bfloat16")
    jc.data.processed_dir = str(proc)
    arrays, jdims = prepare_arrays(jc)
    stats = data_stats_from_arrays(arrays.data, arrays.conditions, len(arrays.mutation_genes))
    jmodel, params, pmodel = make_pair()
    pc = _configure(Config(), 6, "bfloat16")
    pdims = pc.freeze_dims(jdims.mutation_dim, jdims.expression_dim, jdims.pathway_dim,
                           jdims.condition_names, jdims.survival_mean, jdims.survival_std)
    samples = np.random.default_rng(5).standard_normal((60, jdims.data_dim)).astype(np.float32)
    samples[:, :10] = (samples[:, :10] > 0.3).astype(np.float32) * 0.9 + 0.05 * samples[:, :10]
    conds = np.random.default_rng(6).standard_normal((60, 3)).astype(np.float32)
    return jc, jdims, jmodel, params, pc, pdims, pmodel, stats, samples, conds


@pytest.mark.parametrize("mode", MODES)
def test_postprocess_matches_jax_host_path(setup, mode):
    jc, jdims, jmodel, params, pc, pdims, pmodel, stats, samples, conds = setup
    jc.generation.calibrate_marginals = mode
    pc.generation.calibrate_marginals = mode
    ref = JaxGenerator(jmodel, params, jc, jdims, data_stats=stats)._postprocess(samples, conds)
    got = SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats)._postprocess(samples, conds)
    assert set(got) == set(ref) == {"mutations", "expression", "pathways", "conditions"}
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)


def test_create_conditions_matches_jax(setup):
    jc, jdims, jmodel, params, pc, pdims, pmodel, stats, _, _ = setup
    scenario = {"survival_time": 300, "event_occurred": 1, "metastasis_at_diagnosis": 1}
    for norm in ("train_stats", "fixed"):
        jc.generation.condition_normalization = norm
        pc.generation.condition_normalization = norm
        ref = np.asarray(JaxGenerator(jmodel, params, jc, jdims).create_conditions(5, scenario))
        got = SyntheticPatientGenerator(pmodel, pc, pdims).create_conditions(5, scenario)
        np.testing.assert_array_equal(got, ref)


def test_generate_scenarios_shapes_and_reproducibility(setup):
    _, _, _, _, pc, pdims, pmodel, stats, _, _ = setup
    pc.generation.calibrate_marginals = "copula_joint"
    gen = SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats)
    out = gen.generate_scenarios(pc.generation.scenarios, 7)
    again = gen.generate_scenarios(pc.generation.scenarios, 7)
    assert list(out) == [s.name for s in pc.generation.scenarios]
    for name, cohort in out.items():
        assert cohort["mutations"].shape == (7, pdims.mutation_dim)
        assert cohort["expression"].shape == (7, pdims.expression_dim)
        assert cohort["pathways"].shape == (7, pdims.pathway_dim)
        assert set(np.unique(cohort["mutations"])) <= {0.0, 1.0}
        for key in cohort:
            np.testing.assert_array_equal(cohort[key], again[name][key])
    pc.generation.batch_scenarios = True
    batched = gen.generate_scenarios(pc.generation.scenarios, 7)
    pc.generation.batch_scenarios = False
    assert all(batched[n]["pathways"].shape == (7, pdims.pathway_dim) for n in batched)


def test_seeded_generators_are_independent():
    a = torch.rand(4, generator=seeded_generator(42, 0))
    assert torch.equal(a, torch.rand(4, generator=seeded_generator(42, 0)))
    assert not torch.equal(a, torch.rand(4, generator=seeded_generator(42, 1)))
    assert not torch.equal(a, torch.rand(4, generator=seeded_generator(43, 0)))


@pytest.mark.parametrize("field,value", [
    ("architecture", "cvae"), ("cfg_dropout_prob", 0.1),
])
def test_unported_features_raise(field, value):
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    cfg = Config()
    setattr(cfg.model, field, value)
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    with pytest.raises(NotImplementedError):
        ConditionalDiffusion.from_config(cfg, dims)


@pytest.mark.parametrize("field,value", [
    ("discrete_mutation_head", True), ("ar_mutation_head", True), ("learn_sigma", True),
    ("low_rank_sigma_dim", 2), ("latent_factor_dim", 2), ("parameterization", "v"),
])
def test_unported_diffusion_heads_raise(field, value):
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    cfg = Config()
    setattr(cfg.model.diffusion, field, value)
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    with pytest.raises(NotImplementedError):
        ConditionalDiffusion.from_config(cfg, dims)


@pytest.mark.parametrize("field,value", [
    ("sample_dtype", "float32"), ("fused_quantize", "out"), ("fused_quantize", "all"),
    ("noise_type", "gaussian"), ("sampler", "dpm"),
])
def test_unported_generation_settings_raise(field, value):
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    cfg = Config()
    setattr(cfg.generation, field, value)
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    with pytest.raises(NotImplementedError):
        ConditionalDiffusion.from_config(cfg, dims)


def test_unknown_config_keys_are_ignored_on_load():
    from osteosarcoma_diffusionmodel_torch.config import Config

    cfg = Config.from_dict({
        "model": {"gnn": {"heads": 8}, "diffusion": {"loss_type": "l1", "num_steps": 7}},
        "generation": {"fused_gn_mode": "f32", "rng_impl": "threefry", "sampler": "ddim"},
    })
    assert cfg.model.diffusion.num_steps == 7
    assert cfg.generation.sampler == "ddim"
    assert not hasattr(cfg.generation, "fused_gn_mode")


def test_device_calibration_backend_is_rejected(setup):
    _, _, _, _, pc, pdims, pmodel, stats, _, _ = setup
    pc.generation.calibration_backend = "device"
    try:
        with pytest.raises(NotImplementedError):
            SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats)
    finally:
        pc.generation.calibration_backend = "auto"
