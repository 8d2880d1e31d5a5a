"""(g) The generator's post-processing and calibration against the JAX
package's host path, on identical raw samples.

Both sides run the same float64 numpy copula code (the port's
ops/copula.py is a copy) with the same tie-break seed, so the calibrated
cohorts are equal; both generators take their numpy path on the CPU
(calibration_backend "auto"). The device path has its own file,
tests/test_torch_copula_device.py.
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
    got = SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats, device="cpu")._postprocess(samples, conds)
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
        got = SyntheticPatientGenerator(pmodel, pc, pdims, device="cpu").create_conditions(5, scenario)
        np.testing.assert_array_equal(got, ref)


def test_generate_scenarios_shapes_and_reproducibility(setup):
    _, _, _, _, pc, pdims, pmodel, stats, _, _ = setup
    pc.generation.calibrate_marginals = "copula_joint"
    gen = SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats, device="cpu")
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
    ("architecture", "diffusion"), ("architecture", "cvae"), ("architecture", "flow"),
    ("architecture", "gnn"),
])
def test_unported_features_raise(field, value):
    """``build_model`` dispatches on ``model.architecture`` as the JAX one
    does (training/trainer.py:849-863): diffusion, cvae and flow build
    their families; anything else is the JAX ValueError."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.cvae import BiologyConstrainedVAE
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.models.flow import ConditionalFlow
    from osteosarcoma_diffusionmodel_torch.training.trainer import build_model

    cfg = Config()
    cfg.model.hidden_dims = [32, 64, 32]
    setattr(cfg.model, field, value)
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    family = {"diffusion": ConditionalDiffusion, "cvae": BiologyConstrainedVAE,
              "flow": ConditionalFlow}.get(value)
    if family is None:
        with pytest.raises(ValueError, match=f"Unknown architecture: {value}"):
            build_model(cfg, dims)
        return
    model = build_model(cfg, dims)
    assert isinstance(model, family) and not model.module.training


# The variants the port once rejected: each builds, routes as the JAX
# package's supports_fused && guidance == 1 rule says, and generates.
VARIANTS = [
    ("model", "cfg_dropout_prob", 0.1), ("diffusion", "ar_mutation_head", True),
    ("diffusion", "learn_sigma", True), ("diffusion", "low_rank_sigma_dim", 2),
    ("diffusion", "latent_factor_dim", 2), ("diffusion", "parameterization", "v"),
    ("generation", "sample_dtype", "float32"), ("generation", "noise_type", "normal"),
]


@pytest.mark.parametrize("section,field,value", VARIANTS)
@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_ported_variants_generate(section, field, value, sampler):
    """Each variant builds and generates a cohort through the generator on
    its route (the kernel sampler's plain loop only where the JAX package
    takes its kernel: the AR and latent heads, the float32 carry, which
    the kernel ignores), with binary mutations and finite values."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays

    cfg = _configure(Config(), 4, "bfloat16")
    cfg.generation.sampler = sampler
    cfg.generation.sampling_steps = 3
    target = {"model": cfg.model, "diffusion": cfg.model.diffusion,
              "generation": cfg.generation}[section]
    setattr(target, field, value)
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    model = ConditionalDiffusion.from_config(cfg, dims)
    data = np.random.default_rng(0).standard_normal((12, 16)).astype(np.float32)
    data[:, :4] = data[:, :4] > 0
    stats = data_stats_from_arrays(data, np.zeros((12, 1), np.float32), 4)
    gen = SyntheticPatientGenerator(model, cfg, dims, data_stats=stats, device="cpu")
    assert gen.uses_kernels() == (field in ("ar_mutation_head", "latent_factor_dim",
                                            "sample_dtype"))
    out = gen.generate(6, {"survival_time": 500})
    assert out["mutations"].shape == (6, 4) and np.isfinite(out["expression"]).all()
    assert set(np.unique(out["mutations"])) <= {0.0, 1.0}


@pytest.mark.parametrize("field,value", [("sampler", "dpm"), ("sampler", "euler"),
                                         ("sampler", "ancestral")])
def test_unported_generation_settings_raise(field, value):
    """A sampler other than "ddim" is DDPM, as in the JAX generator
    (generation/generator.py:242, :266): the model builds (nothing is
    refused) and its cohort equals the "ddpm" cohort under the same seed."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    cfg = _configure(Config(), 4, "bfloat16")
    setattr(cfg.generation, field, value)
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    model = ConditionalDiffusion.from_config(cfg, dims)
    cohorts = []
    for sampler in ("ddpm", value):
        setattr(cfg.generation, field, sampler)
        gen = SyntheticPatientGenerator(model, cfg, dims, device="cpu")
        cohorts.append(gen.generate(5, {"survival_time": 500}, seeded_generator(3)))
    for key in cohorts[0]:
        np.testing.assert_array_equal(cohorts[1][key], cohorts[0][key], err_msg=key)


def test_jax_generator_samples_ddpm_for_other_samplers(setup):
    """The reference behaviour the port follows: the JAX generator's
    "ancestral" cohort equals its "ddpm" cohort under the same key."""
    import jax

    jc, jdims, jmodel, params, *_ = setup
    cohorts = []
    for sampler in ("ddpm", "ancestral"):
        jc.generation.sampler = sampler
        gen = JaxGenerator(jmodel, params, jc, jdims)
        cohorts.append(gen.generate(5, {"survival_time": 500}, rng=jax.random.PRNGKey(4)))
    jc.generation.sampler = "ddpm"
    for key in cohorts[0]:
        np.testing.assert_array_equal(np.asarray(cohorts[1][key]), np.asarray(cohorts[0][key]),
                                      err_msg=key)


@pytest.mark.parametrize("section,field,value", [
    ("diffusion", "discrete_mutation_head", True), ("generation", "fused_quantize", "none"),
    ("generation", "fused_quantize", "out"), ("generation", "fused_quantize", "io"),
    ("generation", "fused_quantize", "all"),
])
def test_ported_settings_generate(section, field, value):
    """The D3PM head and every int8 mode build and generate a cohort
    through the generator, with binary mutations."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    cfg = _configure(Config(), 4, "bfloat16")
    setattr(cfg.model.diffusion if section == "diffusion" else cfg.generation, field, value)
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    model = ConditionalDiffusion.from_config(cfg, dims)
    assert model.discrete_head == (field == "discrete_mutation_head")
    gen = SyntheticPatientGenerator(model, cfg, dims, device="cpu")
    out = gen.generate(6, {"survival_time": 500})
    assert gen.sampler().quantize == (None if value in ("none", True) else value)
    assert out["mutations"].shape == (6, 4) and np.isfinite(out["expression"]).all()
    assert set(np.unique(out["mutations"])) <= {0.0, 1.0}


def test_unknown_fused_quantize_raises():
    """As the TPU sampler rejects it (fused_sampler.py:645-648)."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    cfg = Config()
    cfg.generation.fused_quantize = "int4"
    with pytest.raises(ValueError, match="fused_quantize"):
        ConditionalDiffusion.from_config(cfg, cfg.freeze_dims(4, 8, 4, ["a"]))


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
    """Once rejected, "device" now calibrates on the port's
    DeviceCalibrator (on the CPU here) and returns the numpy path's
    marginals: equal per-gene counts, sorted continuous columns within
    1e-4."""
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import DeviceCalibrator

    _, _, _, _, pc, pdims, pmodel, stats, samples, conds = setup
    pc.generation.calibrate_marginals = "copula_joint"
    try:
        pc.generation.calibration_backend = "numpy"
        want = SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats,
                                         device="cpu")._postprocess(samples, conds)
        pc.generation.calibration_backend = "device"
        gen = SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats, device="cpu")
        got = gen._postprocess(torch.from_numpy(samples), conds)
    finally:
        pc.generation.calibration_backend = "auto"
    assert isinstance(gen._device_joint_cal, DeviceCalibrator)
    np.testing.assert_array_equal(got["mutations"].sum(0), want["mutations"].sum(0))
    for key in ("expression", "pathways"):
        np.testing.assert_allclose(np.sort(got[key], axis=0), np.sort(want[key], axis=0),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
