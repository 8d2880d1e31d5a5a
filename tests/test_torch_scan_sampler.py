"""The port's scan samplers (``ConditionalDiffusion.scan_sample`` and
``scan_sample_ddim``) against the JAX package's ``lax.scan`` samplers
(``sample``, ``sample_ddim``), and the generator's route between them and
the kernel sampler against the JAX rule (``supports_fused`` and guidance 1).

Tiny shapes (data 10/40/14, hidden 128/256/128, T = 12). The JAX models
split their keys with threefry, so each test rebuilds every draw of the
JAX sampler from its key (x_T, the step noise, low-rank sigma's eps and
eps_k, the D3PM uniforms, the final residual) and passes them to the port.
The port's model takes the JAX schedule's float32 tables, so the
comparison is not blurred by the schedules' float32 rounding
(tests/test_torch_schedules.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.generation.generator import (
    SyntheticPatientGenerator as JaxGenerator,
)
from osteosarcoma_diffusionmodel_tpu.ops.fused_sampler import supports_fused as jax_supports_fused
from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module
from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler, supports_fused
from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule
from torch_parity import CONDITIONS, DATA_DIMS, make_pair

T = 12
B = 16
D = sum(DATA_DIMS)
M = DATA_DIMS[0]
LR = 3
# f32 compute and carry: the same operations in another summation order
# through 11 composed steps. Under CFG at guidance 7.5 the chain amplifies
# rounding: the bound is twice what the JAX sampler itself moves when its
# weights move by 1e-6 (relative), measured in the test. bf16 carry: the
# JAX package's own bf16-carry bound (tests/test_fused_sampler.py:101,
# tests/test_torch_sampler.py) on all but 0.5% of the values (v's x0 is a
# difference of O(10) terms, so a bf16 rounding that the two frameworks
# place differently moves it by a few ulps of those terms), every value
# within 0.5.
GUIDANCE = 7.5
F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=0.15, rtol=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(overrides, dtype="float32", discrete=False):
    """The pair on the JAX schedule's tables."""
    jmodel, params, pmodel = make_pair(num_steps=T, compute_dtype=dtype, discrete=discrete,
                                       overrides=overrides, rng_impl="threefry")
    js = jmodel.schedule
    sched = DiffusionSchedule(**{f.name: np.asarray(getattr(js, f.name), np.float64)
                                 for f in dataclasses.fields(DiffusionSchedule)})
    return jmodel, params, dataclasses.replace(pmodel, schedule=sched)


def _conditions(seed=3):
    return np.random.default_rng(seed).standard_normal((B, len(CONDITIONS))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _prior(key_x, key_bits, jmodel, dtype):
    m = jmodel.mutation_dim if jmodel.discrete_head else 0
    x = jax.random.normal(key_x, (B, D - m), dtype)
    if m:
        bits = jax.random.bernoulli(key_bits, 0.5, (B, m))
        x = jnp.concatenate([bits.astype(dtype), x], axis=1)
    return _t(x.astype(jnp.float32))


def ddpm_draws(jmodel, rng):
    """Every draw JAX ``sample`` makes from ``rng`` (diffusion.py:752-937),
    under the port's names."""
    m = jmodel.mutation_dim if jmodel.discrete_head else 0
    lr = jmodel.low_rank_sigma_dim
    carry = jnp.dtype(jmodel.sample_dtype)
    init_rng, scan_rng, final_rng, bit_rng = jax.random.split(rng, 4)
    out = {"x_T": _prior(init_rng, bit_rng, jmodel, carry)}
    steps = {k: [] for k in ("z", "lr_eps", "lr_epsk", "bits")}
    for key in jax.random.split(scan_rng, T - 1):
        noise_key = key
        if m:
            noise_key, bit_key = jax.random.split(key)
            steps["bits"].append(jax.random.uniform(bit_key, (B, m)))
        if lr:
            noise_key, e_key, f_key = jax.random.split(noise_key, 3)
            steps["lr_eps"].append(jax.random.normal(e_key, (B, D - m), jnp.float32))
            steps["lr_epsk"].append(jax.random.normal(f_key, (B, lr), jnp.float32))
        steps["z"].append(jmodel._step_noise(noise_key, (B, D - m), carry).astype(jnp.float32))
    out.update({k: _t(np.stack(v)) for k, v in steps.items() if v})
    resid_rng = final_rng
    if m:
        resid_rng, final_bit_rng = jax.random.split(final_rng)
        out["final_bits"] = _t(jax.random.uniform(final_bit_rng, (B, m)))
    if jmodel.learn_sigma:
        out["final_z"] = _t(jax.random.normal(resid_rng, (B, D - m), jnp.float32))
    if lr:
        e_key, f_key = jax.random.split(resid_rng)
        out["final_lr_eps"] = _t(jax.random.normal(e_key, (B, D - m), jnp.float32))
        out["final_lr_epsk"] = _t(jax.random.normal(f_key, (B, lr), jnp.float32))
    return out


def ddim_draws(jmodel, rng, n_steps):
    """The draws JAX ``sample_ddim`` makes from ``rng`` (:942-1063): x_T,
    the last step's z (learned sigma's residual) and the D3PM uniforms."""
    m = jmodel.mutation_dim if jmodel.discrete_head else 0
    init_rng, scan_rng, bit_rng = jax.random.split(rng, 3)
    out = {"x_T": _prior(init_rng, bit_rng, jmodel, jnp.float32)}
    bits = []
    for key in jax.random.split(scan_rng, n_steps):
        step_key = key
        if m:
            step_key, bit_key = jax.random.split(key)
            bits.append(jax.random.uniform(bit_key, (B, m)))
        z = jax.random.normal(step_key, (B, D - m), jnp.float32)
    out["final_z"] = _t(z)
    if bits:
        out["bits"] = _t(np.stack(bits))
    return out


def _sensitive_tol(sample, params):
    """F32, widened to twice the largest change of the JAX sampler's output
    (``sample(params)``) when every weight moves by 1e-6 (relative)."""
    moved = jax.tree_util.tree_map(lambda a: (a * (1 + 1e-6)).astype(a.dtype), params)
    spread = float(np.abs(np.asarray(sample(params)) - np.asarray(sample(moved))).max())
    return dict(atol=max(F32["atol"], 2 * spread), rtol=F32["rtol"])


def _close(got, ref, tol, m=0):
    """Continuous columns within ``tol`` (under BF16, all but 0.5% of them,
    every one within 0.5); the D3PM bits equal but for a few rows where a
    uniform lies within the tolerance's reach of p."""
    got, ref = got.numpy(), np.asarray(ref)
    assert np.isfinite(got).all() and float(np.std(ref)) > 0.05
    if tol is BF16:
        diff = np.abs(got[:, m:] - ref[:, m:])
        assert (diff > tol["atol"] + tol["rtol"] * np.abs(ref[:, m:])).mean() <= 0.005
        assert diff.max() <= 0.5
    else:
        np.testing.assert_allclose(got[:, m:], ref[:, m:], **tol)
    if m:
        assert np.isin(got[:, :m], (0.0, 1.0)).all()
        assert (got[:, :m] != ref[:, :m]).mean() < 0.02


DDPM_CASES = {
    "x0": ({}, "float32"),
    "x0-noclip-noskip": ({"model.diffusion.clip_denoised": False,
                          "model.denoiser_input_skip": False}, "float32"),
    "v": ({"model.diffusion.parameterization": "v"}, "float32"),
    "epsilon": ({"model.diffusion.parameterization": "epsilon"}, "float32"),
    "learned-sigma": ({"model.diffusion.parameterization": "v",
                       "model.diffusion.learn_sigma": True}, "float32"),
    "low-rank-sigma": ({"model.diffusion.parameterization": "epsilon",
                        "model.diffusion.low_rank_sigma_dim": LR}, "float32"),
    "low-rank-mutations": ({"model.diffusion.low_rank_sigma_dim": LR,
                            "model.diffusion.low_rank_sigma_scope": "mutations"}, "float32"),
    "cfg": ({"model.cfg_dropout_prob": 0.1}, "float32"),
    "cfg-learned-sigma": ({"model.cfg_dropout_prob": 0.1,
                           "model.diffusion.learn_sigma": True}, "float32"),
    "noise-normal": ({"generation.noise_type": "normal"}, "float32"),
    "d3pm-v": ({"model.diffusion.parameterization": "v"}, "float32"),
    "bf16-carry": ({"model.diffusion.parameterization": "v"}, "bfloat16"),
}


@pytest.mark.parametrize("case", list(DDPM_CASES))
def test_scan_sample_matches_jax_sample(case):
    """DDPM-12 with every draw of the JAX sampler injected: f32 compute
    and carry within 2e-4 (under CFG at guidance 7.5, within twice the JAX
    sampler's own spread); bf16 compute and carry within the bf16-carry
    bound."""
    overrides, dtype = DDPM_CASES[case]
    overrides = dict(overrides, **{"generation.sample_dtype": dtype})
    discrete = case.startswith("d3pm")
    jmodel, params, pmodel = _pair(overrides, dtype, discrete)
    guidance = GUIDANCE if "cfg" in case else 1.0
    cond = _conditions()
    rng = jax.random.PRNGKey(7)
    ref = jmodel.sample(params, jnp.asarray(cond), rng, guidance_scale=guidance)
    got = pmodel.scan_sample(torch.from_numpy(cond), guidance_scale=guidance,
                             draws=ddpm_draws(jmodel, rng))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    tol = BF16 if dtype == "bfloat16" else F32
    if guidance != 1.0:
        tol = _sensitive_tol(lambda p: jmodel.sample(p, jnp.asarray(cond), rng,
                                                     guidance_scale=guidance), params)
    _close(got, ref, tol, M if discrete else 0)


DDIM_CASES = {
    "v": {"model.diffusion.parameterization": "v"},
    "epsilon": {"model.diffusion.parameterization": "epsilon"},
    "learned-sigma": {"model.diffusion.learn_sigma": True},
    "cfg": {"model.cfg_dropout_prob": 0.1},
    "cfg-learned-sigma-v": {"model.cfg_dropout_prob": 0.1, "model.diffusion.learn_sigma": True,
                            "model.diffusion.parameterization": "v"},
    "d3pm-epsilon": {"model.diffusion.parameterization": "epsilon"},
}


@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_scan_sample_ddim_matches_jax(case):
    """eta = 0 DDIM-5 with x_T, the last step's z and the D3PM uniforms of
    the JAX sampler injected, f32 within 2e-4; CFG at guidance 7.5."""
    discrete = case.startswith("d3pm")
    jmodel, params, pmodel = _pair(DDIM_CASES[case], "float32", discrete)
    guidance = GUIDANCE if "cfg" in case else 1.0
    cond = _conditions(4)
    rng = jax.random.PRNGKey(9)
    ref = jmodel.sample_ddim(params, jnp.asarray(cond), rng, num_sampling_steps=5,
                             guidance_scale=guidance)
    got = pmodel.scan_sample_ddim(torch.from_numpy(cond), num_sampling_steps=5,
                                  guidance_scale=guidance, draws=ddim_draws(jmodel, rng, 5))
    tol = F32
    if guidance != 1.0:
        tol = _sensitive_tol(lambda p: jmodel.sample_ddim(
            p, jnp.asarray(cond), rng, num_sampling_steps=5, guidance_scale=guidance), params)
    _close(got, ref, tol, M if discrete else 0)


def test_scan_sample_draws_from_its_generator():
    """Without injected draws: the same seed gives the same cohort, another
    seed another, and the DDPM carry is finite."""
    _, _, pmodel = _pair({"model.diffusion.parameterization": "v",
                          "model.diffusion.low_rank_sigma_dim": LR})
    cond = torch.from_numpy(_conditions())
    a, b, c = (pmodel.scan_sample(cond, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    d = pmodel.scan_sample_ddim(cond, torch.Generator().manual_seed(1), 4)
    assert torch.isfinite(d).all()


# ----------------------------------------------------------------------
# The generator's route
# ----------------------------------------------------------------------
ROUTE_GRID = [
    {},
    {"model.diffusion.ar_mutation_head": True},
    {"model.diffusion.latent_factor_dim": 2},
    {"model.diffusion.latent_factor_dim": 2, "model.diffusion.latent_encoder_input": "mutations"},
    {"model.cfg_dropout_prob": 0.1},
    {"model.cfg_dropout_prob": 0.1, "generation.guidance_scale": 1.0},
    {"model.diffusion.parameterization": "v"},
    {"model.diffusion.parameterization": "epsilon"},
    {"model.diffusion.learn_sigma": True},
    {"model.diffusion.low_rank_sigma_dim": 2},
    {"model.diffusion.clip_denoised": False},
    {"model.denoiser_input_skip": False},
    {"generation.noise_type": "normal"},
    {"generation.sample_dtype": "float32"},
    {"model.hidden_dims": [64, 128, 64]},
]


@pytest.mark.parametrize("overrides", ROUTE_GRID, ids=lambda o: ",".join(
    f"{k.split('.')[-1]}={v}" for k, v in o.items()) or "default")
def test_generator_route_matches_jax_rule(overrides):
    """The port's generator takes the kernel sampler exactly where the JAX
    package's supports_fused holds at guidance 1 (guidance: the config's
    scale where the model was trained with condition dropout), and the
    other sampler's entry point is never called (a spy on each)."""
    jmodel, params, pmodel = make_pair(num_steps=4, overrides=overrides)
    jgen = JaxGenerator(jmodel, params, _route_config(overrides, jax=True), None)
    jax_guidance = (jgen.config.generation.guidance_scale if jmodel.cfg_dropout_prob > 0
                    else 1.0)
    want = jax_supports_fused(jmodel) and jax_guidance == 1.0
    pcfg = _route_config(overrides)
    gen = SyntheticPatientGenerator(pmodel, pcfg, None, device="cpu")
    assert supports_fused(pmodel) == jax_supports_fused(jmodel)
    assert gen.guidance() == jax_guidance and gen.uses_kernels() == want
    calls = []

    def spy(name, real):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return wrapped

    cond = _conditions()[:4]
    if pmodel.latent_factor_dim:
        cond = np.concatenate([cond, np.zeros((4, pmodel.latent_factor_dim), np.float32)], 1)
        pmodel = dataclasses.replace(pmodel, latent_factor_dim=0)  # conditions arrive widened
        gen.model = pmodel
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(FusedSampler, "sample", spy("kernel", FusedSampler.sample))
        mp.setattr(ConditionalDiffusion, "scan_sample", spy("scan", ConditionalDiffusion.scan_sample))
        gen_module.SAMPLERS.clear()
        out = gen.sample_raw(cond, torch.Generator().manual_seed(0))
    finally:
        mp.undo()
    assert calls == (["kernel"] if want else ["scan"])
    assert dict(gen_module.SAMPLERS) == {"kernel" if want else "scan": 1}
    assert torch.isfinite(out).all() and out.shape == (4, D)


def _route_config(overrides, jax=False):
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_torch.config import Config
    from torch_parity import _configure

    cfg = _configure(JaxConfig() if jax else Config(), 4, "bfloat16", overrides=overrides)
    cfg.generation.sampler = "ddpm"
    return cfg
