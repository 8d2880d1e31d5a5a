"""The D3PM mutation head of the port against the JAX package.

The binary D3PM algebra (ops/discrete.py), the sampler's coefficient
table with the head on, the DDPM and DDIM samplers with bits (the kernel
sampler through its plain versions, and the plain loop over the
nn.Module), K3's and K1's D3PM modes, the generator's calibration of a
discrete-head cohort and the checkpoint metadata. The JAX references
are the whole-loop sampler in interpret mode and step-by-step loops
over the Flax denoiser, with numpy inputs handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops import discrete as jax_discrete
from osteosarcoma_diffusionmodel_tpu.ops.fused_sampler import FusedSampler as JaxFusedSampler
from osteosarcoma_diffusionmodel_tpu.ops.schedules import ddim_timesteps
from osteosarcoma_diffusionmodel_torch.ops import discrete
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
from torch_parity import DATA_DIMS, TILE_B, make_pair

M = DATA_DIMS[0]
D = sum(DATA_DIMS)
B = 2 * TILE_B
# The bounds of the JAX package's own D3PM parity test
# (tests/test_fused_sampler.py:364-373): bf16-carry tolerance on the
# continuous block, and bits that may flip where two implementations move
# p_prev across a uniform draw. A bit flipped at an intermediate DDIM step
# changes that row's next denoiser input by more than the carry tolerance
# (a few large jumps follow), so there the bf16-product kernel sampler
# must match on 80% of the rows; every other comparison on all rows.
ATOL, RTOL, MAX_MISMATCH = 0.15, 0.05, 0.05


@pytest.fixture(scope="module")
def dpair():
    return make_pair(num_steps=6, discrete=True)


def _conditions(seed=1):
    return np.random.default_rng(seed).standard_normal((B, 3)).astype(np.float32)


def _uniform_noise(steps, seed):
    """Noise made from uniforms, as the JAX test makes it."""
    u = np.random.default_rng(seed).uniform(size=(steps, B, D)).astype(np.float32)
    return ((u - 0.5) * np.float32(sk.UNIFORM_SCALE)).astype(np.float32)


def _check(got, ref, min_rows=1.0):
    """Bits binary, < 5% of them flipped, and at least ``min_rows`` of the
    rows with the continuous block within atol 0.15 / rtol 0.05."""
    assert set(np.unique(got[:, :M])) <= {0.0, 1.0}
    assert float(np.mean(got[:, :M] != ref[:, :M])) < MAX_MISMATCH
    close = np.abs(got[:, M:] - ref[:, M:]) <= ATOL + RTOL * np.abs(ref[:, M:])
    assert float(np.mean(close.all(axis=1))) >= min_rows
    assert float(np.std(ref[:, M:])) > 0.05


# ----------------------------------------------------------------------
# ops/discrete.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("beta,acp_prev", [(0.02, 0.9), (0.5, 0.1), (1e-4, 0.9999), (0.3, 1.0)])
def test_posterior_prob_one_matches_jax(beta, acp_prev):
    """f32 on both sides in the same operation order: 1e-6. The last
    row (acp_prev = 1) returns p1."""
    rng = np.random.default_rng(0)
    x_t = (rng.uniform(size=(7, M)) < 0.5).astype(np.float32)
    p1 = rng.uniform(size=(7, M)).astype(np.float32)
    b32, a32 = np.float32(beta), np.float32(acp_prev)
    ref = np.asarray(jax_discrete.posterior_prob_one(jnp.asarray(x_t), jnp.asarray(p1), b32, a32))
    got = discrete.posterior_prob_one(torch.from_numpy(x_t), torch.from_numpy(p1),
                                      torch.tensor(b32), torch.tensor(a32)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if acp_prev == 1.0:
        np.testing.assert_allclose(got, p1, atol=1e-6)


def test_keep_prob_cross_entropy_and_bit_flips_match_jax():
    acp = np.linspace(0.0, 1.0, 11).astype(np.float32)
    np.testing.assert_allclose(discrete.keep_prob(torch.from_numpy(acp)).numpy(),
                               np.asarray(jax_discrete.keep_prob(jnp.asarray(acp))), atol=1e-7)
    rng = np.random.default_rng(1)
    logits = (5 * rng.standard_normal((6, M))).astype(np.float32)
    bits = (rng.uniform(size=(6, M)) < 0.4).astype(np.float32)
    np.testing.assert_allclose(
        discrete.bernoulli_cross_entropy(torch.from_numpy(logits), torch.from_numpy(bits)).numpy(),
        np.asarray(jax_discrete.bernoulli_cross_entropy(jnp.asarray(logits), jnp.asarray(bits))),
        atol=1e-6)
    # Flip rate (1 - acp)/2 per bit (the JAX stream cannot be reproduced:
    # compared in law, 4000 draws per rate: 0.03 is > 4 standard errors).
    many = torch.from_numpy((rng.uniform(size=(4000, M)) < 0.5).astype(np.float32))
    for a in (0.0, 0.5, 0.9):
        flipped = discrete.q_sample_bits(many, torch.full((4000,), a),
                                         torch.Generator().manual_seed(2))
        assert set(torch.unique(flipped).tolist()) <= {0.0, 1.0}
        assert abs(float((flipped != many).float().mean()) - 0.5 * (1 - a)) < 0.03


# ----------------------------------------------------------------------
# Host tables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ddim", [None, 3])
def test_coefficient_table_with_head_matches_jax(dpair, ddim):
    """Columns 4-5 (beta, acp_prev) with the head on: the port's float64
    schedule rounded once to f32 against the JAX f32 schedule (1e-5
    relative); the last row's acp_prev is exactly 1."""
    jmodel, params, pmodel = dpair
    ref = np.asarray(JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True,
                                     ddim_steps=ddim).coeffs)
    got = FusedSampler(pmodel, "cpu", ddim_steps=ddim).coeffs.numpy()
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=1e-5, atol=1e-7)
    assert got[-1, 5] == 1.0 and np.all(got[:, 4] > 0)
    # Without the head the columns are zeros, as in the JAX table.
    jmodel_c, params_c, pmodel_c = make_pair(num_steps=6)
    assert not FusedSampler(pmodel_c, "cpu", ddim_steps=ddim).coeffs[:, 4:].any()


# ----------------------------------------------------------------------
# Samplers
# ----------------------------------------------------------------------
def test_ddpm_d3pm_matches_jax_fused_sampler(dpair):
    """Buffer mode, the same x_T (the JAX sampler's own prior draw) and
    the same uniform-made noise: the port's kernel sampler (plain
    versions) and its plain loop against the TPU kernel in interpret
    mode with f32 GroupNorm statistics."""
    jmodel, params, pmodel = dpair
    rng = jax.random.PRNGKey(2)
    cond = _conditions()
    noise = _uniform_noise(6, 3)
    jsampler = JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True, gn_mode="f32")
    assert jsampler.mut_dim == M
    ref = np.asarray(jsampler.sample(jnp.asarray(cond), rng, noise=jnp.asarray(noise)))
    init_rng, _ = jax.random.split(rng)
    x_init = torch.from_numpy(np.array(jsampler._x_init(init_rng, B).astype(jnp.float32)))
    args = (torch.from_numpy(cond), torch.Generator().manual_seed(0))
    kw = dict(x_init=x_init, noise=torch.from_numpy(noise))
    sampler = FusedSampler(pmodel, "cpu")
    assert sampler.mut_dim == M
    _check(sampler.sample(*args, **kw).numpy(), ref)
    _check(pmodel.sample(*args, **kw).numpy(), ref)


def jax_ddim_discrete_loop(jmodel, params, cond, x_init, bit_u, steps):
    """eta = 0 DDIM with the D3PM head over the Flax denoiser: bf16 carry,
    f32 arithmetic per step, JAX posterior_prob_one with the strided
    jump's beta_eff = 1 - acp_t/acp_prev (sample_ddim :999-1003,
    :1048-1060), bits from the given uniforms."""
    T = jmodel.schedule.num_steps
    ts = ddim_timesteps(T, steps)[::-1]
    acp = np.asarray(jmodel.schedule.alphas_cumprod, np.float64)
    prev = np.concatenate([ts[1:], [-1]])
    acp_t = acp[ts]
    acp_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], 1.0)
    c1 = np.sqrt((1 - acp_prev) / (1 - acp_t))
    c0 = np.sqrt(acp_prev) - c1 * np.sqrt(acp_t)
    beta = 1.0 - acp_t / acp_prev
    x = jnp.asarray(x_init, jnp.bfloat16)
    for s, t in enumerate(ts):
        xf = x.astype(jnp.float32)
        x_in = xf.at[:, :M].set(2.0 * xf[:, :M] - 1.0)
        out = jmodel.denoiser.apply({"params": params}, x_in, jnp.full((B,), t / T, jnp.float32),
                                    conditions=jnp.asarray(cond))
        x0 = jnp.clip(out, -jmodel.denoised_clip_value, jmodel.denoised_clip_value)
        cont = np.float32(c0[s]) * x0 + np.float32(c1[s]) * xf
        p_prev = jax_discrete.posterior_prob_one(xf[:, :M], jax.nn.sigmoid(out[:, :M]),
                                                 np.float32(beta[s]), np.float32(acp_prev[s]))
        bits = (jnp.asarray(bit_u[s]) < p_prev).astype(jnp.float32)
        x = jnp.concatenate([bits, cont[:, M:]], axis=1).astype(jnp.bfloat16)
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("steps", [3, 6])
def test_ddim_d3pm_matches_jax_loop(steps):
    """The kernel sampler's eta = 0 DDIM draws its bits from Philox
    ("none" mode still draws on the mutation columns); the same uniforms
    go to the port's plain loop through ``bit_uniforms`` and to a JAX
    loop. Both modules compute in f32, so the plain loop agrees on every
    row; the kernel sampler's bf16 products flip a few bits."""
    jmodel, params, pmodel = make_pair(num_steps=20, compute_dtype="float32", discrete=True)
    cond = _conditions(8)
    rng = np.random.default_rng(9)
    x_init = np.concatenate([(rng.uniform(size=(B, M)) < 0.5),
                             rng.standard_normal((B, D - M))], axis=1).astype(np.float32)
    x_init = np.array(jnp.asarray(x_init, jnp.bfloat16).astype(jnp.float32))
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(0)))
    bit_u = torch.stack([sk.philox_uniform(seed, s, B, D, width=M) for s in range(steps)])
    ref = jax_ddim_discrete_loop(jmodel, params, cond, x_init, bit_u.numpy(), steps)
    got = FusedSampler(pmodel, "cpu", ddim_steps=steps).sample(
        torch.from_numpy(cond), torch.Generator().manual_seed(0), x_init=torch.from_numpy(x_init))
    _check(got.numpy(), ref, min_rows=0.8)
    plain = pmodel.sample_ddim(torch.from_numpy(cond), torch.Generator(), steps,
                               x_init=torch.from_numpy(x_init), bit_uniforms=bit_u)
    _check(plain.numpy(), ref)


def test_x_prior_bits_and_statistics(dpair):
    """x_T: Bernoulli(1/2) bits on the mutation block (mean 0.5 within
    0.05 at 2000 x 10 draws), standard normal elsewhere."""
    _, _, pmodel = dpair
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import x_prior

    x = x_prior(2000, D, M, torch.Generator().manual_seed(3))
    assert set(torch.unique(x[:, :M]).tolist()) == {0.0, 1.0}
    assert abs(float(x[:, :M].mean()) - 0.5) < 0.05
    assert abs(float(x[:, M:].std()) - 1.0) < 0.05
    out = FusedSampler(pmodel, "cpu").sample(torch.zeros(5, 3), torch.Generator().manual_seed(4))
    assert set(torch.unique(out[:, :M]).tolist()) <= {0.0, 1.0}


# ----------------------------------------------------------------------
# Kernels' D3PM modes (plain versions)
# ----------------------------------------------------------------------
def _d3pm_inputs(seed=0, b=9, d=70, m=12, steps=4):
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy((3 * rng.standard_normal((b, d))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    x[:, :m] = torch.from_numpy((rng.uniform(size=(b, m)) < 0.5).astype(np.float32))
    b_out = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    coeffs = torch.from_numpy(rng.uniform(0.1, 0.9, (steps, 6)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, b, d)).astype(np.float32))
    return acc, x.to(torch.bfloat16), b_out, coeffs, noise


@pytest.mark.parametrize("mode", ["none", "buffer", "philox"])
def test_posterior_step_d3pm_matches_jax_algebra(mode):
    """K3's plain version with mut_dim against the TPU's st_out/st_post
    in jax f32 on the same inputs and uniforms: continuous columns within
    one bf16 rounding (2^-7 relative), bits exact except where the two
    f32 evaluations straddle a uniform (at most 1 of 108 here)."""
    acc, x, b_out, coeffs, noise = _d3pm_inputs()
    step, m = 2, 12
    got = sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, step, mode, noise=noise, seed=5,
                               mut_dim=m).float().numpy()
    c0, c1, sv, g, beta, acp_prev = (np.float32(v) for v in coeffs[step].numpy())
    xf = jnp.asarray(x.float().numpy())
    xt = xf.at[:, :m].set(2.0 * xf[:, :m] - 1.0)
    out = jnp.asarray(acc.numpy()) + jnp.asarray(b_out.numpy()) + g * xt
    cont = c0 * jnp.clip(out, -30, 30) + c1 * xf
    if mode == "buffer":
        z = jnp.asarray(noise[step].numpy())
        cont, u = cont + sv * z, z * np.float32(1 / sk.UNIFORM_SCALE) + 0.5
    else:
        u = jnp.asarray(sk.philox_uniform(5, step, *x.shape).numpy())
        if mode == "philox":
            cont = cont + sv * (u - 0.5) * np.float32(sk.UNIFORM_SCALE)
    p_prev = jax_discrete.posterior_prob_one(xf[:, :m], jax.nn.sigmoid(out[:, :m]), beta, acp_prev)
    bits = np.asarray((u[:, :m] < p_prev).astype(jnp.float32))
    assert set(np.unique(got[:, :m])) <= {0.0, 1.0}
    assert int((got[:, :m] != bits).sum()) <= 1
    np.testing.assert_allclose(got[:, m:], np.asarray(cont)[:, m:], rtol=2 ** -7, atol=1e-6)


def test_posterior_step_bits_use_the_same_uniforms_in_every_mode():
    """"none" (DDIM) draws the bits from the same Philox values that
    "philox" mode turns into noise, so with sv = 0 both give equal bits."""
    acc, x, b_out, coeffs, _ = _d3pm_inputs(1)
    coeffs[:, 2] = 0.0
    a = sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, 1, "none", seed=9, mut_dim=12)
    b = sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, 1, "philox", seed=9, mut_dim=12)
    assert torch.equal(a, b)
    assert not torch.equal(a, sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, 1, "none",
                                                   seed=10, mut_dim=12))


def test_gemm_mut_prologue_matches_jax_dot():
    """K1 with a_mut_cols: the TPU's (1 + mask)·x - mask in f32, rounded to
    bf16 for the dot, f32 accumulation (1e-5 relative); ``a`` unchanged."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((19, 70)).astype(np.float32)).to(torch.bfloat16)
    a[:, :12] = torch.from_numpy((rng.uniform(size=(19, 12)) < 0.5).astype(np.float32)).to(
        torch.bfloat16)
    before = a.clone()
    w = torch.from_numpy((rng.standard_normal((70, 32)) / 8).astype(np.float32)).to(torch.bfloat16)
    got = sk.gemm_bf16_f32acc(a, w, a_mut_cols=12)
    mask = (np.arange(70) < 12).astype(np.float32)
    xf = jnp.asarray(a.float().numpy())
    ref = jnp.dot(((1.0 + mask) * xf - mask).astype(jnp.bfloat16),
                  jnp.asarray(w.float().numpy(), jnp.bfloat16), preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert torch.equal(a, before)


# ----------------------------------------------------------------------
# Generator and checkpoint
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["copula_joint", "copula_full", "copula", "quantile", False])
def test_discrete_head_calibration_matches_jax_host_path(tmp_path, mode):
    """The model owns the bits: calibration passes them through and
    reshapes the continuous block (copula_joint -> the copula_full
    route); bit-identical to the JAX host path on the same samples."""
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data, prepare_arrays
    from osteosarcoma_diffusionmodel_tpu.generation.generator import (
        SyntheticPatientGenerator as JaxGenerator,
    )
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays
    from torch_parity import _configure

    make_dummy_data(tmp_path, n_samples=40, n_mutation_genes=M, n_expression_genes=40,
                    n_pathways=14)
    jc = _configure(JaxConfig(), 6, "bfloat16", discrete=True)
    jc.data.processed_dir = str(tmp_path)
    arrays, jdims = prepare_arrays(jc)
    stats = data_stats_from_arrays(arrays.data, arrays.conditions, M)
    jmodel, params, pmodel = make_pair(discrete=True)
    pc = _configure(Config(), 6, "bfloat16", discrete=True)
    pdims = pc.freeze_dims(jdims.mutation_dim, jdims.expression_dim, jdims.pathway_dim,
                           jdims.condition_names, jdims.survival_mean, jdims.survival_std)
    rng = np.random.default_rng(5)
    samples = rng.standard_normal((60, jdims.data_dim)).astype(np.float32)
    samples[:, :M] = (rng.uniform(size=(60, M)) < 0.3).astype(np.float32)
    conds = rng.standard_normal((60, 3)).astype(np.float32)
    jc.generation.calibrate_marginals = mode
    pc.generation.calibrate_marginals = mode
    ref = JaxGenerator(jmodel, params, jc, jdims, data_stats=stats)._postprocess(samples, conds)
    got = SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats, device="cpu")._postprocess(samples,
                                                                                     conds)
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    np.testing.assert_array_equal(got["mutations"], samples[:, :M])


def test_discrete_head_round_trips_through_metadata(tmp_path):
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import (
        load_metadata,
        metadata_to_dims,
        save_metadata,
    )

    cfg = Config()
    cfg.model.diffusion.discrete_mutation_head = True
    dims = cfg.freeze_dims(4, 8, 4, ["a"])
    save_metadata(tmp_path, cfg, dims)
    meta = load_metadata(tmp_path)
    back = Config.from_dict(meta["config"])
    assert back.model.diffusion.discrete_mutation_head is True
    model = ConditionalDiffusion.from_config(back, metadata_to_dims(meta))
    assert model.discrete_head and model.mutation_dim == 4
    cfg.model.diffusion.discrete_mutation_head = False
    save_metadata(tmp_path, cfg, dims)
    again = ConditionalDiffusion.from_config(Config.from_dict(load_metadata(tmp_path)["config"]),
                                             dims)
    assert not again.discrete_head
