"""(c) DDPM, (d) DDIM and (f) the in-loop noise of the port's sampler
against the JAX package's whole-loop sampler.

The port's ``FusedSampler`` runs here with the kernels' plain versions
(CPU tensors), through the same per-step orchestration the card runs.
The JAX reference is ``FusedSampler(interpret=True, gn_mode="f32")``,
the TPU kernel in interpret mode with exact Flax GroupNorm numerics,
plus a step-by-step loop over the Flax denoiser. Inputs and noise are
drawn with numpy or jax.random on the test side and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops.fused_sampler import FusedSampler as JaxFusedSampler
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import (
    UNIFORM_SCALE,
    philox4x32_10,
    philox_uniform_noise,
)
from torch_parity import DATA_DIMS, TILE_B, make_pair

D = sum(DATA_DIMS)
B = 2 * TILE_B
# The bf16-carry tolerance of tests/test_fused_sampler.py:101: every step
# rounds the carry to bf16 (8 mantissa bits) and the two sides round
# their products and sums at different points.
ATOL, RTOL = 0.15, 0.05


def _x_init(rng):
    """The JAX sampler's x_T: normal(split(rng)[0], (B, D), bf16)."""
    init_rng, _ = jax.random.split(rng)
    return np.array(jax.random.normal(init_rng, (B, D), jnp.bfloat16).astype(jnp.float32))


def _conditions(seed=1):
    return np.random.default_rng(seed).standard_normal((B, 3)).astype(np.float32)


def jax_reference_loop(jmodel, params, conditions, x_init, noise):
    """bf16-carry reverse loop over the Flax denoiser (f32 arithmetic per
    step, one bf16 rounding), as in tests/test_fused_sampler.py."""
    sched = jmodel.schedule
    T = sched.num_steps
    c0 = np.asarray(sched.posterior_coef_x0)
    c1 = np.asarray(sched.posterior_coef_xt)
    sv = np.sqrt(np.asarray(sched.posterior_variance))
    x = jnp.asarray(x_init, jnp.bfloat16)
    for s, t in enumerate(range(T - 1, -1, -1)):
        pred = jmodel.denoiser.apply({"params": params}, x.astype(jnp.float32),
                                     jnp.full((B,), t / T, jnp.float32),
                                     conditions=jnp.asarray(conditions))
        x0 = jnp.clip(pred, -jmodel.denoised_clip_value, jmodel.denoised_clip_value)
        if t > 0:
            x = (c0[t] * x0 + c1[t] * x.astype(jnp.float32) + sv[t] * noise[s]).astype(jnp.bfloat16)
        else:
            x = x0.astype(jnp.bfloat16)
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture(scope="module")
def pair():
    return make_pair(num_steps=6)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert float(np.std(ref)) > 0.05  # the comparison sees real signal


def test_ddpm_matches_jax_fused_sampler(pair):
    jmodel, params, pmodel = pair
    rng = jax.random.PRNGKey(2)
    cond = _conditions()
    noise = np.random.default_rng(3).standard_normal((6, B, D)).astype(np.float32)
    ref = np.asarray(JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True,
                                     gn_mode="f32").sample(jnp.asarray(cond), rng,
                                                           noise=jnp.asarray(noise)))
    got = FusedSampler(pmodel, "cpu").sample(
        torch.from_numpy(cond), torch.Generator().manual_seed(0),
        x_init=torch.from_numpy(_x_init(rng)), noise=torch.from_numpy(noise)).numpy()
    _close(got, ref)


def test_padded_carry_acc_and_w_out_layout():
    """At a data width that is not a multiple of 16 (50), the carry, acc
    and the kernel copy of W_out have rows padded to 64 columns (16-byte
    multiples, so K1 reads them through TMA); the sample still has 50
    contiguous columns and still matches the TPU kernel in interpret mode
    at the bf16-carry tolerance."""
    dims = (10, 31, 9)
    d = sum(dims)
    jmodel, params, pmodel = make_pair(num_steps=6, data_dims=dims)
    sampler = FusedSampler(pmodel, "cpu")
    buf = sampler._buffers(B)
    assert sampler.w_out.w.shape == (128, d) and sampler.w_out.w.stride(0) == 64
    assert buf["acc"].shape == (B, d) and buf["acc"].stride(0) == 64
    rng = jax.random.PRNGKey(8)
    cond = _conditions(9)
    noise = np.random.default_rng(10).standard_normal((6, B, d)).astype(np.float32)
    ref = np.asarray(JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True,
                                     gn_mode="f32").sample(jnp.asarray(cond), rng,
                                                           noise=jnp.asarray(noise)))
    init_rng, _ = jax.random.split(rng)
    x_init = np.array(jax.random.normal(init_rng, (B, d), jnp.bfloat16).astype(jnp.float32))
    got = sampler.sample(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                         x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise))
    assert got.shape == (B, d) and got.is_contiguous()
    _close(got.numpy(), ref)


def test_ddpm_matches_jax_reference_loop(pair):
    jmodel, params, pmodel = pair
    x_init = _x_init(jax.random.PRNGKey(4))
    cond = _conditions(5)
    noise = np.random.default_rng(6).standard_normal((6, B, D)).astype(np.float32)
    ref = jax_reference_loop(jmodel, params, cond, x_init, noise)
    args = (torch.from_numpy(cond), torch.Generator().manual_seed(0))
    kw = dict(x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise))
    _close(FusedSampler(pmodel, "cpu").sample(*args, **kw).numpy(), ref)
    # The port's plain loop over its nn.Module is the same sampler.
    _close(pmodel.sample(*args, **kw).numpy(), ref)


@pytest.mark.parametrize("steps", [3, 6])
def test_ddim_matches_jax_fused_sampler(steps):
    jmodel, params, pmodel = make_pair(num_steps=20)
    rng = jax.random.PRNGKey(7)
    cond = _conditions(8)
    ref = np.asarray(JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True,
                                     gn_mode="f32", ddim_steps=steps).sample(jnp.asarray(cond), rng))
    x_init = torch.from_numpy(_x_init(rng))
    gen = torch.Generator().manual_seed(0)
    got = FusedSampler(pmodel, "cpu", ddim_steps=steps).sample(torch.from_numpy(cond), gen,
                                                                x_init=x_init)
    _close(got.numpy(), ref)
    _close(pmodel.sample_ddim(torch.from_numpy(cond), gen, steps, x_init=x_init).numpy(), ref)


def test_sampler_tables_match_jax(pair):
    """Host tables: t_add is the same numpy arithmetic on the same f32
    weights (1e-6); the coefficient table differs only by the JAX
    schedule's float32 rounding (1e-3 relative, see test_torch_schedules)."""
    jmodel, params, pmodel = pair
    for ddim in (None, 3):
        ref = JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True, ddim_steps=ddim)
        got = FusedSampler(pmodel, "cpu", ddim_steps=ddim)
        np.testing.assert_allclose(got.t_add.numpy(), np.asarray(ref.t_add), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.coeffs.numpy()[:, :4], np.asarray(ref.coeffs)[:, :4],
                                   rtol=1e-3, atol=1e-6)
        # The last row returns clip(x0) with no noise in both samplers.
        np.testing.assert_allclose(got.coeffs.numpy()[-1, :3], [1.0, 0.0, 0.0], atol=1e-7)


def test_ragged_batch_and_conditions_have_effect(pair):
    _, _, pmodel = pair
    sampler = FusedSampler(pmodel, "cpu")
    x_init = torch.zeros(TILE_B + 3, D)
    noise = torch.zeros(6, TILE_B + 3, D)
    gen = torch.Generator().manual_seed(0)
    a = sampler.sample(torch.zeros(TILE_B + 3, 3), gen, x_init=x_init, noise=noise)
    b = sampler.sample(5.0 * torch.ones(TILE_B + 3, 3), gen, x_init=x_init, noise=noise)
    assert a.shape == (TILE_B + 3, D) and torch.isfinite(a).all()
    assert float((a - b).abs().max()) > 1e-3


def test_noise_shape_is_checked(pair):
    _, _, pmodel = pair
    with pytest.raises(ValueError):
        FusedSampler(pmodel, "cpu").sample(torch.zeros(4, 3), torch.Generator(),
                                           noise=torch.zeros(5, 4, D))
    with pytest.raises(ValueError):
        FusedSampler(pmodel, "cpu", ddim_steps=3).sample(torch.zeros(4, 3), torch.Generator(),
                                                         noise=torch.zeros(3, 4, D))


# ----------------------------------------------------------------------
# (f) the in-loop uniform noise
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expected):
    """Philox4x32-10 known-answer vectors of its authors (Random123)."""
    words = philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == expected


def test_philox_noise_statistics():
    """U(-sqrt3, sqrt3): mean 0 (6 standard errors at 400k draws = 0.0095),
    variance 1 (|var - 1| < 0.01), support within +-sqrt3."""
    z = philox_uniform_noise(1234, 5, 400, 1000)
    assert z.dtype == torch.float32
    assert abs(float(z.mean())) < 0.0095
    assert abs(float(z.var()) - 1.0) < 0.01
    assert float(z.abs().max()) <= np.sqrt(3.0)
    hist = torch.histc(z, bins=10, min=-np.sqrt(3.0), max=np.sqrt(3.0)) / z.numel()
    assert float((hist - 0.1).abs().max()) < 0.005  # flat density


def test_philox_stream_is_keyed_and_layout_free():
    a = philox_uniform_noise(7, 3, 20, 64)
    assert torch.equal(a[:10], philox_uniform_noise(7, 3, 10, 64))  # counter = row*D + col
    assert not torch.equal(a, philox_uniform_noise(7, 4, 20, 64))  # new step
    assert not torch.equal(a, philox_uniform_noise(8, 3, 20, 64))  # new seed
    assert torch.equal(a, philox_uniform_noise(7, 3, 20, 64))


def test_in_loop_noise_matches_buffer_noise_in_law(pair):
    """DDPM with the in-loop Philox noise against DDPM with numpy
    U(-sqrt3, sqrt3) noise fed through the buffer: the same law, so the
    cohort mean and spread agree within sampling error (512 samples per
    side: 0.05 on the mean of O(0.5)-spread features, 10% on the std)."""
    _, _, pmodel = pair
    n = 512
    cond = torch.zeros(n, 3)
    x_init = torch.from_numpy(np.random.default_rng(9).standard_normal((n, D)).astype(np.float32))
    sampler = FusedSampler(pmodel, "cpu")
    a = sampler.sample(cond, torch.Generator().manual_seed(10), x_init=x_init)
    u = np.random.default_rng(11).uniform(-0.5, 0.5, (6, n, D)).astype(np.float32) * UNIFORM_SCALE
    b = sampler.sample(cond, torch.Generator().manual_seed(10), x_init=x_init,
                       noise=torch.from_numpy(u))
    assert not torch.equal(a, b)
    assert float((a.mean(0) - b.mean(0)).abs().mean()) < 0.05
    ratio = a.std(0).mean() / b.std(0).mean()
    assert 0.9 < float(ratio) < 1.1
