"""The latent-tail sampler of the port against the JAX package's
(osteosarcoma_diffusionmodel_tpu/ops/latent_sampler.py), and K7's plain
version against a written-out step.

The port runs on CPU tensors here, so ``LatentFusedSampler`` runs the
plain versions of K1/K2/K3/K7 through the same per-step orchestration the
card runs. The JAX references are ``LatentTailSampler`` (its XLA
reference) and ``LatentFusedSampler(interpret=True, gn_mode="f32")`` (the
TPU kernel in interpret mode). Inputs are drawn on the test side (numpy,
or jax.random where the JAX sampler draws x_T itself) and handed to both.

Where the point is the latent algebra (host tables, the exact-noise
sampler), the port's model takes the JAX schedule's float32 tables (as
float64), so the comparison is not blurred by the schedules' 1e-3
float32 rounding difference (tests/test_torch_schedules.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.ops.fused_sampler import FusedSampler as JaxFusedSampler
from osteosarcoma_diffusionmodel_tpu.ops.latent_sampler import (
    LatentFusedSampler as JaxLatentFused,
    LatentTailSampler as JaxLatentTail,
    supports_latent as jax_supports_latent,
)
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.networks import DiffusionDenoiser
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
from osteosarcoma_diffusionmodel_torch.ops.latent_sampler import (
    LatentFusedSampler,
    LatentTailSampler,
    calibrate_head_steps,
    supports_latent,
)
from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule
from torch_parity import CONDITIONS, DATA_DIMS, TILE_B, make_pair

T = 8
B = 2 * TILE_B
D = sum(DATA_DIMS)
# The JAX package's own bounds: exact-noise latent vs data space to f32
# association error (test_latent_sampler.py:106), the kernel hybrid to
# the bf16-carry tolerance (:213-215).
EXACT = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=0.15, rtol=0.05)


def with_jax_schedule(pmodel, jmodel):
    """The port's model on the JAX schedule's float32 tables."""
    js = jmodel.schedule
    sched = DiffusionSchedule(**{f.name: np.asarray(getattr(js, f.name), np.float64)
                                 for f in dataclasses.fields(DiffusionSchedule)})
    return dataclasses.replace(pmodel, schedule=sched)


@pytest.fixture(scope="module")
def f32_pair():
    jmodel, params, pmodel = make_pair(num_steps=T, compute_dtype="float32")
    return jmodel, params, with_jax_schedule(pmodel, jmodel)


def _conditions(seed=1, rows=B):
    return np.random.default_rng(seed).standard_normal((rows, len(CONDITIONS))).astype(np.float32)


def _np(t):
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, np.float64)


# ----------------------------------------------------------------------
# supports_latent
# ----------------------------------------------------------------------
@pytest.mark.parametrize("change", ["parameterization", "learn_sigma", "clip_denoised"])
def test_configs_jax_refuses_are_refused(change):
    """Each configuration the JAX gate refuses, the port's gate refuses,
    and the latent sampler will not take it (the model itself builds)."""
    jc, pc = JaxConfig(), Config()
    for cfg in (jc, pc):
        cfg.model.hidden_dims = [128, 256, 128]
        cfg.model.latent_dim = 32
    jdims = jc.freeze_dims(*DATA_DIMS, CONDITIONS)
    jmodel = JaxDiffusion.from_config(jc, jdims)
    assert jax_supports_latent(jmodel)
    bad = {"parameterization": "epsilon", "learn_sigma": True, "clip_denoised": False}[change]
    assert not jax_supports_latent(dataclasses.replace(jmodel, **{change: bad}))
    setattr(pc.model.diffusion, change, bad)
    pmodel = ConditionalDiffusion.from_config(pc, pc.freeze_dims(*DATA_DIMS, CONDITIONS))
    assert not supports_latent(pmodel)
    with pytest.raises(ValueError, match="latent-tail"):
        LatentTailSampler(pmodel, 1, "cpu")


def test_supports_latent_gates(f32_pair):
    jmodel, _, pmodel = f32_pair
    assert supports_latent(pmodel) and jax_supports_latent(jmodel)
    d3pm = dataclasses.replace(pmodel, discrete_head=True, mutation_dim=DATA_DIMS[0])
    assert not supports_latent(d3pm)
    assert not jax_supports_latent(dataclasses.replace(jmodel, discrete_head=True))
    no_skip = dataclasses.replace(pmodel, denoiser=DiffusionDenoiser(
        D, len(CONDITIONS), 32, 16, (128, 256, 128), input_skip=False))
    assert not supports_latent(no_skip)
    for model in (d3pm, no_skip):
        with pytest.raises(ValueError):
            LatentTailSampler(model, 1, "cpu")
    for head in (0, T):
        with pytest.raises(ValueError):
            LatentTailSampler(pmodel, head, "cpu")


# ----------------------------------------------------------------------
# Host tables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("head", [1, 3, T - 1])
def test_host_tables_match_jax(f32_pair, head):
    """float64 host algebra on the same f32 weights and schedule, cast
    once to f32: equal within f32 rounding (rtol 1e-6)."""
    jmodel, params, pmodel = f32_pair
    ref = JaxLatentTail(jmodel, params, head_steps=head)
    got = LatentTailSampler(pmodel, head, "cpu")
    for name in ("t_add", "gains_f32", "c0_f32", "c1_f32", "sv_f32", "K_in", "K_out", "b_out",
                 "L_T", "C_T", "R", "M2", "m_b", "A", "w", "v", "seg_sv", "seg_c0"):
        a, b = _np(getattr(got, name)), _np(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-30) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * scale, err_msg=name)
    for name in ("c_x", "c_beta", "v2"):
        assert getattr(got, name) == pytest.approx(getattr(ref, name), rel=1e-6, abs=1e-12), name
    np.testing.assert_array_equal(got.seg_rows, ref.seg_rows)


# ----------------------------------------------------------------------
# The plain sampler against the JAX XLA reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("head", [1, 3, T - 1])
def test_latent_tail_matches_jax_exact_noise(f32_pair, head):
    jmodel, params, pmodel = f32_pair
    rng = jax.random.PRNGKey(2)
    cond = _conditions()
    noise = np.random.default_rng(3).standard_normal((T, B, D)).astype(np.float32)
    ref = np.asarray(JaxLatentTail(jmodel, params, head_steps=head).sample(
        jnp.asarray(cond), rng, noise=jnp.asarray(noise)))
    # The x_T the JAX sampler draws (first of its 4-way split).
    x_init = np.array(jax.random.normal(jax.random.split(rng, 4)[0], (B, D), jnp.float32))
    got = LatentTailSampler(pmodel, head, "cpu").sample(
        torch.from_numpy(cond), torch.Generator().manual_seed(0),
        x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, ref, **EXACT)
    assert float(np.std(ref)) > 0.05


def test_latent_tail_noise_shape_is_checked(f32_pair):
    _, _, pmodel = f32_pair
    with pytest.raises(ValueError):
        LatentTailSampler(pmodel, 2, "cpu").sample(torch.zeros(4, 3), torch.Generator(),
                                                   noise=torch.zeros(T - 1, 4, D))


# ----------------------------------------------------------------------
# The kernel sampler (plain kernels on the CPU) against the TPU kernel
# ----------------------------------------------------------------------
def _latent_seams(tables, noise, head):
    """zeta = L^-1 K_inᵀ z and eta = Σ v z / sqrt(v2) from the wide
    segment noise (test_latent_sampler.py:198-206): together they make
    the hybrid reproduce the data-space trajectory."""
    seg = noise[head: T - 1].astype(np.float64)
    k_in, l_t = _np(tables.K_in), _np(tables.L_T)
    zeta = (seg @ k_in) @ np.linalg.inv(l_t)
    eta = np.einsum("k,kbd->bd", _np(tables.v), seg) / np.sqrt(tables.v2)
    return zeta.astype(np.float32), eta.astype(np.float32)


@pytest.mark.parametrize("head", [1, 3])
def test_latent_fused_matches_jax_interpret(head):
    jmodel, params, pmodel = make_pair(num_steps=T, compute_dtype="float32")
    rng = jax.random.PRNGKey(2)
    cond = _conditions()
    noise = np.random.default_rng(3).standard_normal((T, B, D)).astype(np.float32)
    jax_sampler = JaxLatentFused(jmodel, params, head_steps=head, tile_b=TILE_B,
                                 interpret=True, gn_mode="f32")
    zeta, eta = _latent_seams(jax_sampler.tables, noise, head)
    ref = np.asarray(jax_sampler.sample(jnp.asarray(cond), rng, noise=jnp.asarray(noise),
                                        zeta=jnp.asarray(zeta), eta=jnp.asarray(eta)))
    # The fused head draws x_T from its own split of rng.
    head_rng = jax.random.split(rng, 3)[0]
    x_init = np.array(jax.random.normal(jax.random.split(head_rng)[0], (B, D),
                                          jnp.bfloat16).astype(jnp.float32))
    sampler = LatentFusedSampler(pmodel, head, "cpu")
    assert sampler.n_lat == T - 1 - head
    got = sampler.sample(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                         x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise),
                         zeta=torch.from_numpy(zeta), eta=torch.from_numpy(eta)).numpy()
    np.testing.assert_allclose(got, ref, **BF16)
    assert float(np.std(ref)) > 0.05
    assert sk.LATENT.launches == 0  # CPU tensors: the plain versions ran


def test_latent_fused_matches_plain_latent_tail(f32_pair):
    """The kernel hybrid against the port's plain one with the same x_T,
    head noise, zeta and eta (chip_smoke.py runs this at full width)."""
    _, _, pmodel = f32_pair
    head = 2
    cond = torch.from_numpy(_conditions(4))
    rng = np.random.default_rng(5)
    x_init = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).bfloat16().float()
    noise = rng.standard_normal((T, B, D)).astype(np.float32)
    sampler = LatentFusedSampler(pmodel, head, "cpu")
    zeta, eta = _latent_seams(sampler.tables, noise, head)
    got = sampler.sample(cond, torch.Generator(), x_init=x_init, noise=torch.from_numpy(noise),
                         zeta=torch.from_numpy(zeta), eta=torch.from_numpy(eta))
    ref = LatentTailSampler(pmodel, head, "cpu").sample(cond, torch.Generator(), x_init=x_init,
                                                        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **BF16)


def test_latent_fused_seam_shapes_are_checked(f32_pair):
    _, _, pmodel = f32_pair
    sampler = LatentFusedSampler(pmodel, 3, "cpu")
    with pytest.raises(ValueError):
        sampler.sample(torch.zeros(4, 3), torch.Generator(), zeta=torch.zeros(T, 4, 128))


@pytest.mark.parametrize("stop_after", [1, 3])
def test_stop_after_matches_jax_head(stop_after):
    jmodel, params, pmodel = make_pair(num_steps=T)
    rng = jax.random.PRNGKey(6)
    cond = _conditions(7)
    noise = np.random.default_rng(8).standard_normal((T, B, D)).astype(np.float32)
    ref = JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True, gn_mode="f32").sample(
        jnp.asarray(cond), rng, noise=jnp.asarray(noise), stop_after=stop_after, keep_bf16=True)
    ref = np.asarray(ref.astype(jnp.float32))
    x_init = np.array(jax.random.normal(jax.random.split(rng)[0], (B, D),
                                          jnp.bfloat16).astype(jnp.float32))
    sampler = FusedSampler(pmodel, "cpu")
    got = sampler.sample(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                         x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise),
                         stop_after=stop_after)
    np.testing.assert_allclose(got.numpy(), ref, **BF16)
    assert torch.equal(got, got.bfloat16().float())  # the bf16 carry's values
    full = sampler.sample(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                          x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise))
    again = sampler.sample(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                           x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise),
                           stop_after=T)
    assert torch.equal(full, again)
    with pytest.raises(ValueError):
        sampler.sample(torch.from_numpy(cond), torch.Generator(), stop_after=T + 1)


# ----------------------------------------------------------------------
# The clip-headroom probe
# ----------------------------------------------------------------------
def test_probe_profile_and_head_grow_as_the_margin_tightens(f32_pair):
    _, _, pmodel = f32_pair
    cond = torch.zeros(16, 3)
    head_loose, profile = calibrate_head_steps(pmodel, cond, torch.Generator().manual_seed(5),
                                               margin=0.9, device="cpu")
    assert profile.shape == (T,) and np.isfinite(profile).all() and (profile > 0).all()
    tiny = float(profile[: T - 1].max()) / (2.0 * pmodel.clip_value)
    head_strict, again = calibrate_head_steps(pmodel, cond, torch.Generator().manual_seed(5),
                                              margin=tiny, device="cpu")
    np.testing.assert_array_equal(profile, again)  # same generator, same trajectory
    assert 1 <= head_loose <= head_strict <= T - 1
    # The head covers the last row whose peak exceeds margin·clip.
    unsafe = np.nonzero(profile[: T - 1] > tiny * pmodel.clip_value)[0]
    assert head_strict == int(unsafe[-1]) + 1


# ----------------------------------------------------------------------
# Distribution mode: own zeta/eta draws
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sampler_cls", [LatentTailSampler, LatentFusedSampler])
def test_distribution_mode_moments_match_plain_loop(sampler_cls):
    """With their own draws (plain: generator; kernel: Philox zeta), the
    latent samplers reproduce the plain data-space loop's distribution:
    the bounds of test_latent_sampler.py:145-169."""
    _, _, pmodel = make_pair(num_steps=10, compute_dtype="float32")
    n = 512
    cond = torch.zeros(n, 3)
    lat = sampler_cls(pmodel, 2, "cpu").sample(cond, torch.Generator().manual_seed(7)).numpy()
    ref = pmodel.sample(cond, torch.Generator().manual_seed(11)).numpy()
    assert lat.shape == ref.shape == (n, D)
    np.testing.assert_allclose(lat.mean(axis=0), ref.mean(axis=0), atol=0.2)
    np.testing.assert_allclose(lat.std(axis=0), ref.std(axis=0), atol=0.2, rtol=0.25)
    cl = np.cov(lat[:, :16], rowvar=False)
    cr = np.cov(ref[:, :16], rowvar=False)
    assert np.abs(cl - cr).max() < 0.25


def test_conditions_have_effect(f32_pair):
    _, _, pmodel = f32_pair
    sampler = LatentFusedSampler(pmodel, 1, "cpu")
    a = sampler.sample(torch.zeros(8, 3), torch.Generator().manual_seed(4))
    b = sampler.sample(torch.ones(8, 3), torch.Generator().manual_seed(4))
    assert float((a - b).abs().max()) > 1e-3


# ----------------------------------------------------------------------
# K7's plain version against a written-out step
# ----------------------------------------------------------------------
def _k7_inputs(m=5, h=16, n_lat=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (n_lat, 5)).astype(np.float32))
    return rng, f, coeffs


@pytest.mark.parametrize("mode", ["buffer", "philox"])
def test_latent_draw_matches_written_out_step(mode):
    rng, f, coeffs = _k7_inputs()
    h = f(5, 16).bfloat16()
    hacc, xi = f(5, 16), f(5, 16)
    zeta = f(3, 5, 16)
    step, seed = 1, 77
    zbf = torch.empty(5, 16, dtype=torch.bfloat16)
    hacc0, xi0 = hacc.clone(), xi.clone()
    sk.latent_draw(h, hacc, xi, zbf, coeffs, step, mode, zeta=zeta, seed=seed)
    w, v = coeffs[step, 3].item(), coeffs[step, 4].item()
    if mode == "buffer":
        z = zeta[step].numpy()
    else:  # Philox (seed, step), counter row·16 + col, 24-bit uniform
        z = sk.philox_uniform_noise(seed, step, 5, 16).numpy()
        words = sk.philox4x32_10(torch.arange(5 * 16, dtype=torch.int64), torch.zeros(80,
                                 dtype=torch.int64), torch.zeros(80, dtype=torch.int64),
                                 torch.zeros(80, dtype=torch.int64), seed, step)[0]
        u = (words.numpy() >> 8).astype(np.float64) / 2**24
        np.testing.assert_allclose(z.ravel(), (u - 0.5) * 2 * np.sqrt(3), rtol=1e-6, atol=1e-6)
    z32, w32, v32 = np.float32(z), np.float32(w), np.float32(v)
    np.testing.assert_array_equal(zbf.float().numpy(), torch.from_numpy(z).bfloat16().float())
    np.testing.assert_array_equal(xi.numpy(), xi0.numpy() + v32 * z32)
    np.testing.assert_array_equal(hacc.numpy(), hacc0.numpy() + w32 * h.float().numpy())
    assert sk.LATENT.launches == 0


def test_latent_update_matches_written_out_step():
    rng, f, coeffs = _k7_inputs(seed=1)
    s, o_lat, n_inj, c_proj = f(5, 16), f(5, 16), f(5, 16), f(5, 16)
    t_add = f(4, 16)
    h_in = torch.empty(5, 16, dtype=torch.bfloat16)
    s0 = s.numpy().copy()
    step = 2
    sk.latent_update(s, o_lat, n_inj, c_proj, t_add, coeffs, step, h_in)
    a, c0, sv = (np.float32(coeffs[step, i].item()) for i in range(3))
    expect = a * s0 + c0 * o_lat.numpy() + sv * n_inj.numpy()
    np.testing.assert_array_equal(s.numpy(), expect)
    nxt = torch.from_numpy(expect + t_add[step + 1].numpy() + c_proj.numpy()).bfloat16()
    assert torch.equal(h_in, nxt)
    with pytest.raises(ValueError):  # the table holds no row after the last
        sk.latent_update(s, o_lat, n_inj, c_proj, t_add[:3], coeffs, step, h_in)
    with pytest.raises(ValueError):
        sk.latent_draw(s.bfloat16(), s, s, h_in, coeffs, 0, "buffer")  # no zeta
    with pytest.raises(ValueError):
        sk.latent_draw(s.bfloat16(), s, s, h_in, coeffs, 0, "none")
