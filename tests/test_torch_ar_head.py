"""The denoiser's heads in the port against the JAX package: the forward
pass with each head, the latent encoder, the AR (FVSBN) head's logits and
its sequential draw, the weight bridge, the conflicts ``from_config``
refuses, the variant knobs in ``metadata.json``, the latent-factor prior,
the AR head's calibration route, and generation and serving of an AR +
latent-factor checkpoint.

Tiny shapes (data 10/40/14, hidden 128/256/128), seeded numpy inputs; the
JAX models split their sampler keys with threefry, so the AR draw's
per-gene uniforms are rebuilt from the JAX key and passed to the port.
"""

import dataclasses
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.generation.generator import (
    SyntheticPatientGenerator as JaxGenerator,
)
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.models.networks import DiffusionDenoiser as JaxDenoiser
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module
from osteosarcoma_diffusionmodel_torch.generation.generator import (
    SyntheticPatientGenerator,
    seeded_generator,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.networks import init_flax
from osteosarcoma_diffusionmodel_torch.serving.server import serve
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from torch_parity import CONDITIONS, DATA_DIMS, TRAIN_DUMMY, _configure, make_pair

M, E, P = DATA_DIMS
D = M + E + P
B = 12
# The denoiser's own tolerances (tests/test_torch_networks.py).
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=0.05, rtol=0.02)}
AR_LATENT = {"model.diffusion.ar_mutation_head": True, "model.diffusion.latent_factor_dim": 3}
HEADS = {
    "ar-latent-sigma": dict(AR_LATENT, **{"model.diffusion.learn_sigma": True}),
    "ar-continuous-latent-mutations": {
        "model.diffusion.ar_mutation_head": True, "model.diffusion.ar_context": "continuous",
        "model.diffusion.latent_factor_dim": 2,
        "model.diffusion.latent_encoder_input": "mutations"},
    "low-rank-mutations": {"model.diffusion.low_rank_sigma_dim": 3,
                           "model.diffusion.low_rank_sigma_scope": "mutations"},
    "low-rank-no-skip": {"model.diffusion.low_rank_sigma_dim": 2,
                         "model.denoiser_input_skip": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def stats():
    c = make_dummy_cohort(**TRAIN_DUMMY)
    data, conditions, _ = cohort_arrays(c, Config())
    return ckpt.data_stats_from_arrays(data, conditions, M)


def _inputs(seed=0, cond_dim=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)).astype(np.float32)
    x[:, :M] = (x[:, :M] > 0.3).astype(np.float32)
    t = rng.uniform(0, 1, B).astype(np.float32)
    c = rng.standard_normal((B, cond_dim)).astype(np.float32)
    return x, t, c


def _apply(jmodel, params, *args, method=None, **kw):
    return np.asarray(jmodel.denoiser.apply({"params": params}, *args, method=method, **kw))


# ----------------------------------------------------------------------
# The heads' forward passes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", list(HEADS))
def test_forward_with_each_head_matches_flax(heads, dtype):
    """The denoiser (with the sigma head's log-variance appended), the
    latent encoder through its view, the AR head's context and
    teacher-forced logits, and the low-rank parameters, on the same
    weights: the denoiser's own tolerances."""
    jmodel, params, pmodel = make_pair(compute_dtype=dtype, overrides=HEADS[heads])
    k = pmodel.latent_factor_dim
    x, t, c = _inputs(cond_dim=3 + k)
    ref = _apply(jmodel, params, jnp.asarray(x), jnp.asarray(t), conditions=jnp.asarray(c))
    d = pmodel.denoiser
    with torch.no_grad():
        got = d(torch.from_numpy(x), torch.from_numpy(t), conditions=torch.from_numpy(c))
        assert got.shape == (B, 2 * D if pmodel.learn_sigma else D)
        np.testing.assert_allclose(got.numpy(), ref, **TOL[dtype])
        if k:
            want = np.asarray(jmodel.encode_latents(params, jnp.asarray(x)))
            got = pmodel.encode_latents(torch.from_numpy(x)).numpy()
            assert got.shape == (B, k) and float(np.std(want)) > 0.01
            np.testing.assert_allclose(got, want, **TOL[dtype])
        if pmodel.ar_head:
            ctx = pmodel._ar_context_view(torch.from_numpy(x[:, M:]), torch.from_numpy(c[:, :3]))
            want_ctx = jmodel._ar_context_view(jnp.asarray(x[:, M:]), jnp.asarray(c[:, :3]))
            np.testing.assert_array_equal(ctx.numpy(), np.asarray(want_ctx))
            for name, args in (("ar_context_logits", (ctx,)),
                               ("ar_logits", (torch.from_numpy(x[:, :M]), ctx))):
                want = _apply(jmodel, params, *(jnp.asarray(a.numpy()) for a in args),
                              method=getattr(JaxDenoiser, name))
                np.testing.assert_allclose(getattr(d, name)(*args).numpy(), want, **TOL["float32"])
        if pmodel.low_rank_sigma_dim:
            want = jmodel._lowrank_params(params)
            for a, b in zip(pmodel._lowrank_params(), want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("context", ["pathways", "continuous", "none"])
def test_ar_sample_matches_jax(context):
    """The sequential draw with the JAX key's per-gene uniforms injected:
    the bits equal JAX ``ar_sample``'s, except after a gene whose uniform
    lies within 1e-6 of its probability (none here)."""
    jmodel, params, pmodel = make_pair(
        compute_dtype="float32", rng_impl="threefry",
        overrides={"model.diffusion.ar_mutation_head": True, "model.diffusion.ar_context": context})
    x, _, c = _inputs(1)
    cont, rng = x[:, M:], jax.random.PRNGKey(5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jmodel.ar_sample(jparams, rng, jnp.asarray(cont), jnp.asarray(c)))
    u = np.stack([np.asarray(jax.random.uniform(k, (B,))) for k in jax.random.split(rng, M)], 1)
    got = pmodel.ar_sample(torch.from_numpy(cont), torch.from_numpy(c),
                           uniforms=torch.from_numpy(u)).numpy()
    assert np.isin(got, (0.0, 1.0)).all() and 0.05 < want.mean() < 0.95
    ctx = jmodel._ar_context_view(jnp.asarray(cont), jnp.asarray(c))
    p = jax.nn.sigmoid(_apply(jmodel, params, jnp.asarray(want), ctx,
                              method=JaxDenoiser.ar_logits))
    for row in np.flatnonzero((got != want).any(axis=1)):
        first = np.flatnonzero(got[row] != want[row])[0]
        assert abs(u[row, first] - p[row, first]) < 1e-6, (row, first)


def test_convert_round_trip_with_every_head():
    """Every head's parameters map Flax -> port -> Flax unchanged, raw
    arrays untransposed."""
    for overrides in (HEADS["ar-latent-sigma"], HEADS["low-rank-mutations"]):
        _, params, pmodel = make_pair(overrides=overrides)
        sd = flax_params_to_state_dict(params)
        assert set(sd) == set(pmodel.denoiser.state_dict())
        back = state_dict_to_flax_params(sd)
        flat = jax.tree_util.tree_leaves_with_path(params)
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node, leaf)
        for name in ("ar_coupling", "lowrank_U"):
            if name in params:
                np.testing.assert_array_equal(sd[name].numpy(), params[name])


def test_init_flax_draws_the_flax_initializers():
    """init_flax: zero AR biases and log-parameters, a zero AR context
    output kernel, a zero-kernel -6-bias sigma projection, normal(0.01)
    couplings and U, LeCun-normal Dense kernels (spread 1/sqrt(fan_in))."""
    _, _, pmodel = make_pair(overrides=dict(HEADS["ar-latent-sigma"],
                                            **{"model.diffusion.low_rank_sigma_dim": 2,
                                               "model.diffusion.learn_sigma": False}))
    d = pmodel.denoiser
    init_flax(d, torch.Generator().manual_seed(0))
    assert not d.ar_bias.any() and not d.ar_ctx_fc2.weight.any()
    assert not d.lowrank_logdiag.any() and not d.lowrank_logs.any()
    for p in (d.ar_coupling, d.lowrank_U):
        assert 0.005 < float(p.detach().std()) < 0.02, tuple(p.shape)
    fc1 = d.latent_enc_fc1.weight
    assert float(fc1.std()) == pytest.approx(1 / np.sqrt(fc1.shape[1]), rel=0.1)
    jm, _, sp = make_pair(overrides={"model.diffusion.learn_sigma": True})
    init_flax(sp.denoiser, torch.Generator().manual_seed(0))
    assert not sp.denoiser.sigma_proj.weight.any()
    assert torch.equal(sp.denoiser.sigma_proj.bias, torch.full((D,), -6.0))


CONFLICTS = {
    "parameterization": {"model.diffusion.parameterization": "score"},
    "low-rank-and-learned-sigma": {"model.diffusion.low_rank_sigma_dim": 2,
                                   "model.diffusion.learn_sigma": True},
    "mutation-low-rank-d3pm": {"model.diffusion.low_rank_sigma_dim": 2,
                               "model.diffusion.low_rank_sigma_scope": "mutations",
                               "model.diffusion.discrete_mutation_head": True},
    "ar-and-d3pm": {"model.diffusion.ar_mutation_head": True,
                    "model.diffusion.discrete_mutation_head": True},
    "mutation-low-rank-ar": {"model.diffusion.low_rank_sigma_dim": 2,
                             "model.diffusion.low_rank_sigma_scope": "mutations",
                             "model.diffusion.ar_mutation_head": True},
    "ar-context": {"model.diffusion.ar_mutation_head": True,
                   "model.diffusion.ar_context": "expression"},
}


@pytest.mark.parametrize("case", list(CONFLICTS))
def test_from_config_conflicts_raise_as_jax(case):
    """Each conflict JAX ``from_config`` refuses with a ValueError, the
    port refuses with one too."""
    jc = _configure(JaxConfig(), 4, "float32", overrides=CONFLICTS[case])
    pc = _configure(Config(), 4, "float32", overrides=CONFLICTS[case])
    with pytest.raises(ValueError):
        JaxDiffusion.from_config(jc, jc.freeze_dims(*DATA_DIMS, CONDITIONS))
    with pytest.raises(ValueError):
        ConditionalDiffusion.from_config(pc, pc.freeze_dims(*DATA_DIMS, CONDITIONS))


KNOBS = {
    "model.diffusion.parameterization": "v", "model.diffusion.learn_sigma": True,
    "model.diffusion.sigma_loss_weight": 0.5, "model.diffusion.latent_factor_dim": 4,
    "model.diffusion.latent_encoder_input": "mutations", "model.diffusion.ar_mutation_head": True,
    "model.diffusion.ar_ce_weight": 2.0, "model.diffusion.ar_context": "none",
    "model.diffusion.ar_context_hidden": 32, "model.diffusion.ar_l2": 1e-4,
    "model.diffusion.ar_ctx_l2": 0.1, "model.diffusion.ar_lr": 3e-3,
    "model.diffusion.low_rank_sigma_weight": 0.25, "model.diffusion.low_rank_sigma_scope": "full",
    "model.cfg_dropout_prob": 0.15, "generation.guidance_scale": 4.0,
}


def test_metadata_round_trips_the_variant_knobs(tmp_path):
    """The port's defaults are the JAX package's; a ``metadata.json``
    written by the port, and one written from a JAX config, rebuild every
    knob."""
    jc, pc = JaxConfig(), Config()
    for path in list(KNOBS) + ["model.diffusion.low_rank_sigma_dim"]:
        *parents, leaf = path.split(".")
        a, b = jc, pc
        for name in parents:
            a, b = getattr(a, name), getattr(b, name)
        assert getattr(a, leaf) == getattr(b, leaf), path
    from torch_parity import override

    pc, jc = override(Config(), KNOBS), override(JaxConfig(), KNOBS)
    dims = pc.freeze_dims(*DATA_DIMS, CONDITIONS)
    ckpt.save_metadata(tmp_path, pc, dims)
    from_port = Config.from_dict(ckpt.load_metadata(tmp_path)["config"])
    from_jax = Config.from_dict(json.loads(json.dumps(dataclasses.asdict(jc), default=str)))
    for cfg in (from_port, from_jax):
        assert cfg.model == pc.model and cfg.generation.guidance_scale == 4.0
    model = ConditionalDiffusion.from_config(from_port, ckpt.metadata_to_dims(
        ckpt.load_metadata(tmp_path)))
    assert model.ar_head and model.latent_factor_dim == 4 and model.ar_lr == 3e-3


# ----------------------------------------------------------------------
# Generation
# ----------------------------------------------------------------------
def _generators(overrides, stats, **kw):
    jmodel, params, pmodel = make_pair(compute_dtype="float32", overrides=overrides,
                                       rng_impl="threefry")
    jc = _configure(JaxConfig(), 6, "float32", overrides=overrides)
    pc = _configure(Config(), 6, "float32", overrides=overrides)
    for cfg in (jc, pc):
        for key, value in kw.items():
            setattr(cfg.generation, key, value)
    jdims = jc.freeze_dims(*DATA_DIMS, CONDITIONS)
    pdims = pc.freeze_dims(*DATA_DIMS, CONDITIONS)
    return (JaxGenerator(jmodel, params, jc, jdims, data_stats=stats),
            SyntheticPatientGenerator(pmodel, pc, pdims, data_stats=stats, device="cpu"))


@pytest.mark.parametrize("view", ["full", "mutations"])
def test_latent_prior_matches_jax(stats, view):
    """The prior fitted once on the cohort's encoded latents: its mean and
    Cholesky factor against the JAX generator's (f32 encoder: 1e-5 on the
    mean, 1e-4 on the factor), and a draw of the right shape."""
    overrides = {"model.diffusion.latent_factor_dim": 3,
                 "model.diffusion.latent_encoder_input": view}
    jgen, pgen = _generators(overrides, stats)
    jgen._latent_prior_draw(4, jax.random.PRNGKey(0))
    h = pgen._latent_prior_draw(4, torch.Generator().manual_seed(0))
    assert h.shape == (4, 3) and torch.isfinite(h).all()
    for got, want, tol in zip(pgen._latent_prior, jgen._latent_prior, (1e-5, 1e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    bare = SyntheticPatientGenerator(pgen.model, pgen.config, pgen.dims, device="cpu")
    with pytest.raises(ValueError, match="data_matrix"):
        bare.generate(3, {"survival_time": 500})


def test_ar_head_calibration_route_matches_jax(stats):
    """An AR cohort skips the joint copula as JAX :484 does: the host path
    gives the JAX ``_calibrate``'s continuous block and thresholded
    placeholder bits exactly; on the device path it takes the continuous
    calibrator; the bits that come out are the AR draw's."""
    jgen, pgen = _generators({"model.diffusion.ar_mutation_head": True}, stats)
    assert not pgen._joint_branch("copula_joint", 30, M)
    plain = dataclasses.replace(pgen.model, ar_head=False)
    assert SyntheticPatientGenerator(plain, pgen.config, pgen.dims, data_stats=stats,
                                     device="cpu")._joint_branch("copula_joint", 30, M)
    raw = np.random.default_rng(2).standard_normal((30, D)).astype(np.float32)
    want_mut, want_cont = jgen._calibrate(raw, M, "copula_joint")
    got_mut, got_cont = pgen._calibrate(raw, M, "copula_joint")
    np.testing.assert_array_equal(got_mut, np.asarray(want_mut))
    np.testing.assert_array_equal(got_cont, np.asarray(want_cont))
    pgen.config.generation.calibration_backend = "device"
    gen_module.CALIBRATIONS.clear()
    cond = np.zeros((30, 3), np.float32)
    out = pgen._postprocess(torch.from_numpy(raw), cond, seeded_generator(1))
    assert dict(gen_module.CALIBRATIONS) == {"device": 1}
    np.testing.assert_allclose(np.sort(np.concatenate([out["expression"], out["pathways"]], 1),
                                       axis=0),
                               np.sort(np.asarray(want_cont), axis=0), atol=1e-4)
    assert np.isin(out["mutations"], (0.0, 1.0)).all()
    assert not np.array_equal(out["mutations"], np.asarray(want_mut))


def test_generate_with_ar_and_latent_heads(stats, monkeypatch):
    """generate on an AR + latent-factor model: the kernel sampler's
    route, the AR draw conditioned on the calibrated pathway block, binary
    bits; the same seed gives the same cohort, another seed another."""
    _, pgen = _generators(AR_LATENT, stats, calibrate_marginals="copula_joint")
    assert pgen.uses_kernels()
    seen = []
    real = ConditionalDiffusion.ar_sample

    def spy(self, continuous, conditions, generator=None, uniforms=None):
        seen.append(continuous.numpy().copy())
        return real(self, continuous, conditions, generator, uniforms)

    monkeypatch.setattr(ConditionalDiffusion, "ar_sample", spy)
    scenario = {"survival_time": 400, "event_occurred": 1}
    a = pgen.generate(9, scenario, seeded_generator(3, 0))
    b = pgen.generate(9, scenario, seeded_generator(3, 0))
    c = pgen.generate(9, scenario, seeded_generator(4, 0))
    np.testing.assert_array_equal(seen[0], a["pathways"])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["pathways"], c["pathways"])
    assert a["mutations"].shape == (9, M) and np.isin(a["mutations"], (0.0, 1.0)).all()


def test_ar_latent_checkpoint_serves_binary_bits(stats, tmp_path):
    """/generate on an AR + latent-factor checkpoint (the port's layout:
    weights, metadata, data stats) answers through the generator, with the
    AR head's bits, under both samplers."""
    _, params, pmodel = make_pair(overrides=AR_LATENT)
    pc = _configure(Config(), 6, "bfloat16", overrides=AR_LATENT)
    ckpt.save_weights(tmp_path, pmodel.denoiser.state_dict())
    ckpt.save_metadata(tmp_path, pc, pc.freeze_dims(*DATA_DIMS, CONDITIONS))
    ckpt.save_data_stats(tmp_path, stats)
    server = serve(tmp_path, host="127.0.0.1", port=0, warmup=False, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert server.service.generator.model.ar_head
        for sampler in ("ddpm", "ddim"):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
            conn.request("POST", "/generate", body=json.dumps(
                {"num_samples": 5, "sampler": sampler, "scenario": {"survival_time": 900}}))
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200, body
            mut = np.asarray(body["mutations"])
            assert mut.shape == (5, M) and np.isin(mut, (0.0, 1.0)).all()
            assert np.isfinite(np.asarray(body["expression"])).all()
    finally:
        server.shutdown()
        server.server_close()
