"""The port's conditional flow (models/flow.py) against the JAX package's.

Tiny shapes (data 10/40/14, three conditions, hidden 32/64/32: six
couplings of width 64, batch 16), weights from the JAX ``init_params``
carried over by ``convert.py``, inputs from seeded numpy. At init every
coupling's output kernel is zero and the flow is the identity, so the
parity cases first perturb those kernels (and biases) with seeded values.
Tolerances: f32 1e-5 relative on the log-density and 1e-5 absolute on
values of order 1-10; bf16 (each coupling's products rounded to bf16,
six couplings, a log-determinant summed over half the features): the
log-density within 2e-3 relative, the inverse within 5e-2 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import OsteosarcomaArrays as JaxArrays
from osteosarcoma_diffusionmodel_tpu.models.flow import ConditionalFlow as JaxFlow
from osteosarcoma_diffusionmodel_tpu.models.flow import ConditionalRealNVP as JaxRealNVP
from osteosarcoma_diffusionmodel_tpu.training.trainer import Trainer as JaxTrainer
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays
from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
from osteosarcoma_diffusionmodel_torch.models.flow import ConditionalFlow
from osteosarcoma_diffusionmodel_torch.models.networks import init_flax
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model
from torch_parity import BATCH, TRAIN_DUMMY, constraint_specs

DIMS = (10, 40, 14)
D = sum(DIMS)
LP_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
X_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}


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


def _config(cfg, dtype="float32", constraints=False):
    cfg.model.architecture = "flow"
    cfg.model.hidden_dims = [32, 64, 32]
    cfg.model.compute_dtype = dtype
    cfg.model.constraints.enabled = constraints
    cfg.model.constraints.cooccurrence_weight = 0.3
    cfg.training.batch_size = BATCH
    return cfg


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed + 400)
    for net in params.values():
        out = net["out"]
        out["kernel"] = (scale * rng.standard_normal(out["kernel"].shape)).astype(np.float32)
        out["bias"] = (scale * rng.standard_normal(out["bias"].shape)).astype(np.float32)
    return params


def _pair(cohort=None, perturb=True, **kw):
    jc, pc = _config(JaxConfig(), **kw), _config(Config(), **kw)
    names = ["a", "b", "c"]
    jdims, pdims = jc.freeze_dims(*DIMS, names), pc.freeze_dims(*DIMS, names)
    jspec = pspec = None
    if cohort is not None:
        jspec, pspec = constraint_specs(cohort[0], cohort[1])
    jmodel = JaxFlow.from_config(jc, jdims, jspec)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), 3))
    params = {k: {n: dict(v) for n, v in net.items()} for k, net in params.items()}
    if perturb:
        _perturb(params)
    pmodel = build_model(pc, pdims, pspec)
    assert isinstance(pmodel, ConditionalFlow)
    pmodel.module.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, pmodel


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, D)).astype(np.float32)
    c = rng.standard_normal((BATCH, 3)).astype(np.float32)
    return x, c


def test_from_config_shapes():
    """max(4, 2 x 3) = 6 couplings of width max(hidden) = 64, each
    (D + C) -> 64 -> 64 -> 2D; the constraint weights 0 without a spec."""
    _, params, pmodel = _pair(perturb=False)
    module = pmodel.module
    assert module.num_couplings == 6 and sorted(params) == [f"coupling_{k}" for k in range(6)]
    net = module.coupling_0
    assert (net.fc1.in_features, net.fc1.out_features, net.out.out_features) == (D + 3, 64, 2 * D)
    assert pmodel.constraint_spec is None and pmodel.pathway_coherence_weight == 0.0
    assert "masks" not in module.state_dict()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_inverse_log_prob_match_jax(dtype):
    jmodel, params, pmodel = _pair(dtype=dtype)
    x, c = _inputs()
    v = {"params": params}
    jz, jld = jmodel.module.apply(v, jnp.asarray(x), jnp.asarray(c),
                                  method=JaxRealNVP.forward)
    jlp = jmodel.module.apply(v, jnp.asarray(x), jnp.asarray(c), method=JaxRealNVP.log_prob)
    z = np.random.default_rng(1).standard_normal((BATCH, D)).astype(np.float32)
    jx = jmodel.module.apply(v, jnp.asarray(z), jnp.asarray(c), method=JaxRealNVP.inverse)
    with torch.no_grad():
        pz, pld = pmodel.module(torch.from_numpy(x), torch.from_numpy(c))
        plp = pmodel.module.log_prob(torch.from_numpy(x), torch.from_numpy(c))
        px = pmodel.module.inverse(torch.from_numpy(z), torch.from_numpy(c))
    assert float(np.abs(np.asarray(jld)).max()) > 1.0  # the perturbed couplings act
    atol = X_ATOL[dtype]
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=0, atol=atol)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0, atol=atol)
    scale = float(np.abs(np.asarray(jlp)).max())
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=0, atol=LP_RTOL[dtype] * scale)
    np.testing.assert_allclose(pld.numpy(), np.asarray(jld), rtol=0, atol=LP_RTOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_and_identity_at_init(dtype):
    """inverse(forward(x)) = x on perturbed weights: f32 within 1e-5; bf16
    within 2e-3 of max(1, max|x|) (half a bf16 ulp: each coupling's net
    reads its input rounded to bf16, and the inverse hands it the previous
    coupling's reconstruction, whose f32 rounding can move that input by
    one bf16 ulp). At the Flax init (the port's own ``init_flax`` too) the
    flow is exactly the identity with log-determinant 0."""
    _, _, pmodel = _pair(dtype=dtype)
    x, c = _inputs(2)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    with torch.no_grad():
        z, _ = pmodel.module(xt, ct)
        back = pmodel.module.inverse(z, ct)
    assert float((z - xt).abs().max()) > 0.1
    atol = 1e-5 if dtype == "float32" else 2e-3 * max(1.0, float(np.abs(x).max()))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=atol)
    for model in (_pair(perturb=False)[2], _pair(perturb=True)[2]):
        init_flax(model.module, torch.Generator().manual_seed(0))
        with torch.no_grad():
            z, log_det = model.module(xt, ct)
        assert torch.equal(z, xt) and torch.equal(log_det, torch.zeros(BATCH))
        assert all(float(getattr(model.module, f"coupling_{k}").out.weight.abs().max()) == 0
                   for k in range(6))
        assert float(model.module.coupling_0.fc1.weight.std()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("constraints", [False, True])
def test_loss_matches_jax_on_injected_z(cohort, constraints, dtype):
    """The NLL per dimension and, with constraints, the terms on
    ``inverse(z)`` with the z its key draws: f32 rtol 1e-5; bf16 rtol
    2e-2 or 5e-3 absolute (the constraint terms' batch correlations lie in
    [-1, 1])."""
    _, data, conditions, _ = cohort
    jmodel, params, pmodel = _pair(cohort if constraints else None, constraints=constraints,
                                   dtype=dtype)
    x, c = data[:BATCH], conditions[:BATCH]
    key = jax.random.PRNGKey(5)
    total, want = jmodel.loss(params, jnp.asarray(x), jnp.asarray(c), key)
    z = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    with torch.no_grad():
        ptotal, got = pmodel.loss(torch.from_numpy(x), torch.from_numpy(c), z=torch.from_numpy(z))
    assert set(got) == set(want) and ("cooccurrence" in got) == constraints
    rtol, atol = (1e-5, 1e-6) if dtype == "float32" else (2e-2, 5e-3)
    for name, value in want.items():
        assert float(got[name]) == pytest.approx(float(value), rel=rtol, abs=atol), name
    assert float(ptotal) == float(got["loss"])


def test_loss_draws_from_its_generator(cohort):
    _, data, conditions, _ = cohort
    _, _, pmodel = _pair(cohort, constraints=True)
    x, c = torch.from_numpy(data[:BATCH]), torch.from_numpy(conditions[:BATCH])
    with torch.no_grad():
        losses = [float(pmodel.loss(x, c, torch.Generator().manual_seed(s))[0])
                  for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_matches_jax(dtype):
    """``sample`` with z injected equals JAX's ``inverse`` of that z; drawn
    from a generator, the same seed gives the same cohort."""
    jmodel, params, pmodel = _pair(dtype=dtype)
    _, c = _inputs()
    z = np.random.default_rng(3).standard_normal((BATCH, D)).astype(np.float32)
    want = jmodel.module.apply({"params": params}, jnp.asarray(z), jnp.asarray(c),
                               method=JaxRealNVP.inverse)
    got = pmodel.sample(torch.from_numpy(c), z=torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=X_ATOL[dtype])
    drawn = pmodel.sample(torch.from_numpy(c), torch.Generator().manual_seed(0))
    assert drawn.shape == (BATCH, D)
    assert torch.equal(drawn, pmodel.sample(torch.from_numpy(c), torch.Generator().manual_seed(0)))


def test_train_step_matches_jax_trainer(cohort, tmp_path):
    """One AdamW step (mixup 0.2, pathway jitter 0.05, constraints on, lr
    1e-3, weight decay 0.1, clip 1.0) from perturbed params with the JAX
    key's draws (the loss's z from the step's loss key): the gradient norm
    within rtol 1e-4 and every parameter within 2e-6 of the JAX Trainer's,
    except where the clipped gradient is below 1e-6 (held to 2 lr; all but
    1e-3 of the parameters within 2e-6)."""
    c, data, conditions, dims = cohort
    jc, pc = _config(JaxConfig(), constraints=True), _config(Config(), constraints=True)
    for cfg, sub in ((jc, "jax"), (pc, "port")):
        cfg.training.learning_rate = 1e-3
        cfg.training.weight_decay = 0.1
        cfg.training.save_dir = str(tmp_path / sub)
    common = dict(data=data, conditions=conditions,
                  survival=np.asarray(c.clinical["survival_days"], np.float32),
                  sample_ids=list(c.sample_ids), mutation_genes=c.mutation_genes,
                  expression_genes=c.expression_genes, pathway_names=c.pathway_names,
                  condition_names=dims.condition_names, survival_mean=dims.survival_mean,
                  survival_std=dims.survival_std)
    jdims = jc.freeze_dims(*DIMS, dims.condition_names, dims.survival_mean, dims.survival_std)
    pdims = pc.freeze_dims(*DIMS, dims.condition_names, dims.survival_mean, dims.survival_std)
    jspec, pspec = constraint_specs(c, data)
    jtr = JaxTrainer(JaxFlow.from_config(jc, jdims, jspec), JaxArrays(**common), jdims, jc)
    ptr = Trainer(build_model(pc, pdims, pspec), OsteosarcomaArrays(**common), pdims, pc, "cpu")
    params = _perturb(jax.tree_util.tree_map(np.asarray, jtr.params), scale=0.02)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    ptr.module.load_state_dict(flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))

    rows = jtr.train_idx[:BATCH]
    x, cond = jtr._data[rows], jtr._cond[rows]
    surv = jtr._surv[rows]
    rng = jax.random.PRNGKey(100)
    mix_rng, noise_rng, loss_rng = jax.random.split(rng, 3)
    lam_rng, perm_rng = jax.random.split(mix_rng)
    lam = np.float32(jax.random.beta(lam_rng, 0.2, 0.2))
    perm = np.asarray(jax.random.permutation(perm_rng, BATCH))
    jitter = np.asarray(jax.random.normal(noise_rng, (BATCH, 14), jnp.float32))
    z = np.asarray(jax.random.normal(loss_rng, (BATCH, D), jnp.float32))
    aug = (lam * x + (1 - lam) * x[perm]).at[:, 50:].add(0.05 * jnp.asarray(jitter))
    grads = jax.jit(jax.grad(lambda p, b, k: jtr._loss_with_aux(p, {}, b, k, True)[0]))(
        params, (aug, lam * cond + (1 - lam) * cond[perm], surv), loss_rng)
    norm = float(optax.global_norm(grads))
    sensitive = {k: np.abs(v.numpy()) * min(1.0, 1.0 / norm) < 1e-6 for k, v in
                 flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items()}

    new_params, _, _, want_metrics = jtr._train_step(params, jtr.tx.init(params), {}, x, cond,
                                                     surv, rng)
    metrics = ptr.train_step(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(cond)),
                             lam=float(lam), perm=torch.from_numpy(perm),
                             pathway_noise=torch.from_numpy(jitter), z=torch.from_numpy(z))
    assert float(metrics["grad_norm"]) == pytest.approx(norm, rel=1e-4)
    assert float(metrics["loss"]) == pytest.approx(float(want_metrics["loss"]), rel=1e-5)
    want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, new_params))
    got = ptr.module.state_dict()
    assert set(got) == set(want)
    wide = total = 0
    for name, value in want.items():
        diff = np.abs(got[name].numpy() - value.numpy())
        ok = (diff <= 2e-6) | (sensitive[name] & (diff <= 2e-3))
        assert ok.all(), f"{name}: max |diff| {diff.max():.3e}"
        wide += (diff > 2e-6).sum()
        total += diff.size
    assert wide / total < 1e-3
