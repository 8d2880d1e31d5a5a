"""The port's cVAE (models/cvae.py) against the JAX package's.

Tiny shapes (data 10/40/14, three conditions, hidden 32/64/32, latent 8,
batch 16), weights from the JAX ``init_variables`` carried over by
``convert.py``, inputs from seeded numpy. At init BatchNorm's scale,
bias and running statistics are 1/0/0/1 and the survival head's output
layer is small, so the eval-mode cases perturb them first
(:func:`_perturb`). Dropout masks cannot be reproduced across libraries:
the deterministic cases run with dropout off on both sides (Flax's
``deterministic=True`` with ``use_running_average=False``, which
``ConditionalVAEModule.__call__`` takes apart; the port's dropout rates
set to 0), and the port's dropout is held by its statistics.
Tolerances: f32 1e-5 (absolute, on values of order 1-10); bf16 products
2e-2 relative and absolute.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import OsteosarcomaArrays as JaxArrays
from osteosarcoma_diffusionmodel_tpu.models import cvae as jcvae
from osteosarcoma_diffusionmodel_tpu.models.networks import SurvivalHead as JaxSurvivalHead
from osteosarcoma_diffusionmodel_tpu.training.trainer import Trainer as JaxTrainer
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import (
    flatten_params,
    flax_params_to_state_dict,
    state_dict_to_flax,
)
from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays
from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
from osteosarcoma_diffusionmodel_torch.models.cvae import BiologyConstrainedVAE
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model
from torch_parity import BATCH, TRAIN_DUMMY, constraint_specs

DIMS = (10, 40, 14)
D = sum(DIMS)
LATENT = 8
F32 = dict(rtol=0.0, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
PRE_BN_BIAS = re.compile(r"(encoder|decoder)\.fc_\d+\.bias$")


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


class _NoDropVAE(jcvae.ConditionalVAEModule):
    """The JAX module with the survival head's fixed dropout at 0 (its
    layers take ``model.gnn.dropout``, 0 in these cases), so that a
    train-mode call of the JAX loss is deterministic."""

    def setup(self):
        self.encoder = jcvae.VAEEncoder(hidden_dims=tuple(self.hidden_dims),
                                        latent_dim=self.latent_dim, dropout=self.dropout,
                                        dtype=self.dtype)
        self.decoder = jcvae.VAEDecoder(hidden_dims=tuple(reversed(self.hidden_dims)),
                                        output_dim=self.data_dim, dropout=self.dropout,
                                        dtype=self.dtype)
        self.survival_head = JaxSurvivalHead(dropout=0.0, dtype=self.dtype)


def _config(cfg, dtype="float32", dropout=0.0, constraints=False):
    cfg.model.architecture = "cvae"
    cfg.model.hidden_dims = [32, 64, 32]
    cfg.model.latent_dim = LATENT
    cfg.model.compute_dtype = dtype
    cfg.model.gnn.dropout = dropout
    cfg.model.constraints.enabled = constraints
    cfg.model.constraints.cooccurrence_weight = 0.3
    cfg.training.batch_size = BATCH
    return cfg


def _perturb(variables, seed=0):
    """Seeded BatchNorm scale/bias/mean/var and a larger survival output
    layer, in place of their inits."""
    rng = np.random.default_rng(seed + 300)
    params, stats = variables["params"], variables["batch_stats"]
    for part in ("encoder", "decoder"):
        for name, bn in params[part].items():
            if name.startswith("bn_"):
                n = bn["scale"].shape
                bn["scale"] = (1.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
                bn["bias"] = (0.3 * rng.standard_normal(n)).astype(np.float32)
                stats[part][name]["mean"] = (0.5 * rng.standard_normal(n)).astype(np.float32)
                stats[part][name]["var"] = rng.uniform(0.3, 3.0, n).astype(np.float32)
    fc2 = params["survival_head"]["fc2"]
    fc2["kernel"] = (0.3 * rng.standard_normal(fc2["kernel"].shape)).astype(np.float32)
    return variables


def _pair(cohort=None, perturb=True, no_drop=False, **kw):
    """(JAX model, its variables as numpy, port model) on the same weights."""
    jc, pc = _config(JaxConfig(), **kw), _config(Config(), **kw)
    names = ["a", "b", "c"]
    jdims, pdims = jc.freeze_dims(*DIMS, names), pc.freeze_dims(*DIMS, names)
    jspec = pspec = None
    if cohort is not None:
        c, data = cohort[0], cohort[1]
        jspec, pspec = constraint_specs(c, data)
    jmodel = jcvae.BiologyConstrainedVAE.from_config(jc, jdims, jspec)
    if no_drop:
        m = jmodel.module
        jmodel = dataclasses.replace(jmodel, module=_NoDropVAE(
            data_dim=m.data_dim, latent_dim=m.latent_dim, hidden_dims=m.hidden_dims,
            dropout=m.dropout, dtype=m.dtype))
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init_variables(jax.random.PRNGKey(0), 3))
    variables = {k: dict(v) for k, v in variables.items()}
    if perturb:
        _perturb(variables)
    pmodel = build_model(pc, pdims, pspec)
    assert isinstance(pmodel, BiologyConstrainedVAE)
    pmodel.module.load_state_dict(
        flax_params_to_state_dict(variables["params"], variables["batch_stats"]))
    if no_drop:
        pmodel.module.survival_head.drop.p = 0.0
    return jmodel, variables, pmodel


def _inputs(seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, D)).astype(np.float32)
    x[:, :10] = (x[:, :10] > 0.5).astype(np.float32)
    c = rng.standard_normal((batch, 3)).astype(np.float32)
    surv = rng.standard_normal(batch).astype(np.float32)
    return x, c, surv


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_jax(dtype):
    """mu, logvar, the reconstruction from z = mu, the survival head and
    decode, in eval mode on the running statistics."""
    jmodel, variables, pmodel = _pair(dtype=dtype)
    x, c, _ = _inputs()
    tol = F32 if dtype == "float32" else BF16
    want = jmodel.module.apply(variables, jnp.asarray(x), jnp.asarray(c))
    with torch.no_grad():
        got = pmodel.module(torch.from_numpy(x), torch.from_numpy(c))
    for name, g, w in zip(("x_recon", "mu", "logvar", "survival"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g.numpy(), w, tol, name)
    z = np.random.default_rng(1).standard_normal((BATCH, LATENT)).astype(np.float32)
    want = jmodel.module.apply(variables, jnp.asarray(z), jnp.asarray(c),
                               method=jcvae.ConditionalVAEModule.decode)
    with torch.no_grad():
        got = pmodel.module.decode(torch.from_numpy(z), torch.from_numpy(c))
    _close(got.numpy(), want, tol, "decode")


@pytest.mark.parametrize("calls", [1, 3])
def test_train_mode_batchnorm_matches_jax(calls):
    """Train mode, dropout off: the outputs of each call (BatchNorm on the
    batch's f32 statistics) and the running statistics after 1 and 3 calls
    against Flax's ``mutated["batch_stats"]`` (momentum 0.99, biased
    variance): f32, 1e-5."""
    jmodel, variables, pmodel = _pair(perturb=True)
    pmodel.module.survival_head.drop.p = 0.0
    pmodel.module.train()
    stats = variables["batch_stats"]
    for i in range(calls):
        x, c, _ = _inputs(seed=10 + i)
        want, mutated = jmodel.module.apply(
            {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x),
            jnp.asarray(c), deterministic=True, use_running_average=False,
            mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        with torch.no_grad():
            got = pmodel.module(torch.from_numpy(x), torch.from_numpy(c))
        for name, g, w in zip(("x_recon", "mu", "logvar", "survival"), got, want):
            _close(g.numpy(), w, F32, f"{name}, call {i + 1}")
    _, port_stats = state_dict_to_flax(pmodel.module.state_dict())
    want_flat, got_flat = flatten_params(stats), flatten_params(port_stats)
    assert sorted(got_flat) == sorted(want_flat) and len(got_flat) == 12
    for key in want_flat:
        _close(got_flat[key], want_flat[key], dict(rtol=1e-6, atol=1e-6), key)


@pytest.mark.parametrize("constraints", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_loss_matches_jax_on_injected_eps(cohort, train, constraints):
    """Every metric of the loss against ``BiologyConstrainedVAE.loss`` with
    the epsilon that its key draws (in eval mode too, as there), in eval
    mode and in train mode with dropout 0; the constraint terms on the
    reconstruction with the cohort's spec. f32, rtol 1e-5."""
    _, data, conditions, _ = cohort
    jmodel, variables, pmodel = _pair(cohort if constraints else None, no_drop=True,
                                      constraints=constraints)
    x, c = data[:BATCH], conditions[:BATCH]
    surv = np.random.default_rng(2).standard_normal(BATCH).astype(np.float32)
    key = jax.random.PRNGKey(7)
    _, want, new_stats = jmodel.loss(variables["params"], variables["batch_stats"],
                                     jnp.asarray(x), jnp.asarray(c), jnp.asarray(surv), key,
                                     train=train)
    z_rng, _ = jax.random.split(key)
    eps = np.asarray(jax.random.normal(z_rng, (BATCH, LATENT), jnp.float32))
    total, got = pmodel.loss(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(surv),
                             eps=torch.from_numpy(eps), train=train)
    assert set(got) == set(want)
    assert ("pathway_coherence" in got) == constraints
    for name, value in want.items():
        assert float(got[name]) == pytest.approx(float(value), rel=1e-5, abs=1e-6), name
    assert float(total) == float(got["loss"])
    assert not pmodel.module.training  # the loss restores the mode
    _, port_stats = state_dict_to_flax(pmodel.module.state_dict())
    want_flat, got_flat = flatten_params(new_stats), flatten_params(port_stats)
    for key_ in want_flat:
        _close(got_flat[key_], want_flat[key_], dict(rtol=1e-6, atol=1e-6), key_)


def test_loss_draws_from_its_generator(cohort):
    _, data, conditions, _ = cohort
    _, _, pmodel = _pair()
    x, c = torch.from_numpy(data[:BATCH]), torch.from_numpy(conditions[:BATCH])
    surv = torch.zeros(BATCH)
    with torch.no_grad():
        losses = [float(pmodel.loss(x, c, surv, torch.Generator().manual_seed(s))[0])
                  for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_matches_jax_decode(dtype):
    """``sample`` with z injected equals the JAX ``decode`` of that z on
    the running statistics, even when the module is in training mode."""
    jmodel, variables, pmodel = _pair(dtype=dtype)
    _, c, _ = _inputs()
    z = np.random.default_rng(3).standard_normal((BATCH, LATENT)).astype(np.float32)
    want = jmodel.module.apply(variables, jnp.asarray(z), jnp.asarray(c),
                               method=jcvae.ConditionalVAEModule.decode)
    pmodel.module.train()
    got = pmodel.sample(torch.from_numpy(c), z=torch.from_numpy(z))
    assert pmodel.module.training
    _close(got.numpy(), want, F32 if dtype == "float32" else BF16, "sample")
    drawn = pmodel.sample(torch.from_numpy(c), torch.Generator().manual_seed(0))
    again = pmodel.sample(torch.from_numpy(c), torch.Generator().manual_seed(0))
    assert drawn.shape == (BATCH, D) and torch.equal(drawn, again)


def _trainer_pair(cohort, tmp_path):
    c, data, conditions, dims = cohort
    kw = dict(constraints=True)
    jc, pc = _config(JaxConfig(), **kw), _config(Config(), **kw)
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
    jmodel = jcvae.BiologyConstrainedVAE.from_config(jc, jdims, jspec)
    m = jmodel.module
    jmodel = dataclasses.replace(jmodel, module=_NoDropVAE(
        data_dim=m.data_dim, latent_dim=m.latent_dim, hidden_dims=m.hidden_dims,
        dropout=m.dropout, dtype=m.dtype))
    jtr = JaxTrainer(jmodel, JaxArrays(**common), jdims, jc)
    ptr = Trainer(build_model(pc, pdims, pspec), OsteosarcomaArrays(**common), pdims, pc, "cpu")
    ptr.module.load_state_dict(flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jtr.params),
        jax.tree_util.tree_map(np.asarray, jtr.batch_stats)))
    ptr.module.survival_head.drop.p = 0.0
    return jtr, ptr


def test_train_step_matches_jax_trainer(cohort, tmp_path):
    """One AdamW step (mixup 0.2 with the survival target mixed alike,
    pathway jitter 0.05, constraints on, dropout 0, lr 1e-3, weight decay
    0.1 on every parameter, BatchNorm's scale and bias included, clip 1.0)
    from the same variables with the JAX key's draws: the normalized
    survival target equal, the gradient norm within rtol 1e-4, every
    parameter within 2e-6 of the JAX Trainer's except where the clipped
    gradient is below 1e-6 (Adam's lr * g / (|g| + eps) then moves by up to
    lr: held to 2 lr, and all but 1e-3 of the other parameters within
    2e-6), and the running statistics within 1e-6. The biases of the Dense
    layers that feed a train-mode BatchNorm have a gradient of exactly 0
    (BatchNorm subtracts the batch mean): both libraries compute rounding
    noise there, which Adam scales to about lr, so those are held to 2 lr
    and left out of the share."""
    jtr, ptr = _trainer_pair(cohort, tmp_path)
    np.testing.assert_array_equal(ptr._surv.numpy(), np.asarray(jtr._surv))
    rows = jtr.train_idx[:BATCH]
    data, cond, surv = jtr._data[rows], jtr._cond[rows], jtr._surv[rows]
    rng = jax.random.PRNGKey(100)
    mix_rng, noise_rng, loss_rng = jax.random.split(rng, 3)
    lam_rng, perm_rng = jax.random.split(mix_rng)
    lam = np.float32(jax.random.beta(lam_rng, 0.2, 0.2))
    perm = np.asarray(jax.random.permutation(perm_rng, BATCH))
    jitter = np.asarray(jax.random.normal(noise_rng, (BATCH, 14), jnp.float32))
    z_rng, _ = jax.random.split(loss_rng)
    eps = np.asarray(jax.random.normal(z_rng, (BATCH, LATENT), jnp.float32))

    aug = (lam * data + (1 - lam) * data[perm]).at[:, 50:].add(0.05 * jnp.asarray(jitter))
    aug_batch = (aug, lam * cond + (1 - lam) * cond[perm], lam * surv + (1 - lam) * surv[perm])
    grads = jax.jit(jax.grad(lambda p, b, k: jtr._loss_with_aux(p, jtr.batch_stats, b, k,
                                                                True)[0]))(
        jtr.params, aug_batch, loss_rng)
    norm = float(optax.global_norm(grads))
    sensitive = {k: np.abs(v.numpy()) * min(1.0, 1.0 / norm) < 1e-6 for k, v in
                 flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items()}

    params, _, stats, want_metrics = jtr._train_step(jtr.params, jtr.opt_state, jtr.batch_stats,
                                                     data, cond, surv, rng)
    metrics = ptr.train_step(torch.from_numpy(np.array(data)), torch.from_numpy(np.array(cond)),
                             torch.from_numpy(np.array(surv)), lam=float(lam),
                             perm=torch.from_numpy(perm), pathway_noise=torch.from_numpy(jitter),
                             eps=torch.from_numpy(eps))
    assert float(metrics["grad_norm"]) == pytest.approx(norm, rel=1e-4)
    assert float(metrics["loss"]) == pytest.approx(float(want_metrics["loss"]), rel=1e-5)
    want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                     jax.tree_util.tree_map(np.asarray, stats))
    got = ptr.module.state_dict()
    assert set(got) == set(want)
    wide = total = 0
    for name, value in want.items():
        diff = np.abs(got[name].numpy() - value.numpy())
        if name.endswith((".mean", ".var")):
            assert diff.max() <= 1e-6, name
            continue
        ok = (diff <= 2e-6) | (sensitive[name] & (diff <= 2e-3))
        assert ok.all(), f"{name}: max |diff| {diff.max():.3e}"
        if not PRE_BN_BIAS.match(name):
            wide += (diff > 2e-6).sum()
            total += diff.size
    assert wide / total < 1e-3


def test_checkpoint_and_convert_round_trip(tmp_path):
    """Params and ``batch_stats`` through the port's state_dict and
    ``best_model.npz`` (``batch_stats/`` keys, no ``num_batches_tracked``)
    and back, bit for bit."""
    _, variables, pmodel = _pair()
    state = pmodel.module.state_dict()
    params, stats = state_dict_to_flax(state)
    for tree, flat in ((params, variables["params"]), (stats, variables["batch_stats"])):
        want = flatten_params(flat)
        got = flatten_params(tree)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ckpt.save_weights(tmp_path, state)
    with np.load(tmp_path / "best_model.npz") as f:
        keys = set(f.files)
    assert "batch_stats/encoder/bn_0/mean" in keys and "decoder/output/kernel" in keys
    assert not any("num_batches_tracked" in k or k.endswith("running_mean") for k in keys)
    again = ckpt.load_weights(tmp_path)
    assert set(again) == set(state)
    for key in state:
        assert torch.equal(again[key], state[key]), key


@pytest.mark.parametrize("where,key", [
    ("params", "encoder/attn_0/kernel"), ("params", "decoder/fc_mu/kernel"),
    ("params", "survival_head/fc3/kernel"), ("params", "coupling_0/fc9/kernel"),
    ("batch_stats", "encoder/bn_0/count"), ("batch_stats", "gnn_0/mean"),
])
def test_unknown_leaves_raise(where, key):
    """A parameter or statistic of no module of the port is refused."""
    from osteosarcoma_diffusionmodel_torch.convert import unflatten_params

    _, variables, _ = _pair(perturb=False)
    trees = {k: flatten_params(v) for k, v in variables.items()}
    trees[where][key] = np.zeros((4, 4) if key.endswith("kernel") else 4, np.float32)
    with pytest.raises(NotImplementedError):
        flax_params_to_state_dict(unflatten_params(trees["params"]),
                                  unflatten_params(trees["batch_stats"]))


def test_dropout_statistics():
    """In training mode each layer's dropout zeroes a share p of its
    inputs (``model.gnn.dropout`` 0.4 here; the survival head's fixed 0.2)
    and scales the rest by 1/(1-p); eval mode drops nothing."""
    _, _, pmodel = _pair(dropout=0.4)
    module = pmodel.module
    seen = {}

    def hook(name):
        def record(mod, inputs, output):
            seen.setdefault(name, []).append((inputs[0].detach(), output.detach()))
        return record

    handles = [module.encoder.drop.register_forward_hook(hook("encoder")),
               module.decoder.drop.register_forward_hook(hook("decoder")),
               module.survival_head.drop.register_forward_hook(hook("survival"))]
    x, c, _ = _inputs(batch=256)
    torch.manual_seed(0)
    module.train()
    with torch.no_grad():
        module(torch.from_numpy(x), torch.from_numpy(c))
    module.eval()
    for h in handles:
        h.remove()
    for name, p in (("encoder", 0.4), ("decoder", 0.4), ("survival", 0.2)):
        inp = torch.cat([i.flatten() for i, _ in seen[name]])
        out = torch.cat([o.flatten() for _, o in seen[name]])
        live = inp != 0
        dropped = (out[live] == 0).float().mean().item()
        n = int(live.sum())
        assert abs(dropped - p) < 4 * np.sqrt(p * (1 - p) / n), (name, dropped)
        kept = live & (out != 0)
        torch.testing.assert_close(out[kept], inp[kept] / (1 - p), rtol=1e-2, atol=0)
    with torch.no_grad():
        a = module(torch.from_numpy(x), torch.from_numpy(c))
        b = module(torch.from_numpy(x), torch.from_numpy(c))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
