"""The port's training step against the JAX package: the constraint
losses, the diffusion loss on injected draws, the AdamW train step and
its global-norm clip, the split and the epoch permutation.

Tiny shapes (data 10/40/14, hidden 128/256/128), seeded numpy inputs.
JAX keys cannot be reproduced in torch, so each comparison derives the
JAX step's draws (t, noise, bit uniforms, mixup's lambda and
permutation, the pathway jitter) from its keys on the test side and
passes them to the port. tests/test_torch_dataset.py holds the arrays,
schedules, dropout, checkpoints and the CLI's train step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import OsteosarcomaArrays as JaxArrays
from osteosarcoma_diffusionmodel_tpu.models import constraints as jcons
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.training.trainer import Trainer as JaxTrainer
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays, train_val_split
from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
from osteosarcoma_diffusionmodel_torch.models import constraints as pcons
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, clip_by_global_norm
from torch_parity import BATCH, TRAIN_DUMMY, constraint_specs, train_config

LOSS_RTOL = 1e-5  # f32 loss terms against the JAX package's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops run fastest on one thread (GroupNorm on 8 threads
    takes milliseconds here); restored after the module."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cohort():
    """The tiny structured cohort: (DummyCohort, data, conditions, dims)."""
    c = make_dummy_cohort(**TRAIN_DUMMY)
    data, conditions, dims = cohort_arrays(c, Config())
    return c, data, conditions, dims


def _models(cohort, **kw):
    """(JAX model, Flax params as numpy, port model) on the same weights."""
    c, data, _, _ = cohort
    jspec, pspec = constraint_specs(c, data)
    jc, pc = train_config(JaxConfig(), **kw), train_config(Config(), **kw)
    names = ["survival_days_norm", "event_occurred", "metastasis_at_diagnosis"]
    jdims = jc.freeze_dims(10, 40, 14, names)
    pdims = pc.freeze_dims(10, 40, 14, names)
    jmodel = JaxDiffusion.from_config(jc, jdims, jspec)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), 3))
    gain = params["skip_gain"]
    gain["kernel"] = (0.3 * np.random.default_rng(5).standard_normal(
        gain["kernel"].shape)).astype(np.float32)
    pmodel = ConditionalDiffusion.from_config(pc, pdims, pspec)
    pmodel.denoiser.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, pmodel


def _loss_draws(key, batch, T, M, D):
    """The draws JaxDiffusion.loss makes from ``key`` (diffusion.py:513)."""
    t_rng, noise_rng, _, _, bit_rng = jax.random.split(key, 5)
    t = np.asarray(jax.random.randint(t_rng, (batch,), 0, T))
    noise = np.asarray(jax.random.normal(noise_rng, (batch, D - M), jnp.float32))
    bits = np.asarray(jax.random.uniform(bit_rng, (batch, M))) if M else None
    return t, noise, bits


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# (a) constraint losses
# ----------------------------------------------------------------------
def test_constraint_spec_build_matches_jax(cohort):
    c, data, _, _ = cohort
    jspec, pspec = constraint_specs(c, data)
    for name in ("pathway_mask", "exclusive_pairs", "rule_mutation_idx", "rule_pathway_idx",
                 "rule_sign", "mutation_corr_target"):
        np.testing.assert_array_equal(getattr(pspec, name), getattr(jspec, name), err_msg=name)
        assert getattr(pspec, name).dtype == getattr(jspec, name).dtype, name
    assert pspec.pathway_mask.shape[1] > 0 and len(pspec.rule_sign) == 2
    assert pspec.exclusive_pairs.shape == (2, 2)
    np.testing.assert_array_equal(pcons.mutation_corr_matrix(data[:, :10]),
                                  jcons.mutation_corr_matrix(data[:, :10]))


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_constraint_losses_match_jax(cohort, empty, seed):
    """Each of the four losses on a random batch of predicted x0, and on
    an empty spec (every loss 0): f32, rtol 1e-5."""
    c, data, _, _ = cohort
    if empty:
        jspec = jcons.ConstraintSpec(10, 40, 14)
        pspec = pcons.ConstraintSpec(10, 40, 14)
    else:
        jspec, pspec = constraint_specs(c, data)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, 64)).astype(np.float32)
    x[:, :10] = rng.uniform(-0.2, 1.2, (BATCH, 10))
    want = jcons.constraint_losses(jnp.asarray(x), jspec)
    got = pcons.constraint_losses(torch.from_numpy(x), pspec, pspec.tensors("cpu"))
    assert set(got) == set(want)
    for name, value in want.items():
        assert float(got[name]) == pytest.approx(float(value), rel=LOSS_RTOL, abs=1e-7), name
        if empty:
            assert float(got[name]) == 0.0


# ----------------------------------------------------------------------
# (b) the diffusion loss on injected draws
# ----------------------------------------------------------------------
LOSS_CASES = [
    # compute dtype, constraints, D3PM head, loss type, balanced weights
    ("float32", True, False, "l2", False),
    ("float32", False, False, "l2", False),
    ("float32", True, True, "l2", False),
    ("float32", False, True, "l1", False),
    ("float32", True, False, "huber", False),
    ("float32", True, True, "huber", True),
    ("float32", False, False, "l1", True),
    ("bfloat16", True, False, "l2", False),
    ("bfloat16", True, True, "l2", True),
]


@pytest.mark.parametrize("dtype,constraints,discrete,loss_type,balanced", LOSS_CASES)
def test_loss_matches_jax_on_injected_draws(cohort, dtype, constraints, discrete, loss_type,
                                            balanced):
    """Every metric of the port's loss against JaxDiffusion.loss(...,
    deterministic=True) with the JAX key's t, noise and bit uniforms:
    f32 rtol 1e-5; bf16 rtol 2e-2 or 5e-3 absolute (bf16 products summed
    in another order by each library; the batch correlations inside the
    constraint terms lie in [-1, 1])."""
    _, data, conditions, _ = cohort
    jmodel, params, pmodel = _models(cohort, compute_dtype=dtype, discrete=discrete,
                                     loss_type=loss_type, balanced=balanced,
                                     constraints=constraints)
    x0, cond = data[:BATCH], conditions[:BATCH]
    key = jax.random.PRNGKey(11)
    total, want = jmodel.loss(params, jnp.asarray(x0), jnp.asarray(cond), key,
                              deterministic=True)
    M = 10 if discrete else 0
    t, noise, bits = _loss_draws(key, BATCH, 20, M, 64)
    with torch.no_grad():
        ptotal, got = pmodel.loss(torch.from_numpy(x0), torch.from_numpy(cond), t=_t(t),
                                  noise=_t(noise), bit_uniforms=_t(bits), train=False)
    assert set(got) == set(want)
    assert ("mutation_ce" in got) == discrete and ("pathway_coherence" in got) == constraints
    rtol, atol = (LOSS_RTOL, 1e-6) if dtype == "float32" else (2e-2, 5e-3)
    for name, value in want.items():
        assert float(got[name]) == pytest.approx(float(value), rel=rtol, abs=atol), name
    assert float(ptotal) == float(got["loss"])


def test_loss_draws_from_its_generator(cohort):
    """Without injected draws the loss takes t, noise and bits from its
    generator: the same seed gives the same loss, another seed another."""
    _, data, conditions, _ = cohort
    _, _, pmodel = _models(cohort, discrete=True)
    x0, cond = torch.from_numpy(data[:BATCH]), torch.from_numpy(conditions[:BATCH])
    with torch.no_grad():
        losses = [float(pmodel.loss(x0, cond, torch.Generator().manual_seed(s))[0])
                  for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
    assert all(math.isfinite(v) for v in losses)


# ----------------------------------------------------------------------
# (c) the train step against the JAX Trainer's
# ----------------------------------------------------------------------
def _trainer_pair(cohort, tmp_path, **kw):
    c, data, conditions, dims = cohort
    jc = train_config(JaxConfig(), **kw)
    pc = train_config(Config(), **kw)
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
    jdims = jc.freeze_dims(10, 40, 14, dims.condition_names, dims.survival_mean,
                           dims.survival_std)
    jspec, pspec = constraint_specs(c, data)
    jtr = JaxTrainer(JaxDiffusion.from_config(jc, jdims, jspec), JaxArrays(**common), jdims, jc)
    ptr = Trainer(ConditionalDiffusion.from_config(pc, dims, pspec), OsteosarcomaArrays(**common),
                  dims, pc, "cpu")
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    ptr.model.denoiser.load_state_dict(flax_params_to_state_dict(params))
    return jtr, ptr


@pytest.mark.parametrize("discrete", [False, True])
def test_train_steps_match_jax_trainer(cohort, tmp_path, discrete):
    """One and three AdamW steps (mixup 0.2, pathway jitter 0.05,
    constraints on, dropout 0, lr 1e-3, weight decay 0.1) from the same
    params with the JAX keys' draws: the global gradient norm before the
    clip within rtol 1e-4, and every parameter within 2e-6 of the JAX
    Trainer's after step 1 (f32). Adam moves a parameter by
    lr * g / (|g| + 1e-8), so where the clipped gradient is below 1e-6
    (100 eps) rounding in g moves the update by up to lr: those
    parameters are held to 2 lr, and all but 1e-3 of all parameters
    must still be within 2e-6. After step 3
    the differences of those few have reached their neighbours'
    gradients: all but 1e-3 of the parameters within 2e-6, every one
    within 2 lr a step."""
    jtr, ptr = _trainer_pair(cohort, tmp_path, discrete=discrete)
    T, M, D, lr = 20, 10 if discrete else 0, 64, 1e-3
    rows = jtr.train_idx[:BATCH]
    data = jtr._data[rows]
    cond = jtr._cond[rows]
    surv = jtr._surv[rows]
    params, opt_state = jtr.params, jtr.opt_state
    grad_fn = jax.jit(jax.grad(lambda p, b, k: jtr._loss_with_aux(p, {}, b, k, True)[0]))
    sensitive = None
    clipped = 0
    for step in range(3):
        rng = jax.random.PRNGKey(100 + step)
        mix_rng, noise_rng, loss_rng = jax.random.split(rng, 3)
        lam_rng, perm_rng = jax.random.split(mix_rng)
        lam = np.float32(jax.random.beta(lam_rng, 0.2, 0.2))
        perm = np.asarray(jax.random.permutation(perm_rng, BATCH))
        jitter = np.asarray(jax.random.normal(noise_rng, (BATCH, 14), jnp.float32))
        t, noise, bits = _loss_draws(loss_rng, BATCH, T, M, D)

        # The JAX gradient and its global norm on the same augmented batch.
        aug = lam * data + (1 - lam) * data[perm]
        aug_cond = lam * cond + (1 - lam) * cond[perm]
        aug = aug.at[:, 50:].add(0.05 * jnp.asarray(jitter))
        grads = grad_fn(params, (aug, aug_cond, surv), loss_rng)
        want_norm = float(optax.global_norm(grads))
        clipped += want_norm >= 1.0
        if step == 0:
            sensitive = {
                k: np.abs(v.numpy()) * min(1.0, 1.0 / want_norm) < 1e-6 for k, v in
                flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items()}

        params, opt_state, _, _ = jtr._train_step(params, opt_state, {}, data, cond, surv, rng)
        metrics = ptr.train_step(
            torch.from_numpy(np.array(data)), torch.from_numpy(np.array(cond)),
            lam=float(lam), perm=_t(perm), pathway_noise=_t(jitter),
            t=_t(t), noise=_t(noise), bit_uniforms=_t(bits))
        assert float(metrics["grad_norm"]) == pytest.approx(want_norm, rel=1e-4), step
        if step in (0, 2):
            want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
            got = ptr.model.denoiser.state_dict()
            diffs = {k: np.abs(got[k].numpy() - v.numpy()) for k, v in want.items()}
            for name, diff in diffs.items():
                allowed = sensitive[name] if step == 0 else np.ones_like(diff, bool)
                ok = (diff <= 2e-6) | (allowed & (diff <= 2 * lr * (step + 1)))
                assert ok.all(), f"{name} after step {step + 1}: max |diff| {diff.max():.3e}"
            wide = sum((d > 2e-6).sum() for d in diffs.values())
            assert wide / sum(d.size for d in diffs.values()) < 1e-3, (step, wide)
    assert clipped >= 1  # the clip acted on at least one step


def test_clip_by_global_norm_is_optax():
    rng = np.random.default_rng(3)
    for scale in (0.01, 10.0):
        arrays = [(scale * rng.standard_normal(s)).astype(np.float32) for s in ((4, 5), (7,))]
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(a) for a in arrays], optax.EmptyState())
        grads = [torch.from_numpy(a.copy()) for a in arrays]
        norm = clip_by_global_norm(grads, 1.0)
        assert float(norm) == pytest.approx(float(optax.global_norm(arrays)), rel=1e-6)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# ----------------------------------------------------------------------
# (d) the split and the epoch permutation
# ----------------------------------------------------------------------
def test_split_and_epoch_batches_match_jax(cohort, tmp_path):
    from osteosarcoma_diffusionmodel_tpu.data.dataset import train_val_split as jax_split

    for n, frac, seed in ((40, 0.2, 42), (100, 0.2, 0), (7, 0.5, 3)):
        for a, b in zip(train_val_split(n, frac, seed), jax_split(n, frac, seed)):
            np.testing.assert_array_equal(a, b)
    jtr, ptr = _trainer_pair(cohort, tmp_path)
    np.testing.assert_array_equal(ptr.train_idx, jtr.train_idx)
    np.testing.assert_array_equal(ptr.val_idx, jtr.val_idx)
    for epoch in (0, 1, 17):
        perm = np.random.default_rng(42 + 1000 + epoch).permutation(jtr.train_idx)
        np.testing.assert_array_equal(ptr.epoch_batches(epoch), perm[:32].reshape(2, BATCH))


