"""Training the diffusion model's variants in the port against the JAX
package: the loss and every metric with the AR head, latent factors, CFG,
the v and epsilon targets, learned and low-rank sigma; one and three
optimizer steps against the JAX ``Trainer`` with its optimizer layout (the
AR head's own Adam, the undecayed low-rank group, one global-norm clip);
resuming both optimizers; and the CLI's train, generate and validate
steps on a variant.

Tiny shapes (data 10/40/14, hidden 128/256/128, T = 20, batch 16), f32.
Each comparison derives the JAX step's draws (t, noise, the CFG keep
uniforms, mixup's lambda and permutation, the pathway jitter) from its
keys and passes them to the port, as tests/test_torch_train.py does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import OsteosarcomaArrays as JaxArrays
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.models.networks import DiffusionDenoiser as JaxDenoiser
from osteosarcoma_diffusionmodel_tpu.training.trainer import Trainer as JaxTrainer
from osteosarcoma_diffusionmodel_tpu.training.trainer import _set_learning_rate
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer
from torch_parity import BATCH, TRAIN_DUMMY, constraint_specs, override, perturb_heads, train_config

LOSS_RTOL = 1e-5  # f32 loss terms against the JAX package's (tests/test_torch_train.py)
T, M, D, P = 20, 10, 64, 14
NAMES = ["survival_days_norm", "event_occurred", "metastasis_at_diagnosis"]


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


def _configs(overrides, constraints=True, mixup=0.2):
    jc = override(train_config(JaxConfig(), constraints=constraints), overrides)
    pc = override(train_config(Config(), constraints=constraints), overrides)
    for cfg in (jc, pc):
        cfg.training.augmentation.mixup_alpha = mixup
    return jc, pc


def _models(cohort, overrides, constraints=True):
    """(JAX model, Flax params with the heads perturbed, port model)."""
    c, data, _, _ = cohort
    jspec, pspec = constraint_specs(c, data)
    jc, pc = _configs(overrides, constraints)
    jmodel = JaxDiffusion.from_config(jc, jc.freeze_dims(M, 40, P, NAMES), jspec)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), 3))
    perturb_heads(params, 1)
    pmodel = ConditionalDiffusion.from_config(pc, pc.freeze_dims(M, 40, P, NAMES), pspec)
    pmodel.denoiser.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, pmodel


def _loss_draws(key, batch, m):
    """The draws JaxDiffusion.loss makes from ``key`` (diffusion.py:513):
    t, noise, the CFG keep uniforms, the D3PM bit uniforms."""
    t_rng, noise_rng, _, cfg_rng, bit_rng = jax.random.split(key, 5)
    return dict(
        t=_t(jax.random.randint(t_rng, (batch,), 0, T)),
        noise=_t(jax.random.normal(noise_rng, (batch, D - m), jnp.float32)),
        cfg_uniforms=_t(jax.random.uniform(cfg_rng, (batch, 1))),
        bit_uniforms=_t(jax.random.uniform(bit_rng, (batch, m))) if m else None,
    )


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# The loss
# ----------------------------------------------------------------------
LOSS_CASES = {
    "x0-ar-latent-cfg": {"model.diffusion.ar_mutation_head": True,
                         "model.diffusion.latent_factor_dim": 3,
                         "model.cfg_dropout_prob": 0.4},
    "x0-ar-continuous-latent-mutations": {"model.diffusion.ar_mutation_head": True,
                                          "model.diffusion.ar_context": "continuous",
                                          "model.diffusion.latent_factor_dim": 2,
                                          "model.diffusion.latent_encoder_input": "mutations"},
    "v-learned-sigma": {"model.diffusion.parameterization": "v",
                        "model.diffusion.learn_sigma": True},
    "epsilon-low-rank-full": {"model.diffusion.parameterization": "epsilon",
                              "model.diffusion.low_rank_sigma_dim": 3},
    "epsilon-low-rank-mutations": {"model.diffusion.parameterization": "epsilon",
                                   "model.diffusion.low_rank_sigma_dim": 3,
                                   "model.diffusion.low_rank_sigma_scope": "mutations"},
    "v-d3pm-learned-sigma": {"model.diffusion.parameterization": "v",
                             "model.diffusion.learn_sigma": True,
                             "model.diffusion.discrete_mutation_head": True},
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_variant_loss_matches_jax(cohort, case):
    """Every metric of the port's loss against JaxDiffusion.loss(...,
    deterministic=True) on the JAX key's t, noise, CFG keep uniforms and
    bit uniforms: f32 rtol 1e-5."""
    _, data, conditions, _ = cohort
    jmodel, params, pmodel = _models(cohort, LOSS_CASES[case])
    x0, cond = data[:BATCH], conditions[:BATCH]
    key = jax.random.PRNGKey(11)
    _, want = jmodel.loss(params, jnp.asarray(x0), jnp.asarray(cond), key, deterministic=True)
    m = M if pmodel.discrete_head else 0
    with torch.no_grad():
        total, got = pmodel.loss(torch.from_numpy(x0), torch.from_numpy(cond),
                                 **_loss_draws(key, BATCH, m))
    assert set(got) == set(want)
    for name, value in want.items():
        assert float(got[name]) == pytest.approx(float(value), rel=LOSS_RTOL, abs=1e-6), name
    assert float(total) == float(got["loss"])
    assert ("ar_ce" in got) == ("ar_mutation_head" in case or "-ar-" in case)


def test_ar_ce_reads_the_rows_before_mixup(cohort):
    """The AR CE on ``ar_x0``/``ar_conditions`` (the rows before mixup),
    the rest of the loss on the mixed rows, against the JAX loss given the
    same two batches; sel_loss leaves the AR terms out."""
    _, data, conditions, _ = cohort
    jmodel, params, pmodel = _models(cohort, {"model.diffusion.ar_mutation_head": True})
    x0, cond = data[:BATCH], conditions[:BATCH]
    perm = np.random.default_rng(4).permutation(BATCH)
    mixed, mixed_c = 0.7 * x0 + 0.3 * x0[perm], 0.7 * cond + 0.3 * cond[perm]
    key = jax.random.PRNGKey(12)
    _, want = jmodel.loss(params, jnp.asarray(mixed), jnp.asarray(mixed_c), key,
                          deterministic=True, ar_x0=jnp.asarray(x0),
                          ar_conditions=jnp.asarray(cond))
    with torch.no_grad():
        _, got = pmodel.loss(torch.from_numpy(mixed), torch.from_numpy(mixed_c),
                             ar_x0=torch.from_numpy(x0), ar_conditions=torch.from_numpy(cond),
                             **_loss_draws(key, BATCH, 0))
        _, on_mixed = pmodel.loss(torch.from_numpy(mixed), torch.from_numpy(mixed_c),
                                  **_loss_draws(key, BATCH, 0))
    for name, value in want.items():
        assert float(got[name]) == pytest.approx(float(value), rel=LOSS_RTOL, abs=1e-6), name
    assert float(got["ar_ce"]) != pytest.approx(float(on_mixed["ar_ce"]), rel=1e-3)
    assert float(got["sel_loss"]) == pytest.approx(float(on_mixed["sel_loss"]), rel=1e-6)
    assert float(got["sel_loss"]) < float(got["loss"])


# ----------------------------------------------------------------------
# The train step against the JAX Trainer's
# ----------------------------------------------------------------------
TRAIN_CASES = {
    "ar-low-rank": {"model.diffusion.ar_mutation_head": True,
                    "model.diffusion.low_rank_sigma_dim": 3,
                    "model.diffusion.parameterization": "epsilon"},
    "latent-cfg-learned-sigma-v": {"model.diffusion.latent_factor_dim": 3,
                                   "model.cfg_dropout_prob": 0.3,
                                   "model.diffusion.learn_sigma": True,
                                   "model.diffusion.parameterization": "v"},
}


def _trainer_pair(cohort, tmp_path, overrides):
    c, data, conditions, dims = cohort
    jc, pc = _configs(overrides)
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
    jdims = jc.freeze_dims(M, 40, P, dims.condition_names, dims.survival_mean,
                           dims.survival_std)
    jspec, pspec = constraint_specs(c, data)
    jtr = JaxTrainer(JaxDiffusion.from_config(jc, jdims, jspec), JaxArrays(**common), jdims, jc)
    pdims = pc.freeze_dims(M, 40, P, dims.condition_names, dims.survival_mean,
                           dims.survival_std)
    ptr = Trainer(ConditionalDiffusion.from_config(pc, pdims, pspec),
                  OsteosarcomaArrays(**common), pdims, pc, "cpu")
    ptr.model.denoiser.load_state_dict(
        flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jtr.params)))
    return jtr, ptr


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_variant_train_steps_match_jax_trainer(cohort, tmp_path, case):
    """One and three steps (mixup 0.2, pathway jitter 0.05, constraints on,
    lr 1e-3, weight decay 0.1; the AR head's Adam at ar_lr 1e-2, the
    low-rank parameters undecayed) from the same params with the JAX keys'
    draws: the global gradient norm within rtol 1e-4, and the parameters
    held to the JAX Trainer's by tests/test_torch_train.py's rule (2e-6;
    where the clipped gradient is below 1e-6, 2 lr a step with that
    parameter's own lr; all but 1e-3 of the parameters within 2e-6)."""
    jtr, ptr = _trainer_pair(cohort, tmp_path, TRAIN_CASES[case])
    lr, ar_lr = 1e-3, ptr.model.ar_lr
    assert len(ptr.optimizers) == (2 if ptr.model.ar_head else 1)
    if ptr.model.low_rank_sigma_dim:
        assert [g["weight_decay"] for g in ptr.optimizer.param_groups] == [0.1, 0.0]
    rows = jtr.train_idx[:BATCH]
    data, cond, surv = jtr._data[rows], jtr._cond[rows], jtr._surv[rows]
    params, opt_state = jtr.params, jtr.opt_state
    grad_fn = jax.jit(jax.grad(lambda p, b, k, raw: jtr._loss_with_aux(
        p, {}, b, k, True, raw)[0]))
    sensitive = None
    for step in range(3):
        rng = jax.random.PRNGKey(100 + step)
        mix_rng, noise_rng, loss_rng = jax.random.split(rng, 3)
        lam_rng, perm_rng = jax.random.split(mix_rng)
        lam = np.float32(jax.random.beta(lam_rng, 0.2, 0.2))
        perm = np.asarray(jax.random.permutation(perm_rng, BATCH))
        jitter = np.asarray(jax.random.normal(noise_rng, (BATCH, P), jnp.float32))
        aug = lam * data + (1 - lam) * data[perm]
        aug_cond = lam * cond + (1 - lam) * cond[perm]
        aug = aug.at[:, D - P:].add(0.05 * jnp.asarray(jitter))
        grads = grad_fn(params, (aug, aug_cond, surv), loss_rng, (data, cond))
        want_norm = float(optax.global_norm(grads))
        if step == 0:
            sensitive = {
                k: np.abs(v.numpy()) * min(1.0, 1.0 / want_norm) < 1e-6 for k, v in
                flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items()}
        params, opt_state, _, _ = jtr._train_step(params, opt_state, {}, data, cond, surv, rng)
        draws = _loss_draws(loss_rng, BATCH, 0)
        metrics = ptr.train_step(
            torch.from_numpy(np.array(data)), torch.from_numpy(np.array(cond)),
            lam=float(lam), perm=_t(perm), pathway_noise=_t(jitter), t=draws["t"],
            noise=draws["noise"], cfg_uniforms=draws["cfg_uniforms"])
        assert float(metrics["grad_norm"]) == pytest.approx(want_norm, rel=1e-4), step
        if step in (0, 2):
            want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
            got = ptr.model.denoiser.state_dict()
            diffs = {k: np.abs(got[k].numpy() - v.numpy()) for k, v in want.items()}
            for name, diff in diffs.items():
                own_lr = ar_lr if name.startswith("ar_") else lr
                allowed = sensitive[name] if step == 0 else np.ones_like(diff, bool)
                ok = (diff <= 2e-6) | (allowed & (diff <= 2 * own_lr * (step + 1)))
                assert ok.all(), f"{name} after step {step + 1}: max |diff| {diff.max():.3e}"
            wide = sum((d > 2e-6).sum() for d in diffs.values())
            assert wide / sum(d.size for d in diffs.values()) < 1e-3, (step, wide)


AR_EPOCHS = 3
AR_TRAJECTORY_TOL = 1e-5  # the AR parameters and context logits after 3 epochs (6 steps)


@pytest.mark.parametrize("main_lr", [1e-3, 1e-15])
def test_ar_trajectory_matches_jax_trainer(cohort, tmp_path, main_lr):
    """Three epochs of the port's Trainer beside the JAX Trainer's
    ``train_epoch`` (its scan over the epoch's batches, keys folded in by
    batch), the JAX keys' draws passed to the port's steps, the epoch's
    batches the same rule's. The AR parameters and the AR context's logits
    on every cohort row stay within 1e-5 of the JAX trainer's. With the main
    learning rate forced to 1e-15 (a plateau schedule's collapse; JAX
    tests/test_ar_head.py ``test_ar_optimizer_branch_is_plateau_immune``)
    the AR parameters still move, by the same amounts in both, and the
    others do not."""
    jtr, ptr = _trainer_pair(cohort, tmp_path, {"model.diffusion.ar_mutation_head": True})
    jtr.opt_state = _set_learning_rate(jtr.opt_state, main_lr)
    ptr.set_learning_rate(main_lr)
    start = {k: v.clone() for k, v in ptr.model.denoiser.state_dict().items()}
    for epoch in range(AR_EPOCHS):
        rng = jax.random.PRNGKey(300 + epoch)
        batches = ptr.epoch_batches(epoch)
        perm = np.random.default_rng(jtr.config.training.random_seed + 1000 + epoch).permutation(
            jtr.train_idx)
        np.testing.assert_array_equal(batches.ravel(), perm[: batches.size])
        jtr.train_epoch(epoch, rng)
        for b, rows in enumerate(batches):
            mix_rng, noise_rng, loss_rng = jax.random.split(jax.random.fold_in(rng, b), 3)
            lam_rng, perm_rng = jax.random.split(mix_rng)
            draws = _loss_draws(loss_rng, BATCH, 0)
            ptr.train_step(
                ptr._data[rows], ptr._cond[rows], ptr._surv[rows],
                lam=float(np.float32(jax.random.beta(lam_rng, 0.2, 0.2))),
                perm=_t(jax.random.permutation(perm_rng, BATCH)),
                pathway_noise=_t(jax.random.normal(noise_rng, (BATCH, P), jnp.float32)),
                t=draws["t"], noise=draws["noise"])
    want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jtr.params))
    got = ptr.model.denoiser.state_dict()
    for name in (n for n in want if n.startswith("ar_")):
        diff = float(np.abs(got[name].numpy() - want[name].numpy()).max())
        assert diff <= AR_TRAJECTORY_TOL, f"{name}: max |diff| {diff:.3e}"
        assert float((got[name] - start[name]).abs().max()) > 1e-4, f"{name} did not move"
    jm, dims = jtr.model, jtr.dims
    data, cond = np.asarray(jtr._data), np.asarray(jtr._cond)
    ctx = jm._ar_context_view(jnp.asarray(data[:, M:]), jnp.asarray(cond))
    want_logits = np.asarray(jm.denoiser.apply({"params": jtr.params}, ctx,
                                               method=JaxDenoiser.ar_context_logits))
    with torch.no_grad():
        got_logits = ptr.model.denoiser.ar_context_logits(ptr.model._ar_context_view(
            ptr._data[:, M:], ptr._cond)).numpy()
    assert float(np.abs(got_logits).max()) > 0.1
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=AR_TRAJECTORY_TOL)
    if main_lr < 1e-9:
        for name in (n for n in got if not n.startswith("ar_")):
            moved = float((got[name] - start[name]).abs().max())
            assert moved < 1e-9, f"{name} moved {moved:.3e} at the collapsed main rate"
            assert np.abs(want[name].numpy() - start[name].numpy()).max() < 1e-9, name


def test_ar_optimizer_checkpoint_resume(cohort, tmp_path):
    """Two epochs with an AR head and low-rank sigma, a checkpoint each
    epoch: a fresh trainer's resume() restores the weights, both
    optimizers' moments and steps, AdamW's lowered LR and the AR Adam's
    constant one."""
    c, data, conditions, dims = cohort
    pc = _configs({"model.diffusion.ar_mutation_head": True,
                   "model.diffusion.low_rank_sigma_dim": 2})[1]
    pc.training.save_dir = str(tmp_path / "ckpt")
    pc.training.num_epochs = 2
    pc.training.save_frequency = 1
    arrays = OsteosarcomaArrays(data, conditions, np.zeros(len(data), np.float32),
                                list(c.sample_ids), c.mutation_genes, c.expression_genes,
                                c.pathway_names, dims.condition_names)
    _, pspec = constraint_specs(c, data)
    tr = Trainer(ConditionalDiffusion.from_config(pc, dims, pspec), arrays, dims, pc, "cpu")
    history = tr.train()
    assert all(math.isfinite(v) for v in history.train_loss + history.val_loss)
    tr.set_learning_rate(2.5e-5)
    tr.save_checkpoint(1, history.val_loss[-1])
    again = Trainer(ConditionalDiffusion.from_config(pc, dims, pspec), arrays, dims, pc, "cpu")
    assert again.resume() and again.start_epoch == 2
    assert again.optimizer.param_groups[0]["lr"] == 2.5e-5
    assert again.ar_optimizer.param_groups[0]["lr"] == pc.model.diffusion.ar_lr
    want, got = tr.model.denoiser.state_dict(), again.model.denoiser.state_dict()
    for name in want:
        assert torch.equal(want[name], got[name]), name
    for opt, opt2 in zip(tr.optimizers, again.optimizers):
        for (_, p), (_, q) in zip(tr._named(opt), again._named(opt2)):
            s, r = opt.state[p], opt2.state[q]
            assert float(s["step"]) == float(r["step"]) == 4.0
            assert torch.equal(s["exp_avg"], r["exp_avg"])
            assert torch.equal(s["exp_avg_sq"], r["exp_avg_sq"])
    assert {n for n, _ in again._named(again.ar_optimizer)} == {
        "ar_coupling", "ar_bias", "ar_ctx_fc1.weight", "ar_ctx_fc1.bias",
        "ar_ctx_fc2.weight", "ar_ctx_fc2.bias"}


def test_cli_trains_generates_and_validates_a_variant(cohort, tmp_path):
    """``--steps train generate validate --device cpu`` on an AR +
    latent-factor + CFG model:
    the checkpoint's metadata rebuilds the model, the mutation CSVs are
    the AR head's bits, the validation metrics are finite; sample-path
    fine-tuning, enabled, is skipped for these heads as in the JAX CLI."""
    c = cohort[0]
    write_processed(c, tmp_path / "processed")
    raw = {
        "data": {"processed_dir": str(tmp_path / "processed")},
        "model": {"hidden_dims": [128, 256, 128], "latent_dim": 32, "cfg_dropout_prob": 0.2,
                  "diffusion": {"num_steps": 8, "ar_mutation_head": True,
                                "latent_factor_dim": 2}},
        "training": {"save_dir": str(tmp_path / "ckpt"), "num_epochs": 2, "save_frequency": 1,
                     "sample_path_finetune": {"enabled": True}},
        "generation": {"num_synthetic_samples": 30, "sampler": "ddim", "sampling_steps": 4,
                       "guidance_scale": 3.0},
        "output": {"results_dir": str(tmp_path / "results"),
                   "synthetic_data_dir": str(tmp_path / "synthetic")},
    }
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    cli.main(["--config", str(path), "--steps", "train", "generate", "validate",
              "--device", "cpu"])
    meta = ckpt.load_metadata(tmp_path / "ckpt")
    diffusion = meta["config"]["model"]["diffusion"]
    assert diffusion["ar_mutation_head"] and diffusion["latent_factor_dim"] == 2
    assert "ar_coupling" in ckpt.load_weights(tmp_path / "ckpt")
    mut = np.genfromtxt(tmp_path / "synthetic" / "typical_patient" /
                        "typical_patient_mutations.csv", delimiter=",", skip_header=1)
    assert mut.shape == (10, M) and np.isin(mut, (0.0, 1.0)).all()
    results = np.genfromtxt(tmp_path / "results" / "validation_results.csv", delimiter=",",
                            names=True)
    assert math.isfinite(float(results["overall_biological_score"]))
