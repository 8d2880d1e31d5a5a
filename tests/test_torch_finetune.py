"""Sample-path fine-tuning (``training/finetune.py``) against the JAX
package's ``sample_path_finetune``, and the CLI's STEP 4b.

Tiny shapes (data 10/40/14, hidden 128/256/128, T = 6, f32): the weights
of ``tests/torch_parity.make_pair`` (dropout 0.2, so eval mode matters),
the seeded 40-row structured cohort. JAX keys cannot be reproduced in
torch, so each step's draws (the rows drawn with replacement, the DDIM
chain's x_T, the anchor loss's t and noise) are derived from the JAX
step key on the test side and injected through ``draws=``. The x0 clip
(30) is far from every x0 of these chains, so ``torch.clamp``'s gradient
at the bound and ``jnp.clip``'s half of it never meet here.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_tpu.training.finetune import (
    sample_path_finetune as jax_finetune,
)
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.models import constraints as pcons
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.training.finetune import sample_path_finetune
from torch_parity import TRAIN_DUMMY, make_pair

T, DDIM, BATCH, LR = 6, 4, 16, 1e-3
SETTINGS = dict(ddim_steps=DDIM, sample_batch=BATCH, learning_rate=LR, soft_tau=0.1,
                cooccurrence_weight=5.0, anchor_weight=1.0)
LOSS_RTOL = 1e-5  # f32 losses against the JAX function's
GRAD_FLOOR = 1e-4  # below it rounding can move a first Adam step (see the test)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cohort():
    c = make_dummy_cohort(**TRAIN_DUMMY)
    data, conditions, _ = cohort_arrays(c, Config())
    return data, conditions


def _pair():
    return make_pair(num_steps=T, compute_dtype="float32")


def _draws(key, steps, n, D):
    """Each step's draws as JAX ``sample_path_finetune`` makes them from
    ``fold_in(key, i)`` (finetune.py:85-93): the rows, ``sample_ddim``'s
    x_T (diffusion.py:974), the loss's t and noise (diffusion.py:513)."""
    out = []
    for i in range(steps):
        k_cond, k_z, k_anchor = jax.random.split(jax.random.fold_in(key, i), 3)
        init_rng, _, _ = jax.random.split(k_z, 3)
        t_rng, noise_rng, _, _, _ = jax.random.split(k_anchor, 5)
        out.append({
            "rows": torch.from_numpy(np.asarray(jax.random.randint(k_cond, (BATCH,), 0, n))).long(),
            "x_T": torch.from_numpy(np.asarray(jax.random.normal(init_rng, (BATCH, D)))),
            "t": torch.from_numpy(np.asarray(jax.random.randint(t_rng, (n,), 0, T))).long(),
            "noise": torch.from_numpy(np.asarray(jax.random.normal(noise_rng, (n, D)))),
        })
    return out


def _port_grads(data, conditions, draws):
    """The gradient of step 0's objective on the port (fresh weights of the
    pair): it agrees with JAX's to ~1e-5, far below GRAD_FLOOR."""
    _, _, pmodel = _pair()
    d = pmodel.denoiser.eval()
    x0, cond = torch.from_numpy(data), torch.from_numpy(conditions)
    x = pmodel.ddim_chain(cond[draws["rows"]], None, DDIM, draws={"x_T": draws["x_T"]})
    target = torch.from_numpy(pcons.mutation_corr_matrix(data[:, :10]))
    cooc = pcons.cooccurrence_matching_loss(torch.sigmoid((x[:, :10] - 0.5) / 0.1), target)
    anchor, _ = pmodel.loss(x0, cond, None, t=draws["t"], noise=draws["noise"], train=False)
    (5.0 * cooc + anchor).backward()
    return {n: p.grad for n, p in d.named_parameters()}


def _run_both(cohort, steps):
    data, conditions = cohort
    jmodel, params, pmodel = _pair()
    key = jax.random.PRNGKey(7)
    x0, cond = jnp.asarray(data), jnp.asarray(conditions)
    new_params, jhist = jax_finetune(jmodel, params, x0, cond, key, steps=steps, **SETTINGS)
    pmodel.denoiser.train()  # the fine-tuning must run it in eval mode and restore this
    phist = sample_path_finetune(
        pmodel, torch.from_numpy(data), torch.from_numpy(conditions),
        torch.Generator().manual_seed(0), steps=steps,
        draws=_draws(key, steps, data.shape[0], data.shape[1]), **SETTINGS)
    assert pmodel.denoiser.training
    return jmodel, params, new_params, jhist, pmodel, phist


def test_one_step_matches_jax(cohort):
    """One step: loss, co-occurrence and anchor within rtol 1e-5; every
    parameter within 2e-6 of the JAX step's, except where |grad| < GRAD_FLOOR.
    Adam's first step moves a parameter by lr * g / (|g| + 1e-8), so where
    rounding moves g by a share of itself the update moves by up to 2 lr.
    Through the chain (four denoiser passes, the soft bits' 1/tau) the two
    libraries' f32 gradients differ by up to 1.1e-5 absolute at max |g|
    0.89 (measured on these weights), ten times PR 8's single-loss step:
    so GRAD_FLOOR is 1e-4, those parameters are held to 2 lr, and all but
    1e-3 of all parameters must still be within 2e-6."""
    data, conditions = cohort
    jmodel, params, new_params, jhist, pmodel, phist = _run_both(cohort, 1)
    assert set(phist) == {"loss", "cooccurrence", "anchor"}
    for name in phist:
        assert len(phist[name]) == 1
        assert phist[name][0] == pytest.approx(jhist[name][0], rel=LOSS_RTOL), name
    assert phist["cooccurrence"][0] > 0 and phist["anchor"][0] > 0

    grads = _port_grads(data, conditions, _draws(jax.random.PRNGKey(7), 1, *data.shape)[0])
    sensitive = {k: np.abs(v.numpy()) < GRAD_FLOOR for k, v in grads.items()}
    want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, new_params))
    before = flax_params_to_state_dict(params)
    got = pmodel.denoiser.state_dict()
    moved = 0
    wide = total = 0
    for name, value in want.items():
        diff = np.abs(got[name].numpy() - value.numpy())
        ok = (diff <= 2e-6) | (sensitive[name] & (diff <= 2 * LR))
        assert ok.all(), f"{name}: max |diff| {diff.max():.3e}"
        moved += int((np.abs(value.numpy() - before[name].numpy()) > 1e-4).sum())
        wide += int((diff > 2e-6).sum())
        total += diff.size
    assert wide / total < 1e-3 and moved > total // 2  # Adam moved most weights by ~lr


def test_three_steps_histories_match_jax(cohort):
    """Three steps: the histories (steps 0 and 2), step 0 within rtol 1e-5
    and step 2 within rtol 1e-3: by then the few parameters whose first
    update rounding may move by up to 2 lr (the one-step test) have moved
    the soft co-occurrence by 1e-4 of itself (measured)."""
    *_, jhist, _, phist = _run_both(cohort, 3)
    for name in phist:
        assert len(phist[name]) == len(jhist[name]) == 2
        assert phist[name][0] == pytest.approx(jhist[name][0], rel=LOSS_RTOL), name
        assert phist[name][1] == pytest.approx(jhist[name][1], rel=1e-3), name


def test_refuses_the_discrete_head(cohort):
    data, conditions = cohort
    _, _, pmodel = make_pair(num_steps=T, compute_dtype="float32", discrete=True)
    with pytest.raises(ValueError, match="discrete"):
        sample_path_finetune(pmodel, torch.from_numpy(data), torch.from_numpy(conditions),
                             torch.Generator().manual_seed(0), steps=1, **SETTINGS)


def test_mutation_dim_falls_back_to_the_spec(cohort):
    """A model without ``mutation_dim`` takes the constraint spec's (and the
    same step follows); one with neither raises."""
    data, conditions = cohort
    x0, cond = torch.from_numpy(data), torch.from_numpy(conditions)
    draws = _draws(jax.random.PRNGKey(3), 1, *data.shape)
    hists = []
    for fallback in (False, True):
        _, _, pmodel = _pair()
        if fallback:
            pmodel.mutation_dim = 0
            pmodel.constraint_spec = pcons.ConstraintSpec(10, 40, 14)
        hists.append(sample_path_finetune(pmodel, x0, cond, None, steps=1, draws=draws,
                                          **SETTINGS))
    assert hists[0] == hists[1]
    _, _, pmodel = _pair()
    pmodel.mutation_dim = 0
    with pytest.raises(ValueError, match="mutation_dim"):
        sample_path_finetune(pmodel, x0, cond, None, steps=1, draws=draws, **SETTINGS)


# ----------------------------------------------------------------------
# The CLI's STEP 4b
# ----------------------------------------------------------------------
def _cli_config(tmp_path, **model):
    write_processed(make_dummy_cohort(40, 12, 64, 6), tmp_path / "processed")
    raw = {
        "data": {"processed_dir": str(tmp_path / "processed")},
        "model": {"hidden_dims": [32, 64, 32], "latent_dim": 16, "compute_dtype": "float32",
                  "diffusion": {"num_steps": 8}, **model},
        "training": {"save_dir": str(tmp_path / "ckpt"), "num_epochs": 2, "batch_size": 8,
                     "sample_path_finetune": {"enabled": True, "steps": 2,
                                              "sample_batch": 16}},
        "output": {"results_dir": str(tmp_path / "results")},
    }
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    return Config.from_yaml(path)


def test_cli_finetune_backs_up_best_and_anchors_on_train_rows(tmp_path, monkeypatch):
    """JAX tests/test_finetune.py:130: the best model is kept as
    best_model_prefinetune, the anchor covers the 32 training rows (not
    the 40), and best_model.npz holds the fine-tuned weights."""
    cfg = _cli_config(tmp_path)
    seen = {}

    def spy(model, data, cond, *args, **kwargs):
        seen["n_anchor"] = data.shape[0]
        seen["generator"] = args[0]
        return sample_path_finetune(model, data, cond, *args, **kwargs)

    monkeypatch.setattr(cli, "sample_path_finetune", spy)
    history = cli.train_model(cfg, device="cpu")
    assert seen["n_anchor"] == 32
    assert seen["generator"].initial_seed() == cfg.training.random_seed + 77
    before = ckpt.load_weights(tmp_path / "ckpt", "best_model_prefinetune")
    after = ckpt.load_weights(tmp_path / "ckpt")
    assert set(before) == set(after)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert [len(v) for v in history.finetune.values()] == [2, 2, 2]
    assert np.isfinite(history.finetune["loss"]).all()


@pytest.mark.parametrize("model", [
    {"architecture": "cvae"},
    {"architecture": "flow"},
    {"diffusion": {"num_steps": 8, "discrete_mutation_head": True}},
    {"diffusion": {"num_steps": 8, "latent_factor_dim": 2}},
    {"diffusion": {"num_steps": 8, "ar_mutation_head": True}},
], ids=["cvae", "flow", "d3pm", "latent", "ar"])
def test_cli_skips_finetune_where_jax_does(tmp_path, caplog, model):
    """Every ``finetune_skip_reason``: the JAX CLI's warning, no backup, no
    fine-tuning."""
    cfg = _cli_config(tmp_path, **model)
    with caplog.at_level(logging.WARNING, logger="osteosarcoma_diffusionmodel_torch.cli"):
        history = cli.train_model(cfg, device="cpu")
    assert history.finetune is None
    assert any("sample_path_finetune" in r.getMessage() and "skipping" in r.getMessage()
               for r in caplog.records)
    assert not (tmp_path / "ckpt" / "best_model_prefinetune.npz").exists()
