"""The port's research scripts against the JAX scripts they stand for, on
the CPU at tiny sizes.

- scripts/replay_ar_torch.py against scripts/replay_ar.py (loaded as a
  module; the port never imports it) on the same numpy inputs: M = 62 as
  both fix it, 24 rows, a 17-column context. The logits, the loss and its
  gradient within 1e-5; 200 full-batch Adam steps from the JAX init within
  1e-4; the sequential draw bit-equal given the JAX keys' uniforms
  (``jax.random.bernoulli(k, p)`` is ``uniform(k) < p``); the validator's
  pair sample equal, the chi-square pattern correlation within 1e-5 (f32
  against the port's f64); the record's keys those of REPLAY_AR.json and
  REPLAY_AR_SEEDS.json plus ``device``.
- scripts/replay_lowrank_torch.py: one covariance-only Adam step from the
  same weights (the port's seeded init, carried to Flax by convert.py) with the JAX key's draws (t, noise) passed to the
  port's loss: the loss within 1e-5 relative, every parameter within 1e-6
  (the frozen ones unchanged); the replay end to end on a seeded
  checkpoint of a small model.
- scripts/profile_ar_torch.py at PROFILE_EPOCHS=2 PROFILE_BLOCK=1
  PROFILE_EXPR=40 PROFILE_GEN=32 (and PROFILE_N=40) on a T = 20 model
  writes every key of PROFILE_AR.json (the train keys named by the block).
- Without a card and without ``--device cpu``, each script raises.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort, write_processed
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.networks import init_flax
from osteosarcoma_diffusionmodel_torch.utils.card import seeded_checkpoint
from torch_parity import CONDITIONS, DATA_DIMS, _configure, perturb_heads

REPO = Path(__file__).resolve().parent.parent
ROWS, CTX = 24, 17


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield {n: _script(n) for n in ("replay_ar", "replay_ar_torch", "replay_lowrank_torch",
                                   "profile_ar_torch")}
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def inputs():
    """Bits, contexts (a train and a validation split) and JAX init params
    with the context's output layer perturbed, so every path carries
    signal."""
    rng = np.random.default_rng(5)
    bits = (rng.random((ROWS + 8, 62)) < rng.uniform(0.1, 0.6, 62)).astype(np.float32)
    ctx = rng.standard_normal((ROWS + 8, CTX)).astype(np.float32)
    jax_script = _script("replay_ar")
    params = {k: np.asarray(v) for k, v in jax_script.init_params(
        jax.random.PRNGKey(0), CTX).items()}
    params["c2"] = (0.3 * rng.standard_normal(params["c2"].shape)).astype(np.float32)
    params["c2b"] = (0.2 * rng.standard_normal(62)).astype(np.float32)
    params["b"] = (0.5 * rng.standard_normal(62)).astype(np.float32)
    return bits, ctx, params


def _torch(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def test_ar_logits_loss_and_gradient_match_jax(scripts, inputs):
    jx, pt = scripts["replay_ar"], scripts["replay_ar_torch"]
    bits, ctx, params = inputs
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_logits = np.asarray(jx.ar_logits(jp, jnp.asarray(bits), jnp.asarray(ctx)))
    tp = {k: v.requires_grad_(True) for k, v in _torch(params).items()}
    got_logits = pt.ar_logits(tp, torch.from_numpy(bits), torch.from_numpy(ctx))
    np.testing.assert_allclose(got_logits.detach().numpy(), want_logits, rtol=1e-5, atol=1e-5)
    (want_total, want_ce), want_grad = jax.value_and_grad(
        lambda p: jx.ce_loss(p, jnp.asarray(bits), jnp.asarray(ctx), 1e-3, 1e-2),
        has_aux=True)(jp)
    total, ce = pt.ce_loss(tp, torch.from_numpy(bits), torch.from_numpy(ctx), 1e-3, 1e-2)
    total.backward()
    total = total.detach()
    assert float(total) == pytest.approx(float(want_total), rel=1e-5)
    assert float(ce.detach()) == pytest.approx(float(want_ce), rel=1e-5)
    for name, g in want_grad.items():
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_fit_matches_jax_after_200_steps(scripts, inputs):
    """200 full-batch Adam steps at 1e-2, no mixup, from the same init."""
    jx, pt = scripts["replay_ar"], scripts["replay_ar_torch"]
    bits, ctx, _ = inputs
    tr, va = slice(0, ROWS), slice(ROWS, None)
    want, want_tr, want_va = jx.fit(jnp.asarray(bits[tr]), jnp.asarray(ctx[tr]),
                                    jnp.asarray(bits[va]), jnp.asarray(ctx[va]), 1e-3, 1e-2,
                                    steps=200, seed=0)
    init = {k: np.asarray(v) for k, v in jx.init_params(jax.random.PRNGKey(0), CTX).items()}
    t = torch.from_numpy
    got, got_tr, got_va = pt.fit(t(bits[tr]), t(ctx[tr]), t(bits[va]), t(ctx[va]), 1e-3, 1e-2,
                                 steps=200, params=_torch(init))
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert got_tr == pytest.approx(want_tr, rel=1e-4)
    assert got_va == pytest.approx(want_va, rel=1e-4)


def test_fit_draws_mixup_and_minibatches(scripts, inputs):
    """The trainer-faithful setting (mixup 0.2, 16 rows a step) runs, its
    draws come from the chunk's seeds alone (the same for any fit seed
    given the same init), and it moves the parameters elsewhere than the
    full batch does."""
    pt = scripts["replay_ar_torch"]
    bits, ctx, params = inputs
    t = torch.from_numpy
    args = (t(bits[:ROWS]), t(ctx[:ROWS]), t(bits[ROWS:]), t(ctx[ROWS:]), 1e-5, 1e-2)
    a = pt.fit(*args, steps=100, mixup_alpha=0.2, batch=16, seed=0, params=_torch(params))[0]
    b = pt.fit(*args, steps=100, mixup_alpha=0.2, batch=16, seed=3, params=_torch(params))[0]
    full = pt.fit(*args, steps=100, params=_torch(params))[0]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.allclose(a["W"], full["W"], atol=1e-3)


def test_sample_is_bit_equal_given_the_jax_uniforms(scripts, inputs):
    jx, pt = scripts["replay_ar"], scripts["replay_ar_torch"]
    rng = np.random.default_rng(9)
    _, _, params = inputs
    params = dict(params, W=(0.8 * rng.standard_normal((62, 62))).astype(np.float32))
    ctx = rng.standard_normal((256, CTX)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jx.sample({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(ctx), key)
    keys = jax.random.split(key, 62)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (256,), jnp.float32)) for k in keys],
                        axis=1)
    got = pt.sample(_torch(params), torch.from_numpy(ctx), uniforms=torch.from_numpy(uniforms))
    assert 0.2 < want.mean() < 0.8
    np.testing.assert_array_equal(got, want)


def test_pairs_and_chi2_corr_match_jax(scripts):
    jx, pt = scripts["replay_ar"], scripts["replay_ar_torch"]
    for n_genes in (62, 30):
        want, got = jx.validator_pairs(n_genes), pt.validator_pairs(n_genes)
        for w, g in zip(want, got):
            assert g.tolist() == np.asarray(w).tolist()
    pi, pj = pt.validator_pairs(62)
    rng = np.random.default_rng(4)
    real = (rng.random((40, 62)) < 0.3).astype(np.float32)
    synth = (rng.random((300, 62)) < 0.3).astype(np.float32)
    synth[:, 1] = synth[:, 0]  # some structure to correlate
    want = jx.chi2_corr(real, synth, *jx.validator_pairs(62))
    assert pt.chi2_corr(real, synth, pi, pj) == pytest.approx(want, abs=1e-5)
    assert pt.freq_corr(real, synth) == jx.freq_corr(real, synth)


@pytest.mark.parametrize("mode,record", [("cells", "REPLAY_AR.json"),
                                         ("seeds", "REPLAY_AR_SEEDS.json")])
def test_replay_ar_record_has_the_jax_keys(scripts, mode, record):
    """The study end to end at 24 patients, 40 expression genes, 100 steps
    a fit: the JAX record's keys plus ``device``; the baselines are the
    numpy draws both scripts make."""
    env = ({"AR_L2": "1e-5", "AR_CTX_L2": "0,1e-2"} if mode == "cells"
           else {"AR_SEEDS": "0,1"})
    out = scripts["replay_ar_torch"].run("cpu", n=24, env=env, dims=(62, 40, 14), steps=100)
    ref = json.loads((REPO / record).read_text())
    assert set(out) == set(ref) | {"device", "elapsed_sec"}
    assert out["train_rows"] == 20 and out["device"]["platform"] == "cpu"
    if mode == "cells":
        assert set(out["cells"]) == {"pathways/l2=1e-05/ctx_l2=0",
                                     "pathways/l2=1e-05/ctx_l2=0.01", "none/l2=1e-05/ctx_l2=0"}
        assert set(out["joint_condition_ablation"]) == set(ref["joint_condition_ablation"])
        for cell in out["cells"].values():
            assert set(cell) == {"train_ce", "val_ce", "chi2_corr", "freq_corr"}
    else:
        assert out["seed_sweep"]["seeds"] == [0, 1]
        assert set(out["seed_sweep"]) == set(ref["seed_sweep"])
    assert out["bootstrap_real_chi2_corr"] > 0.9 and abs(out["independent_chi2_corr"]) < 0.2


# ----------------------------------------------------------------------
# Low-rank replay
# ----------------------------------------------------------------------
LOWRANK = {"model.diffusion.low_rank_sigma_dim": 8,
           "model.diffusion.low_rank_sigma_scope": "mutations"}


def test_lowrank_fit_step_matches_jax(scripts):
    """The JAX script's step (optax.multi_transform: Adam 3e-2 on the
    lowrank parameters, set_to_zero elsewhere) against ``fit_step`` on the
    converted weights, the loss's t and noise from the JAX key."""
    pt = scripts["replay_lowrank_torch"]
    jc = _configure(JaxConfig(), 20, "float32", overrides=LOWRANK)
    pc = _configure(Config(), 20, "float32", overrides=LOWRANK)
    jmodel = JaxDiffusion.from_config(jc, jc.freeze_dims(*DATA_DIMS, CONDITIONS))
    pmodel = ConditionalDiffusion.from_config(pc, pc.freeze_dims(*DATA_DIMS, CONDITIONS))
    init_flax(pmodel.denoiser, torch.Generator().manual_seed(0))
    params = perturb_heads(state_dict_to_flax_params(pmodel.denoiser.state_dict()))
    pmodel.denoiser.load_state_dict(flax_params_to_state_dict(params))
    dims = pmodel.denoiser.data_dim
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((16, dims)).astype(np.float32)
    x0[:, :10] = (x0[:, :10] > 0).astype(np.float32)
    cond = rng.standard_normal((16, 3)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    labels = jax.tree_util.tree_map_with_path(
        lambda p, _: "cov" if "lowrank" in str(p[0]) else "frozen", jparams)
    opt = optax.multi_transform({"cov": optax.adam(3e-2), "frozen": optax.set_to_zero()}, labels)
    key = jax.random.PRNGKey(4)

    def lf(pp):
        _, m = jmodel.loss(pp, jnp.asarray(x0), jnp.asarray(cond), key, deterministic=True)
        return m["lowrank_sigma_nll"] * dims

    want_loss, grads = jax.jit(jax.value_and_grad(lf))(jparams)
    updates, _ = opt.update(grads, opt.init(jparams))
    want = flax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jparams, updates)))
    t_rng, noise_rng = jax.random.split(key, 5)[:2]
    draws = {"t": torch.from_numpy(np.array(jax.random.randint(t_rng, (16,), 0, 20))),
             "noise": torch.from_numpy(np.array(jax.random.normal(noise_rng, (16, dims))))}
    before = {k: v.clone() for k, v in pmodel.denoiser.state_dict().items()}
    got_loss = pt.fit_step(pmodel, pt.covariance_optimizer(pmodel), torch.from_numpy(x0),
                           torch.from_numpy(cond), dims, **draws)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    got = pmodel.denoiser.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        if not name.startswith("lowrank"):
            assert torch.equal(got[name], before[name]), name
    assert not torch.equal(got["lowrank_U"], before["lowrank_U"])


def _small(cfg):
    cfg.model.hidden_dims = [128, 256, 128]
    cfg.model.latent_dim = 32
    cfg.model.diffusion.num_steps = 20
    return cfg


def test_lowrank_replay_end_to_end(scripts, tmp_path, monkeypatch, capsys):
    """The replay on a work directory with the demo's layout (processed
    tables, ``ckpt/best_model.npz`` of a small low-rank model with T = 20,
    s(t) read at steps of that schedule): the JAX script's lines, the
    JSON's numbers finite."""
    pt = scripts["replay_lowrank_torch"]
    monkeypatch.setattr(pt, "S_STEPS", (0, 10, 19))
    monkeypatch.setattr(pt, "Config", lambda: _small(Config()))
    cohort = make_dummy_cohort(24, 10, 40, 14, seed=0)
    write_processed(cohort, tmp_path / "processed")
    cfg = _small(Config())
    cfg.model.diffusion.low_rank_sigma_dim = 8
    cfg.model.diffusion.low_rank_sigma_scope = "mutations"
    seeded_checkpoint(tmp_path / "ckpt", cfg, cohort)
    out = pt.replay(tmp_path, "cpu", steps=3, rows=30)
    printed = capsys.readouterr().out
    assert "step 0 nll" in printed and "U row-norm mean" in printed
    assert printed.count("co-occurrence pattern corr") == 4
    assert set(out["alphas"]) == {"1.0", "2.0", "4.0", "8.0"}
    assert all(np.isfinite(v) for a in out["alphas"].values() for v in a.values())
    assert list(out["s_t"]) == ["0", "10", "19"] and out["rows"] == 24


# ----------------------------------------------------------------------
# AR profile
# ----------------------------------------------------------------------
def test_profile_ar_writes_the_jax_keys(scripts, tmp_path, monkeypatch):
    pt = scripts["profile_ar_torch"]
    monkeypatch.setattr(pt, "Config", lambda: _small(Config()))
    monkeypatch.setattr(pt, "PER_EPOCH_EPOCHS", 2)
    for k, v in {"PROFILE_EPOCHS": "2", "PROFILE_BLOCK": "1", "PROFILE_EXPR": "40",
                 "PROFILE_GEN": "32", "PROFILE_N": "40"}.items():
        monkeypatch.setenv(k, v)
    assert pt.main(["--device", "cpu", "--out", str(tmp_path / "p.json")]) == 0
    out = json.loads((tmp_path / "p.json").read_text())
    ref = json.loads((REPO / "PROFILE_AR.json").read_text())
    renamed = {k.replace("block25", "block1"): v for k, v in ref.items()}
    assert set(out) == set(renamed) | {"device"}
    for key, value in renamed.items():
        if isinstance(value, dict):
            assert set(out[key]) == set(value) | ({"kernel_launches"} if key.startswith("gen_")
                                                  else set()), key
    assert out["platform"] == "cpu" and out["n_gen"] == 32 and out["block"] == 1
    assert out["gen_default"]["fused_engaged"] and out["gen_ar"]["fused_engaged"]
    assert out["gen_default"]["kernel_launches"] == {}  # CPU tensors take the plain versions
    assert out["train_ar_block1"]["epochs"] == 2
    assert out["train_default_block1"]["steady_sec_per_epoch"] is not None
    assert 0.0 < out["gen_ar"]["ar_bits_mean"] < 1.0


def test_scripts_refuse_without_a_card(scripts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("AR_SEEDS", raising=False)
    for name, argv in (("replay_ar_torch", []), ("profile_ar_torch", []),
                       ("replay_lowrank_torch", ["work"])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            scripts[name].main(argv)
