"""The port's (data, model) mesh on torch.distributed against the JAX
package's parallel/mesh.py, and its multi-device dry run.

One world of 4 gloo ranks on the CPU (tests/torch_dist.py ``mesh_world``,
spawned once for the module) checks the mesh rules (shapes and the JAX
ValueErrors, as tests/test_sharding.py:42-50 and test_mesh_utils.py),
the row split, the global batch's mean and gradient, the tensor-parallel
parameter choice against JAX's ``denoiser_param_sharding`` on the same
weights (tests/test_sharding.py:88-119), and one train step over a (2, 2)
mesh (batch over ``data``, the denoiser column-parallel over ``model``)
against the same step on one device. The dry run runs as JAX's runs in
``test_graft_dryrun_driver_path``: ``dryrun_multichip(4)`` from a fresh
interpreter.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.parallel.mesh import (
    MODEL_AXIS,
    make_mesh as jax_make_mesh,
)
from osteosarcoma_diffusionmodel_tpu.parallel.mesh import (
    denoiser_param_sharding as jax_param_sharding,
)
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.parallel import initialize_distributed
from osteosarcoma_diffusionmodel_torch.parallel.dryrun import (
    DRYRUN_DIMS,
    DRYRUN_HIDDEN,
    DRYRUN_STEPS,
    flagship,
)
from torch_dist import REPO, results, spawn

WORLD = 4
# The (2, 2) step against one device (f32 products): the batch's sums and
# the gradient's over 2 ranks in another order, the clip's norm from shard
# sums. AdamW's first step moves a parameter by lr * g / (|g| + 1e-8), so
# rounding in a gradient near 0 moves it by up to 2 lr; the others must
# agree within 2e-6, all but 1e-3 of them (the bounds of
# tests/test_torch_train.py's step against the JAX trainer's).
TP_LOSS_RTOL = 1e-5
TP_LR = 1e-4
TP_PARAM_ATOL = 2e-6
TP_WIDE_SHARE = 1e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 4-rank world once; (per-rank results, the inputs)."""
    work = tmp_path_factory.mktemp("mesh_world")
    _, _, model = flagship(compute_dtype="float32")
    rng = np.random.default_rng(0)
    inputs = {
        "tp_model": model,
        "x": torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)),
        "x0": torch.from_numpy(rng.standard_normal((16, sum(DRYRUN_DIMS))).astype(np.float32)),
        "cond": torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32)),
    }
    torch.save(inputs, work / "inputs.pt")
    spawn("mesh_world", WORLD, work, timeout=180)
    return results(work, WORLD), inputs


def test_make_mesh_shapes(world):
    out, _ = world
    for r, res in enumerate(out):
        assert res["m4"][:2] == ((4, 1), ("data", "model"))
        assert res["m4"][2] == (r, 0)
        assert res["m22"][:2] == ((2, 2), ("data", "model"))
        assert res["m22"][2] == (r // 2, r % 2)
        assert res["all"][0] == (4, 1)
        assert res["m2"][0] == (2, 1)
        assert res["m2"][2] == ((r, 0) if r < 2 else None)  # the first two ranks


def test_make_mesh_errors_are_jax(world):
    """The JAX package's ValueError texts (mesh.py:60-82)."""
    with pytest.raises(ValueError) as too_many:
        jax_make_mesh(16)
    with pytest.raises(ValueError) as indivisible:
        jax_make_mesh(3, model_parallel=2)
    for res in world[0]:
        assert res["too_many"] == "requested a 8-device mesh but only 4 devices are visible"
        assert str(too_many.value).startswith("requested a 16-device mesh but only")
        assert res["indivisible"] == str(indivisible.value) == (
            "3 devices not divisible by model_parallel=2")


def test_shard_batch_padding_and_placements(world):
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    for r, res in enumerate(world[0]):
        assert torch.equal(res["shard8"], x[2 * r: 2 * r + 2])  # contiguous rows
        assert res["shard10"] == (10, 3)  # 10 % 4: replicated, as JAX requires even shards
        assert res["shard_pair"] == [(4, 3), (4, 1)]  # (2, 2): 2 data ranks
        assert res["pad"] == (5248, 128, 8)
        assert [repr(p) for p in res["placements"][0]] == ["Shard(dim=0)", "Replicate()"]
        assert [repr(p) for p in res["placements"][1]] == ["Replicate()", "Replicate()"]


def test_global_batch_mean_and_gradient(world):
    """A shard's mean over its rows is the global batch's on every rank; the
    rows' gradients of (loss / world), summed over the ranks, are the
    global loss's gradient (f32, rtol 1e-6)."""
    out, inputs = world
    x = inputs["x"]
    for r, res in enumerate(out):
        mean, loss, grad, shape = res["global"]
        assert shape == (2, 3)
        torch.testing.assert_close(mean, x.mean(0), rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(loss, (x * x).mean(), rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(grad, 2 * x / x.numel(), rtol=1e-6, atol=1e-7)
        assert res["replicated"]  # 10 rows over 4 ranks: the whole batch, no collective


def _jax_sharded_names():
    """The torch names of the parameters JAX's rule shards over a
    model-parallel axis of 2, on the dry run's model."""
    config = JaxConfig()
    config.model.hidden_dims = list(DRYRUN_HIDDEN)
    config.model.diffusion.num_steps = DRYRUN_STEPS
    config.model.constraints.enabled = False
    dims = config.freeze_dims(*DRYRUN_DIMS, ["a", "b", "c"])
    params = JaxDiffusion.from_config(config, dims).init_params(jax.random.PRNGKey(0), 3)
    specs = jax_param_sharding(jax_make_mesh(8, model_parallel=2), params)
    marks = jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, float(MODEL_AXIS in tuple(s.spec)), np.float32),
        params, specs)
    state = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, marks))
    return {k for k, v in state.items() if bool(v.all())}, set(state)


def test_param_sharding_matches_jax(world):
    """The port's rule shards the parameters JAX's does on the same model;
    a Linear's shard is over its output features (axis 0 of the torch
    weight); a model axis of 1 and narrow layers shard nothing."""
    want, names = _jax_sharded_names()
    for res in world[0]:
        got = {k for k, v in res["sharding"].items() if v.startswith("Shard")}
        assert set(res["sharding"]) == names
        assert got == want and len(got) > 0
        assert res["sharding"]["input_proj.weight"] == "Shard(dim=0)"
        assert res["sharding"]["skip_gain.weight"] == "Replicate()"
        assert res["sharding_m4"] == {"Replicate()"}
        assert set(res["small"].values()) == {"Replicate()"}


def test_tensor_parallel_step_matches_one_device(world):
    """One train step over the (2, 2) mesh (the denoiser's wide Linears
    column-parallel, the batch over 2 data ranks, clip 1.0, AdamW 1e-4 /
    1e-5) against the step on one device: the loss within rtol 1e-5, every
    gathered parameter within 2 lr, all but 1e-3 of them within 2e-6."""
    for res in world[0]:
        loss_ref, loss_tp, diffs, plain_linears = res["tp"]
        assert np.isfinite(loss_ref)
        assert loss_tp == pytest.approx(loss_ref, rel=TP_LOSS_RTOL)
        worst = max(diffs.items(), key=lambda kv: kv[1][0])
        assert worst[1][0] <= 2 * TP_LR, worst
        wide = sum(n for _, n, _ in diffs.values())
        assert wide / sum(size for _, _, size in diffs.values()) < TP_WIDE_SHARE, wide
        assert plain_linears < 15  # the wide Linears were swapped for column-parallel ones


def test_initialize_distributed_noop(monkeypatch):
    """No coordinator in the arguments or the environment: a silent no-op."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_from_a_fresh_process():
    """``dryrun_multichip(4)`` from a fresh interpreter with no card: it
    spawns 4 gloo ranks, one train step over the (2, 2) mesh and a
    sharded sample, finite loss, rc 0."""
    code = ("from osteosarcoma_diffusionmodel_torch.parallel.dryrun import dryrun_multichip\n"
            "out, seconds = dryrun_multichip(4, timeout_s=240)\n"
            "print(out, end='')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "4 ranks on cpu (gloo), mesh {'data': 2, 'model': 2}" in proc.stdout
    assert "sharded sample (16, 54)" in proc.stdout


def test_dryrun_reports_the_failing_rank(tmp_path, monkeypatch):
    """A rank that fails stops the others and raises with its stderr tail."""
    from osteosarcoma_diffusionmodel_torch.parallel import dryrun

    monkeypatch.setattr(dryrun, "REPO", Path(tmp_path))  # no package there: every rank fails
    monkeypatch.setenv("PYTHONPATH", "")
    with pytest.raises(RuntimeError, match=r"multi-device dry run rank \d failed") as info:
        dryrun.dryrun_multichip(2, timeout_s=60, device="cpu")
    assert "No module named 'osteosarcoma_diffusionmodel_torch'" in str(info.value)
