"""The cVAE and the flow through the port's entry points, on the CPU at
tiny widths (data 10/40/14, hidden 32/64/32, latent 8).

For each architecture: the CLI's ``train generate validate`` with
``--device cpu`` (``best_model.npz`` with the cVAE's BatchNorm statistics,
``--resume`` from the periodic checkpoint), the generator's route
(``SAMPLERS``: "cvae" or "plain", and no sampler kernel wrapper called),
one ``/generate`` of the server on 127.0.0.1 with a per-request sampler
(ignored by these families, as in the JAX server), and a JAX checkpoint
exported by ``scripts/export_jax_checkpoint.py`` and sampled by the port
with z injected, against the JAX module on the same z (f32, 1e-5).
"""

import http.client
import importlib.util
import json
import math
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort, write_processed
from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module
from osteosarcoma_diffusionmodel_torch.generation.generator import (
    SyntheticPatientGenerator,
    load_trained_model,
    seeded_generator,
)
from osteosarcoma_diffusionmodel_torch.serving.server import serve
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from torch_parity import TRAIN_DUMMY

ROUTES = {"cvae": "cvae", "flow": "plain"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def no_sampler_kernels(monkeypatch):
    """The kernel sampler and the scan loops must not be reached."""

    def refuse(*args, **kwargs):
        raise AssertionError("a diffusion sampler was called for a cVAE or flow model")

    monkeypatch.setattr(gen_module, "FusedSampler", refuse)
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    for name in ("scan_sample", "scan_sample_ddim", "sample", "sample_ddim"):
        monkeypatch.setattr(ConditionalDiffusion, name, refuse)


def _yaml(root: Path, arch: str, epochs: int = 3) -> Path:
    if not (root / "processed").exists():
        write_processed(make_dummy_cohort(**TRAIN_DUMMY), root / "processed")
    raw = {
        "data": {"processed_dir": str(root / "processed")},
        "model": {"architecture": arch, "hidden_dims": [32, 64, 32], "latent_dim": 8},
        "training": {"save_dir": str(root / "ckpt"), "num_epochs": epochs, "save_frequency": 2},
        "generation": {"num_synthetic_samples": 30, "sampler": "ancestral"},
        "output": {"results_dir": str(root / "results"),
                   "synthetic_data_dir": str(root / "synthetic")},
    }
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


@pytest.mark.parametrize("arch", ["cvae", "flow"])
def test_cli_train_generate_validate(arch, tmp_path, no_sampler_kernels):
    path = _yaml(tmp_path, arch)
    gen_module.SAMPLERS.clear()
    cli.main(["--config", str(path), "--steps", "train", "generate", "validate",
              "--device", "cpu"])
    assert dict(gen_module.SAMPLERS) == {ROUTES[arch]: 3}
    history = np.genfromtxt(tmp_path / "results" / "training_history.csv", delimiter=",",
                            names=True)
    assert history.shape == (3,) and np.isfinite(history["train_loss"]).all()
    assert np.isfinite(history["val_loss"]).all()
    meta = ckpt.load_metadata(tmp_path / "ckpt")
    assert meta["config"]["model"]["architecture"] == arch
    with np.load(tmp_path / "ckpt" / "best_model.npz") as f:
        keys = set(f.files)
    stats = {k for k in keys if k.startswith("batch_stats/")}
    if arch == "cvae":
        assert len(stats) == 12 and "batch_stats/decoder/bn_2/var" in stats
        assert "survival_head/fc2/kernel" in keys
    else:
        assert not stats and "coupling_5/out/kernel" in keys
    results = np.genfromtxt(tmp_path / "results" / "validation_results.csv", delimiter=",",
                            names=True)
    assert math.isfinite(float(results["overall_biological_score"]))
    assert math.isfinite(float(results["mmd"]))
    for scenario in ("typical_patient", "metastatic_poor_prognosis"):
        mut = np.genfromtxt(tmp_path / "synthetic" / scenario / f"{scenario}_mutations.csv",
                            delimiter=",", skip_header=1)
        expr = np.genfromtxt(tmp_path / "synthetic" / scenario / f"{scenario}_expression.csv",
                             delimiter=",", skip_header=1)
        assert mut.shape == (10, 10) and np.isin(mut, (0.0, 1.0)).all()
        assert expr.shape == (10, 40) and np.isfinite(expr).all()

    # --resume goes on from the latest checkpoint_epoch_<n>: the periodic one
    # of epoch 1, or epoch 2 where it was the best (the JAX trainer's
    # per-epoch loop writes one at each best epoch too), the cVAE's running
    # statistics restored with the weights.
    latest = ckpt.latest_epoch(tmp_path / "ckpt")
    assert latest in (1, 2) and ckpt.epoch_dir(tmp_path / "ckpt", 1).is_dir()
    weights, _, info = ckpt.load_training_state(ckpt.epoch_dir(tmp_path / "ckpt", latest))
    raw = yaml.safe_load(path.read_text())
    raw["training"]["num_epochs"] = 4
    path.write_text(yaml.safe_dump(raw))
    from osteosarcoma_diffusionmodel_torch.data.dataset import prepare_arrays
    from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model

    cfg = Config.from_yaml(path)
    arrays, dims = prepare_arrays(cfg)
    trainer = Trainer(build_model(cfg, dims), arrays, dims, cfg, "cpu")
    assert trainer.resume() and trainer.start_epoch == latest + 1 and info["epoch"] == latest
    for key, value in weights.items():
        assert torch.equal(trainer.module.state_dict()[key], value), key
    if arch == "cvae":
        assert "encoder.bn_0.mean" in weights and float(weights["encoder.bn_0.mean"].abs().max()) > 0
    cli.main(["--config", str(path), "--steps", "train", "--resume", "--device", "cpu"])
    history = np.genfromtxt(tmp_path / "results" / "training_history.csv", delimiter=",",
                            names=True)
    assert np.atleast_1d(history).shape == (3 - latest,)
    assert np.isfinite(history["train_loss"]).all()


@pytest.mark.parametrize("arch", ["cvae", "flow"])
def test_server_answers_generate(arch, tmp_path, no_sampler_kernels):
    """Warmup and one /generate (sampler "ddim" per request, which these
    families ignore) from the server on 127.0.0.1:0, on the CPU."""
    path = _yaml(tmp_path, arch, epochs=2)
    cli.main(["--config", str(path), "--steps", "train", "--device", "cpu"])
    gen_module.SAMPLERS.clear()
    server = serve(tmp_path / "ckpt", host="127.0.0.1", port=0, warmup=(4,), device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        body = {"num_samples": 5, "scenario": {"survival_time": 400}, "sampler": "ddim"}
        conn.request("POST", "/generate", body=json.dumps(body))
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 200, out
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
    finally:
        server.shutdown()
        server.server_close()
    assert health["architecture"] == arch
    assert np.asarray(out["mutations"]).shape == (5, 10)
    assert np.isfinite(np.asarray(out["expression"])).all()
    assert dict(gen_module.SAMPLERS) == {ROUTES[arch]: 2}  # the warmup and the request


def _exporter():
    script = Path(__file__).resolve().parent.parent / "scripts" / "export_jax_checkpoint.py"
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["cvae", "flow"])
def test_exported_jax_checkpoint_samples_as_jax(arch, tmp_path):
    """A JAX Orbax checkpoint (params and, for the cVAE, perturbed
    ``batch_stats``) through scripts/export_jax_checkpoint.py: the port
    loads it, its statistics equal the JAX ones, and its ``sample`` with z
    injected equals the JAX module's decode (cVAE) or inverse (flow) of
    that z, f32 within 1e-5."""
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_tpu.data.dataset import prepare_arrays
    from osteosarcoma_diffusionmodel_tpu.models.cvae import ConditionalVAEModule
    from osteosarcoma_diffusionmodel_tpu.models.flow import ConditionalRealNVP
    from osteosarcoma_diffusionmodel_tpu.training import checkpoint as jax_ckpt
    from osteosarcoma_diffusionmodel_tpu.training.trainer import build_model as jax_build

    write_processed(make_dummy_cohort(**TRAIN_DUMMY), tmp_path / "processed")
    jc = JaxConfig()
    jc.data.processed_dir = str(tmp_path / "processed")
    jc.model.architecture = arch
    jc.model.hidden_dims, jc.model.latent_dim = [32, 64, 32], 8
    jc.model.compute_dtype = "float32"
    arrays, dims = prepare_arrays(jc)
    jmodel = jax_build(jc, dims)
    rng = np.random.default_rng(9)
    orbax = tmp_path / "orbax"
    if arch == "cvae":
        variables = jax.tree_util.tree_map(
            np.asarray, jmodel.init_variables(jax.random.PRNGKey(1), dims.condition_dim))
        params, stats = variables["params"], jax.tree_util.tree_map(
            lambda a: (a + rng.uniform(0.2, 1.0, a.shape)).astype(np.float32),
            variables["batch_stats"])
    else:
        params = jax.tree_util.tree_map(
            np.asarray, jmodel.init_params(jax.random.PRNGKey(1), dims.condition_dim))
        params = jax.tree_util.tree_map(
            lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), params)
        stats = {}
    jax_ckpt.save_metadata(orbax, jc, dims)
    jax_ckpt.save_data_stats(orbax, arrays)
    jax_ckpt.CheckpointManager(orbax).save(
        "best_model", {"params": params, "batch_stats": stats, "epoch": 0}, wait=True)
    out = _exporter().export(orbax, tmp_path / "port")

    model, cfg, pdims = load_trained_model(out)
    assert cfg.model.architecture == arch and pdims.data_dim == dims.data_dim
    if arch == "cvae":
        np.testing.assert_array_equal(model.module.encoder.bn_1.var.numpy(),
                                      stats["encoder"]["bn_1"]["var"])
    n = 12
    cond = rng.standard_normal((n, dims.condition_dim)).astype(np.float32)
    width = 8 if arch == "cvae" else dims.data_dim
    z = rng.standard_normal((n, width)).astype(np.float32)
    if arch == "cvae":
        want = jmodel.module.apply({"params": params, "batch_stats": stats}, jnp.asarray(z),
                                   jnp.asarray(cond), method=ConditionalVAEModule.decode)
    else:
        want = jmodel.module.apply({"params": params}, jnp.asarray(z), jnp.asarray(cond),
                                   method=ConditionalRealNVP.inverse)
    got = model.sample(torch.from_numpy(cond), z=torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    gen = SyntheticPatientGenerator(model, cfg, pdims, data_stats=ckpt.load_data_stats(out),
                                    device="cpu")
    cohort = gen.generate(6, {"survival_time": 900}, seeded_generator(1))
    assert cohort["expression"].shape == (6, 40) and np.isfinite(cohort["expression"]).all()
