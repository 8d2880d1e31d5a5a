"""Import guard: the PyTorch port never loads JAX, Flax, pandas, PyYAML,
matplotlib or requests.

The card's machine has PyTorch, numpy and scipy but no JAX and no
promise of pandas, PyYAML, matplotlib or requests. A fresh interpreter (without the test
suite's JAX environment) imports every module of the port and
``chip_smoke.py``, runs a tiny CPU generate and a one-epoch CPU train
through the trainer and its checkpoints, and must not have any of them
in ``sys.modules``. The kernel modules import without nvcc and
without Triton: the kernels build at first launch, never at import.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np, torch
import osteosarcoma_diffusionmodel_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
walked = {"analysis", "analysis.embedding", "analysis.report", "analysis.survival",
          "models.gnn", "utils.profiling", "parallel", "parallel.batch", "parallel.mesh",
          "parallel.dryrun"}
assert walked <= {n[len(pkg.__name__) + 1:] for n in names}, names
import chip_smoke

from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
from osteosarcoma_diffusionmodel_torch.ops import _build

cfg = Config()
cfg.model.hidden_dims = [64, 128, 64]
cfg.model.latent_dim = 16
cfg.model.diffusion.num_steps = 5
dims = cfg.freeze_dims(6, 20, 6, ["a", "b", "c"])
model = ConditionalDiffusion.from_config(cfg, dims)
init_weights(model.denoiser, torch.Generator().manual_seed(0))
out = SyntheticPatientGenerator(model, cfg, dims, device="cpu").generate(8, {"survival_time": 500})
assert out["expression"].shape == (8, 20) and np.isfinite(out["expression"]).all()

import tempfile
from pathlib import Path
from osteosarcoma_diffusionmodel_torch.cli import build_constraint_spec
from osteosarcoma_diffusionmodel_torch.data.dataset import prepare_arrays
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort, write_processed
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer
with tempfile.TemporaryDirectory() as tmp:
    write_processed(make_dummy_cohort(24, 6, 20, 6), Path(tmp) / "processed")
    cfg.data.processed_dir = str(Path(tmp) / "processed")
    cfg.training.save_dir = str(Path(tmp) / "ckpt")
    cfg.training.num_epochs = 1
    cfg.training.save_frequency = 1
    arrays, tdims = prepare_arrays(cfg)
    model = ConditionalDiffusion.from_config(cfg, tdims, build_constraint_spec(cfg, arrays))
    log = Trainer(model, arrays, tdims, cfg, "cpu").train()
    assert len(log.train_loss) == 1 and np.isfinite(log.train_loss).all()
    assert (Path(tmp) / "ckpt" / "checkpoint_epoch_0" / "optimizer.npz").exists()
assert _build.LIBRARY._lib is None  # nothing was built or loaded
bad = sorted(m for m in ("jax", "flax", "pandas", "yaml", "triton", "requests", "matplotlib",
                         "osteosarcoma_diffusionmodel_tpu") if m in sys.modules)
assert not bad, bad
print("modules", len(names))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_pandas_or_yaml():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20  # every module was walked


@pytest.mark.parametrize("module", [
    "osteosarcoma_diffusionmodel_torch.ops.copula_device",
    "osteosarcoma_diffusionmodel_torch.serving.monitoring",
    "osteosarcoma_diffusionmodel_torch.serving.server",
    "osteosarcoma_diffusionmodel_torch.data.gdc_loader",
    "osteosarcoma_diffusionmodel_torch.data.preprocessor",
    "osteosarcoma_diffusionmodel_torch.analysis.report",
    "osteosarcoma_diffusionmodel_torch.models.gnn",
    "osteosarcoma_diffusionmodel_torch.utils.profiling",
    "osteosarcoma_diffusionmodel_torch.parallel.batch",
    "osteosarcoma_diffusionmodel_torch.parallel.mesh",
    "osteosarcoma_diffusionmodel_torch.parallel.dryrun",
])
def test_calibration_and_serving_modules_import_no_jax(module):
    """The device calibration, the serving modules, the GDC loader, the
    preprocessor, the report, the GAT encoder, the profiling module and the
    multi-device layer (``parallel/``), each imported alone in a fresh
    interpreter: no JAX, Flax, pandas,
    PyYAML (yaml only lazily, inside ``Config.from_yaml``), matplotlib
    (only inside the report's ``_matplotlib``) or requests, nothing of the
    JAX package."""
    script = (f"import sys, importlib; importlib.import_module({module!r}); "
              "bad = sorted(m for m in ('jax', 'flax', 'pandas', 'yaml', 'requests', "
              "'matplotlib', 'osteosarcoma_diffusionmodel_tpu') if m in sys.modules); "
              "assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


@pytest.mark.parametrize("scripts", [
    ("demo_full_scale_torch",), ("demo_held_out_torch",), ("replay_calibration_torch",),
    ("production_run_torch",), ("replay_ar_torch", "profile_ar_torch", "replay_lowrank_torch")],
    ids="+".join)
def test_quality_scripts_import_no_jax_or_pandas(scripts):
    """The port's quality scripts, each loaded alone in a fresh
    interpreter, and its three research scripts loaded together in one: no
    JAX, Flax, Optax, Orbax, pandas, PyYAML or matplotlib at module level,
    nothing of the JAX package."""
    load = "".join(f"spec = importlib.util.spec_from_file_location('s{i}', 'scripts/{name}.py'); "
                   "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
                   for i, name in enumerate(scripts))
    code = ("import importlib.util, sys; " + load +
            "bad = sorted(m for m in ('jax', 'flax', 'optax', 'orbax', 'pandas', 'yaml', "
            "'matplotlib', 'osteosarcoma_diffusionmodel_tpu') if m in sys.modules); "
            "assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(where, tmp_path):
    """No CUDA device here: chip_smoke.py exits non-zero and prints no
    result line, both in the repo and as a lone copy of the script."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = REPO
    env = _clean_env()
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
