"""Import guard: the PyTorch port never loads JAX, Flax, pandas or PyYAML.

The card's machine has PyTorch, numpy and scipy but no JAX and no
promise of pandas or PyYAML. A fresh interpreter (without the test
suite's JAX environment) imports every module of the port and
``chip_smoke.py``, runs a tiny CPU generate, and must not have any of
them in ``sys.modules``. The kernel modules import without nvcc and
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
out = SyntheticPatientGenerator(model, cfg, dims).generate(8, {"survival_time": 500})
assert out["expression"].shape == (8, 20) and np.isfinite(out["expression"]).all()
assert _build.LIBRARY._lib is None  # nothing was built or loaded
bad = sorted(m for m in ("jax", "flax", "pandas", "yaml", "triton", "osteosarcoma_diffusionmodel_tpu")
             if m in sys.modules)
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
