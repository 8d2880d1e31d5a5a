"""The port's epoch blocks (``training.epochs_per_dispatch``) against the
JAX trainer's block loop and per-epoch loop: with early stopping firing
inside a block, both train through the block's last epoch, write the same
``checkpoint_epoch_<n>/`` directories and pick the same best epoch.

Tiny shapes (data 6/20/4, hidden 32/64/32, T = 8, f32, constraints off),
seeded numpy inputs. The two trainers draw their own noise, so the
losses differ; rows near a constant 2.0 make every epoch of the short run
improve on the last in both (the output moves towards 2.0), which fixes
the best epoch at the last one.
"""

import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import OsteosarcomaArrays as JaxArrays
from osteosarcoma_diffusionmodel_tpu.training.checkpoint import BEST_NAME
from osteosarcoma_diffusionmodel_tpu.training.trainer import Trainer as JaxTrainer
from osteosarcoma_diffusionmodel_tpu.training.trainer import build_model as jax_build_model
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model

M, E, P, N = 6, 20, 4, 40
NAMES = ["a", "b", "c"]


def _config(cfg, save_dir, k):
    cfg.model.hidden_dims = [32, 64, 32]
    cfg.model.latent_dim = 16
    cfg.model.diffusion.num_steps = 8
    cfg.model.compute_dtype = "float32"
    cfg.model.constraints.enabled = False
    tc = cfg.training
    tc.batch_size, tc.num_epochs, tc.val_split = 8, 12, 0.25
    tc.learning_rate = 1e-3
    tc.patience, tc.min_delta, tc.save_frequency = 3, 10.0, 3
    tc.epochs_per_dispatch = k
    tc.save_dir = str(save_dir)
    return cfg


def _arrays(cls):
    rng = np.random.default_rng(0)
    return cls(
        data=(2.0 + 0.05 * rng.normal(size=(N, M + E + P))).astype(np.float32),
        conditions=rng.normal(size=(N, 3)).astype(np.float32),
        survival=rng.uniform(100, 2000, size=N).astype(np.float32),
        sample_ids=[f"P{i}" for i in range(N)],
        mutation_genes=[f"M{i}" for i in range(M)],
        expression_genes=[f"E{i}" for i in range(E)],
        pathway_names=[f"PW{i}" for i in range(P)],
        condition_names=list(NAMES),
    )


def _epoch_dirs(save_dir):
    return sorted(p.name for p in save_dir.iterdir() if ckpt.EPOCH_RE.search(p.name))


@pytest.mark.parametrize("k", [1, 4, 5])
def test_epoch_blocks_match_jax_trainer(tmp_path, k):
    """Early stopping fires at epoch 4 (patience 3 after the first; min_delta
    10 makes every later epoch count as no improvement): k = 1 stops there,
    k = 4 ends its first block there, k = 5 trains one epoch past it. The
    history length, the checkpoint_epoch_<n> names and the best epoch equal
    the JAX trainer's."""
    jc = _config(JaxConfig(), tmp_path / "jax", k)
    jdims = jc.freeze_dims(M, E, P, NAMES)
    jt = JaxTrainer(jax_build_model(jc, jdims), _arrays(JaxArrays), jdims, jc)
    jhist = jt.train()
    jbest = int(jt.checkpoints.restore(BEST_NAME, jt.state_dict(0, 0.0))["epoch"])

    pc = _config(Config(), tmp_path / "port", k)
    pdims = pc.freeze_dims(M, E, P, NAMES)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pt = Trainer(build_model(pc, pdims), _arrays(OsteosarcomaArrays), pdims, pc, "cpu")
        phist = pt.train()
    finally:
        torch.set_num_threads(old)

    want_len = {1: 4, 4: 4, 5: 5}[k]
    assert len(jhist.train_loss) == len(phist.train_loss) == want_len
    assert jt.early_stopping.early_stop and pt.early_stopping.early_stop
    assert _epoch_dirs(tmp_path / "port") == _epoch_dirs(tmp_path / "jax")
    assert pt.best_epoch == jbest == want_len - 1
    assert np.isfinite(phist.train_loss + phist.val_loss).all()
    assert (tmp_path / "port" / "best_model.npz").exists()
    if k > 1:  # one periodic checkpoint, at the end of the block holding epoch 2
        assert _epoch_dirs(tmp_path / "port") == [f"checkpoint_epoch_{want_len - 1}"]
