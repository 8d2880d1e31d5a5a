"""Training runtime: the AdamW train step, plateau LR, early stopping,
checkpoints and resume.

Counterpart of osteosarcoma_diffusionmodel_tpu/training/trainer.py's
per-epoch path (`train_epoch` :554, `validate` :598, `train` :768) and its
architecture dispatch (:func:`build_model`, :849-863), for the three
model families: the diffusion model, the cVAE and the flow. The trainer
holds the family's ``nn.Module`` (``model.module``) and calls its loss as
the JAX `_loss_with_aux` does (:256-275): the cVAE's with the z-scored
survival target, the diffusion model's with the rows before augmentation
for the AR head; the module is in training mode during a step (dropout,
and the cVAE's BatchNorm on the batch's statistics, updating the running
ones) and in eval mode in :meth:`Trainer.validate`.

- the whole cohort lives on the trainer's device; a batch is an index
  into that copy;
- a step applies mixup (one Beta(alpha, alpha) lambda a batch, drawn on
  the host from a seeded numpy generator; the cVAE's survival target mixed
  with the same lambda and permutation) and Gaussian jitter on the
  pathway block, then the loss in training mode (the AR head's CE on the
  rows before both augmentations), one global-norm clip over every
  parameter at ``grad_clip_norm`` (:func:`clip_by_global_norm`, optax's
  arithmetic), and the optimizers of the JAX trainer's layout (:200-250):
  ``torch.optim.AdamW`` over every parameter of the module (BatchNorm's
  scale and bias decayed too), with the low-rank sigma parameters
  (``lowrank_*``) in a group without weight decay, and the AR head's
  parameters (``ar_*``) in a plain ``torch.optim.Adam`` of their own at
  the constant ``ar_lr``;
- each epoch takes the batches of ``np.random.default_rng(seed + 1000 +
  epoch).permutation(train_idx)`` in order, dropping the last partial
  one; one host sync an epoch reads its losses;
- the plateau schedule writes the learning rate into AdamW's groups
  only; best model, early stopping and the schedule follow the
  validation ``sel_loss`` (the loss without the AR head's terms; the loss
  itself for a family without it).

Epochs run in blocks of ``training.epochs_per_dispatch`` (k), as the JAX
trainer's block loop does (`_train_block_loop`, :650-766; k = 1 is its
per-epoch loop, :768-843). Each epoch of a block keeps the per-epoch
numerics: its own host sync, plateau step and best-epoch tracking. Host
work waits for the block's end: when early stopping fires, training goes
on to the block's last epoch, and the checkpoints are written there.

Several devices (``training.num_devices`` > 1 with that many ranks in
the process group, or a ``mesh`` from ``parallel.make_mesh``): data
parallelism with the JAX package's global-batch numerics, one process per
device. Every rank holds the whole cohort and the same parameters, takes
the same global batch, draws the global batch's draws from the same seeded
generators (mixup on the global batch) and keeps its rows; the loss's batch
statistics (the constraint terms', the cVAE's BatchNorm moments) and means
are all-reduced over the data group (:mod:`..parallel.batch`), so every
rank computes the global batch's loss. A rank backpropagates its share
(loss / world) and the gradients are summed over the group before the
clip and AdamW, so the step is the one-device step up to reduction order.
A batch whose size does not divide the data axis (a last validation
batch, a cohort smaller than the batch) is replicated: every rank computes
it whole, and its gradient is not summed (JAX :361-377, :543-550). Under a
mesh, epoch blocks need the effective batch to divide the data axis;
otherwise the trainer warns and runs per-epoch blocks (JAX :774-786). Rank 0
alone writes files. One device is the same step with one rank and no
collective.

Checkpoints (:mod:`.checkpoint`): ``metadata.json`` and ``data_stats.npz``
at the start of ``train``; ``best_model.npz``, the weights (and the cVAE's
BatchNorm statistics) of the best epoch so far, kept on the device and
written at the end of each block that improved on it;
``checkpoint_epoch_<last>/`` (weights, the optimizers' moments and steps,
the learning rate) at the end of each block in which some epoch reaches a
multiple of ``save_frequency``, and with k = 1 also at each best epoch.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, FrozenDims
from ..data.dataset import OsteosarcomaArrays, mixup, train_val_split
from ..models.cvae import BiologyConstrainedVAE
from ..models.diffusion import (
    ConditionalDiffusion,
    check_denoiser,
    check_supported,
    visible_devices,
)
from ..models.flow import ConditionalFlow
from ..models.networks import init_flax
from ..parallel.batch import BatchShard, all_reduce_grads, attached
from ..parallel.mesh import DATA_AXIS, axis_size, data_shard, is_writer, make_mesh
from . import checkpoint as ckpt

logger = logging.getLogger(__name__)


class EarlyStopping:
    """Patience/min_delta counter on validation loss
    (reference train.py:129-148)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.early_stop = False

    def __call__(self, val_loss: float) -> None:
        if self.best_loss is None:
            self.best_loss = val_loss
        elif val_loss > self.best_loss - self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_loss = val_loss
            self.counter = 0


class PlateauLR:
    """ReduceLROnPlateau(mode=min) equivalent (reference train.py:176-181)."""

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 10):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.counter = 0
        self.best: Optional[float] = None

    def step(self, val_loss: float) -> float:
        if self.best is None or val_loss < self.best:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter > self.patience:
                self.lr *= self.factor
                self.counter = 0
                logger.info("Plateau: reducing lr to %.3e", self.lr)
        return self.lr


@dataclass
class TrainLog:
    train_loss: List[float] = field(default_factory=list)
    val_loss: List[float] = field(default_factory=list)
    epoch_seconds: List[float] = field(default_factory=list)
    steps_per_sec: float = 0.0
    # Set by the CLI's train step: the pretraining's log (STEP 4a) and the
    # fine-tuning's history (STEP 4b), where they ran.
    pretrain: Optional["TrainLog"] = None
    finetune: Optional[Dict[str, List[float]]] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "train_loss": self.train_loss,
            "val_loss": self.val_loss,
            "epoch_seconds": self.epoch_seconds,
            "steps_per_sec": self.steps_per_sec,
        }


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        sharded: Optional[Sequence[bool]] = None,
                        model_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm``, every gradient becomes g / norm * max_norm (no epsilon),
    else it is left as it is. Returns the norm before clipping; nothing is
    read on the host, and the work is a few multi-tensor launches. With
    ``model_group``, the gradients marked in ``sharded`` are shards over
    that group (tensor parallelism): their squares are summed over it, so
    every rank clips by the whole model's norm."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(list(sharded), device=norms.device)
        shard_sq = (norms[mask] ** 2).sum()
        torch.distributed.all_reduce(shard_sq, group=model_group)
        norm = torch.sqrt((norms[~mask] ** 2).sum() + shard_sq)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def build_model(config: Config, dims: FrozenDims, constraint_spec=None):
    """The model of ``model.architecture`` (JAX :849-863): the diffusion
    model, the cVAE or the flow, each with its module in eval mode; any
    other architecture is a ValueError, as there, and so is a
    ``model.denoiser`` the architecture does not take."""
    arch = config.model.architecture
    if arch in ("cvae", "flow"):
        check_denoiser(config)
    if arch == "diffusion":
        return ConditionalDiffusion.from_config(config, dims, constraint_spec)
    if arch == "cvae":
        return BiologyConstrainedVAE.from_config(config, dims, constraint_spec)
    if arch == "flow":
        return ConditionalFlow.from_config(config, dims, constraint_spec)
    raise ValueError(f"Unknown architecture: {arch}")


class Trainer:
    """Per-epoch training loop of one model family on one device, or data
    parallel over the data axis of a mesh."""

    def __init__(self, model, arrays: OsteosarcomaArrays,
                 dims: FrozenDims, config: Config, device: str | torch.device, mesh=None):
        check_supported(config, dims, training=True, device=device)
        tc = config.training
        wanted = tc.num_devices or 1
        if mesh is None and wanted > 1 and visible_devices(device) >= wanted:
            mesh = make_mesh(wanted)
        if mesh is not None and mesh.get_coordinate() is None:
            raise ValueError("this rank is not in the trainer's mesh")
        self.mesh = mesh
        if mesh is not None:
            logger.info("Training mesh: %s", dict(zip(mesh.mesh_dim_names, mesh.shape)))
        self.writer = is_writer()
        self.model = model
        self.arrays = arrays
        self.dims = dims
        self.config = config
        self.device = torch.device(device)
        self.is_vae = isinstance(model, BiologyConstrainedVAE)

        self.module = model.module
        # The init draws come from a CPU generator, so the module is on the
        # CPU for them (a module that an earlier trainer moved to the card
        # keeps its parameter objects, which that trainer's optimizer holds).
        init_flax(self.module.cpu(), torch.Generator().manual_seed(tc.random_seed))
        self.module.to(self.device)
        named = list(self.module.named_parameters())
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        # capturable keeps the step counters on the card (and the updates
        # free of host reads).
        capturable = self.device.type == "cuda"
        decay = [p for n, p in named if not n.startswith(("ar_", "lowrank"))]
        no_decay = [p for n, p in named if n.startswith("lowrank")]
        ar_params = [p for n, p in named if n.startswith("ar_")]
        groups = [{"params": decay}] + (
            [{"params": no_decay, "weight_decay": 0.0}] if no_decay else [])
        self.optimizer = torch.optim.AdamW(
            groups, lr=tc.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=tc.weight_decay, capturable=capturable,
        )
        self.ar_optimizer = torch.optim.Adam(
            ar_params, lr=getattr(model, "ar_lr", 0.0), betas=(0.9, 0.999), eps=1e-8,
            capturable=capturable) if ar_params else None
        self.optimizers = [o for o in (self.optimizer, self.ar_optimizer) if o is not None]
        self.start_epoch = 0

        self.train_idx, self.val_idx = train_val_split(
            arrays.n_samples, tc.val_split, tc.random_seed)
        self._data = torch.from_numpy(np.ascontiguousarray(arrays.data, np.float32)).to(self.device)
        self._cond = torch.from_numpy(
            np.ascontiguousarray(arrays.conditions, np.float32)).to(self.device)
        surv_norm = ((arrays.survival - arrays.survival_mean)
                     / max(arrays.survival_std, 1e-8)).astype(np.float32)
        self._surv = torch.from_numpy(surv_norm).to(self.device)
        self._val_idx = torch.from_numpy(self.val_idx).to(self.device)
        self.pathway_start = dims.mutation_dim + dims.expression_dim

        # The step's draws: the loss's (t, noise, bit flips; the cVAE's
        # epsilon; the flow's z), mixup's permutation and the pathway
        # jitter on the device; mixup's lambda on the host.
        self.generator = torch.Generator(device=self.device).manual_seed(tc.random_seed + 7)
        self.np_rng = np.random.default_rng(tc.random_seed + 7)

        self.plateau = PlateauLR(tc.learning_rate, tc.lr_plateau_factor, tc.lr_plateau_patience)
        self.early_stopping = EarlyStopping(tc.patience, tc.min_delta)
        self.save_dir = tc.save_dir
        self.history = TrainLog()
        self.best_epoch: Optional[int] = None

    # ------------------------------------------------------------------
    def _loss(self, data, cond, surv, raw, train: bool, draws, shard: BatchShard):
        """The family's loss as the JAX `_loss_with_aux` calls it, on this
        rank's rows of the batch."""
        kw = dict(train=train, shard=shard, **draws)
        if self.is_vae:
            return self.model.loss(data, cond, surv, self.generator, **kw)
        if isinstance(self.model, ConditionalDiffusion):
            return self.model.loss(data, cond, self.generator, ar_x0=raw[0],
                                   ar_conditions=raw[1], **kw)
        return self.model.loss(data, cond, self.generator, **kw)

    def _shard(self, rows: int) -> BatchShard:
        """This rank's share of a ``rows``-row batch (the whole batch on one
        device or where ``rows`` does not divide the data axis)."""
        return data_shard(self.mesh, rows, self.generator)

    def train_step(self, data: torch.Tensor, cond: torch.Tensor,
                   surv: Optional[torch.Tensor] = None, *,
                   lam: Optional[float] = None, perm: Optional[torch.Tensor] = None,
                   pathway_noise: Optional[torch.Tensor] = None,
                   **draws: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch (``surv``: the normalized survival
        target, which only the cVAE reads). The keyword arguments replace
        the step's draws: mixup's lambda and permutation, the pathway
        jitter, then the loss's (``t``, ``noise``, ``bit_uniforms``,
        ``cfg_uniforms`` for the diffusion model; ``eps`` for the cVAE;
        ``z`` for the flow). Under a mesh every rank passes the same global
        batch (and global draws) and computes its rows of it. Returns the
        loss's metrics (the global batch's) and ``grad_norm``, the global
        norm before the clip, as device tensors."""
        aug = self.config.training.augmentation
        raw_data, raw_cond = data, cond
        if aug.mixup_alpha > 0:
            mixed = mixup(data, cond, aug.mixup_alpha, lam=lam, perm=perm, rng=self.np_rng,
                          generator=self.generator, survival=surv if self.is_vae else None)
            data, cond, surv = mixed if self.is_vae else (*mixed, surv)
        if aug.pathway_noise > 0:
            ps = self.pathway_start
            if pathway_noise is None:
                pathway_noise = torch.randn(data[:, ps:].shape, generator=self.generator,
                                            device=data.device)
            data = torch.cat([data[:, :ps], data[:, ps:] + aug.pathway_noise * pathway_noise],
                             dim=1)
        shard = self._shard(data.shape[0])
        take = shard.take
        draws = self.model.loss_draws(data.shape[0], self.generator, data.device, **draws)
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=True)
        with attached(self.module, shard):
            loss, metrics = self._loss(take(data), take(cond), take(surv),
                                       (take(raw_data), take(raw_cond)), True,
                                       {k: take(v) for k, v in draws.items()}, shard)
        (loss / shard.world).backward()
        grads = [p.grad for p in self.params]
        if shard.group is not None:
            all_reduce_grads(grads, shard.group)
        metrics["grad_norm"] = clip_by_global_norm(grads, self.config.training.grad_clip_norm)
        for opt in self.optimizers:
            opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    def epoch_batches(self, epoch: int) -> np.ndarray:
        """(n_batches, batch) row indices of ``epoch``: the seeded
        permutation of the training rows, the last partial batch dropped."""
        tc = self.config.training
        perm = np.random.default_rng(tc.random_seed + 1000 + epoch).permutation(self.train_idx)
        batch_size = min(tc.batch_size, len(perm))
        n_batches = max(len(perm) // batch_size, 1)
        return perm[: n_batches * batch_size].reshape(n_batches, batch_size)

    def train_epoch(self, epoch: int) -> torch.Tensor:
        """The epoch's mean train loss, as a device scalar."""
        batches = torch.from_numpy(self.epoch_batches(epoch)).to(self.device)
        losses = [self.train_step(self._data[idx], self._cond[idx], self._surv[idx])["loss"]
                  for idx in batches]
        return torch.stack(losses).mean()

    @torch.no_grad()
    def validate(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(val loss, val selection loss) as device scalars: per-batch
        means of the loss in eval mode, averaged; the selection loss is
        ``sel_loss`` where the family reports one, else the loss (JAX
        :598-617); NaN without validation rows. Under a mesh a batch that
        divides the data axis is split over it, as in :meth:`train_step`."""
        if len(self.val_idx) == 0:
            nan = torch.full((), float("nan"), device=self.device)
            return nan, nan
        batch_size = self.config.training.batch_size
        total, sel = [], []
        for b in range(0, len(self.val_idx), batch_size):
            idx = self._val_idx[b: b + batch_size]
            shard = self._shard(len(idx))
            take = shard.take
            data, cond = take(self._data[idx]), take(self._cond[idx])
            draws = self.model.loss_draws(len(idx), self.generator, self.device)
            _, metrics = self._loss(data, cond, take(self._surv[idx]), (data, cond), False,
                                    {k: take(v) for k, v in draws.items()}, shard)
            total.append(metrics["loss"])
            sel.append(metrics.get("sel_loss", metrics["loss"]))
        return torch.stack(total).mean(), torch.stack(sel).mean()

    # ------------------------------------------------------------------
    def set_learning_rate(self, lr: float) -> None:
        """The plateau schedule's rate, into AdamW's groups (the AR head's
        Adam keeps ``ar_lr``)."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _named(self, opt: torch.optim.Optimizer) -> List[Tuple[str, torch.Tensor]]:
        """(name, parameter) of ``opt`` in its ``state_dict`` order."""
        by_id = {id(p): n for n, p in zip(self.param_names, self.params)}
        return [(by_id[id(p)], p) for group in opt.param_groups for p in group["params"]]

    def save_checkpoint(self, epoch: int, val_loss: float) -> None:
        """``checkpoint_epoch_<epoch>/``: weights and BatchNorm statistics,
        the optimizers' moments (by parameter name) and steps, the LR
        (rank 0)."""
        if not self.writer:
            return
        moments = {"exp_avg": {}, "exp_avg_sq": {}}
        steps = []
        for opt in self.optimizers:
            named = self._named(opt)
            for name, p in named:
                for kind in moments:
                    moments[kind][name] = opt.state[p][kind]
            steps.append(int(float(opt.state[named[0][1]]["step"])))
        info = {"epoch": epoch, "val_loss": val_loss, "step": steps[0],
                "lr": self.optimizer.param_groups[0]["lr"]}
        if self.ar_optimizer is not None:
            info["ar_step"] = steps[1]
        ckpt.save_training_state(self.save_dir, epoch, self.module.state_dict(), moments, info)

    def resume(self) -> bool:
        """Restore the latest periodic checkpoint, if any: the weights and
        BatchNorm statistics, the optimizers' moments and steps, and the
        learning rate (into AdamW and the plateau schedule). Training goes on
        from the epoch after it."""
        latest = ckpt.latest_epoch(self.save_dir)
        if latest is None:
            logger.info("No checkpoint to resume from")
            return False
        weights, moments, info = ckpt.load_training_state(ckpt.epoch_dir(self.save_dir, latest))
        self.module.load_state_dict(weights)
        for opt, step_key in ((self.optimizer, "step"), (self.ar_optimizer, "ar_step")):
            if opt is None:
                continue
            groups = opt.state_dict()["param_groups"]
            if opt is self.optimizer:
                groups = [dict(g, lr=info["lr"]) for g in groups]
            step = torch.tensor(float(info[step_key]))
            opt.load_state_dict({
                "state": {i: {"step": step.clone(), "exp_avg": moments["exp_avg"][n],
                              "exp_avg_sq": moments["exp_avg_sq"][n]}
                          for i, (n, _) in enumerate(self._named(opt))},
                "param_groups": groups,
            })
        self.plateau.lr = float(info["lr"])
        self.start_epoch = int(info["epoch"]) + 1
        logger.info("Resumed from epoch %d", latest)
        return True

    def write_best(self, best: Dict[str, torch.Tensor]) -> None:
        """``best_model.npz`` from a ``state_dict`` snapshot (rank 0)."""
        if not self.writer:
            return
        ckpt.save_weights(self.save_dir, {k: v.cpu() for k, v in best.items()})

    def _run_epoch(self, epoch: int) -> Tuple[float, float]:
        """Train and validate one epoch, read its losses in one host sync,
        log them and step the plateau schedule on them. Returns (val loss,
        val selection loss)."""
        t0 = time.perf_counter()
        train_loss = self.train_epoch(epoch)
        val_loss, val_sel = self.validate()
        train_loss, val_loss, val_sel = torch.stack([train_loss, val_loss, val_sel]).tolist()
        if val_loss != val_loss:  # no val samples: fall back to train loss
            val_loss = val_sel = train_loss
        dt = time.perf_counter() - t0
        self.history.train_loss.append(train_loss)
        self.history.val_loss.append(val_loss)
        self.history.epoch_seconds.append(dt)
        tc = self.config.training
        if epoch % 25 == 0 or epoch == tc.num_epochs - 1:
            logger.info("Epoch %d/%d  train %.4f  val %.4f  (%.2fs)",
                        epoch + 1, tc.num_epochs, train_loss, val_loss, dt)
        prev_lr = self.plateau.lr
        new_lr = self.plateau.step(val_sel)
        if new_lr != prev_lr:
            self.set_learning_rate(new_lr)
        return val_loss, val_sel

    def train(self, resume: bool = False) -> TrainLog:
        tc = self.config.training
        if resume:
            self.resume()
        if self.writer:
            ckpt.save_metadata(self.save_dir, self.config, self.dims)
            ckpt.save_data_stats(self.save_dir, ckpt.data_stats_from_arrays(
                self.arrays.data, self.arrays.conditions, self.dims.mutation_dim))

        k = max(tc.epochs_per_dispatch, 1)
        if k > 1 and self.mesh is not None:
            # The effective batch (a cohort smaller than batch_size shrinks
            # it) must divide the data axis, as JAX's in-scan sharding needs.
            eff_batch = min(tc.batch_size, len(self.train_idx))
            if eff_batch % axis_size(self.mesh, DATA_AXIS):
                logger.warning("epochs_per_dispatch>1 needs the effective batch size divisible "
                               "by the mesh data axis; falling back to per-epoch dispatch")
                k = 1
        best_val = float("inf")
        total_steps = 0
        t_start = time.perf_counter()
        epoch, stop = self.start_epoch, False
        while epoch < tc.num_epochs and not stop:
            last = min(epoch + k, tc.num_epochs) - 1
            best, periodic = None, False
            for e in range(epoch, last + 1):
                val_loss, val_sel = self._run_epoch(e)
                total_steps += max(len(self.train_idx) // tc.batch_size, 1)
                if val_sel < best_val:
                    best_val, self.best_epoch = val_sel, e
                    best = {n: v.detach().clone() for n, v in self.module.state_dict().items()}
                periodic = periodic or (e + 1) % tc.save_frequency == 0
                if not stop:
                    self.early_stopping(val_sel)
                    if self.early_stopping.early_stop:
                        logger.info("Early stopping at epoch %d (trained through epoch %d)",
                                    e + 1, last + 1)
                        stop = True
            if best is not None:
                self.write_best(best)
            if periodic or (k == 1 and best is not None):
                self.save_checkpoint(last, val_loss)
            epoch = last + 1

        elapsed = time.perf_counter() - t_start
        self.history.steps_per_sec = total_steps / max(elapsed, 1e-9)
        logger.info("Training complete: best val %.4f (epoch %s), %.1f steps/sec",
                    best_val, self.best_epoch, self.history.steps_per_sec)
        return self.history
