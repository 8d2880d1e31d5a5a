"""The port's checkpoint directory: weights, metadata, cohort statistics
and the trainer's periodic checkpoints.

Counterpart of osteosarcoma_diffusionmodel_tpu/training/checkpoint.py
without Orbax. A checkpoint directory holds

- ``best_model.npz``: the model's parameters as flat Flax paths
  (``enc_0/fc1/kernel``, ``encoder/bn_0/scale``, ``coupling_0/out/kernel``,
  ...) and, for the cVAE, its BatchNorm statistics under a ``batch_stats/``
  prefix (``batch_stats/encoder/bn_0/mean``), so the JAX side can write it
  without torch (scripts/export_jax_checkpoint.py) and :mod:`..convert` maps
  it onto the port's modules;
- ``metadata.json``: ``{"dims": ..., "config": ...}`` exactly as the JAX
  package writes it;
- ``data_stats.npz``: the training cohort's statistics under the JAX keys
  (feature_mean, feature_std, mutation_freq, feature_sorted,
  mutation_matrix, data_matrix, condition_mean, condition_std);
- ``checkpoint_epoch_<n>/``: what resuming training needs after epoch n:
  ``model.npz`` (the weights, as in ``best_model.npz``), ``optimizer.npz``
  (``exp_avg/<name>`` and ``exp_avg_sq/<name>`` by ``state_dict`` name,
  from AdamW or, for the AR head's ``ar_*`` parameters, from their Adam)
  and ``state.json`` (epoch, val loss, AdamW's step count, the AR Adam's
  ``ar_step`` where the model has the head, and the learning rate, which
  the plateau schedule may have lowered).

The JAX package's Orbax checkpoints are not read here:
scripts/export_jax_checkpoint.py turns one into ``best_model.npz``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import Config, FrozenDims
from ..convert import (
    flatten_params,
    flax_params_to_state_dict,
    state_dict_to_flax,
    unflatten_params,
)

METADATA_FILE = "metadata.json"
DATA_STATS_FILE = "data_stats.npz"
BEST_NAME = "best_model"
EPOCH_RE = re.compile(r"checkpoint_epoch_(\d+)$")
BATCH_STATS_PREFIX = "batch_stats/"


def data_stats_from_arrays(data: np.ndarray, conditions: np.ndarray,
                           mutation_dim: int) -> Dict[str, np.ndarray]:
    """Per-feature training-cohort statistics (`save_data_stats`)."""
    m = mutation_dim
    return {
        "feature_mean": data.mean(axis=0),
        "feature_std": data.std(axis=0),
        "mutation_freq": data[:, :m].mean(axis=0),
        "feature_sorted": np.sort(data, axis=0),
        "mutation_matrix": data[:, :m],
        "data_matrix": data,
        "condition_mean": conditions.mean(axis=0),
        "condition_std": conditions.std(axis=0),
    }


def save_data_stats(save_dir: str | Path, stats: Mapping[str, np.ndarray]) -> None:
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(save_dir / DATA_STATS_FILE, **stats)


def load_data_stats(save_dir: str | Path) -> Optional[Dict[str, np.ndarray]]:
    path = Path(save_dir) / DATA_STATS_FILE
    if not path.exists():
        return None
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def save_metadata(save_dir: str | Path, config: Config, dims: FrozenDims) -> None:
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    meta = {"dims": dataclasses.asdict(dims), "config": config.to_dict()}
    with open(save_dir / METADATA_FILE, "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_metadata(save_dir: str | Path) -> Optional[Dict[str, Any]]:
    path = Path(save_dir) / METADATA_FILE
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def metadata_to_dims(meta: Dict[str, Any]) -> FrozenDims:
    d = dict(meta["dims"])
    d.pop("condition_dim", None)
    names = d.pop("condition_names", [])
    return FrozenDims(condition_dim=len(names), condition_names=names, **d)


def save_weights(save_dir: str | Path, state_dict: Mapping[str, torch.Tensor],
                 name: str = BEST_NAME) -> None:
    """``<name>.npz``: the parameters and any BatchNorm statistics."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    params, batch_stats = state_dict_to_flax(state_dict)
    flat = flatten_params(params)
    flat.update({BATCH_STATS_PREFIX + k: v for k, v in flatten_params(batch_stats).items()})
    np.savez(save_dir / f"{name}.npz", **flat)


def load_weights(save_dir: str | Path, name: str = BEST_NAME) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from ``<name>.npz`` (``best_model.npz``),
    BatchNorm statistics included."""
    with np.load(Path(save_dir) / f"{name}.npz") as f:
        flat = {k: f[k] for k in f.files}
    stats = {k[len(BATCH_STATS_PREFIX):]: flat.pop(k) for k in list(flat)
             if k.startswith(BATCH_STATS_PREFIX)}
    return flax_params_to_state_dict(unflatten_params(flat), unflatten_params(stats))


def epoch_dir(save_dir: str | Path, epoch: int) -> Path:
    return Path(save_dir) / f"checkpoint_epoch_{epoch}"


def latest_epoch(save_dir: str | Path) -> Optional[int]:
    """The highest n of the ``checkpoint_epoch_<n>/`` directories, if any."""
    save_dir = Path(save_dir)
    if not save_dir.is_dir():
        return None
    epochs = [int(m.group(1)) for p in save_dir.iterdir() if (m := EPOCH_RE.search(p.name))]
    return max(epochs) if epochs else None


def save_training_state(save_dir: str | Path, epoch: int,
                        state_dict: Mapping[str, torch.Tensor],
                        moments: Mapping[str, Mapping[str, torch.Tensor]],
                        info: Mapping[str, Any]) -> Path:
    """Write ``checkpoint_epoch_<epoch>/``: the weights, ``moments``
    (``{"exp_avg": {name: tensor}, "exp_avg_sq": {...}}``, stored as
    float32 whatever the parameters' dtype) and ``info``
    (JSON: epoch, val_loss, step, lr, and ar_step with an AR head)."""
    path = epoch_dir(save_dir, epoch)
    save_weights(path, state_dict, name="model")
    np.savez(path / "optimizer.npz", **{
        f"{kind}/{name}": t.detach().cpu().float().numpy()
        for kind, tensors in moments.items() for name, t in tensors.items()})
    (path / "state.json").write_text(json.dumps(dict(info), indent=2))
    return path


def load_training_state(path: str | Path) -> tuple:
    """(state_dict, moments, info) as :func:`save_training_state` wrote them."""
    path = Path(path)
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    with np.load(path / "optimizer.npz") as f:
        for key in f.files:
            kind, name = key.split("/", 1)
            moments.setdefault(kind, {})[name] = torch.from_numpy(f[key])
    info = json.loads((path / "state.json").read_text())
    return load_weights(path, name="model"), moments, info
