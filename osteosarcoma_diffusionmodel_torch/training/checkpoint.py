"""The port's checkpoint directory: weights, metadata and cohort statistics.

Counterpart of osteosarcoma_diffusionmodel_tpu/training/checkpoint.py
(:28-98) without Orbax. A checkpoint directory holds

- ``best_model.npz``: the denoiser's parameters as flat Flax paths
  (``enc_0/fc1/kernel``, ...), so the JAX side can write it without torch
  (scripts/export_jax_checkpoint.py) and :mod:`..convert` maps it onto the
  port's modules;
- ``metadata.json``: ``{"dims": ..., "config": ...}`` exactly as the JAX
  package writes it;
- ``data_stats.npz``: the training cohort's statistics under the JAX keys
  (feature_mean, feature_std, mutation_freq, feature_sorted,
  mutation_matrix, data_matrix, condition_mean, condition_std).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import Config, FrozenDims
from ..convert import (
    flatten_params,
    flax_params_to_state_dict,
    state_dict_to_flax_params,
    unflatten_params,
)

METADATA_FILE = "metadata.json"
DATA_STATS_FILE = "data_stats.npz"
BEST_NAME = "best_model"


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


def save_weights(save_dir: str | Path, state_dict: Mapping[str, torch.Tensor]) -> None:
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    flat = flatten_params(state_dict_to_flax_params(state_dict))
    np.savez(save_dir / f"{BEST_NAME}.npz", **flat)


def load_weights(save_dir: str | Path) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from ``best_model.npz``."""
    with np.load(Path(save_dir) / f"{BEST_NAME}.npz") as f:
        flat = {k: f[k] for k in f.files}
    return flax_params_to_state_dict(unflatten_params(flat))
