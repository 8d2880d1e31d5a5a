"""Carry weights between the JAX package's Flax parameters and the port.

The Flax denoiser's parameter tree (osteosarcoma_diffusionmodel_tpu/
models/networks.py, names at :186-219) maps one to one onto
:class:`~.models.networks.DiffusionDenoiser`:

- a Dense ``kernel`` (in, out) is a Linear ``weight`` (out, in); ``bias``
  stays ``bias``;
- a GroupNorm ``scale``/``bias`` is ``weight``/``bias``;
- module paths keep their names (``enc_0/fc1`` -> ``enc_0.fc1``).

Parameters of heads the port does not implement yet (low-rank sigma, AR
head, latent encoder, learned sigma) are rejected, never dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TOP_LEVEL = {
    "time_proj", "skip_gain", "condition_embed", "cond_proj", "input_proj",
    "bottleneck", "output_proj",
}


def _check_module(name: str) -> None:
    if name in _TOP_LEVEL or name.startswith(("enc_", "dec_")):
        return
    raise NotImplementedError(
        f"Flax parameter {name!r} belongs to a head the PyTorch port does not "
        "implement yet"
    )


def flatten_params(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested Flax params -> {"enc_0/fc1/kernel": array, ...}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays) -> the port's ``state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flatten_params(params).items():
        parts = path.split("/")
        _check_module(parts[0])
        module, leaf = ".".join(parts[:-1]), parts[-1]
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            state[f"{module}.weight"] = torch.from_numpy(np.array(arr.T, order="C"))
        elif leaf == "scale":
            state[f"{module}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "bias":
            state[f"{module}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise NotImplementedError(f"unknown Flax parameter leaf {path!r}")
    return state


def state_dict_to_flax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`flax_params_to_state_dict` (GroupNorm modules are
    recognized by their 1-D weight)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        _check_module(module.split(".")[0])
        arr = value.detach().cpu().float().numpy()
        path = module.replace(".", "/")
        if leaf == "weight" and arr.ndim == 2:
            flat[f"{path}/kernel"] = np.ascontiguousarray(arr.T)
        elif leaf == "weight":
            flat[f"{path}/scale"] = arr
        elif leaf == "bias":
            flat[f"{path}/bias"] = arr
        else:
            raise ValueError(f"unexpected state_dict entry {key!r}")
    return unflatten_params(flat)
