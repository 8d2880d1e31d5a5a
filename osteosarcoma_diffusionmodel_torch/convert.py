"""Carry weights between the JAX package's Flax variables and the port.

The Flax parameter trees of the three architectures map one to one onto
the port's modules: the denoiser's (osteosarcoma_diffusionmodel_tpu/
models/networks.py, names at :186-219) onto
:class:`~.models.networks.DiffusionDenoiser`, the cVAE's (``encoder/fc_i``,
``encoder/bn_i``, ``encoder/fc_mu``, ``encoder/fc_logvar``,
``decoder/fc_i``, ``decoder/bn_i``, ``decoder/output``,
``survival_head/fc1``, ``survival_head/fc2``) onto
:class:`~.models.cvae.ConditionalVAEModule`, and the flow's
(``coupling_k/{fc1,fc2,out}``) onto :class:`~.models.flow.ConditionalRealNVP`,
and the GAT encoder's (osteosarcoma_diffusionmodel_tpu/models/gnn.py:
``input_proj``, ``gat_<i>/lin``, ``gat_<i>/attn_src``, ``gat_<i>/attn_dst``,
``output_proj``) onto :class:`~.models.gnn.PathwayGraphEncoder`:

- a Dense ``kernel`` (in, out) is a Linear ``weight`` (out, in); ``bias``
  stays ``bias``;
- a GroupNorm or BatchNorm ``scale``/``bias`` is ``weight``/``bias``;
- the cVAE's ``batch_stats`` tree (``encoder/bn_0/mean``, ``.../var``) is
  the port's BatchNorm buffers of the same names (``encoder.bn_0.mean``);
- module paths keep their names (``enc_0/fc1`` -> ``enc_0.fc1``), the
  heads' Dense layers too (``sigma_proj``, ``latent_enc_fc1/2``,
  ``ar_ctx_fc1/2``);
- the raw arrays of the AR head and of low-rank sigma (``ar_coupling``,
  ``ar_bias``, ``lowrank_U``, ``lowrank_logdiag``, ``lowrank_logs``) keep
  their names and layout (no transpose), and so do the GAT layers'
  (heads, features) ``attn_src`` / ``attn_dst`` (``gat_0/attn_src`` ->
  ``gat_0.attn_src``); a GAT layer's ``lin`` has a kernel and no bias.

A parameter or statistic of any other module or leaf is rejected, never
dropped.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_TOP_LEVEL = {
    "time_proj", "skip_gain", "condition_embed", "cond_proj", "input_proj",
    "bottleneck", "output_proj", "sigma_proj", "latent_enc_fc1", "latent_enc_fc2",
    "ar_ctx_fc1", "ar_ctx_fc2",
}
RAW_ARRAYS = {"ar_coupling", "ar_bias", "lowrank_U", "lowrank_logdiag", "lowrank_logs"}


# The cVAE's and the flow's module paths, whole.
_FAMILY_MODULES = re.compile(
    r"(encoder/(fc_\d+|bn_\d+|fc_mu|fc_logvar)|decoder/(fc_\d+|bn_\d+|output)"
    r"|survival_head/fc[12]|coupling_\d+/(fc1|fc2|out))$")
BATCH_STATS = ("mean", "var")
# The GAT encoder: each layer's projection (a kernel, no bias) and its raw
# attention vectors.
_GAT_LIN = re.compile(r"gat_\d+/lin$")
_GAT_RAW = re.compile(r"gat_\d+/attn_(src|dst)$")


def _check_module(path: str) -> None:
    """``path``: a module path with "/" or "." between its names."""
    path = path.replace(".", "/")
    top = path.split("/")[0]
    if (top in _TOP_LEVEL or top.startswith(("enc_", "dec_")) or _FAMILY_MODULES.match(path)
            or _GAT_LIN.match(path)):
        return
    raise NotImplementedError(
        f"Flax variable {path!r} belongs to no module of the PyTorch port's models"
    )


def _check_gat_leaf(module: str, leaf: str, kernel: str) -> None:
    """A GAT layer's ``lin`` holds its kernel (``kernel`` in Flax,
    ``weight`` in PyTorch) and nothing else."""
    if _GAT_LIN.match(module.replace(".", "/")) and leaf != kernel:
        raise NotImplementedError(
            f"GAT projection {module!r} has no {leaf!r} in the PyTorch port's encoder")


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


def flax_params_to_state_dict(params: Mapping[str, Any],
                              batch_stats: Optional[Mapping[str, Any]] = None
                              ) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays), and the cVAE's ``batch_stats``
    where given, -> the port's ``state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flatten_params(params).items():
        if path in RAW_ARRAYS or _GAT_RAW.match(path):
            state[path.replace("/", ".")] = torch.from_numpy(np.array(value, np.float32))
            continue
        module, _, leaf = path.rpartition("/")
        _check_module(module or path)
        _check_gat_leaf(module, leaf, "kernel")
        module = module.replace("/", ".")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            state[f"{module}.weight"] = torch.from_numpy(np.array(arr.T, order="C"))
        elif leaf == "scale":
            state[f"{module}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "bias":
            state[f"{module}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise NotImplementedError(f"unknown Flax parameter leaf {path!r}")
    for path, value in flatten_params(batch_stats or {}).items():
        module, _, leaf = path.rpartition("/")
        _check_module(module or path)
        if leaf not in BATCH_STATS:
            raise NotImplementedError(f"unknown Flax batch_stats leaf {path!r}")
        state[f"{module.replace('/', '.')}.{leaf}"] = torch.from_numpy(
            np.array(value, np.float32))
    return state


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of :func:`flax_params_to_state_dict`: (params, batch_stats),
    the latter empty without BatchNorm. GroupNorm and BatchNorm modules are
    recognized by their 1-D weight, BatchNorm's statistics by their
    ``mean``/``var`` names."""
    flat: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        arr = value.detach().cpu().float().numpy()
        if key in RAW_ARRAYS or _GAT_RAW.match(key.replace(".", "/")):
            flat[key.replace(".", "/")] = arr
            continue
        module, leaf = key.rsplit(".", 1)
        _check_module(module)
        _check_gat_leaf(module, leaf, "weight")
        path = module.replace(".", "/")
        if leaf == "weight" and arr.ndim == 2:
            flat[f"{path}/kernel"] = np.ascontiguousarray(arr.T)
        elif leaf == "weight":
            flat[f"{path}/scale"] = arr
        elif leaf == "bias":
            flat[f"{path}/bias"] = arr
        elif leaf in BATCH_STATS:
            stats[f"{path}/{leaf}"] = arr
        else:
            raise ValueError(f"unexpected state_dict entry {key!r}")
    return unflatten_params(flat), unflatten_params(stats)


def state_dict_to_flax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The params half of :func:`state_dict_to_flax`."""
    return state_dict_to_flax(state)[0]
