"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py).

One tiny configuration, built twice: the JAX model with Flax params from
``init_params`` and the port's model with the same params carried over by
``convert.flax_params_to_state_dict``. The skip gain, zero at Flax init,
is set to seeded nonzero values so the g(t)·x path carries signal.
"""

from __future__ import annotations

import jax
import numpy as np

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

DATA_DIMS = (10, 40, 14)
HIDDEN = (128, 256, 128)
CONDITIONS = ["a", "b", "c"]
TILE_B = 16


def _configure(cfg, num_steps: int, compute_dtype: str, discrete: bool = False):
    cfg.model.hidden_dims = list(HIDDEN)
    cfg.model.latent_dim = 32
    cfg.model.diffusion.num_steps = num_steps
    cfg.model.diffusion.discrete_mutation_head = discrete
    cfg.model.compute_dtype = compute_dtype
    cfg.generation.noise_type = "uniform"
    return cfg


def make_pair(num_steps: int = 6, compute_dtype: str = "bfloat16", seed: int = 0,
              discrete: bool = False, data_dims=DATA_DIMS):
    """(jax_model, flax_params as numpy, port_model) on the same weights;
    ``discrete`` turns on the D3PM mutation head on both."""
    jc = _configure(JaxConfig(), num_steps, compute_dtype, discrete)
    pc = _configure(Config(), num_steps, compute_dtype, discrete)
    jdims = jc.freeze_dims(*data_dims, CONDITIONS)
    pdims = pc.freeze_dims(*data_dims, CONDITIONS)
    jmodel = JaxDiffusion.from_config(jc, jdims)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), len(CONDITIONS))
    )
    rng = np.random.default_rng(seed + 100)
    gain = params["skip_gain"]
    gain["kernel"] = (0.3 * rng.standard_normal(gain["kernel"].shape)).astype(np.float32)
    gain["bias"] = np.full(gain["bias"].shape, 0.1, np.float32)
    pmodel = ConditionalDiffusion.from_config(pc, pdims)
    pmodel.denoiser.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, pmodel
