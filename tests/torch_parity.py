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


def _configure(cfg, num_steps: int, compute_dtype: str, discrete: bool = False, hidden=HIDDEN,
               overrides=None):
    cfg.model.hidden_dims = list(hidden)
    cfg.model.latent_dim = 32
    cfg.model.diffusion.num_steps = num_steps
    cfg.model.diffusion.discrete_mutation_head = discrete
    cfg.model.compute_dtype = compute_dtype
    cfg.generation.noise_type = "uniform"
    return override(cfg, overrides)


def override(cfg, overrides=None):
    """``cfg`` with each ``{"model.diffusion.learn_sigma": True, ...}``
    entry set (dotted attribute paths)."""
    for path, value in (overrides or {}).items():
        *parents, leaf = path.split(".")
        node = cfg
        for name in parents:
            node = getattr(node, name)
        if not hasattr(node, leaf):
            raise AttributeError(f"{type(node).__name__} has no field {leaf!r}")
        setattr(node, leaf, value)
    return cfg


def perturb_heads(params, seed: int = 0):
    """Seeded values in place of the heads' zero or constant Flax inits
    (the sigma projection's kernel and bias, the AR context's output
    layer, the low-rank log-diagonal and log-scales), so each head's path
    carries signal."""
    rng = np.random.default_rng(seed + 200)

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    if "sigma_proj" in params:
        sp = params["sigma_proj"]
        sp["kernel"] = normal(sp["kernel"].shape, 0.05)
        sp["bias"] = normal(sp["bias"].shape, 0.5) - 2.0
    if "ar_ctx_fc2" in params:
        params["ar_ctx_fc2"]["kernel"] = normal(params["ar_ctx_fc2"]["kernel"].shape, 0.3)
        params["ar_bias"] = normal(params["ar_bias"].shape, 0.5)
        params["ar_coupling"] = normal(params["ar_coupling"].shape, 0.5)
    if "lowrank_U" in params:
        params["lowrank_U"] = normal(params["lowrank_U"].shape, 0.3)
        params["lowrank_logdiag"] = normal(params["lowrank_logdiag"].shape, 0.3) - 1.0
        params["lowrank_logs"] = normal(params["lowrank_logs"].shape, 0.2) - 0.5
    return params


def make_pair(num_steps: int = 6, compute_dtype: str = "bfloat16", seed: int = 0,
              discrete: bool = False, data_dims=DATA_DIMS, hidden=HIDDEN, overrides=None,
              rng_impl=None):
    """(jax_model, flax_params as numpy, port_model) on the same weights;
    ``discrete`` turns on the D3PM mutation head on both; ``overrides``
    (dotted config paths) set the variants on both, the heads'
    zero-initialized parameters perturbed (:func:`perturb_heads`).
    ``rng_impl="threefry"`` makes the JAX samplers split their keys with
    threefry, so a test can rebuild their draws."""
    jc = _configure(JaxConfig(), num_steps, compute_dtype, discrete, hidden, overrides)
    pc = _configure(Config(), num_steps, compute_dtype, discrete, hidden, overrides)
    if rng_impl is not None:
        jc.generation.rng_impl = rng_impl
    jdims = jc.freeze_dims(*data_dims, CONDITIONS)
    pdims = pc.freeze_dims(*data_dims, CONDITIONS)
    jmodel = JaxDiffusion.from_config(jc, jdims)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), len(CONDITIONS))
    )
    rng = np.random.default_rng(seed + 100)
    if "skip_gain" in params:
        gain = params["skip_gain"]
        gain["kernel"] = (0.3 * rng.standard_normal(gain["kernel"].shape)).astype(np.float32)
        gain["bias"] = np.full(gain["bias"].shape, 0.1, np.float32)
    if overrides:
        perturb_heads(params, seed)
    pmodel = ConditionalDiffusion.from_config(pc, pdims)
    pmodel.denoiser.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, pmodel


# The training tests' tiny structured cohort and model (tests/test_torch_train.py,
# tests/test_torch_dataset.py).
TRAIN_DUMMY = dict(n_samples=40, n_mutation_genes=10, n_expression_genes=40, n_pathways=14)
TRAIN_HIDDEN = [128, 256, 128]
BATCH = 16


def train_config(cfg, compute_dtype="float32", discrete=False, loss_type="l2",
                 balanced=False, constraints=True, dropout=0.0, num_steps=20):
    """A JAX or port ``Config`` at the training tests' size (20 steps,
    hidden 128/256/128, batch 16, the co-occurrence term weighted 0.3)."""
    cfg.model.hidden_dims = list(TRAIN_HIDDEN)
    cfg.model.latent_dim = 32
    cfg.model.compute_dtype = compute_dtype
    cfg.model.gnn.dropout = dropout
    cfg.model.diffusion.num_steps = num_steps
    cfg.model.diffusion.discrete_mutation_head = discrete
    cfg.model.diffusion.loss_type = loss_type
    cfg.model.diffusion.block_loss_weighting = "balanced" if balanced else "none"
    cfg.model.constraints.enabled = constraints
    cfg.model.constraints.cooccurrence_weight = 0.3
    cfg.training.batch_size = BATCH
    return cfg


def constraint_specs(cohort, data):
    """The JAX and the port's ConstraintSpec of a dummy cohort: Hallmark
    sets, two exclusive pairs, the two directional rules, the cohort's
    mutation correlation."""
    from osteosarcoma_diffusionmodel_tpu.models import constraints as jcons
    from osteosarcoma_diffusionmodel_torch.data.pathways import HALLMARK_GENE_SETS
    from osteosarcoma_diffusionmodel_torch.models import constraints as pcons

    kw = dict(
        mutation_genes=cohort.mutation_genes, expression_genes=cohort.expression_genes,
        pathway_names=cohort.pathway_names, gene_sets=dict(HALLMARK_GENE_SETS),
        exclusive_gene_pairs=[["TP53", "MDM2"], ["RB1", "MYC"]],
        correlation_rules=[{"mutation": "TP53", "pathway": "HALLMARK_P53_PATHWAY",
                            "direction": "negative"},
                           {"mutation": "MYC", "pathway": "HALLMARK_MYC_TARGETS_V1",
                            "direction": "positive"}],
        mutation_data=data[:, : len(cohort.mutation_genes)],
    )
    return jcons.ConstraintSpec.build(**kw), pcons.ConstraintSpec.build(**kw)
