"""Sample-path fine-tuning: differentiate through a short DDIM chain.

Counterpart of osteosarcoma_diffusionmodel_tpu/training/finetune.py
(:40-121). The diffusion loss never sees the model's own samples, so
cohort statistics such as pairwise mutation co-occurrence are not
optimized by it. Each step here generates a batch through a short DDIM
chain with autograd on (:meth:`ConditionalDiffusion.ddim_chain`, the
counterpart of differentiating JAX's ``sample_ddim`` scan), soft-binarizes
its mutation block with a tempered sigmoid around the 0.5 threshold, and
descends the co-occurrence matching loss against the training cohort's
mutation correlation, anchored by the diffusion loss on every training
row so the marginals do not drift.

The optimizer is a fresh ``torch.optim.Adam`` (optax ``adam``: betas
0.9/0.999, eps 1e-8; no clip, no weight decay) over every parameter. The
denoiser runs in eval mode throughout (no dropout), with autograd on. The
losses stay on the device and are read at the logged steps only.

Not applicable to the discrete (D3PM) mutation head: its reverse chain
draws hard bits, which have no pathwise gradient.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from ..models.constraints import cooccurrence_matching_loss, mutation_corr_matrix

logger = logging.getLogger(__name__)


def sample_path_finetune(
    model,
    x0_data: torch.Tensor,
    conditions: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    steps: int = 200,
    ddim_steps: int = 8,
    sample_batch: int = 256,
    learning_rate: float = 1e-5,
    soft_tau: float = 0.1,
    cooccurrence_weight: float = 1.0,
    anchor_weight: float = 1.0,
    draws: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
) -> Dict[str, List[float]]:
    """Fine-tune ``model.module`` in place so sampled cohorts match the
    training cohort's mutation co-occurrence.

    x0_data: (N, D) the training rows (mutation block first) and
    conditions: (N, C) theirs, both on the model's device. Each step draws
    ``sample_batch`` condition rows with replacement, the chain's x_T, and
    the anchor loss's t and noise from ``generator`` (on that device), in
    that order; ``draws[i]`` replaces step i's draws by name ("rows",
    "x_T", "t", "noise"). Returns the history: ``loss``, ``cooccurrence``
    and ``anchor`` at every 25th step and at the last.
    """
    if getattr(model, "discrete_head", False):
        raise ValueError(
            "sample-path fine-tuning requires the continuous mutation "
            "path (discrete D3PM bit draws have no pathwise gradient)"
        )
    spec = model.constraint_spec
    M = model.mutation_dim or (spec.mutation_dim if spec is not None else 0)
    if not M:
        raise ValueError("model.mutation_dim must be set for fine-tuning")

    module = model.module
    dev = x0_data.device
    target = torch.from_numpy(
        mutation_corr_matrix(x0_data[:, :M].detach().cpu().numpy())).to(dev)
    optimizer = torch.optim.Adam(module.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, capturable=dev.type == "cuda")
    n, D = x0_data.shape
    history: Dict[str, List[float]] = {"loss": [], "cooccurrence": [], "anchor": []}
    was_training = module.training
    module.eval()
    try:
        for i in range(steps):
            given = draws[i] if draws is not None else {}
            rows = given.get("rows")
            if rows is None:
                rows = torch.randint(0, n, (sample_batch,), generator=generator, device=dev)
            x_T = given.get("x_T")
            if x_T is None:
                x_T = torch.randn((sample_batch, D), generator=generator, device=dev)
            optimizer.zero_grad(set_to_none=True)
            x = model.ddim_chain(conditions[rows.to(dev)], generator,
                                 num_sampling_steps=ddim_steps, draws={"x_T": x_T})
            soft_bits = torch.sigmoid((x[:, :M] - 0.5) / soft_tau)
            cooc = cooccurrence_matching_loss(soft_bits, target)
            anchor, _ = model.loss(x0_data, conditions, generator, t=given.get("t"),
                                   noise=given.get("noise"), train=False)
            total = cooccurrence_weight * cooc + anchor_weight * anchor
            total.backward()
            optimizer.step()
            if i % 25 == 0 or i == steps - 1:
                lv, cv, av = torch.stack([total, cooc, anchor]).detach().tolist()
                history["loss"].append(lv)
                history["cooccurrence"].append(cv)
                history["anchor"].append(av)
                logger.info("Sample-path finetune %d/%d  loss %.4f  cooc %.4f  anchor %.4f",
                            i + 1, steps, lv, cv, av)
    finally:
        module.train(was_training)
    return history
