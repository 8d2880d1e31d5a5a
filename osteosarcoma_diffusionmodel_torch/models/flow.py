"""Conditional normalizing flow (RealNVP-style affine coupling).

Counterpart of osteosarcoma_diffusionmodel_tpu/models/flow.py:

- :class:`CouplingNet` (:34-54): Dense -> SiLU -> Dense -> SiLU -> Dense to
  (log-scale, shift), the output kernel zero at init so the flow starts as
  the identity, the log-scale bounded as 2 tanh(log_s / 2);
- :class:`ConditionalRealNVP` (:57-117): ``num_couplings`` couplings on
  alternating half masks (the first half of the features kept by even
  couplings, the second by odd ones), ``forward`` x -> z with log |det|,
  its exact ``inverse`` and ``log_prob`` under N(0, I);
- :class:`ConditionalFlow` (:120-222): ``from_config`` (max(4, 2 x
  len(hidden_dims)) couplings of width max(hidden_dims); constraint
  weights 0 unless constraints are on and a spec is given), the loss (the
  negative log-likelihood per dimension, and the constraint losses on
  ``inverse(z)`` for z ~ N(0, I), differentiable through the inverse) and
  single-pass sampling.

The Dense layers run in ``model.compute_dtype`` with float32 parameters;
the coupling arithmetic is float32. The flow has no dropout and no
batch statistics. The random draws (the loss's z, the sample's z) come
from a ``torch.Generator`` or are passed in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, FrozenDims
from ..parallel.batch import BatchShard, RowBlock, batch_mean
from .constraints import ConstraintSpec, constraint_losses
from .networks import _Dense, generator_on, torch_dtype

_LOG2PI = math.log(2.0 * math.pi)


class CouplingNet(nn.Module):
    """MLP producing (log-scale, shift) for the transformed half."""

    def __init__(self, in_features: int, out_dim: int, hidden_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.fc1 = _Dense(in_features, hidden_dim, compute_dtype)
        self.fc2 = _Dense(hidden_dim, hidden_dim, compute_dtype)
        self.out = _Dense(hidden_dim, 2 * out_dim, compute_dtype)

    def flax_init(self, generator: torch.Generator) -> None:
        """The output kernel is zero at init (an identity flow)."""
        with torch.no_grad():
            self.out.weight.zero_()

    def forward(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.silu(self.fc2(F.silu(self.fc1(h))))
        log_s, t = self.out(h).float().chunk(2, dim=-1)
        return 2.0 * torch.tanh(log_s / 2.0), t


class ConditionalRealNVP(nn.Module):
    """K alternating affine couplings conditioned on the clinical vector,
    under the Flax names ``coupling_k``."""

    def __init__(self, data_dim: int, condition_dim: int, num_couplings: int = 6,
                 hidden_dim: int = 512, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.data_dim = data_dim
        self.num_couplings = num_couplings
        half = data_dim // 2
        masks = torch.zeros(num_couplings, data_dim)
        masks[0::2, :half] = 1.0
        masks[1::2, half:] = 1.0
        self.register_buffer("masks", masks, persistent=False)
        for k in range(num_couplings):
            self.add_module(f"coupling_{k}", CouplingNet(data_dim + condition_dim, data_dim,
                                                         hidden_dim, compute_dtype))

    def _coupling(self, k: int, x: torch.Tensor, conditions: torch.Tensor):
        """(mask, 1 - mask, masked log-scale, masked shift) of coupling k."""
        mask = self.masks[k]
        free = 1.0 - mask
        log_s, t = getattr(self, f"coupling_{k}")(torch.cat([x * mask, conditions], dim=-1))
        return mask, free, log_s * free, t * free

    def forward(self, x: torch.Tensor, conditions: torch.Tensor):
        """x -> (z, log |det dz/dx|), float32."""
        z = x.float()
        conditions = conditions.float()
        log_det = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for k in range(self.num_couplings):
            mask, free, log_s, t = self._coupling(k, z, conditions)
            z = z * mask + free * (z * torch.exp(log_s) + t)
            log_det = log_det + torch.sum(log_s, dim=-1)
        return z, log_det

    def inverse(self, z: torch.Tensor, conditions: torch.Tensor) -> torch.Tensor:
        """z -> x, the exact inverse of :meth:`forward`."""
        x = z.float()
        conditions = conditions.float()
        for k in reversed(range(self.num_couplings)):
            mask, free, log_s, t = self._coupling(k, x, conditions)
            x = x * mask + free * ((x - t) * torch.exp(-log_s))
        return x

    def log_prob(self, x: torch.Tensor, conditions: torch.Tensor) -> torch.Tensor:
        z, log_det = self.forward(x, conditions)
        return -0.5 * torch.sum(z * z + _LOG2PI, dim=-1) + log_det


@dataclass
class ConditionalFlow:
    """The module and its constraint weights (the JAX dataclass)."""

    module: ConditionalRealNVP
    constraint_spec: Optional[ConstraintSpec] = None
    pathway_coherence_weight: float = 0.0
    mutation_expression_weight: float = 0.0
    mutual_exclusivity_weight: float = 0.0
    cooccurrence_weight: float = 0.0

    @staticmethod
    def from_config(config: Config, dims: FrozenDims,
                    constraint_spec: Optional[ConstraintSpec] = None) -> "ConditionalFlow":
        mc, cc = config.model, config.model.constraints
        module = ConditionalRealNVP(
            data_dim=dims.data_dim, condition_dim=dims.condition_dim,
            num_couplings=max(4, len(mc.hidden_dims) * 2), hidden_dim=max(mc.hidden_dims),
            compute_dtype=torch_dtype(mc.compute_dtype),
        ).eval()
        use_constraints = cc.enabled and constraint_spec is not None

        def weight(w):
            return float(w) if use_constraints else 0.0

        return ConditionalFlow(
            module=module,
            constraint_spec=constraint_spec if use_constraints else None,
            pathway_coherence_weight=weight(cc.pathway_coherence_weight),
            mutation_expression_weight=weight(cc.mutation_expression_weight),
            mutual_exclusivity_weight=weight(cc.gene_network_weight),
            cooccurrence_weight=weight(cc.cooccurrence_weight),
        )

    def loss_draws(self, batch: int, generator: Optional[torch.Generator], device, *,
                   z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The draws :meth:`loss` makes for a ``batch``-row batch: ``z``
        (batch, D) from ``generator`` on ``device`` unless given, where the
        constraint terms read it; none otherwise."""
        if self.constraint_spec is None:
            return {} if z is None else {"z": z}
        if z is None:
            z = torch.randn((batch, self.module.data_dim), generator=generator, device=device)
        return {"z": z}

    def loss(self, x0: torch.Tensor, conditions: torch.Tensor,
             generator: Optional[torch.Generator] = None, *, z: Optional[torch.Tensor] = None,
             train: bool = False,
             shard: Optional[BatchShard] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, metrics): the negative log-likelihood in nats per
        dimension (``nll_per_dim``) and, with a spec, the constraint terms
        on ``inverse(z)`` with z (B, D) ~ N(0, I) from ``generator`` unless
        given; ``loss``. ``train`` changes nothing (no dropout, no batch
        statistics); it is there for the trainer's uniform call. With a
        ``shard``, the rows are this rank's of its global batch, and the
        means and constraint statistics are the global batch's."""
        del train
        module = self.module
        nll = -batch_mean(module.log_prob(x0, conditions), shard) / module.data_dim
        metrics = {"nll_per_dim": nll}
        total = nll
        if self.constraint_spec is not None:
            z = self.loss_draws(x0.shape[0], generator, x0.device, z=z)["z"]
            x_sample = module.inverse(z.to(x0.device, torch.float32), conditions)
            spec = self.constraint_spec
            terms = constraint_losses(x_sample, spec, spec.tensors(x_sample.device), shard)
            metrics.update(terms)
            total = (total
                     + self.pathway_coherence_weight * terms["pathway_coherence"]
                     + self.mutation_expression_weight * terms["mutation_expression"]
                     + self.mutual_exclusivity_weight * terms["mutual_exclusivity"]
                     + self.cooccurrence_weight * terms["cooccurrence"])
        metrics["loss"] = total
        return total, metrics

    @torch.no_grad()
    def sample(self, conditions: torch.Tensor, generator: Optional[torch.Generator] = None, *,
               z: Optional[torch.Tensor] = None, num_samples: Optional[int] = None,
               rows: Optional[RowBlock] = None) -> torch.Tensor:
        """``inverse(z)`` with z (num_samples, D) ~ N(0, I), drawn on the
        module's device from ``generator`` unless given. Returns (N, D)
        float32 there. ``rows``: only that block of the cohort's rows (z
        drawn for the whole cohort), for a sharded generator."""
        module = self.module
        device = module.masks.device
        if num_samples is None:
            num_samples = conditions.shape[0]
        if z is None:
            z = torch.randn((num_samples, module.data_dim),
                            generator=generator_on(generator, device), device=device)
        if rows is not None:
            z, conditions = rows.take(z), rows.take(conditions)
        return module.inverse(z.to(device, torch.float32), conditions.to(device, torch.float32))
