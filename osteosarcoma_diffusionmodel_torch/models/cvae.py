"""Conditional VAE with biological constraints.

Counterpart of osteosarcoma_diffusionmodel_tpu/models/cvae.py:

- :class:`VAEEncoder` (:37-63): concat(x, conditions) -> [Dense ->
  BatchNorm -> ReLU -> Dropout]* -> the mu and log-variance heads;
- :class:`VAEDecoder` (:66-91): concat(z, conditions) through the hidden
  dims reversed, then the output layer;
- :class:`ConditionalVAEModule` (:94-156): encoder, decoder and the
  survival head on mu, with the reparameterization;
- :class:`BiologyConstrainedVAE` (:159-285): ``from_config``, the loss
  (sum-MSE reconstruction and the analytic KL, each summed over features
  and batch and divided by the batch; the survival head's mean squared
  error; the four constraint losses on the reconstruction) and prior
  sampling through the decoder.

The Dense layers run in ``model.compute_dtype`` with float32 parameters
(:class:`~.networks._Dense`); BatchNorm is Flax's (:class:`~.networks.
BatchNorm`): batch statistics in training mode, the running ones in eval
mode. The module's mode decides both BatchNorm and dropout, as Flax's
``use_running_average = deterministic = not train`` does in the loss;
sampling runs it in eval mode. The random draws (the reparameterization's
epsilon, which the JAX loss draws in eval mode too, and the prior's z) come
from a ``torch.Generator`` or are passed in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, FrozenDims
from ..parallel.batch import BatchShard, RowBlock, batch_mean, batch_sum
from .constraints import ConstraintSpec, constraint_losses
from .networks import BatchNorm, Dropout, SurvivalHead, _Dense, generator_on, torch_dtype


class _MLP(nn.Module):
    """[Dense -> BatchNorm -> ReLU -> Dropout] over ``hidden_dims`` with the
    Flax names ``fc_i``/``bn_i``."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int], dropout: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.depth = len(hidden_dims)
        for i, width in enumerate(hidden_dims):
            self.add_module(f"fc_{i}", _Dense(in_features, width, compute_dtype))
            self.add_module(f"bn_{i}", BatchNorm(width))
            in_features = width
        self.drop = Dropout(dropout)

    def hidden(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            h = self.drop(F.relu(getattr(self, f"bn_{i}")(getattr(self, f"fc_{i}")(h))))
        return h


class VAEEncoder(_MLP):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int], latent_dim: int,
                 dropout: float, compute_dtype: torch.dtype):
        super().__init__(input_dim, hidden_dims, dropout, compute_dtype)
        self.fc_mu = _Dense(hidden_dims[-1], latent_dim, compute_dtype)
        self.fc_logvar = _Dense(hidden_dims[-1], latent_dim, compute_dtype)

    def forward(self, x: torch.Tensor, conditions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar), float32."""
        h = self.hidden(torch.cat([x, conditions], dim=-1))
        return self.fc_mu(h).float(), self.fc_logvar(h).float()


class VAEDecoder(_MLP):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int], output_dim: int,
                 dropout: float, compute_dtype: torch.dtype):
        super().__init__(input_dim, hidden_dims, dropout, compute_dtype)
        self.output = _Dense(hidden_dims[-1], output_dim, compute_dtype)

    def forward(self, z: torch.Tensor, conditions: torch.Tensor) -> torch.Tensor:
        return self.output(self.hidden(torch.cat([z, conditions], dim=-1))).float()


class ConditionalVAEModule(nn.Module):
    """Encoder + decoder + survival head, under the Flax names ``encoder``,
    ``decoder`` and ``survival_head``."""

    def __init__(self, data_dim: int, condition_dim: int, latent_dim: int,
                 hidden_dims: Sequence[int], dropout: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = list(hidden_dims)
        self.data_dim = data_dim
        self.latent_dim = latent_dim
        self.encoder = VAEEncoder(data_dim + condition_dim, hidden, latent_dim, dropout,
                                  compute_dtype)
        self.decoder = VAEDecoder(latent_dim + condition_dim, hidden[::-1], data_dim, dropout,
                                  compute_dtype)
        self.survival_head = SurvivalHead(latent_dim, compute_dtype)

    def forward(self, x: torch.Tensor, conditions: torch.Tensor,
                eps: Optional[torch.Tensor] = None):
        """(x_recon, mu, logvar, survival_pred); z = mu + eps * exp(logvar / 2)
        with ``eps`` (B, latent), else z = mu."""
        mu, logvar = self.encoder(x, conditions)
        z = mu if eps is None else mu + eps * torch.exp(0.5 * logvar)
        return self.decoder(z, conditions), mu, logvar, self.survival_head(mu)

    def decode(self, z: torch.Tensor, conditions: torch.Tensor) -> torch.Tensor:
        return self.decoder(z, conditions)

    def encode(self, x: torch.Tensor, conditions: torch.Tensor) -> torch.Tensor:
        return self.encoder(x, conditions)[0]


@dataclass
class BiologyConstrainedVAE:
    """The module and its loss weights (the JAX dataclass)."""

    module: ConditionalVAEModule
    constraint_spec: Optional[ConstraintSpec] = None
    pathway_coherence_weight: float = 1.0
    mutation_expression_weight: float = 0.5
    survival_weight: float = 0.3
    mutual_exclusivity_weight: float = 0.2
    cooccurrence_weight: float = 1.0

    @staticmethod
    def from_config(config: Config, dims: FrozenDims,
                    constraint_spec: Optional[ConstraintSpec] = None) -> "BiologyConstrainedVAE":
        """The model of ``config``, its module in eval mode. The weights
        come from ``model.constraints`` whether or not a spec is given
        (JAX :185-194)."""
        mc, cc = config.model, config.model.constraints
        module = ConditionalVAEModule(
            data_dim=dims.data_dim, condition_dim=dims.condition_dim,
            latent_dim=mc.latent_dim, hidden_dims=tuple(mc.hidden_dims),
            dropout=mc.gnn.dropout, compute_dtype=torch_dtype(mc.compute_dtype),
        ).eval()
        use_constraints = cc.enabled and constraint_spec is not None
        return BiologyConstrainedVAE(
            module=module,
            constraint_spec=constraint_spec if use_constraints else None,
            pathway_coherence_weight=float(cc.pathway_coherence_weight),
            mutation_expression_weight=float(cc.mutation_expression_weight),
            survival_weight=float(cc.survival_prediction_weight),
            mutual_exclusivity_weight=float(cc.gene_network_weight),
            cooccurrence_weight=float(cc.cooccurrence_weight),
        )

    @property
    def latent_dim(self) -> int:
        return self.module.latent_dim

    def loss_draws(self, batch: int, generator: Optional[torch.Generator], device, *,
                   eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The draws :meth:`loss` makes for a ``batch``-row batch: the
        reparameterization's ``eps`` (batch, latent) from ``generator`` on
        ``device`` unless given."""
        if eps is None:
            eps = torch.randn((batch, self.latent_dim), generator=generator, device=device)
        return {"eps": eps}

    def loss(self, x: torch.Tensor, conditions: torch.Tensor, survival: torch.Tensor,
             generator: Optional[torch.Generator] = None, *, eps: Optional[torch.Tensor] = None,
             train: bool = False,
             shard: Optional[BatchShard] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, metrics): the ELBO, the survival term and the constraint
        terms on a batch ``x`` (B, D) under ``conditions`` (B, C) with the
        normalized ``survival`` (B,). ``eps`` (B, latent) replaces the
        reparameterization's draw from ``generator``; ``train`` runs the
        module in training mode for this call (BatchNorm on the batch's
        statistics, updating the running ones; dropout on). With a
        ``shard``, ``x`` holds this rank's rows of its global batch and every
        batch statistic is the global batch's (BatchNorm's too, where the
        caller attached the shard to the module). Metrics: ``recon_loss``,
        ``kl_loss``, ``survival_loss``, the constraint terms with a spec,
        ``loss``."""
        module = self.module
        batch = x.shape[0]
        eps = self.loss_draws(batch, generator, x.device, eps=eps)["eps"]
        was_training = module.training
        module.train(train)
        try:
            x_recon, mu, logvar, survival_pred = module(x, conditions, eps.to(x.device))
        finally:
            module.train(was_training)
        rows = batch if shard is None else batch * shard.world
        recon_loss = batch_sum((x_recon - x) ** 2, shard) / rows
        kl_loss = -0.5 * batch_sum(1.0 + logvar - mu**2 - torch.exp(logvar), shard) / rows
        survival_loss = batch_mean((survival_pred - survival) ** 2, shard)
        total = recon_loss + kl_loss + self.survival_weight * survival_loss
        metrics = {"recon_loss": recon_loss, "kl_loss": kl_loss, "survival_loss": survival_loss}
        if self.constraint_spec is not None:
            spec = self.constraint_spec
            terms = constraint_losses(x_recon, spec, spec.tensors(x_recon.device), shard)
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
        """Prior sampling (JAX :270-285): z ~ N(0, I) of (num_samples,
        latent), drawn on the module's device from ``generator`` unless
        given, decoded in eval mode. Returns (N, D) float32 there. ``rows``:
        decode only that block of the cohort's rows (its z drawn for the
        whole cohort, its rows kept), for a sharded generator."""
        module = self.module
        device = module.survival_head.fc1.weight.device
        if num_samples is None:
            num_samples = conditions.shape[0]
        if z is None:
            z = torch.randn((num_samples, self.latent_dim),
                            generator=generator_on(generator, device), device=device)
        if rows is not None:
            z, conditions = rows.take(z), rows.take(conditions)
        was_training = module.training
        module.eval()
        try:
            return module.decode(z.to(device, torch.float32), conditions.to(device, torch.float32))
        finally:
            module.train(was_training)
