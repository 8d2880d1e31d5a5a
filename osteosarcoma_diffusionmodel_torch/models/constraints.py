"""Biological constraint losses on a predicted patient batch.

Counterpart of osteosarcoma_diffusionmodel_tpu/models/constraints.py.
:func:`mutation_corr_matrix` and :class:`ConstraintSpec` (its fields,
``build`` and ``split``) are numpy, copied from there (:34-155). The
four losses (:158-253) are torch functions on tensors:

- pathway coherence: 1 - the mean within-pathway pairwise batch
  correlation, through one masked product (B, G) x (G, P); no G x G
  correlation matrix is built;
- mutation-expression: hinge penalties on the batch correlation of each
  directional rule's mutation and pathway columns;
- mutual exclusivity: the expected co-occurrence of configured pairs;
- co-occurrence: the off-diagonal squared error between the batch
  mutation correlation matrix and the training cohort's.

An empty part of the spec turns its loss into a constant 0.
:meth:`ConstraintSpec.tensors` puts the index arrays on a device once.
With a :class:`~..parallel.batch.BatchShard`, the batch is this rank's
rows of a global batch, and every mean, standard deviation and
correlation over the batch is the global batch's (all-reduced over the
data group, differentiably), as XLA computes the JAX losses on a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..parallel.batch import BatchShard, batch_mean

_EPS = 1e-8


def mutation_corr_matrix(mutation_data: np.ndarray) -> np.ndarray:
    """Cohort mutation correlation matrix, constant-gene-safe: rows and
    columns of zero-variance genes are zeroed instead of NaN."""
    std = mutation_data.std(axis=0)
    safe = np.where(std > 1e-6, std, 1.0)
    z = (mutation_data - mutation_data.mean(axis=0)) / safe
    corr = (z.T @ z / mutation_data.shape[0]).astype(np.float32)
    corr[std <= 1e-6, :] = 0.0
    corr[:, std <= 1e-6] = 0.0
    return corr


class SpecTensors(NamedTuple):
    """A :class:`ConstraintSpec`'s arrays as tensors on one device."""

    pathway_mask: torch.Tensor  # (G_expr, P_used) float32
    exclusive_pairs: torch.Tensor  # (K, 2) int64
    rule_mutation_idx: torch.Tensor  # (R,) int64
    rule_pathway_idx: torch.Tensor  # (R,) int64
    rule_sign: torch.Tensor  # (R,) float32
    mutation_corr_target: torch.Tensor  # (M, M) float32 or (0, 0)


@dataclass(frozen=True)
class ConstraintSpec:
    """Host-prepared index structures for the constraint losses; empty
    arrays disable the corresponding loss."""

    mutation_dim: int
    expression_dim: int
    pathway_dim: int
    # (G_expr, P_used) float32 binary membership over *expression columns*.
    pathway_mask: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32)
    )
    # (K, 2) indices into the mutation block for mutually-exclusive pairs.
    exclusive_pairs: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.int32)
    )
    # Directional rules: mutation column index, pathway column index,
    # sign (+1 expected positive corr, -1 expected negative).
    rule_mutation_idx: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )
    rule_pathway_idx: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )
    rule_sign: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    # (M, M) target mutation correlation matrix from the training cohort
    # (empty disables the co-occurrence matching loss).
    mutation_corr_target: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32)
    )

    @staticmethod
    def build(
        mutation_genes: Sequence[str],
        expression_genes: Sequence[str],
        pathway_names: Sequence[str],
        gene_sets: Optional[dict] = None,
        exclusive_gene_pairs: Optional[List[List[str]]] = None,
        correlation_rules: Optional[List] = None,
        min_genes_per_pathway: int = 3,
        mutation_data: Optional[np.ndarray] = None,
    ) -> "ConstraintSpec":
        """Resolve gene/pathway names into static index arrays.

        When `mutation_data` (N, M) is given, its correlation matrix
        becomes the co-occurrence matching target.
        """
        mut_index = {g: i for i, g in enumerate(mutation_genes)}
        expr_index = {g: i for i, g in enumerate(expression_genes)}
        path_index = {p: i for i, p in enumerate(pathway_names)}

        # Pathway mask over expression genes.
        masks = []
        if gene_sets:
            for pathway, genes in gene_sets.items():
                cols = [expr_index[g] for g in genes if g in expr_index]
                if len(cols) < min_genes_per_pathway:
                    continue
                col = np.zeros(len(expression_genes), np.float32)
                col[cols] = 1.0
                masks.append(col)
        pathway_mask = (
            np.stack(masks, axis=1)
            if masks
            else np.zeros((len(expression_genes), 0), np.float32)
        )

        pairs = []
        for pair in exclusive_gene_pairs or []:
            g1, g2 = pair[0], pair[1]
            if g1 in mut_index and g2 in mut_index:
                pairs.append((mut_index[g1], mut_index[g2]))
        exclusive_pairs = (
            np.asarray(pairs, np.int32) if pairs else np.zeros((0, 2), np.int32)
        )

        r_mut, r_path, r_sign = [], [], []
        for rule in correlation_rules or []:
            gene = getattr(rule, "mutation", None) or rule["mutation"]
            pathway = getattr(rule, "pathway", None) or rule["pathway"]
            direction = getattr(rule, "direction", None) or rule["direction"]
            if gene in mut_index and pathway in path_index:
                r_mut.append(mut_index[gene])
                r_path.append(path_index[pathway])
                r_sign.append(1.0 if direction == "positive" else -1.0)

        if mutation_data is not None and mutation_data.shape[0] > 2:
            mutation_corr_target = mutation_corr_matrix(mutation_data)
        else:
            mutation_corr_target = np.zeros((0, 0), np.float32)

        return ConstraintSpec(
            mutation_dim=len(mutation_genes),
            expression_dim=len(expression_genes),
            pathway_dim=len(pathway_names),
            pathway_mask=pathway_mask,
            exclusive_pairs=exclusive_pairs,
            rule_mutation_idx=np.asarray(r_mut, np.int32),
            rule_pathway_idx=np.asarray(r_path, np.int32),
            rule_sign=np.asarray(r_sign, np.float32),
            mutation_corr_target=mutation_corr_target,
        )

    def split(self, x):
        """Split a flat patient vector into (mutations, expression, pathways)."""
        m, e = self.mutation_dim, self.expression_dim
        return x[..., :m], x[..., m : m + e], x[..., m + e :]

    def tensors(self, device) -> SpecTensors:
        """The arrays on ``device``, copied there once (the spec is
        immutable)."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_tensors", {})
        if device in cache:
            return cache[device]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        cache[device] = SpecTensors(
            f32(self.pathway_mask), idx(self.exclusive_pairs).reshape(-1, 2),
            idx(self.rule_mutation_idx), idx(self.rule_pathway_idx), f32(self.rule_sign),
            f32(self.mutation_corr_target),
        )
        return cache[device]


def _standardize_over_batch(x: torch.Tensor, shard: Optional[BatchShard] = None) -> torch.Tensor:
    if shard is None:
        mean = x.mean(dim=0, keepdim=True)
        std = x.std(dim=0, unbiased=False, keepdim=True)
    else:
        mean = shard.mean(x, 0, keepdim=True)
        std = torch.sqrt(shard.mean((x - mean) ** 2, 0, keepdim=True))
    return (x - mean) / (std + _EPS)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def pathway_coherence_loss(expression: torch.Tensor, pathway_mask: torch.Tensor,
                           shard: Optional[BatchShard] = None) -> torch.Tensor:
    """1 - mean within-pathway pairwise correlation, via masked matmul:
    for pathway p with k_p members, sum_{i,j in p} corr(i, j) =
    (1/B) sum_b (Z M)_bp^2, so the mean pairwise correlation is
    (that - k_p) / (k_p (k_p - 1))."""
    if pathway_mask.shape[1] == 0:
        return _zero(expression)
    batch = expression.shape[0]
    z = _standardize_over_batch(expression.float(), shard)
    y = z @ pathway_mask  # (B, P)
    corr_sum = (y * y).sum(dim=0) / batch if shard is None else shard.mean(y * y, 0)
    k = pathway_mask.sum(dim=0)
    mean_pairwise = (corr_sum - k) / torch.clamp(k * (k - 1.0), min=1.0)
    return (1.0 - mean_pairwise).mean()


def mutation_expression_correlation_loss(
    mutations: torch.Tensor,
    pathway_scores: torch.Tensor,
    rule_mutation_idx: torch.Tensor,
    rule_pathway_idx: torch.Tensor,
    rule_sign: torch.Tensor,
    shard: Optional[BatchShard] = None,
) -> torch.Tensor:
    """Hinge penalty for violated directional mutation->pathway rules."""
    if rule_mutation_idx.shape[0] == 0:
        return _zero(mutations)
    mut_cols = _standardize_over_batch(mutations.float()[:, rule_mutation_idx], shard)
    path_cols = _standardize_over_batch(pathway_scores.float()[:, rule_pathway_idx], shard)
    corr = batch_mean(mut_cols * path_cols, shard, 0)  # (R,)
    return torch.clamp(-rule_sign * corr, min=0.0).mean()


def mutual_exclusivity_loss(mutations: torch.Tensor, exclusive_pairs: torch.Tensor,
                            shard: Optional[BatchShard] = None) -> torch.Tensor:
    """Expected co-occurrence mass of mutually-exclusive gene pairs."""
    if exclusive_pairs.shape[0] == 0:
        return _zero(mutations)
    p = torch.clamp(mutations.float(), 0.0, 1.0)
    return batch_mean(p[:, exclusive_pairs[:, 0]] * p[:, exclusive_pairs[:, 1]], shard)


def cooccurrence_matching_loss(mutations: torch.Tensor, corr_target: torch.Tensor,
                               shard: Optional[BatchShard] = None) -> torch.Tensor:
    """Squared error between the batch mutation correlation matrix and
    the training cohort's, over the off-diagonal entries."""
    if corr_target.shape[0] == 0:
        return _zero(mutations)
    z = _standardize_over_batch(mutations.float(), shard)
    if shard is None:
        corr = z.T @ z / mutations.shape[0]
    else:
        corr = shard.sum(z.T @ z) / (mutations.shape[0] * shard.world)
    m = corr_target.shape[0]
    off_diag = 1.0 - torch.eye(m, dtype=torch.float32, device=corr.device)
    diff = (corr - corr_target) * off_diag
    return (diff * diff).sum() / max(m * (m - 1.0), 1.0)


def constraint_losses(x_recon: torch.Tensor, spec: ConstraintSpec, tensors: SpecTensors,
                      shard: Optional[BatchShard] = None) -> Dict[str, torch.Tensor]:
    """All constraint terms on a reconstructed/predicted patient batch;
    ``tensors`` is ``spec.tensors(x_recon.device)``; ``shard``: the batch is
    this rank's rows of a global batch."""
    mut, expr, path = spec.split(x_recon)
    return {
        "pathway_coherence": pathway_coherence_loss(expr, tensors.pathway_mask, shard),
        "mutation_expression": mutation_expression_correlation_loss(
            mut, path, tensors.rule_mutation_idx, tensors.rule_pathway_idx, tensors.rule_sign,
            shard,
        ),
        "mutual_exclusivity": mutual_exclusivity_loss(mut, tensors.exclusive_pairs, shard),
        "cooccurrence": cooccurrence_matching_loss(mut, tensors.mutation_corr_target, shard),
    }
