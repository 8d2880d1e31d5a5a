"""The port's pathway functions and the CLI's pathways step against the
JAX package's ``PathwayFeatures`` and ``compute_pathway_features``.

Seeded numpy tables over member and non-member genes (a repeated gene, a
pathway under ``min_genes``); the pathways step on a dummy processed
directory, each of its three files parsed by pandas and compared.
"""

import numpy as np
import pandas as pd
import pytest

from osteosarcoma_diffusionmodel_tpu.cli import compute_pathway_features as jax_pathways_step
from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data
from osteosarcoma_diffusionmodel_tpu.data.pathways import HALLMARK_GENE_SETS, PathwayFeatures
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.pathways import (
    gene_pathway_matrix,
    pathway_scores_from_expression,
    pathway_scores_from_mutations,
)

OUTPUTS = ("pathway_scores.csv", "pathway_mutation_scores.csv", "gene_pathway_matrix.csv")


def _genes():
    genes = (HALLMARK_GENE_SETS["HALLMARK_P53_PATHWAY"] + ["NOISE1", "NOISE2"]
             + HALLMARK_GENE_SETS["HALLMARK_APOPTOSIS"]
             + HALLMARK_GENE_SETS["HALLMARK_MYC_TARGETS_V1"][:4])  # 4 < min_genes
    return list(dict.fromkeys(genes))


@pytest.mark.parametrize("min_genes", [5, 3])
def test_mutation_scores_match_jax(min_genes):
    """The fraction of the member genes mutated, pathways with at least
    ``min_genes`` members present, in the JAX order."""
    genes = _genes()
    rng = np.random.default_rng(min_genes)
    bits = (rng.random((12, len(genes))) < 0.3).astype(np.float64)
    frame = pd.DataFrame(bits, columns=genes, index=[f"S{i}" for i in range(12)])
    want = PathwayFeatures().compute_pathway_scores_from_mutations(frame, min_genes)
    got, names = pathway_scores_from_mutations(bits, genes, min_genes)
    assert names == list(want.columns) and len(names) >= 2
    np.testing.assert_array_equal(got, want.values)
    assert ("HALLMARK_MYC_TARGETS_V1" in names) == (min_genes <= 4)


def test_scores_without_a_pathway_match_jax():
    frame = pd.DataFrame(np.ones((3, 2)), columns=["NOISE1", "NOISE2"], index=["a", "b", "c"])
    want = PathwayFeatures().compute_pathway_scores_from_mutations(frame)
    got, names = pathway_scores_from_mutations(frame.values, list(frame.columns))
    assert names == [] == list(want.columns) and got.shape == (3, 0)
    got, names = pathway_scores_from_expression(frame.values, list(frame.columns))
    assert names == [] and got.shape == (3, 0)


def test_gene_pathway_matrix_matches_jax():
    want = PathwayFeatures().create_gene_pathway_matrix()
    matrix, genes, pathways = gene_pathway_matrix()
    assert genes == list(want.index) == sorted(genes)
    assert pathways == list(want.columns)
    assert matrix.dtype == np.int64
    np.testing.assert_array_equal(matrix, want.values)


def test_pathways_step_writes_the_jax_files(tmp_path):
    """The CLI's pathways step writes the three files of the JAX step, each
    parsed by pandas to the same header, ids and values."""
    for sub in ("jax", "port"):
        make_dummy_data(tmp_path / sub, n_samples=12, n_mutation_genes=10,
                        n_expression_genes=60, n_pathways=5)
    jcfg, pcfg = JaxConfig(), Config()
    jcfg.data.processed_dir = str(tmp_path / "jax")
    pcfg.data.processed_dir = str(tmp_path / "port")
    jax_pathways_step(jcfg)
    cli.compute_pathway_features(pcfg)
    for name in OUTPUTS:
        want = pd.read_csv(tmp_path / "jax" / name)
        got = pd.read_csv(tmp_path / "port" / name)
        assert list(got.columns) == list(want.columns), name
        pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-12, obj=name)
