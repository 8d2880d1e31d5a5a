"""The port's GAT pathway encoder against the Flax module.

``PathwayGraphEncoder`` on the weights that :mod:`convert` carries over
from a Flax init (12 nodes, input 8, hidden 16, latent 4, 3 layers, 4
heads), one graph and two pooled graphs, within 1e-5; the edge list, the
attention's normalization, the converter's round trip and its refusal of
a stray GNN leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.models import gnn as jax_gnn
from osteosarcoma_diffusionmodel_torch.convert import (
    flatten_params,
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from osteosarcoma_diffusionmodel_torch.models import gnn
from osteosarcoma_diffusionmodel_torch.models.networks import init_flax

TOL = 1e-5
N, IN, HIDDEN, LATENT, LAYERS, HEADS = 12, 8, 16, 4, 3, 4


def _membership(seed: int, genes: int = N, pathways: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gp = (rng.random((genes, pathways)) < 0.3).astype(np.float32)
    gp[-1] = 0  # a gene in no pathway: its self-loop only
    return gp


@pytest.mark.parametrize("seed", [0, 1])
def test_gene_pathway_edges_match_jax(seed):
    gp = _membership(seed)
    got, want = gnn.gene_pathway_edges(gp), jax_gnn.gene_pathway_edges(gp)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair():
    """The Flax encoder's params and the port's encoder on them."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, IN)).astype(np.float32)
    edges = gnn.gene_pathway_edges(_membership(0))
    flax_model = jax_gnn.PathwayGraphEncoder(IN, HIDDEN, LATENT, num_layers=LAYERS,
                                             heads=HEADS, dropout=0.2)
    params = jax.tree_util.tree_map(
        np.asarray, flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    jnp.asarray(edges))["params"])
    port = gnn.PathwayGraphEncoder(IN, HIDDEN, LATENT, num_layers=LAYERS, heads=HEADS,
                                   dropout=0.2)
    port.load_state_dict(flax_params_to_state_dict(params))
    return flax_model, params, port.eval(), x, edges


@pytest.mark.parametrize("pooled", [False, True])
def test_encoder_matches_flax(pair, pooled):
    flax_model, params, port, x, edges = pair
    kw = {}
    if pooled:  # two graphs: the first seven nodes and the rest
        batch = (np.arange(N) >= 7).astype(np.int32)
        kw = {"batch": batch, "num_graphs": 2}
    want = np.asarray(flax_model.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(edges),
        **{k: (jnp.asarray(v) if k == "batch" else v) for k, v in kw.items()}))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(edges),
                   **{k: (torch.from_numpy(v) if k == "batch" else v)
                      for k, v in kw.items()}).numpy()
    assert got.shape == want.shape == ((2 if pooled else 1), LATENT)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_attention_sums_to_one_per_destination(pair):
    _, _, port, x, edges = pair
    src, dst = (torch.from_numpy(edges[i]).long() for i in range(2))
    layer = port.gat_0
    with torch.no_grad():
        h = torch.nn.functional.elu(port.input_proj(torch.from_numpy(x)))
        wh = layer.lin(h).reshape(N, HEADS, HIDDEN)
        alpha = layer.attention(wh, src, dst)
    sums = torch.zeros(N, HEADS, dtype=alpha.dtype).index_add_(0, dst, alpha)
    np.testing.assert_allclose(sums.numpy(), 1.0, rtol=0, atol=1e-6)
    assert (alpha >= 0).all()


def test_dropout_only_in_training_mode(pair):
    _, _, port, x, edges = pair
    args = (torch.from_numpy(x), torch.from_numpy(edges))
    with torch.no_grad():
        a, b = port(*args), port(*args)
        torch.manual_seed(0)
        port.train()
        try:
            c = port(*args)
        finally:
            port.eval()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_flax_tree_round_trips(pair):
    _, params, _, _, _ = pair
    back = flatten_params(state_dict_to_flax_params(flax_params_to_state_dict(params)))
    flat = flatten_params(params)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    assert flat["gat_0/attn_src"].shape == (HEADS, HIDDEN)
    assert "gat_0/lin/bias" not in flat


def test_init_flax_gives_every_parameter(pair):
    _, params, _, _, _ = pair
    fresh = gnn.PathwayGraphEncoder(IN, HIDDEN, LATENT, num_layers=LAYERS, heads=HEADS)
    init_flax(fresh, torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in flatten_params(
        state_dict_to_flax_params(fresh.state_dict())).items()}
    assert shapes == {k: v.shape for k, v in flatten_params(params).items()}
    assert all(torch.isfinite(p).all() for p in fresh.parameters())


@pytest.mark.parametrize("stray", ["gat_0/lin/bias", "gat_1/attn_mid", "gat_x/lin/kernel",
                                   "gat_0/norm/scale"])
def test_stray_gnn_leaf_is_rejected(pair, stray):
    _, params, _, _, _ = pair
    flat = dict(flatten_params(params))
    flat[stray] = np.zeros((HIDDEN,), np.float32)
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    with pytest.raises(NotImplementedError):
        flax_params_to_state_dict(tree)
    state = flax_params_to_state_dict(params)
    state[stray.replace("/kernel", ".weight").replace("/", ".")] = torch.zeros(HIDDEN)
    with pytest.raises((NotImplementedError, ValueError)):
        state_dict_to_flax_params(state)
