"""(b) The denoiser forward and the weight bridge against the Flax model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_torch.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from torch_parity import DATA_DIMS, make_pair

D = sum(DATA_DIMS)


def _inputs(seed=0, batch=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, D)).astype(np.float32)
    t = rng.uniform(0, 1, batch).astype(np.float32)
    c = rng.standard_normal((batch, 3)).astype(np.float32)
    return x, t, c


def _both(compute_dtype):
    jmodel, params, pmodel = make_pair(compute_dtype=compute_dtype)
    x, t, c = _inputs()
    ref = np.asarray(jmodel.denoiser.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                           conditions=jnp.asarray(c)))
    with torch.no_grad():
        got = pmodel.denoiser(torch.from_numpy(x), torch.from_numpy(t),
                              conditions=torch.from_numpy(c)).numpy()
    return got, ref


def test_denoiser_forward_matches_flax_f32():
    """float32 compute: the same products in another summation order,
    so agreement to 1e-5 (outputs are O(1))."""
    got, ref = _both("float32")
    assert float(np.std(ref)) > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_denoiser_forward_matches_flax_bf16_loosely():
    """bfloat16 compute rounds every Dense output to bf16 (8 bits of
    mantissa) in both frameworks, at different points of the
    accumulation: agreement to a few bf16 ulps of O(1) values."""
    got, ref = _both("bfloat16")
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0.02)


def test_state_dict_names_and_shapes():
    _, params, pmodel = make_pair()
    sd = flax_params_to_state_dict(params)
    own = pmodel.denoiser.state_dict()
    assert set(sd) == set(own)
    for key, value in sd.items():
        assert tuple(value.shape) == tuple(own[key].shape), key
    np.testing.assert_array_equal(sd["input_proj.weight"].numpy(),
                                  params["input_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["enc_0.norm1.weight"].numpy(),
                                  params["enc_0"]["norm1"]["scale"])
    assert {k.split(".")[0] for k in sd} == {
        "time_proj", "skip_gain", "condition_embed", "cond_proj", "input_proj",
        "enc_0", "enc_1", "bottleneck", "dec_0", "dec_1", "output_proj",
    }


def test_state_dict_round_trip():
    _, params, _ = make_pair()
    back = state_dict_to_flax_params(flax_params_to_state_dict(params))
    flat_a = {k: v for k, v in _flat(params)}
    flat_b = {k: v for k, v in _flat(back)}
    assert flat_a.keys() == flat_b.keys()
    for key in flat_a:
        np.testing.assert_array_equal(flat_a[key], flat_b[key])


def _flat(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            yield from _flat(value, path)
        else:
            yield path, np.asarray(value)


def test_unported_heads_are_rejected():
    _, params, _ = make_pair()
    params = dict(params)
    params["ar_coupling"] = np.zeros((4, 4), np.float32)
    with pytest.raises(NotImplementedError):
        flax_params_to_state_dict(params)
