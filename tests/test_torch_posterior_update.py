"""K8, the standalone posterior-update kernel, through its plain version.

The JAX kernels (osteosarcoma_diffusionmodel_tpu/ops/pallas_kernels.py
`posterior_update`, `posterior_update_traced`) draw their noise with the
TPU's hardware PRNG, which has no CPU interpret lowering
(tests/test_posterior_kernel.py:1-19), so they cannot run here. The
oracle is that test file's numpy algebra (the posterior mean, the clip,
the t = 0 row) plus Gaussian statistics; the noise is also checked
against a numpy Box-Muller of the same Philox words. The card-only cases
are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_torch.ops import pallas_kernels as pk
from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import philox4x32_10


def _inputs(rows, cols, pred_scale=40.0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    pred = (rng.normal(size=(rows, cols)) * pred_scale).astype(np.float32)  # exercises the clip
    return x, pred


def test_posterior_mean_matches_reference():
    x, pred = _inputs(40, 70)
    c0, c1, sv, clip = 0.3, 0.6, 0.0, 30.0  # sqrt_var = 0: deterministic
    out = pk.posterior_update(torch.from_numpy(x), torch.from_numpy(pred), 7, c0, c1, sv,
                              add_noise=1.0, clip_value=clip).numpy()
    np.testing.assert_allclose(out, c0 * np.clip(pred, -clip, clip) + c1 * x, rtol=1e-5, atol=1e-5)


def test_final_step_returns_clipped_pred():
    x, pred = _inputs(8, 20, pred_scale=100.0)
    for add_noise in (0.0, -1.0):
        out = pk.posterior_update(torch.from_numpy(x), torch.from_numpy(pred), 0, 0.5, 0.5, 1.0,
                                  add_noise=add_noise, clip_value=30.0).numpy()
        np.testing.assert_array_equal(out, np.clip(pred, -30, 30))


def test_noise_statistics_and_seeds():
    zeros = torch.zeros(64, 256)
    out = pk.posterior_update(zeros, zeros, 123, 0.0, 0.0, 1.0, add_noise=1.0).numpy()
    assert abs(out.mean()) < 0.05
    assert abs(out.std() - 1.0) < 0.05
    out2 = pk.posterior_update(zeros, zeros, 124, 0.0, 0.0, 1.0, add_noise=1.0).numpy()
    assert not np.allclose(out, out2)
    again = pk.posterior_update(zeros, zeros, 123, 0.0, 0.0, 1.0, add_noise=1.0).numpy()
    np.testing.assert_array_equal(out, again)


@pytest.mark.parametrize("rows,cols", [(6, 50), (3, 257), (7, 5)])
def test_noise_is_box_muller_of_philox_words(rows, cols):
    """Element i = row·cols + col of the flat array is output i % 4 of
    Philox keyed by (seed, 0) at counter i // 4: words (0, 1) and (2, 3)
    are two pairs (u1, u2) of 24-bit uniforms, u1 floored at 1e-12, and
    each pair gives sqrt(-2 log u1)·cos(2π u2), then ·sin(2π u2)
    (pallas_kernels.py:177-186 draws one cosine an element; the port's K8
    draws both outputs of each pair, four elements a Philox call),
    recomputed in float64 numpy. Shapes whose size is not a multiple of 4
    (3×257, 7×5) end inside a quad. The kernel's noise is held to this
    function on the card (tests/test_torch_cuda.py)."""
    seed = 31
    n = rows * cols
    idx = torch.arange(-(-n // 4), dtype=torch.int64)
    zero = torch.zeros_like(idx)
    words = [w.numpy() for w in philox4x32_10(idx, zero, zero, zero, seed, 0)]
    ref = np.empty((idx.numel(), 4))
    for p in range(2):
        u1 = np.maximum((words[2 * p] >> 8) / 2.0**24, 1e-12)
        u2 = (words[2 * p + 1] >> 8) / 2.0**24
        radius = np.sqrt(-2.0 * np.log(u1))
        ref[:, 2 * p] = radius * np.cos(2.0 * np.pi * u2)
        ref[:, 2 * p + 1] = radius * np.sin(2.0 * np.pi * u2)
    got = pk.gaussian_noise(seed, rows, cols)
    assert got.shape == (rows, cols) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().ravel(), ref.ravel()[:n], rtol=1e-5, atol=1e-5)


def test_traced_variant_matches_reference():
    x, pred = _inputs(32, 300, pred_scale=50.0)
    coefs = torch.tensor([0.4, 0.5, 0.0, 1.0, 30.0])
    out = pk.posterior_update_traced(torch.from_numpy(x), torch.from_numpy(pred), coefs, 5).numpy()
    np.testing.assert_allclose(out, 0.4 * np.clip(pred, -30, 30) + 0.5 * x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("add_noise", [1.0, 0.0])
def test_traced_equals_static(add_noise):
    x, pred = _inputs(17, 33)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pred)
    coefs = (0.25, 0.7, 0.3, add_noise, 20.0)
    static = pk.posterior_update(xt, pt, 11, *coefs)
    traced = pk.posterior_update_traced(xt, pt, torch.tensor(coefs), 11)
    assert torch.equal(static, traced)


def test_arguments_are_checked_and_the_plain_path_counts_nothing():
    x = torch.zeros(4, 6)
    before = pk.POSTERIOR_UPDATE.launches
    with pytest.raises(ValueError):
        pk.posterior_update(x, torch.zeros(4, 7), 0, 1.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError):
        pk.posterior_update(x.double(), x.double(), 0, 1.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError):
        pk.posterior_update_traced(x, x, torch.zeros(4), 0)
    with pytest.raises(ValueError):
        pk.posterior_update(x, x, -1, 1.0, 0.0, 0.0, 0.0)
    out = pk.posterior_update(x, x, 0, 1.0, 0.0, 1.0, 1.0)
    assert out.shape == (4, 6) and torch.isfinite(out).all()
    assert pk.POSTERIOR_UPDATE.launches == before
