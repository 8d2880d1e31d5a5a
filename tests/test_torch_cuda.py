"""The port's kernels against their plain versions, on an NVIDIA card.

These tests need a CUDA device and skip without one. They import no JAX,
so they run on the card's machine, where the suite's conftest (which
imports JAX) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_torch.ops import pallas_kernels as pk
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(torch.bfloat16)


def _posterior_inputs(b, d, steps=4, seed=0):
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy((20 * rng.standard_normal((b, d))).astype(np.float32))
    x = _bf16(rng, (b, d))
    b_out = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (steps, 6)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, b, d)).astype(np.float32))
    return acc, x, b_out, coeffs, noise


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_gemm_matches_plain(cuda):
    rng = np.random.default_rng(0)
    for m, k, n in ((333, 5142, 256), (333, 256, 5142), (5, 40, 24)):
        a = _bf16(rng, (m, k)).to(cuda)
        b = _bf16(rng, (k, n), 1 / math.sqrt(k)).to(cuda)
        bias = torch.randn(n, device=cuda)
        before = sk.GEMM.launches
        got = sk.gemm_bf16_f32acc(a, b, bias=bias)
        assert sk.GEMM.launches == before + 1
        ref = sk.gemm_bf16_f32acc_plain(a, b, bias)
        assert float((got - ref).abs().max()) <= 1e-3 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_cuda_gemm_bf16_out_with_row_add_matches_plain(cuda):
    # The sampler's input product: t_add row as bias, c_proj as row add,
    # bf16 out. One bf16 rounding of sums that differ in f32 order: 2^-7
    # of max(1, |ref|).
    rng = np.random.default_rng(1)
    m, k, n = 333, 5142, 256
    a = _bf16(rng, (m, k)).to(cuda)
    b = _bf16(rng, (k, n), 1 / math.sqrt(k)).to(cuda)
    bias = torch.randn(n, device=cuda)
    row_add = _bf16(rng, (m, n)).float().to(cuda)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=cuda)
    got = sk.gemm_bf16_f32acc(a, b, out=out, bias=bias, row_add=row_add).float()
    ref = sk.gemm_bf16_f32acc_plain(a, b, bias, row_add).to(torch.bfloat16).float()
    assert float((got - ref).abs().max()) <= 2 ** -7 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_cuda_groupnorm_and_posterior_match_plain(cuda):
    h = torch.randn(333, 512, device=cuda) * 3 + 1
    w, b = torch.ones(512, device=cuda), torch.zeros(512, device=cuda)
    got = sk.groupnorm8_silu(h, w, b).float()
    ref = sk.groupnorm8_silu_plain(h, w, b)
    assert float((got - ref).abs().max()) <= 2 ** -7 * max(1.0, float(ref.abs().max()))
    acc, x, b_out, coeffs, noise = (t.to(cuda) for t in _posterior_inputs(333, 5142))
    for mode in ("none", "buffer", "philox"):
        ref = sk.x0_posterior_step_plain(acc, x, b_out, coeffs, 1, mode, noise, seed=3)
        got = sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, 1, mode, noise=noise, seed=3)
        assert float((got.float() - ref.float()).abs().max()) <= 2 ** -7 * max(
            1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
def test_cuda_rbf_kernel_sum_matches_plain(cuda):
    x = torch.randn(100, 5142, device=cuda)
    y = torch.randn(999, 5142, device=cuda) * 1.05
    for a, b in ((x, x), (x, y), (y, y)):
        got = float(pk.rbf_kernel_sum(a, b, 1 / 5142))
        assert got == float(pk.rbf_kernel_sum(a, b, 1 / 5142))  # run to run
        ref = float(pk.rbf_kernel_sum_plain(a, b, 1 / 5142))
        assert abs(got - ref) <= 1e-5 * abs(ref)
