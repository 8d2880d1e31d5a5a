"""(e) The kernels' plain versions against the JAX package, and the
wrappers' device dispatch.

On CPU tensors a wrapper runs the plain version; on CUDA tensors it
launches its kernel or raises (tests/test_torch_cuda.py, on the card);
any other device raises.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops import fused_sampler as jax_fs
from osteosarcoma_diffusionmodel_tpu.ops.pallas_kernels import rbf_kernel_sum as jax_rbf_kernel_sum
from osteosarcoma_diffusionmodel_tpu.ops.stats import mmd_rbf as jax_mmd_rbf
from osteosarcoma_diffusionmodel_torch.ops import pallas_kernels as pk
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(torch.bfloat16)


# ----------------------------------------------------------------------
# K1
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(19, 64, 128), (33, 320, 256), (16, 128, 64)])
def test_gemm_plain_matches_jax_dot(m, k, n):
    """Both accumulate bf16-exact products in f32: 1e-5 relative."""
    rng = np.random.default_rng(m + k)
    a, b = _bf16(rng, (m, k)), _bf16(rng, (k, n), 1 / math.sqrt(k))
    bias = torch.randn(n, generator=torch.Generator().manual_seed(1))
    row_add = torch.randn(m, n, generator=torch.Generator().manual_seed(2))
    got = sk.gemm_bf16_f32acc(a, b, bias=bias, row_add=row_add)
    ref = jnp.dot(jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(b.float().numpy(), jnp.bfloat16),
                  preferred_element_type=jnp.float32) + bias.numpy() + row_add.numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_gemm_strided_views_and_bf16_out():
    """A strided A (the decoder's [h | skip] halves) and a strided bf16
    output give the contiguous result (bf16 output: one rounding)."""
    rng = np.random.default_rng(0)
    base = _bf16(rng, (12, 96))
    b = _bf16(rng, (48, 32))
    out = torch.zeros(12, 80, dtype=torch.bfloat16)
    sk.gemm_bf16_f32acc(base[:, 48:], b, out=out[:, 16:48])
    ref = (base[:, 48:].float() @ b.float()).to(torch.bfloat16)
    assert torch.equal(out[:, 16:48], ref)
    assert torch.equal(out[:, :16], torch.zeros(12, 16, dtype=torch.bfloat16))


def test_gemm_rejects_bad_inputs():
    a = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        sk.gemm_bf16_f32acc(a.float(), torch.zeros(8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        sk.gemm_bf16_f32acc(a, torch.zeros(6, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        sk.gemm_bf16_f32acc(a, torch.zeros(8, 4, dtype=torch.bfloat16).T.contiguous().T)


@pytest.mark.parametrize("m", [1, 17, 333, 999])
@pytest.mark.parametrize("k", [16, 62, 5142, 5152])
def test_gemm_plan(m, k):
    """For the paths' shapes and ragged ones, both kinds and N 256/5142 on
    132 SMs: the tiles cover M x N with no empty tile; the wgmma width is
    a multiple of 8 and at most 256; the splits cover K's k-tiles exactly,
    none empty; the launch stays within one wave of CTAs and, where K
    allows, comes within one tile row of filling the SMs; the input
    product (333 x 5142 · 5142 x 256) is split."""
    sms = 132
    for kind in ("bf16", "int8"):
        kt = sk.k_tiles(k, kind)
        assert (kt - 1) * (64 if kind == "bf16" else 128) < k <= kt * (64 if kind == "bf16" else 128)
        for n in (256, 5142):
            plan = sk.gemm_plan(m, n, k, sms, kind)
            assert plan is sk.gemm_plan(m, n, k, sms, kind)  # cached by shape
            assert plan.bm == 64 and plan.bn % 8 == 0 and 8 <= plan.bn <= 256
            rows, cols = -(-m // plan.bm), -(-n // plan.bn)
            assert (rows - 1) * plan.bm < m <= rows * plan.bm
            assert (cols - 1) * plan.bn < n <= cols * plan.bn
            # The kernel's cut: split s owns k-tiles [s·kt/S, (s+1)·kt/S).
            ranges = [(s * kt // plan.splits, (s + 1) * kt // plan.splits)
                      for s in range(plan.splits)]
            assert ranges[0][0] == 0 and ranges[-1][1] == kt
            assert all(lo < hi for lo, hi in ranges)
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            tiles = rows * cols
            ctas = tiles * plan.splits
            assert ctas <= max(tiles, sms)
            if tiles < sms and kt >= sk.GEMM_MIN_SPLIT_KTILES * (sms // tiles):
                assert ctas > sms - tiles
            if (m, n) == (333, 256) and k >= 5142:
                assert plan.splits > 1


def test_gemm_plan_rejects_unknown_kind():
    with pytest.raises(ValueError):
        sk.gemm_plan(333, 256, 512, 132, "fp8")


def test_tma_ready_operands():
    """TMA reads 16-byte-aligned bases and row strides: a 5142-wide bf16
    carry is not (10,284-byte rows), its padded view is, and so is a
    [h | skip] half of the decoder buffer; a view one element in is not."""
    carry = torch.zeros(333, 5142, dtype=torch.bfloat16)
    padded = torch.zeros(333, sk.pad16(5142), dtype=torch.bfloat16)[:, :5142]
    cat = torch.zeros(333, 768, dtype=torch.bfloat16)
    assert not sk.tma_ready(carry)
    assert sk.tma_ready(padded) and sk.tma_ready(cat[:, 256:]) and sk.tma_ready(cat[:, :256])
    assert not sk.tma_ready(cat[:, 1:257])
    assert sk.tma_ready(torch.zeros(333, sk.pad16(5142))[:, :5142])


def test_gemm_takes_a_row_strided_weight():
    """B may be a row-strided view (the padded W_out): the same result as
    the contiguous weight."""
    rng = np.random.default_rng(7)
    a = _bf16(rng, (9, 32))
    w = _bf16(rng, (32, 50))
    padded = torch.zeros(32, sk.pad16(50), dtype=torch.bfloat16)
    padded[:, :50] = w
    assert torch.equal(sk.gemm_bf16_f32acc(a, padded[:, :50]), sk.gemm_bf16_f32acc(a, w))


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    a = torch.zeros(4, 8, dtype=torch.bfloat16, device="meta")
    b = torch.zeros(8, 4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device"):
        sk.gemm_bf16_f32acc(a, b)
    with pytest.raises(ValueError, match="device"):
        sk.gemm_bf16_f32acc(torch.zeros(4, 8, dtype=torch.bfloat16), b)


# ----------------------------------------------------------------------
# K2
# ----------------------------------------------------------------------
@pytest.mark.parametrize("features", [128, 256, 512])
def test_groupnorm_plain_matches_jax_f32_mode(features):
    """The "f32" gn_mode of the TPU kernel (group-membership matmuls,
    clamped var, eps 1e-6) then SiLU: the same f32 statistics, 1e-5."""
    rng = np.random.default_rng(features)
    h = (3.0 * rng.standard_normal((21, features)) + 1.0).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(features)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(features)).astype(np.float32)
    g, gt = jax_fs._group_mats(features, "f32")
    ref = jax.nn.silu(jax_fs._groupnorm(jnp.asarray(h), g, gt, scale[None], bias[None],
                                        features // 8, "f32"))
    got = sk.groupnorm8_silu_plain(torch.from_numpy(h), torch.from_numpy(scale),
                                   torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    out = sk.groupnorm8_silu(torch.from_numpy(h), torch.from_numpy(scale), torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, got.to(torch.bfloat16))


def test_groupnorm_constant_group_is_finite():
    """A constant group has var 0 (clamped, never negative): finite."""
    h = torch.full((3, 64), 7.0)
    out = sk.groupnorm8_silu(h, torch.ones(64), torch.zeros(64))
    assert torch.isfinite(out.float()).all()


# ----------------------------------------------------------------------
# K3
# ----------------------------------------------------------------------
def _posterior_inputs(seed=0, b=9, d=70, steps=4):
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy((20 * rng.standard_normal((b, d))).astype(np.float32))
    x = _bf16(rng, (b, d))
    b_out = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (steps, 6)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, b, d)).astype(np.float32))
    return acc, x, b_out, coeffs, noise


@pytest.mark.parametrize("mode", ["none", "buffer", "philox"])
def test_posterior_step_plain_matches_formula(mode):
    """The TPU kernel's st_out/st_post algebra in numpy float64, then one
    bf16 rounding: equal up to one bf16 rounding step (2^-7 relative)."""
    acc, x, b_out, coeffs, noise = _posterior_inputs()
    step = 2
    c0, c1, sv, g = (float(v) for v in coeffs[step, :4])
    xf = x.double().numpy()
    x0 = np.clip(acc.double().numpy() + b_out.double().numpy() + g * xf, -30, 30)
    ref = c0 * x0 + c1 * xf
    if mode == "buffer":
        ref = ref + sv * noise[step].double().numpy()
    elif mode == "philox":
        ref = ref + sv * sk.philox_uniform_noise(5, step, *x.shape).double().numpy()
    out = sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, step, mode, noise=noise, seed=5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.double().numpy(), ref, rtol=2 ** -7, atol=1e-6)


def test_posterior_step_clips_and_updates_in_place():
    acc, x, b_out, _, _ = _posterior_inputs()
    coeffs = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    out = sk.x0_posterior_step(acc, x, b_out, coeffs, 0, "none")
    assert out is x
    assert float(x.float().abs().max()) == 30.0


@pytest.mark.parametrize("mut_dim", [0, 12])
def test_posterior_step_on_row_strided_views(mut_dim):
    """acc and the carry as views into padded rows (the sampler's layout):
    the same carry as on contiguous tensors, the padding untouched."""
    acc, x, b_out, coeffs, noise = _posterior_inputs()
    b, d = x.shape
    acc_pad = torch.full((b, sk.pad16(d)), 7.0)
    x_pad = torch.full((b, sk.pad16(d)), 3.0).to(torch.bfloat16)
    acc_pad[:, :d] = acc
    x_pad[:, :d] = x
    for mode in ("none", "buffer", "philox"):
        want = sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, 1, mode, noise=noise, seed=4,
                                    mut_dim=mut_dim)
        xv = x_pad.clone()
        got = sk.x0_posterior_step(acc_pad[:, :d], xv[:, :d], b_out, coeffs, 1, mode,
                                   noise=noise, seed=4, mut_dim=mut_dim)
        assert got.stride(0) == sk.pad16(d)
        assert torch.equal(got, want)
        assert torch.equal(xv[:, d:], x_pad[:, d:])


def test_posterior_step_checks_arguments():
    acc, x, b_out, coeffs, noise = _posterior_inputs()
    with pytest.raises(ValueError):
        sk.x0_posterior_step(acc, x, b_out, coeffs, 0, "gaussian")
    with pytest.raises(IndexError):
        sk.x0_posterior_step(acc, x, b_out, coeffs, 4, "none")
    with pytest.raises(ValueError):
        sk.x0_posterior_step(acc, x, b_out, coeffs, 0, "buffer", noise=noise[:2])


# ----------------------------------------------------------------------
# K4
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,m,d", [(20, 30, 50), (7, 130, 300)])
def test_rbf_kernel_sum_plain_matches_pallas_interpret(n, m, d):
    """The Pallas kernel in interpret mode computes in f32 with HIGHEST
    dots; the plain version in f64: 1e-5 relative on the sum."""
    rng = np.random.default_rng(n * m)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (1.1 * rng.standard_normal((m, d)) + 0.1).astype(np.float32)
    gamma = 1.0 / d
    ref = float(jax_rbf_kernel_sum(jnp.asarray(x), jnp.asarray(y), gamma, interpret=True))
    got = pk.rbf_kernel_sum(torch.from_numpy(x), torch.from_numpy(y), gamma)
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)


def test_mmd_matches_jax_stats():
    """MMD on two cohorts (f32 JAX vs f64 port): 1e-5 absolute."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 60)).astype(np.float32)
    y = (rng.standard_normal((55, 60)) * 1.2 + 0.2).astype(np.float32)
    ref = float(jax_mmd_rbf(jnp.asarray(x), jnp.asarray(y)))
    got = pk.mmd_rbf(torch.from_numpy(x), torch.from_numpy(y))
    assert ref > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-5)
