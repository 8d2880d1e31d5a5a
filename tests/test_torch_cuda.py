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


def _padded(rows, cols, dtype, device, extra=0):
    """A (rows, cols) view of a buffer with rows of pad16(cols) + extra."""
    return torch.zeros(rows, sk.pad16(cols) + extra, dtype=dtype, device=device)[:, :cols]


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


# ----------------------------------------------------------------------
# The D3PM modes of K1 and K3, and the int8 kernels K5 and K6
# ----------------------------------------------------------------------
def _bits_and_values(rng, m, d, mut):
    x = _bf16(rng, (m, d))
    x[:, :mut] = torch.from_numpy((rng.uniform(size=(m, mut)) < 0.5).astype(np.float32))
    return x


@pytest.mark.cuda
def test_cuda_gemm_mut_prologue_matches_plain(cuda):
    # The input product with the 2b - 1 prologue on 62 columns; one bf16
    # rounding of sums that differ in f32 order: 2^-7 of max(1, |ref|).
    # The carry's layout on the path: rows padded to 5152 (TMA-readable).
    rng = np.random.default_rng(2)
    a = _padded(333, 5142, torch.bfloat16, cuda)
    a.copy_(_bits_and_values(rng, 333, 5142, 62).to(cuda))
    before = a.clone()
    b = _bf16(rng, (5142, 256), 1 / math.sqrt(5142)).to(cuda)
    bias = torch.randn(256, device=cuda)
    out = torch.empty(333, 256, dtype=torch.bfloat16, device=cuda)
    launches = sk.GEMM.modes["mut_prologue"]
    got = sk.gemm_bf16_f32acc(a, b, out=out, bias=bias, a_mut_cols=62).float()
    assert sk.GEMM.modes["mut_prologue"] == launches + 1
    ref = sk.gemm_bf16_f32acc_plain(a, b, bias, a_mut_cols=62).to(torch.bfloat16).float()
    assert float((got - ref).abs().max()) <= 2 ** -7 * max(1.0, float(ref.abs().max()))
    assert torch.equal(a, before)


@pytest.mark.cuda
def test_cuda_posterior_d3pm_matches_plain(cuda):
    # Continuous columns within one bf16 rounding; bits: the kernel writes
    # the plain version's operations with _rn intrinsics, so at most a
    # 1e-4 share may differ (an expf ulp at a threshold).
    acc, x, b_out, coeffs, noise = (t.to(cuda) for t in _posterior_inputs(333, 5142))
    x[:, :62] = (torch.rand(333, 62, device=cuda) < 0.5).to(torch.bfloat16)
    coeffs[:, 4:] = torch.tensor([0.05, 0.7], device=cuda)
    for mode in ("none", "buffer", "philox"):
        ref = sk.x0_posterior_step_plain(acc, x, b_out, coeffs, 1, mode, noise, seed=3, mut_dim=62)
        got = sk.x0_posterior_step(acc, x.clone(), b_out, coeffs, 1, mode, noise=noise, seed=3,
                                   mut_dim=62)
        bits = got[:, :62].float()
        assert set(torch.unique(bits).tolist()) <= {0.0, 1.0}
        assert float((bits != ref[:, :62].float()).float().mean()) <= 1e-4
        cont, cref = got[:, 62:].float(), ref[:, 62:].float()
        assert float((cont - cref).abs().max()) <= 2 ** -7 * max(1.0, float(cref.abs().max()))


@pytest.mark.cuda
def test_cuda_rowquant_matches_plain(cuda):
    # Codes and scales equal: the same f32 operations, rint half to even.
    rng = np.random.default_rng(3)
    x = _bits_and_values(rng, 333, 5142, 62).to(cuda)
    wide = _bf16(rng, (333, 1024), 3.0).to(cuda)
    for a, mut in ((x, 62), (wide[:, 512:], 0), (wide[:, :256].float(), 0)):
        q, scale = sk.rowquant_s8(a, mut_cols=mut)
        rq, rs = sk.rowquant_s8_plain(a, mut)
        assert torch.equal(q, rq) and torch.equal(scale, rs)


@pytest.mark.cuda
def test_cuda_gemm_s8_matches_plain(cuda):
    # Exact int32 sums, then the plain version's f32 operations in its
    # order: equal up to one f32 rounding of the largest value.
    rng = np.random.default_rng(4)
    for m, k, n, out_dtype, acc in ((333, 5142, 256, torch.bfloat16, False),
                                    (333, 512, 256, torch.float32, True),
                                    (333, 256, 5142, torch.float32, False)):
        qa, rs = sk.rowquant_s8_plain(_bf16(rng, (m, k)).to(cuda))
        q, cs = sk.pack_int8(rng.standard_normal((k, n)).astype(np.float32))
        qb, cs = sk.kmajor_int8(q).to(cuda), cs.to(cuda)
        bias = torch.randn(n, device=cuda)
        start = torch.randn(m, n, device=cuda)
        out = start.clone() if acc else torch.empty(m, n, dtype=out_dtype, device=cuda)
        got = sk.gemm_s8(qa, rs, qb, cs, out=out, bias=bias, accumulate=acc).float()
        ref = sk.gemm_s8_plain(qa, rs, qb, cs, bias, acc_into=start if acc else None)
        ref = ref.to(out_dtype).float()
        assert float((got - ref).abs().max()) <= 2 ** -23 * max(1.0, float(ref.abs().max()))


# ----------------------------------------------------------------------
# The sm90 mainloop: ragged shapes, strided views, split-K
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 256), (17, 62, 24), (17, 5142, 256), (333, 5152, 256),
                                   (999, 256, 5142), (70, 200, 130)])
@pytest.mark.parametrize("layout", ["padded", "contiguous", "offset"])
def test_cuda_gemm_ragged_and_strided(cuda, m, k, n, layout):
    # Ragged M, N and K through TMA where the operands allow it, else the
    # general path; bf16 and f32 outputs into padded views. Tolerances as
    # in chip_smoke.py: 1e-3 (f32) and 2^-7 (bf16) of max(1, |ref|).
    rng = np.random.default_rng(m + k + n)
    fill = lambda r, c, sc=1.0: _bf16(rng, (r, c), sc).to(cuda)  # noqa: E731
    if layout == "padded":
        a = _padded(m, k, torch.bfloat16, cuda)
    elif layout == "contiguous":
        a = torch.empty(m, k, dtype=torch.bfloat16, device=cuda)
    else:  # one element in: never 16-byte aligned
        a = torch.zeros(m, k + 1, dtype=torch.bfloat16, device=cuda)[:, 1:]
    a.copy_(fill(m, k))
    b = _padded(k, n, torch.bfloat16, cuda)
    b.copy_(fill(k, n, 1 / math.sqrt(k)))
    bias = torch.randn(n, device=cuda)
    row_add = torch.randn(m, n, device=cuda)
    mode = "bf16" if sk.tma_ready(a) and sk.tma_ready(b) else "unaligned"
    for out_dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2 ** -7)):
        buf = torch.zeros(m, sk.pad16(n) + 8, dtype=out_dtype, device=cuda)
        out = buf[:, :n]
        before = sk.GEMM.modes[mode]
        sk.gemm_bf16_f32acc(a, b, out=out, bias=bias, row_add=row_add)
        assert sk.GEMM.modes[mode] == before + 1
        ref = sk.gemm_bf16_f32acc_plain(a, b, bias, row_add).to(out_dtype).float()
        assert float((out.float() - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
        assert not buf[:, n:].any()  # the padding is never written


@pytest.mark.cuda
@pytest.mark.parametrize("mut", [62, 100])
def test_cuda_gemm_prologue_inside_a_split(cuda, mut):
    # The 2b - 1 prologue with K split: 62 bits fall in k-tile 0 (the first
    # split's), 100 bits also in k-tile 1, which a 40-way split gives to the
    # second split. Every plan equals the plain version within one bf16
    # rounding, and the carry is not changed.
    rng = np.random.default_rng(8)
    a = _padded(333, 5142, torch.bfloat16, cuda)
    a.copy_(_bits_and_values(rng, 333, 5142, mut).to(cuda))
    before = a.clone()
    b = _bf16(rng, (5142, 256), 1 / math.sqrt(5142)).to(cuda)
    ref = sk.gemm_bf16_f32acc_plain(a, b, a_mut_cols=mut).to(torch.bfloat16).float()
    for plan in (sk.GemmPlan(64, 64, 1), sk.GemmPlan(64, 64, 5), sk.GemmPlan(64, 128, 40),
                 sk.GemmPlan(64, 256, 3), None):
        out = torch.empty(333, 256, dtype=torch.bfloat16, device=cuda)
        sk.gemm_bf16_f32acc(a, b, out=out, a_mut_cols=mut, plan=plan)
        assert float((out.float() - ref).abs().max()) <= 2 ** -7 * max(1.0, float(ref.abs().max()))
    assert torch.equal(a, before)


@pytest.mark.cuda
def test_cuda_split_k_is_deterministic(cuda):
    # Split-K sums its partials in split order: repeated launches give the
    # same bits (K1, f32), and int8 splits equal the unsplit product exactly.
    rng = np.random.default_rng(9)
    a = _padded(333, 5142, torch.bfloat16, cuda)
    a.copy_(_bf16(rng, (333, 5142)).to(cuda))
    b = _bf16(rng, (5142, 256), 1 / math.sqrt(5142)).to(cuda)
    plan = sk.GemmPlan(64, 64, 7)
    first = sk.gemm_bf16_f32acc(a, b, plan=plan)
    for _ in range(3):
        assert torch.equal(sk.gemm_bf16_f32acc(a, b, plan=plan), first)
    qa, rs = sk.rowquant_s8_plain(a)
    q, cs = sk.pack_int8(rng.standard_normal((5142, 256)).astype(np.float32))
    qb, cs = sk.kmajor_int8(q).to(cuda), cs.to(cuda)
    whole = sk.gemm_s8(qa, rs, qb, cs, plan=sk.GemmPlan(64, 64, 1))
    for splits in (2, 5, 41):
        assert torch.equal(sk.gemm_s8(qa, rs, qb, cs, plan=sk.GemmPlan(64, 128, splits)), whole)
    assert torch.equal(whole, sk.gemm_s8_plain(qa, rs, qb, cs))


# ----------------------------------------------------------------------
# K7 (the latent tail's step) and K8 (the standalone posterior update)
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_latent_step_matches_plain(cuda):
    # The _rn intrinsics in the plain version's order: s, H_acc, xi and the
    # Philox zeta equal the plain version's f32 results; the bf16 outputs
    # are one rounding of equal f32 values.
    rng = np.random.default_rng(5)
    m, h, n_lat = 333, 256, 4
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (n_lat, 5)).astype(np.float32)).to(cuda)
    hid = f(m, h).bfloat16()
    zeta = f(n_lat, m, h)
    for mode in ("philox", "buffer"):
        hacc, xi = f(m, h), f(m, h)
        ref_z, ref_xi, ref_hacc = sk.latent_draw_plain(hid, hacc, xi, coeffs, 2, mode, zeta, 9)
        zbf = torch.empty(m, h, dtype=torch.bfloat16, device=cuda)
        before = sk.LATENT.modes[f"draw_{mode}"]
        sk.latent_draw(hid, hacc, xi, zbf, coeffs, 2, mode, zeta=zeta, seed=9)
        assert sk.LATENT.modes[f"draw_{mode}"] == before + 1
        assert torch.equal(zbf, ref_z) and torch.equal(xi, ref_xi) and torch.equal(hacc, ref_hacc)
    s, o_lat, n_inj, c_proj, t_add = f(m, h), f(m, h), f(m, h), f(m, h), f(n_lat + 1, h)
    ref_s, ref_h = sk.latent_update_plain(s, o_lat, n_inj, c_proj, t_add, coeffs, 3)
    h_in = torch.empty(m, h, dtype=torch.bfloat16, device=cuda)
    sk.latent_update(s, o_lat, n_inj, c_proj, t_add, coeffs, 3, h_in)
    assert torch.equal(s, ref_s) and torch.equal(h_in, ref_h)


@pytest.mark.cuda
def test_cuda_posterior_update_matches_plain(cuda):
    # The affine part with _rn intrinsics; z through logf/sqrtf/cosf, within
    # a few f32 ulps of the plain version's: 2^-19 of max(1, |ref|).
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((333, 5142)).astype(np.float32)).to(cuda)
    pred = torch.from_numpy((40 * rng.standard_normal((333, 5142))).astype(np.float32)).to(cuda)
    for add_noise in (1.0, 0.0):
        coefs = (0.3, 0.6, 0.8, add_noise, 30.0)
        ref = pk.posterior_update_plain(x, pred, 21, *coefs)
        got = pk.posterior_update(x, pred, 21, *coefs)
        traced = pk.posterior_update_traced(x, pred, torch.tensor(coefs, device=cuda), 21)
        tol = 2 ** -19 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol
        assert torch.equal(got, traced)
    z = pk.posterior_update(torch.zeros_like(x), torch.zeros_like(x), 4, 0.0, 0.0, 1.0, 1.0)
    assert abs(float(z.mean())) < 0.005 and abs(float(z.std()) - 1.0) < 0.005
    # The plain noise is a function of (seed, row, col) with no grid: the
    # kernel's matching it shows its noise does not depend on its tiling.
    plain_z = pk.gaussian_noise(4, *x.shape, device=cuda)
    assert float((z - plain_z).abs().max()) <= 2 ** -19 * max(1.0, float(plain_z.abs().max()))
