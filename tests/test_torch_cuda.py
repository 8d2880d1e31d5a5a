"""The port's kernels against their plain versions, and its trainer, on
an NVIDIA card.

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
@pytest.mark.parametrize("n,m", [(100, 100), (999, 999), (100, 999), (9999, 9999), (100, 9999)])
def test_cuda_rbf_kernel_sum_matches_plain(cuda, n, m):
    # The validator's shapes and the production MMD's (100 real rows, 9999
    # synthetic): equal bits twice, 1e-5 relative of the f64 plain version
    # (f32 FMA dots against f64).
    g = torch.Generator(cuda).manual_seed(n + m)
    x = torch.randn(n, 5142, device=cuda, generator=g)
    y = x if n == m else torch.randn(m, 5142, device=cuda, generator=g) * 1.05 + 0.02
    got = float(pk.rbf_kernel_sum(x, y, 1 / 5142))
    assert got == float(pk.rbf_kernel_sum(x, y, 1 / 5142))  # run to run
    ref = float(pk.rbf_kernel_sum_plain(x, y, 1 / 5142))
    assert abs(got - ref) <= 1e-5 * abs(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("splits", [1, 2, 7, 30])
@pytest.mark.parametrize("d", [5142, 1037, 1000])
def test_cuda_rbf_kernel_sum_forced_plans(cuda, bm, splits, d):
    # Every tile under forced split counts, with d a multiple of 4 (16-byte
    # copies), even (8-byte) and odd (4-byte), and n below one tile.
    g = torch.Generator(cuda).manual_seed(d + splits)
    x = torch.randn(37, d, device=cuda, generator=g)
    y = torch.randn(300, d, device=cuda, generator=g) * 1.1
    ref = float(pk.rbf_kernel_sum_plain(x, y, 1 / d))
    plan = pk.RbfPlan(bm, splits)
    got = float(pk.rbf_kernel_sum(x, y, 1 / d, plan=plan))
    assert got == float(pk.rbf_kernel_sum(x, y, 1 / d, plan=plan))
    assert abs(got - ref) <= 1e-5 * abs(ref), (plan, got, ref)


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
    # the plain version's operations with _rn intrinsics but for the
    # sigmoid's fast divide, so at most a 1e-4 share may differ (an ulp of
    # expf or of the divide at a threshold).
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
@pytest.mark.parametrize("rows", [333, 32768])
def test_cuda_rowquant_input_product_matches_plain(cuda, rows):
    # The input product's K5: the padded 5142-wide carry (row stride 5152)
    # with 2b - 1 on 62 bit columns, at the sampler's 333 rows and bench.py's
    # 32,768; and a contiguous f32 row of an odd width (element loads).
    g = torch.Generator(cuda).manual_seed(rows)
    carry = _padded(rows, 5142, torch.bfloat16, cuda)
    carry.copy_(torch.randn(rows, 5142, device=cuda, generator=g))
    carry[:, :62] = (torch.rand(rows, 62, device=cuda, generator=g) < 0.5).to(torch.bfloat16)
    odd = 3.0 * torch.randn(rows, 1037, device=cuda, generator=g)
    for a, mut in ((carry, 62), (odd, 0)):
        q, scale = sk.rowquant_s8(a, mut_cols=mut)
        rq, rs = sk.rowquant_s8_plain(a, mut)
        assert torch.equal(q, rq) and torch.equal(scale, rs)


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


def _latent_segment(rng, m, h, n_lat, cuda):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    ops = dict(m2=(f(h, h) / math.sqrt(h)).bfloat16(), m_b=f(h),
               l_t=(f(h, h) / math.sqrt(h)).bfloat16(), c_proj=f(m, h), t_add=f(n_lat + 1, h),
               coeffs=torch.from_numpy(rng.uniform(0.1, 1.0, (n_lat, 5)).astype(np.float32)).to(cuda),
               zeta=f(n_lat, m, h))
    hs = [(2.0 * f(m, h)).bfloat16() for _ in range(n_lat)]  # each step's stack output
    return ops, hs, f(m, h)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [333, 999])
@pytest.mark.parametrize("mode", ["philox", "buffer"])
@pytest.mark.parametrize("splits", [1, 2])
def test_cuda_latent_step_fused_equals_the_composition(cuda, m, mode, splits):
    # Three latent steps (the last draws nothing) at the sampler's width:
    # one fused launch a step, after the priming draw, against K1 -> K7
    # draw -> K1 -> K7 update with the same plan: s, h_in, H_acc and the
    # next zeta equal bit for bit at every step, xi after the last, split-K
    # on and off. Against the
    # plain composition (cuBLAS f32 products in another order): s, H_acc
    # and xi within 1e-3 of max(1, |ref|), h_in within one bf16 rounding.
    rng = np.random.default_rng(m + splits + len(mode))
    h, n_lat = 256, 3
    ops, hs, s0 = _latent_segment(rng, m, h, n_lat, cuda)
    plan = sk.GemmPlan(64, 64, splits)
    cf, t_add, c_proj = ops["coeffs"], ops["t_add"], ops["c_proj"]
    bf = lambda: torch.empty(m, h, dtype=torch.bfloat16, device=cuda)  # noqa: E731

    s_a, hin_a, acc_a, xi_a, z_a = s0.clone(), bf(), torch.zeros(m, h, device=cuda), \
        torch.zeros(m, h, device=cuda), bf()
    o_lat, n_inj = torch.empty(m, h, device=cuda), torch.empty(m, h, device=cuda)
    s_b, hin_b, acc_b, xi_b, zb = s0.clone(), bf(), torch.zeros(m, h, device=cuda), \
        torch.zeros(m, h, device=cuda), [bf(), bf()]
    s_p, acc_p, xi_p = s0.clone(), torch.zeros(m, h, device=cuda), torch.zeros(m, h, device=cuda)
    zp = sk.latent_draw_plain(None, None, xi_p, cf, 0, mode, ops["zeta"], 11)
    zp, xi_p = zp[0], zp[1]
    sk.latent_draw(None, None, xi_b, zb[0], cf, 0, mode, zeta=ops["zeta"], seed=11)
    for k in range(n_lat):
        sk.gemm_bf16_f32acc(hs[k], ops["m2"], out=o_lat, bias=ops["m_b"], plan=plan)
        sk.latent_draw(hs[k], acc_a, xi_a, z_a, cf, k, mode, zeta=ops["zeta"], seed=11)
        sk.gemm_bf16_f32acc(z_a, ops["l_t"], out=n_inj, plan=plan)
        sk.latent_update(s_a, o_lat, n_inj, c_proj, t_add, cf, k, hin_a)
        before = sk.GEMM_LATENT.modes[mode]
        sk.gemm_bf16_latent_step(hs[k], ops["m2"], ops["m_b"], zb[k % 2], ops["l_t"], s_b, c_proj,
                                 t_add, cf, k, hin_b, acc_b, xi_b, zb[(k + 1) % 2], mode,
                                 zeta=ops["zeta"], seed=11, plan=plan)
        assert sk.GEMM_LATENT.modes[mode] == before + 1
        s_p, hin_p, acc_p, xi_p, zn = sk.gemm_bf16_latent_step_plain(
            hs[k], ops["m2"], ops["m_b"], zp, ops["l_t"], s_p, c_proj, t_add, cf, k, acc_p, xi_p,
            mode, ops["zeta"], 11)
        torch.cuda.synchronize()
        # xi: the fused launch of step k has already added v_{k+1}·zeta_{k+1}
        # (drawn one step on), so the two routes meet after the last step.
        for name, a, b in (("s", s_a, s_b), ("h_in", hin_a, hin_b), ("h_acc", acc_a, acc_b)) + (
                (("xi", xi_a, xi_b),) if k == n_lat - 1 else ()):
            assert torch.equal(a, b), (name, k)
        if k + 1 < n_lat:
            zp = zn
            z_next = sk.latent_draw_plain(None, None, torch.zeros(m, h, device=cuda), cf, k + 1,
                                          mode, ops["zeta"], 11)[0]
            assert torch.equal(zb[(k + 1) % 2], z_next), k
        for name, got, ref in (("s", s_b, s_p), ("h_acc", acc_b, acc_p), ("xi", xi_b, xi_p)):
            assert float((got - ref).abs().max()) <= 1e-3 * max(1.0, float(ref.abs().max())), name
        tol = 2 ** -7 * max(1.0, float(hin_p.float().abs().max()))
        assert float((hin_b.float() - hin_p.float()).abs().max()) <= tol
    with pytest.raises(ValueError):  # the buffer the launch reads cannot take the next draw
        sk.gemm_bf16_latent_step(hs[0], ops["m2"], ops["m_b"], zb[0], ops["l_t"], s_b, c_proj,
                                 t_add, cf, 0, hin_b, acc_b, xi_b, zb[0], mode, zeta=ops["zeta"])


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(7, 5), (3, 257), (333, 5142)])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_posterior_update_quads_and_tails(cuda, rows, cols, offset):
    # K8 takes four elements a Philox call: sizes that end inside a quad
    # (7 x 5, 3 x 257) and bases that are not 16-byte aligned (a view one
    # float into its buffer: the scalar path) give the plain noise at the
    # same flat index, static equal to traced, with and without noise.
    rng = np.random.default_rng(rows + cols + offset)
    n = rows * cols
    bx = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(cuda)
    bp = torch.from_numpy((40 * rng.standard_normal(n + 1)).astype(np.float32)).to(cuda)
    x, pred = bx[offset:offset + n].view(rows, cols), bp[offset:offset + n].view(rows, cols)
    for add_noise in (1.0, 0.0):
        coefs = (0.3, 0.6, 0.8, add_noise, 30.0)
        before = pk.POSTERIOR_UPDATE.modes["static"]
        got = pk.posterior_update(x, pred, 9, *coefs)
        assert pk.POSTERIOR_UPDATE.modes["static"] == before + 1
        traced = pk.posterior_update_traced(x, pred, torch.tensor(coefs, device=cuda), 9)
        ref = pk.posterior_update_plain(x, pred, 9, *coefs)
        torch.cuda.synchronize()
        assert torch.equal(got, traced)
        assert float((got - ref).abs().max()) <= 2 ** -19 * max(1.0, float(ref.abs().max()))
    zeros = torch.zeros(rows, cols, device=cuda)
    z = pk.posterior_update(zeros, zeros, 9, 0.0, 0.0, 1.0, 1.0)
    plain_z = pk.gaussian_noise(9, rows, cols, device=cuda)
    assert float((z - plain_z).abs().max()) <= 2 ** -19 * max(1.0, float(plain_z.abs().max()))


# ----------------------------------------------------------------------
# K2's and K3's work as epilogues of K1 and K6
# ----------------------------------------------------------------------
def _int8_operands(rng, a, n, cuda):
    qa, rs = sk.rowquant_s8_plain(a)
    q, cs = sk.pack_int8(rng.standard_normal((a.shape[1], n)).astype(np.float32) / math.sqrt(n))
    return qa, rs, sk.kmajor_int8(q).to(cuda), cs.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("k,f", [(256, 512), (512, 256), (768, 256), (1024, 64)])
@pytest.mark.parametrize("splits", [1, 2])
def test_cuda_gn_epilogue_matches_plain(cuda, kind, k, f, splits):
    # GroupNorm(8)+SiLU in the product's epilogue, split and unsplit, at
    # every width that holds whole groups, into the h half of a [h | skip]
    # buffer; int8 at K = 768 as the decoder's two-part fc1 (512 + 256).
    # K2's tolerance: f32 statistics in another order can move a value
    # across one bf16 rounding, 2^-7 of max(1, |ref|).
    rng = np.random.default_rng(k + f + splits)
    m = 333
    a = _bf16(rng, (m, k), 3.0).to(cuda)
    bias = torch.randn(f, device=cuda)
    scale = 1.0 + 0.1 * torch.randn(f, device=cuda)
    shift = 0.1 * torch.randn(f, device=cuda)
    buf = torch.zeros(m, f + 256, dtype=torch.bfloat16, device=cuda)
    out = buf[:, :f]
    for bn in sk.gn_widths(f):
        plan = sk.GemmPlan(64, bn, splits)
        if kind == "bf16":
            w = _bf16(rng, (k, f), 1 / math.sqrt(k)).to(cuda)
            before = sk.GEMM_GN.launches
            sk.gemm_bf16_gn_silu(a, w, bias, scale, shift, out=out, plan=plan)
            assert sk.GEMM_GN.launches == before + 1
            v = sk.gemm_bf16_f32acc_plain(a, w, bias)
        else:
            cuts = [(0, 512), (512, 768)] if k == 768 else [(0, k)]
            parts = [_int8_operands(rng, a[:, lo:hi], f, cuda) for lo, hi in cuts]
            pre = torch.randn(m, f, device=cuda) if len(parts) > 1 else None
            if pre is not None:
                sk.gemm_s8(*parts[0], out=pre)
            sk.gemm_s8_gn_silu(*parts[-1], bias, scale, shift, out=out, acc_into=pre, plan=plan)
            v = sk.gemm_s8_plain(*parts[-1], bias, acc_into=pre)
        ref = sk.groupnorm8_silu_plain(v, scale, shift).to(torch.bfloat16).float()
        tol = 2 ** -7 * max(1.0, float(ref.abs().max()))
        assert float((out.float() - ref).abs().max()) <= tol, (bn, splits)
        assert not buf[:, f:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["philox", "buffer", "none"])
@pytest.mark.parametrize("mut,binary", [(0, True), (62, True), (62, False)])
def test_cuda_posterior_epilogue_equals_the_pair(cuda, kind, mode, mut, binary):
    # The output product with K3 in its epilogue against K1 (K6) into the
    # padded f32 acc, then K3, with the same plan: the carry gets the same
    # bits, D3PM bits included, at every width the epilogue is built for;
    # also where the bit columns hold values other than 0 and 1 (the
    # epilogue's general path for a block's bits).
    rng = np.random.default_rng(len(mode) + mut + binary)
    m, k, d = 333, 256, 5142
    h = _bf16(rng, (m, k), 2.0).to(cuda)
    start = _padded(m, d, torch.bfloat16, cuda)
    start.copy_((_bits_and_values(rng, m, d, mut) if binary else _bf16(rng, (m, d))).to(cuda))
    b_out = torch.randn(d, device=cuda)
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (4, 6)).astype(np.float32)).to(cuda)
    coeffs[:, 4:] = torch.tensor([0.05, 0.7], device=cuda)
    noise = torch.randn(4, m, d, device=cuda)
    step = dict(b_out=b_out, coeffs=coeffs, step=1, mode=mode, noise=noise, seed=3,
                mut_dim=mut)
    if kind == "bf16":
        w = _padded(k, d, torch.bfloat16, cuda)
        w.copy_(_bf16(rng, (k, d), 1 / math.sqrt(k)).to(cuda))
    else:
        ops = _int8_operands(rng, h, d, cuda)
    for bn in sk.POSTERIOR_WIDTHS:
        plan = sk.GemmPlan(64, bn, 1)
        acc = _padded(m, d, torch.float32, cuda)
        pair, fused = start.clone(), start.clone()
        if kind == "bf16":
            sk.gemm_bf16_f32acc(h, w, out=acc, plan=plan)
            sk.gemm_bf16_posterior(h, w, fused, **step, plan=plan)
        else:
            sk.gemm_s8(*ops, out=acc, plan=plan)
            sk.gemm_s8_posterior(*ops, fused, **step, plan=plan)
        sk.x0_posterior_step(acc, pair, **step)
        assert torch.equal(fused, pair), bn
        assert not torch.equal(fused, start)


@pytest.mark.cuda
def test_cuda_sampler_step_launches(cuda):
    # One reverse step at the default widths (hidden 256/512/256): 12
    # launches in bf16 and int8 "out" (w_in, 10 fused block products, 1
    # fused output product), 13 under "io", 15 under "all" (K5 and K6 for
    # the input product, the decoders' first fc1 parts); K2 and K3 apart
    # never launch.
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler

    cfg = Config()
    dims = cfg.freeze_dims(10, 40, 14, list(cfg.model.condition_on))
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(cuda)
    kernels = (sk.GEMM, sk.GEMM_GN, sk.GEMM_POSTERIOR, sk.GROUPNORM, sk.POSTERIOR, sk.ROWQUANT,
               sk.GEMM_S8, sk.GEMM_S8_GN, sk.GEMM_S8_POSTERIOR, sk.GEMM_S8Q, sk.GEMM_S8Q_GN,
               sk.GEMM_S8Q_POSTERIOR)
    for quantize, want in ((None, 12), ("out", 12), ("io", 13), ("all", 15)):
        sampler = FusedSampler(model, cuda, quantize=quantize)
        cond = torch.zeros(7, dims.condition_dim)
        sampler.sample(cond, torch.Generator(cuda).manual_seed(0), stop_after=1)  # warm
        before = [k.launches for k in kernels]
        x = sampler.sample(cond, torch.Generator(cuda).manual_seed(0), stop_after=1)
        torch.cuda.synchronize()
        delta = {k.name: k.launches - b for k, b in zip(kernels, before)}
        assert sum(delta.values()) == want, (quantize, delta)
        assert delta["groupnorm8_silu"] == delta["x0_posterior_step"] == 0
        assert delta["rowquant_s8"] == (quantize in ("io", "all"))  # the input product's only
        assert bool(torch.isfinite(x).all())


# ----------------------------------------------------------------------
# K5's work as K6's prologue
# ----------------------------------------------------------------------
def _skip_view(rng, m, k, cuda):
    buf = torch.zeros(m, 256 + k, dtype=torch.bfloat16, device=cuda)
    view = buf[:, 256:]
    view.copy_(_bf16(rng, (m, k), 3.0).to(cuda))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["plain", "plain_bf16", "accumulate", "gn", "gn_accumulate"])
@pytest.mark.parametrize("k", [256, 512])
@pytest.mark.parametrize("splits", [1, 2])
def test_cuda_quant_prologue_equals_k5_then_k6(cuda, epilogue, k, splits):
    # K6 quantizing its own A (a [h | skip] view, 333 rows) against K5 then
    # K6 with the same plan: equal bits in every epilogue, split and not.
    rng = np.random.default_rng(k + splits + len(epilogue))
    m, n = 333, 256
    a = _skip_view(rng, m, k, cuda)
    q, cs = sk.pack_int8(rng.standard_normal((k, n)).astype(np.float32) / math.sqrt(k))
    qb, cs = sk.kmajor_int8(q).to(cuda), cs.to(cuda)
    bias = torch.randn(n, device=cuda)
    qa, rs = sk.rowquant_s8(a)
    start = torch.randn(m, n, device=cuda)
    for bn in (sk.gn_widths(n) if epilogue.startswith("gn") else sk.QUANT_WIDTHS):
        plan = sk.GemmPlan(64, bn, splits)
        if epilogue.startswith("gn"):
            scale = 1.0 + 0.1 * torch.randn(n, device=cuda)
            shift = 0.1 * torch.randn(n, device=cuda)
            acc = start if epilogue == "gn_accumulate" else None
            got = sk.gemm_s8q_gn_silu(a, qb, cs, bias, scale, shift, acc_into=acc, plan=plan)
            want = sk.gemm_s8_gn_silu(qa, rs, qb, cs, bias, scale, shift, acc_into=acc, plan=plan)
        else:
            dtype = torch.bfloat16 if epilogue == "plain_bf16" else torch.float32
            accumulate = epilogue == "accumulate"
            got = start.clone() if accumulate else torch.empty(m, n, dtype=dtype, device=cuda)
            want = got.clone()
            before = sk.GEMM_S8Q.launches
            sk.gemm_s8q(a, qb, cs, out=got, bias=bias, accumulate=accumulate, plan=plan)
            assert sk.GEMM_S8Q.launches == before + 1
            sk.gemm_s8(qa, rs, qb, cs, out=want, bias=bias, accumulate=accumulate, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (epilogue, bn, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["philox", "buffer", "none"])
@pytest.mark.parametrize("mut", [0, 62])
@pytest.mark.parametrize("splits", [1, 2])
def test_cuda_quant_prologue_posterior_equals_k5_then_k6(cuda, mode, mut, splits):
    # The output product (333 x 256 . 256 x 5142, padded carry) with the
    # reverse step: the carry through the prologue equals K5 -> K6's.
    rng = np.random.default_rng(len(mode) + mut + splits)
    m, k, d = 333, 256, 5142
    h = _bf16(rng, (m, k), 2.0).to(cuda)
    start = _padded(m, d, torch.bfloat16, cuda)
    start.copy_(_bits_and_values(rng, m, d, mut).to(cuda))
    q, cs = sk.pack_int8(rng.standard_normal((k, d)).astype(np.float32) / math.sqrt(k))
    qb, cs = sk.kmajor_int8(q).to(cuda), cs.to(cuda)
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (4, 6)).astype(np.float32)).to(cuda)
    coeffs[:, 4:] = torch.tensor([0.05, 0.7], device=cuda)
    step = dict(b_out=torch.randn(d, device=cuda), coeffs=coeffs, step=1, mode=mode,
                noise=torch.randn(4, m, d, device=cuda), seed=3, mut_dim=mut)
    plan = sk.GemmPlan(64, 64, splits)
    fused, pair = start.clone(), start.clone()
    sk.gemm_s8q_posterior(h, qb, cs, fused, **step, plan=plan)
    sk.gemm_s8_posterior(*sk.rowquant_s8(h), qb, cs, pair, **step, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(fused, pair) and not torch.equal(fused, start)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize,head", [("out", False), ("io", False), ("all", False),
                                           ("all", True)])
def test_cuda_int8_sampler_carry_equals_the_k5_route(cuda, quantize, head):
    # The default widths at 333 rows, DDPM-5 with buffer noise: the carry
    # with K6 quantizing its own A equals the carry with K5 before every
    # int8 product, bit for bit.
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler

    cfg = Config()
    cfg.model.diffusion.num_steps = 5
    cfg.model.diffusion.discrete_mutation_head = head
    dims = cfg.freeze_dims(62, 5054, 26, list(cfg.model.condition_on))
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(cuda)
    cond = torch.randn(333, dims.condition_dim)
    noise = torch.randn(5, 333, 5142)
    fused = FusedSampler(model, cuda, quantize=quantize)
    apart = FusedSampler(model, cuda, quantize=quantize)
    blocks = apart.encoders + [apart.bottleneck] + apart.decoders
    for w in [apart.w_out] + [b.fc1 for b in blocks] + [b.fc2 for b in blocks]:
        w.prologue = False
    got = fused.sample(cond, torch.Generator(cuda).manual_seed(1), noise=noise)
    want = apart.sample(cond, torch.Generator(cuda).manual_seed(1), noise=noise)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


# ----------------------------------------------------------------------
# The trainer on the card
# ----------------------------------------------------------------------
def _trainer(device, tmp_path, dropout=0.0):
    """A trainer at the CPU tests' size (data 10/40/14, hidden
    128/256/128, T = 20, f32 products, constraints on, lr 1e-3)."""
    from osteosarcoma_diffusionmodel_torch.cli import build_constraint_spec
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays
    from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer

    cfg = Config()
    cfg.model.hidden_dims = [128, 256, 128]
    cfg.model.latent_dim = 32
    cfg.model.compute_dtype = "float32"
    cfg.model.gnn.dropout = dropout
    cfg.model.diffusion.num_steps = 20
    cfg.training.learning_rate = 1e-3
    cfg.training.save_dir = str(tmp_path / str(device))
    cohort = make_dummy_cohort(40, 10, 40, 14)
    data, conditions, dims = cohort_arrays(cohort, cfg)
    arrays = OsteosarcomaArrays(data, conditions, np.zeros(len(data), np.float32),
                                cohort.sample_ids, cohort.mutation_genes,
                                cohort.expression_genes, cohort.pathway_names,
                                dims.condition_names)
    model = ConditionalDiffusion.from_config(cfg, dims, build_constraint_spec(cfg, arrays))
    return Trainer(model, arrays, dims, cfg, device)


@pytest.mark.cuda
def test_cuda_train_step_equals_cpu_step(cuda, tmp_path):
    """One AdamW step from the same seeded weights and the same draws on
    the card and on the CPU (f32 products, TF32 off): the loss within
    rtol 1e-5, the gradient norm within rtol 1e-4, all but 1e-3 of the
    parameters within 2e-6 and every one within 2 lr (Adam's g / (|g| +
    eps) moves a parameter whose gradient is near eps by up to lr)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _trainer("cpu", tmp_path), _trainer(cuda, tmp_path)
    rng = np.random.default_rng(0)
    rows = cpu.epoch_batches(0)[0]
    draws = dict(lam=0.37, perm=rng.permutation(16),
                 pathway_noise=rng.standard_normal((16, 14), np.float32),
                 t=rng.integers(0, 20, 16), noise=rng.standard_normal((16, 64), np.float32))
    out = []
    for tr in (cpu, card):
        kw = {k: v if k == "lam" else torch.as_tensor(v, device=tr.device)
              for k, v in draws.items()}
        idx = torch.as_tensor(rows, device=tr.device)
        out.append(tr.train_step(tr._data[idx], tr._cond[idx], **kw))
    assert float(out[1]["loss"]) == pytest.approx(float(out[0]["loss"]), rel=1e-5)
    assert float(out[1]["grad_norm"]) == pytest.approx(float(out[0]["grad_norm"]), rel=1e-4)
    want, got = cpu.model.denoiser.state_dict(), card.model.denoiser.state_dict()
    diffs = {k: (got[k].cpu() - want[k]).abs() for k in want}
    wide = sum(int((d > 2e-6).sum()) for d in diffs.values())
    assert wide <= 1e-3 * sum(d.numel() for d in diffs.values()), wide
    assert max(float(d.max()) for d in diffs.values()) <= 2e-3


@pytest.mark.cuda
def test_cuda_train_keeps_every_tensor_on_the_card(cuda, tmp_path):
    """Three epochs on the card: parameters, gradients, AdamW's moments
    and step, the cohort copy and the generator stay on the card; the
    checkpoints are written."""
    tr = _trainer(cuda, tmp_path, dropout=0.2)
    tr.config.training.num_epochs = 3
    tr.config.training.save_frequency = 2
    log = tr.train()
    assert len(log.train_loss) == 3 and np.isfinite(log.train_loss + log.val_loss).all()
    on_card = [tr._data, tr._cond, tr._val_idx]
    for p in tr.params:
        on_card += [p, p.grad, *(v for v in tr.optimizer.state[p].values()
                                 if isinstance(v, torch.Tensor))]
    assert all(t.device.type == "cuda" for t in on_card)
    assert tr.generator.device.type == "cuda"
    assert (tmp_path / str(cuda) / "best_model.npz").exists()
    assert (tmp_path / str(cuda) / "checkpoint_epoch_1" / "optimizer.npz").exists()


@pytest.mark.cuda
def test_cuda_second_trainer_on_one_model(cuda, tmp_path):
    """The CLI's STEP 4a on the card: a pre-trainer built after the main
    trainer re-initializes the shared module (moved back to the CPU for the
    CPU generator's draws) to the CPU init's values; after it trains, the
    main trainer's optimizer steps the same parameter objects on the card."""
    from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer

    main = _trainer(cuda, tmp_path)
    init = {k: v.cpu().clone() for k, v in main.module.state_dict().items()}
    main.module.load_state_dict({k: v + 1.0 for k, v in init.items()})
    pre = Trainer(main.model, main.arrays, main.dims, main.config, cuda)
    for k, v in pre.module.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v.cpu(), init[k]), k
    assert [id(p) for p in pre.params] == [id(p) for p in main.params]
    pre.config.training.num_epochs = 1
    pre.train()
    trained = {k: v.clone() for k, v in main.module.state_dict().items()}
    log = main.train()
    assert np.isfinite(log.train_loss).all()
    assert any(not torch.equal(trained[k], v) for k, v in main.module.state_dict().items())


# ----------------------------------------------------------------------
# The device calibration, and the sampler at serving's small batches
# ----------------------------------------------------------------------
def _calibration_case(n, seed=7):
    """The fitted joint target of a two-factor cohort (m 10, 40 continuous
    columns, 200 real rows), its sorted grid, the continuous target, and a
    raw cohort of n rows without ties (so both runs order it alike)."""
    from osteosarcoma_diffusionmodel_torch.ops import copula as C

    rng = np.random.default_rng(seed)
    z = rng.normal(size=(200, 2))
    bits = ((z @ rng.normal(size=(2, 10)) * 1.2 + rng.normal(size=(200, 10))) > 0.3).astype(float)
    cont = z @ rng.normal(size=(2, 40)) + rng.normal(size=(200, 40)) * 0.7
    freq, chol, tetra, _ = C.fit_joint_copula(bits, cont)
    raw = rng.normal(size=(n, 50)).astype(np.float32)
    return (freq, chol, tetra), np.sort(cont, axis=0).astype(np.float32), \
        C.fit_continuous_copula_chol(cont), raw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [30, 300])  # the dual and the primal whitening (D = 50)
def test_cuda_device_calibration_matches_its_cpu_run(cuda, n):
    """The calibrator on the card against the same calibrator on the CPU:
    equal per-gene counts, sorted continuous columns within 1e-4, and (no
    ties in the input) the same cohort up to float rounding: at least 99%
    of the bits and of the continuous values equal within 1e-4."""
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import DeviceCalibrator

    (freq, chol, tetra), sorted_real, cont_chol, raw = _calibration_case(n)
    kw = dict(freq=freq, joint_chol=chol, tetra=tetra, cont_chol=cont_chol)
    cpu = DeviceCalibrator(10, sorted_real, device="cpu", **kw)
    card = DeviceCalibrator(10, sorted_real, device=cuda, **kw)
    with pytest.raises(ValueError):
        card.joint(torch.from_numpy(raw), seed=1)  # a host tensor is refused
    for (b_cpu, c_cpu), (b_card, c_card) in (
            (cpu.joint(torch.from_numpy(raw), 1), card.joint(torch.from_numpy(raw).to(cuda), 1)),
            ((None, cpu.continuous(torch.from_numpy(raw[:, 10:]), 2)),
             (None, card.continuous(torch.from_numpy(raw).to(cuda)[:, 10:], 2)))):
        assert isinstance(c_card, np.ndarray) and c_card.dtype == np.float32
        if b_cpu is not None:
            np.testing.assert_array_equal(b_card.sum(0), b_cpu.sum(0))
            assert float(np.mean(b_card == b_cpu)) >= 0.99
        np.testing.assert_allclose(np.sort(c_card, 0), np.sort(c_cpu, 0), rtol=1e-4, atol=1e-4)
        assert float(np.mean(np.abs(c_card - c_cpu) <= 1e-4 + 1e-4 * np.abs(c_cpu))) >= 0.99


def _copy_back(case, cuda, monkeypatch):
    """``call(seed) -> (host arrays, device tensors they came from)``: the
    joint calibration of a 700-row cohort at tiny widths, or the download
    of the DDIM cell's calibrated cohort (10,002 x 62 bits, 10,002 x 5,080
    continuous). Sizes no other test here copies back, so the allocator's
    cache holds no block of theirs that another test freed."""
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import DeviceCalibrator

    if case == "download_10002x5142":
        cal = DeviceCalibrator(62, np.zeros((2, 5080), np.float32), device=cuda)
        g = torch.Generator(device=cuda).manual_seed(5)

        def call(seed):
            tensors = (torch.randn(10002, 62, generator=g, device=cuda),
                       torch.randn(10002, 5080, generator=g, device=cuda))
            return cal._download(*tensors), tensors
        return call
    (freq, chol, tetra), sorted_real, _, raw = _calibration_case(700)
    cal = DeviceCalibrator(10, sorted_real, device=cuda, freq=freq, joint_chol=chol, tetra=tetra)
    given, download = [], DeviceCalibrator._download
    monkeypatch.setattr(DeviceCalibrator, "_download",
                        lambda self, *arrays: given.append(arrays) or download(self, *arrays))
    x = torch.from_numpy(raw).to(cuda)
    return lambda seed: (cal.joint(x, seed), given.pop())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["joint_700x50", "download_10002x5142"])
def test_cuda_copy_back_into_reused_page_locked_blocks(cuda, case, monkeypatch):
    """The calibrated arrays come back bit for bit equal to ``.cpu()`` of the
    same tensors, in page-locked memory; a dropped result's blocks serve the
    next call, and a held result keeps its own: one new block per held
    array, its values unchanged, no memory shared with the next result."""
    from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS

    call = _copy_back(case, cuda, monkeypatch)
    out, tensors = call(1)
    for a, t in zip(out, tensors):
        assert a.dtype == np.float32 and torch.from_numpy(a).is_pinned()
        np.testing.assert_array_equal(a.view(np.uint32), t.cpu().numpy().view(np.uint32))
    del out, tensors, a, t
    allocs, pinned = COUNTERS["copy.host_allocs"], COUNTERS["copy.d2h_pinned"]
    held, _ = call(2)
    assert COUNTERS["copy.host_allocs"] == allocs
    assert COUNTERS["copy.d2h_pinned"] == pinned + 2
    kept = [a.copy() for a in held]
    out, _ = call(3)
    assert COUNTERS["copy.host_allocs"] == allocs + len(held)
    for a, k in zip(held, kept):
        np.testing.assert_array_equal(a, k)
    assert not any(np.shares_memory(a, b) for a in held for b in out)


@pytest.mark.cuda
def test_cuda_copy_back_falls_back_to_pageable_memory(cuda, monkeypatch):
    """Where page-locked memory cannot be had, the copy back takes
    ``.cpu()`` and counts its arrays as pageable."""
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import to_host
    from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS

    empty = torch.empty

    def refuse_page_locked(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("CUDA error: out of memory")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", refuse_page_locked)
    tensors = (torch.randn(33, 62, device=cuda), torch.randn(33, 5080, device=cuda))
    keys = ("copy.d2h_pinned", "copy.d2h_pageable", "copy.host_allocs")
    before = [COUNTERS[k] for k in keys]
    out = to_host(*tensors)
    assert [COUNTERS[k] - b for k, b in zip(keys, before)] == [0, 2, 0]
    for a, t in zip(out, tensors):
        assert not torch.from_numpy(a).is_pinned()
        np.testing.assert_array_equal(a, t.cpu().numpy())


@pytest.mark.cuda
def test_cuda_generator_calibrates_on_the_card_under_auto(cuda):
    """Under "auto" the generator on the card calibrates a 300-row cohort
    on the device and a 100-row one on the host (the 256-row threshold),
    with the same marginals."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
    from osteosarcoma_diffusionmodel_torch.generation import generator as pg
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays

    cfg = Config()
    cfg.model.diffusion.num_steps = 20
    data, conditions, dims = cohort_arrays(make_dummy_cohort(40, 10, 40, 14), cfg)
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    gen = pg.SyntheticPatientGenerator(model, cfg, dims, device=cuda,
                                       data_stats=data_stats_from_arrays(data, conditions, 10))
    for rows, backend in ((300, "device"), (100, "host")):
        before = pg.CALIBRATIONS[backend]
        out = gen.generate(rows, {"survival_time": 500}, pg.seeded_generator(0, rows))
        assert pg.CALIBRATIONS[backend] == before + 1
        assert out["expression"].shape == (rows, 40) and np.isfinite(out["expression"]).all()
        assert set(np.unique(out["mutations"])) <= {0.0, 1.0}
    assert gen._device_joint_cal.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 64])
@pytest.mark.parametrize("ddim", [None, 10], ids=["ddpm20", "ddim10"])
def test_cuda_sampler_small_batches_match_plain_loop(cuda, rows, ddim):
    """Serving's small buckets at full width (62/5054/26, hidden
    256/512/256): one 64-row tile with 1 or 64 valid rows. The kernel
    sampler against the plain loop (f32 products) with the same x_T and
    noise, at the bf16-carry tolerance atol 0.15 / rtol 0.05."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler

    cfg = Config()
    cfg.model.diffusion.num_steps = 20
    cfg.model.compute_dtype = "float32"
    dims = cfg.freeze_dims(62, 5054, 26, list(cfg.model.condition_on))
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(cuda)
    g = torch.Generator().manual_seed(rows)
    cond = torch.randn(rows, dims.condition_dim, generator=g)
    x_init = torch.randn(rows, dims.data_dim, generator=g)
    noise = torch.randn(20, rows, dims.data_dim, generator=g)
    got = FusedSampler(model, cuda, ddim_steps=ddim).sample(cond, g, x_init=x_init,
                                                          noise=None if ddim else noise)
    if ddim:
        ref = model.sample_ddim(cond, g, ddim, x_init=x_init)
    else:
        ref = model.sample(cond, g, x_init=x_init, noise=noise)
    assert got.shape == (rows, dims.data_dim) and bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= 0.15 + 0.05 * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 64, 1024])
def test_cuda_step_products_at_serving_rows(cuda, rows):
    # The serving buckets' rows under the plans the sampler takes (at one
    # row: one 64-row tile with one valid row and the largest split-K):
    # K1 against its plain version (f32 rounding of the sum), the GN
    # epilogue against the plain product then K2's plain version (2^-7 of
    # max(1, |ref|)), the posterior epilogue bit-equal to K1 then K3 under
    # the same plan, in every noise mode.
    rng = np.random.default_rng(rows)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    k, f, d = 256, 512, 5142
    a = _bf16(rng, (rows, k), 3.0).to(cuda)
    w = _bf16(rng, (k, f), 1 / math.sqrt(k)).to(cuda)
    bias = torch.randn(f, device=cuda)
    out = torch.empty(rows, f, device=cuda)
    unaligned = sk.GEMM.modes["unaligned"]
    sk.gemm_bf16_f32acc(a, w, out=out, bias=bias)
    assert sk.GEMM.modes["unaligned"] == unaligned
    ref = sk.gemm_bf16_f32acc_plain(a, w, bias)
    assert float((out - ref).abs().max()) <= 1e-3 * max(1.0, float(ref.abs().max()))

    scale = 1.0 + 0.1 * torch.randn(f, device=cuda)
    shift = 0.1 * torch.randn(f, device=cuda)
    res = torch.empty(rows, f, dtype=torch.bfloat16, device=cuda)
    sk.gemm_bf16_gn_silu(a, w, bias, scale, shift, out=res)
    ref = sk.groupnorm8_silu_plain(sk.gemm_bf16_f32acc_plain(a, w, bias), scale, shift)
    ref = ref.to(torch.bfloat16).float()
    assert float((res.float() - ref).abs().max()) <= 2 ** -7 * max(1.0, float(ref.abs().max()))

    w_out = _padded(k, d, torch.bfloat16, cuda)
    w_out.copy_(_bf16(rng, (k, d), 1 / math.sqrt(k)).to(cuda))
    start = _padded(rows, d, torch.bfloat16, cuda)
    start.copy_(_bf16(rng, (rows, d)).to(cuda))
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (4, 6)).astype(np.float32)).to(cuda)
    coeffs[:, 4:] = torch.tensor([0.05, 0.7], device=cuda)
    plan = sk.gemm_plan(rows, d, k, sms, "bf16", sk.POSTERIOR_WIDTHS)
    for mode in ("philox", "buffer", "none"):
        step = dict(b_out=torch.randn(d, device=cuda), coeffs=coeffs, step=1, mode=mode,
                    noise=torch.randn(4, rows, d, device=cuda), seed=3, mut_dim=0)
        acc = _padded(rows, d, torch.float32, cuda)
        pair, fused = start.clone(), start.clone()
        sk.gemm_bf16_f32acc(a, w_out, out=acc, plan=plan)
        sk.gemm_bf16_posterior(a, w_out, fused, **step, plan=plan)
        sk.x0_posterior_step(acc, pair, **step)
        assert torch.equal(fused, pair), mode
        assert not torch.equal(fused, start)


# ----------------------------------------------------------------------
# The diffusion model's variants: the scan samplers, the AR draw and the
# kernel sampler on a latent-factor model's widened conditions
# ----------------------------------------------------------------------
def _variant_model(overrides, dims=(10, 40, 14), steps=12, hidden=(128, 256, 128)):
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.models.networks import init_weights

    cfg = Config()
    cfg.model.hidden_dims = list(hidden)
    cfg.model.latent_dim = 32
    cfg.model.compute_dtype = "float32"
    cfg.model.diffusion.num_steps = steps
    cfg.generation.sample_dtype = "float32"
    for path, value in overrides.items():
        *parents, leaf = path.split(".")
        node = cfg
        for name in parents:
            node = getattr(node, name)
        setattr(node, leaf, value)
    dims = cfg.freeze_dims(*dims, ["a", "b", "c"])
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    return model


def _scan_draws(model, batch, n_loop, g):
    """Every draw of scan_sample (DDPM) on the CPU."""
    d = model.denoiser.data_dim
    k = model.low_rank_sigma_dim
    draws = {"x_T": torch.randn(batch, d, generator=g),
             "z": torch.randn(n_loop, batch, d, generator=g).to(torch.bfloat16).float(),
             "final_z": torch.randn(batch, d, generator=g)}
    if k:
        draws.update(lr_eps=torch.randn(n_loop, batch, d, generator=g),
                     lr_epsk=torch.randn(n_loop, batch, k, generator=g),
                     final_lr_eps=torch.randn(batch, d, generator=g),
                     final_lr_epsk=torch.randn(batch, k, generator=g))
    return draws


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["v-learned-sigma", "epsilon-low-rank", "cfg-ddim"])
def test_cuda_scan_sampler_matches_its_cpu_run(cuda, case):
    # The same model (f32 compute and carry) and draws on the card and on
    # the CPU: f32 on both sides in another summation order, 1e-3 of
    # max(1, |ref|) (the guided case 1 + 2g = 16 times that).
    import copy

    overrides = {
        "v-learned-sigma": {"model.diffusion.parameterization": "v",
                            "model.diffusion.learn_sigma": True},
        "epsilon-low-rank": {"model.diffusion.parameterization": "epsilon",
                             "model.diffusion.low_rank_sigma_dim": 3,
                             "generation.noise_type": "normal"},
        "cfg-ddim": {"model.cfg_dropout_prob": 0.1, "model.diffusion.learn_sigma": True},
    }[case]
    model = _variant_model(overrides)
    g = torch.Generator().manual_seed(1)
    cond = torch.randn(32, 3, generator=g)
    draws = _scan_draws(model, 32, 11, g)
    card = copy.deepcopy(model)
    card.denoiser.to(cuda)
    if case == "cfg-ddim":
        ref = model.scan_sample_ddim(cond, num_sampling_steps=6, guidance_scale=7.5, draws=draws)
        got = card.scan_sample_ddim(cond, num_sampling_steps=6, guidance_scale=7.5, draws=draws)
        tol = 16e-3
    else:
        ref = model.scan_sample(cond, draws=draws)
        got = card.scan_sample(cond, draws=draws)
        tol = 1e-3
    assert got.device.type == "cuda" and bool(torch.isfinite(got).all())
    err = (got.cpu() - ref).abs()
    assert float(err.max()) <= tol * max(1.0, float(ref.abs().max())), float(err.max())


@pytest.mark.cuda
def test_cuda_ar_sample_matches_its_cpu_run(cuda):
    # The same uniforms: equal bits, but after a gene whose uniform lies
    # within 1e-5 of its probability (the f32 products differ in order).
    import copy

    model = _variant_model({"model.diffusion.ar_mutation_head": True,
                            "model.diffusion.ar_context": "continuous"}, dims=(62, 200, 26))
    g = torch.Generator().manual_seed(2)
    cont, cond = torch.randn(333, 226, generator=g), torch.randn(333, 3, generator=g)
    u = torch.rand(333, 62, generator=g)
    ref = model.ar_sample(cont, cond, uniforms=u)
    card = copy.deepcopy(model)
    card.denoiser.to(cuda)
    got = card.ar_sample(cont, cond, uniforms=u).cpu()
    assert set(got.unique().tolist()) <= {0.0, 1.0}
    with torch.no_grad():
        p = torch.sigmoid(model.denoiser.ar_logits(ref, model._ar_context_view(cont, cond)))
    for row in torch.nonzero((got != ref).any(dim=1)).flatten().tolist():
        first = int(torch.nonzero(got[row] != ref[row])[0])
        assert abs(float(u[row, first] - p[row, first])) < 1e-5, (row, first)


@pytest.mark.cuda
@pytest.mark.parametrize("ddim", [None, 10], ids=["ddpm20", "ddim10"])
def test_cuda_kernel_sampler_takes_widened_conditions(cuda, ddim):
    # A latent-factor model (k = 8) at full width, 333 rows: the kernel
    # sampler on the [clinical | factors] conditions against the plain
    # loop (f32 products), the same x_T and noise, at the bf16-carry
    # tolerance atol 0.15 / rtol 0.05.
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler

    model = _variant_model({"model.diffusion.latent_factor_dim": 8,
                            "model.diffusion.ar_mutation_head": True},
                           dims=(62, 5054, 26), steps=20, hidden=(256, 512, 256))
    model.denoiser.to(cuda)
    g = torch.Generator().manual_seed(3)
    cond = torch.randn(333, 11, generator=g)
    x_init = torch.randn(333, 5142, generator=g)
    noise = torch.randn(20, 333, 5142, generator=g)
    before = sk.GEMM.launches
    got = FusedSampler(model, cuda, ddim_steps=ddim).sample(cond, g, x_init=x_init,
                                                          noise=None if ddim else noise)
    assert sk.GEMM.launches == before + (ddim or 20)
    if ddim:
        ref = model.sample_ddim(cond, g, ddim, x_init=x_init)
    else:
        ref = model.sample(cond, g, x_init=x_init, noise=noise)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= 0.15 + 0.05 * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pooled", [False, True])
def test_cuda_gnn_matches_its_cpu_run(cuda, pooled):
    """The GAT pathway encoder (f32 throughout) on the card against the
    same module on the CPU: within 1e-4 of max |out|. TF32 is off so that
    the card's products are f32 too."""
    from osteosarcoma_diffusionmodel_torch.models.gnn import (
        PathwayGraphEncoder,
        gene_pathway_edges,
    )
    from osteosarcoma_diffusionmodel_torch.models.networks import init_flax

    rng = np.random.default_rng(0)
    gp = (rng.random((60, 12)) < 0.2).astype(np.float32)
    x = torch.from_numpy(gp)
    edges = torch.from_numpy(gene_pathway_edges(gp))
    enc = PathwayGraphEncoder(12, 64, 16, num_layers=3, heads=4).eval()
    init_flax(enc, torch.Generator().manual_seed(0))
    kw = {"batch": torch.from_numpy((np.arange(60) >= 25).astype(np.int64)),
          "num_graphs": 2} if pooled else {}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = enc(x, edges, **kw)
            card = enc.to(cuda)
            got = card(x.to(cuda), edges.to(cuda),
                       **{k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in kw.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
        enc.cpu()
    assert got.shape == want.shape == ((2 if pooled else 1), 16)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,ddim,discrete", [(2048, 10, False), (333, None, True)],
                         ids=["ddim10-2048", "d3pm-ddpm20-333"])
def test_cuda_sampler_draws_x_prior_on_the_card(cuda, rows, ddim, discrete):
    """Handed a host generator, the kernel sampler draws x_T on the card
    (62/5054/26, hidden 256/512/256): float32 there, standard normal by its
    moments (the benchmark's prior_z below 5), the D3PM bits in {0, 1} with
    mean 1/2 within 5 standard errors; one host seed gives one cohort and
    another seed another, and each call counts one draw on the card."""
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
    from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS

    overrides = {"model.diffusion.discrete_mutation_head": True} if discrete else {}
    model = _variant_model(overrides, dims=(62, 5054, 26), steps=20, hidden=(256, 512, 256))
    model.denoiser.to(cuda)
    sampler = FusedSampler(model, cuda, ddim_steps=ddim)
    assert sampler.mut_dim == (62 if discrete else 0)
    priors, run = [], sampler._run

    def spy(x_init, *args):
        priors.append(x_init)
        return run(x_init, *args)

    sampler._run = spy
    cond = torch.randn(rows, 3, generator=torch.Generator().manual_seed(rows))
    card, host = COUNTERS["sampler.prior_device"], COUNTERS["sampler.prior_host"]
    a, b, c = (sampler.sample(cond, torch.Generator().manual_seed(s)) for s in (5, 5, 6))
    assert COUNTERS["sampler.prior_device"] == card + 3 and COUNTERS["sampler.prior_host"] == host
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(priors[0], priors[1]) and not torch.equal(priors[0], priors[2])
    x = priors[0]
    assert x.device.type == "cuda" and x.dtype == torch.float32 and x.shape == (rows, 5142)
    m = sampler.mut_dim
    z = x[:, m:].double().flatten()
    n = z.numel()
    prior_z = max(abs(float(z.mean())) * n**0.5, abs(float(z.std()) - 1.0) * (2 * n)**0.5)
    assert prior_z < 5, prior_z
    if discrete:
        bits = x[:, :m].double()
        assert set(bits.unique().tolist()) <= {0.0, 1.0}
        assert abs(float(bits.mean()) - 0.5) <= 5 * 0.5 / bits.numel()**0.5


@pytest.mark.cuda
def test_cuda_sample_sharded_on_nccl_world_of_one(cuda, tmp_path):
    """A real NCCL communicator at world size 1 on the card (NCCL refuses
    two ranks on one card): ``sample_sharded`` over ``make_mesh(1)`` is bit
    for bit ``sample`` in "buffer" (DDPM-20) and "none" (DDIM-10) modes on
    the same generator and noise, at full width and 333 rows, and every
    reverse step launches its kernels on the card."""
    import torch.distributed as dist

    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
    from osteosarcoma_diffusionmodel_torch.parallel import initialize_distributed, make_mesh

    model = _variant_model({}, dims=(62, 5054, 26), steps=20, hidden=(256, 512, 256))
    model.denoiser.to(cuda)
    g = torch.Generator().manual_seed(4)
    cond = torch.randn(333, 3, generator=g)
    noise = torch.randn(20, 333, 5142, generator=g)
    initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, "nccl", timeout_s=60)
    try:
        mesh = make_mesh(1)
        for ddim in (None, 10):
            sampler = FusedSampler(model, cuda, ddim_steps=ddim)
            kw = {} if ddim else {"noise": noise}
            before = sk.GEMM_POSTERIOR.launches
            got = sampler.sample_sharded(mesh, cond, torch.Generator().manual_seed(9), **kw)
            assert sk.GEMM_POSTERIOR.launches == before + (ddim or 20)
            want = sampler.sample(cond, torch.Generator().manual_seed(9), **kw)
            assert got.device.type == "cuda" and torch.equal(got, want)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# The transformer denoiser (models/dit.py): the grouped expert kernel and
# the whole denoiser at Moonlight-16B-A3B's published widths
# ----------------------------------------------------------------------
def _expert_counts(case: str, rows: int, experts: int, g: torch.Generator) -> torch.Tensor:
    """Uneven rows with experts that get none, or every row to one expert."""
    if case == "one":
        counts = torch.zeros(experts, dtype=torch.int64)
        counts[experts // 2] = rows
        return counts
    w = torch.rand(experts, generator=g) ** 3
    w[::7] = 0.0
    counts = (w / w.sum() * rows).floor().long()
    counts[int(w.argmax())] += rows - int(counts.sum())
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uneven", "one"])
def test_cuda_grouped_experts_match_a_loop_over_experts(cuda, case):
    """``grouped_swiglu`` then ``grouped_down`` at the routed experts'
    published widths (2048 -> 2·1408 -> 2048, 64 experts, 7,776 tokens x 6)
    against one plain product per expert on the card, twice with equal
    bits. bf16 operands, f32 sums rounded to bf16 in both; the library
    sums k in another order, so a bf16 rounding may tip one ulp (2^-8) on
    a few values."""
    from osteosarcoma_diffusionmodel_torch.ops import moe

    e, h, inter, rows = 64, 2048, 1408, 7776 * 6
    counts = _expert_counts(case, rows, e, torch.Generator().manual_seed(3))
    assert int(counts.sum()) == rows and int((counts == 0).sum()) >= (1 if case == "uneven" else 63)
    plan = moe.plan_from_counts(counts.to(cuda), rows)
    g = torch.Generator(device=cuda).manual_seed(3)

    def uniform(*shape, fan_in=1):
        return ((torch.rand(shape, generator=g, device=cuda) * 2 - 1) / fan_in ** 0.5).to(
            torch.bfloat16)

    a = uniform(rows, h)
    w_gu, w_down = uniform(e, h, 2 * inter, fan_in=h), uniform(e, inter, h, fan_in=inter)
    scale = torch.rand(rows, generator=g, device=cuda)
    dest = torch.randperm(rows, generator=g, device=cuda)
    hid = moe.grouped_swiglu(a, w_gu, plan)
    y = moe.grouped_down(hid, w_down, plan, scale, dest)
    assert torch.equal(hid, moe.grouped_swiglu(a, w_gu, plan))
    assert torch.equal(y, moe.grouped_down(hid, w_down, plan, scale, dest))
    hid_ref = moe.grouped_swiglu_plain(a, w_gu, plan)
    y_ref = moe.grouped_down_plain(hid_ref, w_down, plan, scale, dest)
    assert float((hid.float() - hid_ref.float()).norm() / hid_ref.float().norm()) <= 2e-3
    assert float((y - y_ref).norm() / y_ref.norm()) <= 2e-3


@pytest.mark.cuda
def test_cuda_grouped_experts_backward_matches_autograd_of_a_loop(cuda):
    """The experts' backward on the card (autograd through
    ``grouped_swiglu`` then ``grouped_down``: ``torch._grouped_mm``'s
    backward, the SwiGLU, the routing weights and the scatter) against
    autograd through one plain product per expert, at 8 experts of 256 ->
    2·128 -> 256, uneven rows and expert 5 with none, twice with equal
    bits. The library's gradients are bf16 where the plain backward keeps
    f32: ~2^-9 relative each."""
    from osteosarcoma_diffusionmodel_torch.ops import moe

    e, k, h, inter, t = 8, 2, 256, 128, 512
    g = torch.Generator(device=cuda).manual_seed(4)
    choice = torch.randint(0, e - 1, (t, k), generator=g, device=cuda)
    choice[choice >= 5] += 1
    plan, order, counts = moe.expert_plan(choice, e)
    assert int(counts[5]) == 0
    leaves = [(torch.randn(t, h, generator=g, device=cuda)).to(torch.bfloat16),
              (torch.randn(e, h, 2 * inter, generator=g, device=cuda) / h ** 0.5).to(torch.bfloat16),
              (torch.randn(e, inter, h, generator=g, device=cuda) / inter ** 0.5).to(torch.bfloat16),
              torch.rand(t, k, generator=g, device=cuda)]
    dy = torch.randn(t, h, generator=g, device=cuda)

    def grads(swiglu, down):
        x, w_gu, w_down, weight = (v.clone().requires_grad_() for v in leaves)
        y = down(swiglu(x[order // k], w_gu, plan), w_down, plan, weight.reshape(-1)[order],
                 order)
        y.view(t, k, h).sum(1).backward(dy)
        return [v.grad.float() for v in (x, w_gu, w_down, weight)]

    got = grads(moe.grouped_swiglu, moe.grouped_down)
    assert all(torch.equal(a, b) for a, b in zip(got, grads(moe.grouped_swiglu, moe.grouped_down)))
    want = grads(moe.grouped_swiglu_plain, moe.grouped_down_plain)
    assert float(got[1][5].abs().max()) == 0.0 and float(got[2][5].abs().max()) == 0.0
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) <= 1e-2


def _routed_operands(cuda, case: str):
    """The routed layer's operands at the transformer cell's shapes (7,776
    tokens x 6 of 64 experts, 2048 -> 2·1408 -> 2048), rows an expert by
    :func:`_expert_counts`, a random assignment of rows to token copies."""
    from osteosarcoma_diffusionmodel_torch.ops import moe

    e, h, inter, k, t = 64, 2048, 1408, 6, 7776
    rows = t * k
    counts = _expert_counts(case, rows, e, torch.Generator().manual_seed(6))
    plan = moe.plan_from_counts(counts.to(cuda), rows)
    g = torch.Generator(device=cuda).manual_seed(6)

    def uniform(*shape, fan_in=1):
        return ((torch.rand(shape, generator=g, device=cuda) * 2 - 1) / fan_in ** 0.5).to(
            torch.bfloat16)

    return dict(a=uniform(rows, h), w_gu=uniform(e, h, 2 * inter, fan_in=h),
                w_down=uniform(e, inter, h, fan_in=inter), plan=plan,
                scale=torch.rand(rows, generator=g, device=cuda),
                dest=torch.randperm(rows, generator=g, device=cuda), k=k, t=t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uneven", "one"])
def test_cuda_routed_epilogue_kernels_match_the_eager_chains(cuda, case):
    """Without autograd the routed experts' epilogues are the kernels of
    ``csrc/moe_epilogue.cu``, one launch each, at the cell's routed shapes
    (uneven rows with empty experts, or every row to one expert).
    ``silu_mul``: bit for bit the eager no-grad branch it replaced (f32
    SiLU in place, the mixed-dtype multiply rounded once to bf16) and its
    plain version. The combine, ``grouped_down(..., top_k=k)``: bit for bit
    its plain version (the same products and sums in the same order), and
    against ``grouped_down(...).view(t, k, -1).sum(1)``, which sums k in
    another order, within the bound on two orders of an f32 sum of k terms,
    2·γ_{k−1}·Σ_j|term_j| an element (γ_n = n·2^-24 / (1 − n·2^-24)); not
    4 ulps of the row's largest term: partial sums outgrow that term, and
    PyTorch's reducer order reached 6 such ulps on random data. Both
    kernels repeat with equal bits."""
    import torch.nn.functional as F

    from osteosarcoma_diffusionmodel_torch.ops import moe

    o = _routed_operands(cuda, case)
    plan, k, t = o["plan"], o["k"], o["t"]
    with torch.no_grad():
        gu = torch._grouped_mm(o["a"], o["w_gu"], offs=plan.offs)
        g, u = gu.chunk(2, dim=1)
        eager = torch.mul(F.silu(g.float(), inplace=True), u,
                          out=torch.empty(u.shape, dtype=u.dtype, device=cuda))
        launches = moe.SILU_MUL.launches, moe.COMBINE.launches
        hid = moe.grouped_swiglu(o["a"], o["w_gu"], plan)
        assert moe.SILU_MUL.launches == launches[0] + 1
        gu = torch._grouped_mm(o["a"], o["w_gu"], offs=plan.offs)
        assert torch.equal(hid, eager) and torch.equal(hid, moe.silu_mul(gu))
        assert torch.equal(hid, moe.silu_mul_plain(gu))
        del g, u, gu, eager
        routed = moe.grouped_down(hid, o["w_down"], plan, o["scale"], o["dest"], top_k=k)
        assert moe.COMBINE.launches == launches[1] + 1
        assert routed.shape == (t, o["w_down"].shape[2]) and routed.dtype == torch.float32
        assert torch.equal(routed, moe.grouped_down(hid, o["w_down"], plan, o["scale"], o["dest"],
                                                    top_k=k))
        y = torch._grouped_mm(hid, o["w_down"], offs=plan.offs)
        src = torch.empty_like(o["dest"]).scatter_(0, o["dest"],
                                                   torch.arange(t * k, device=cuda))
        assert torch.equal(routed, moe.combine_plain(y, o["scale"], src, k))
        terms = (y.index_select(0, src).float() * o["scale"].index_select(0, src)[:, None]).view(
            t, k, -1)
        want = moe.grouped_down(hid, o["w_down"], plan, o["scale"], o["dest"]).view(t, k, -1).sum(1)
        nu = (k - 1) * 2.0 ** -24
        assert bool(((routed - want).abs() <= 2 * nu / (1 - nu) * terms.abs().sum(1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["gu dtype", "gu strides", "y dtype", "scale dtype",
                                   "src strides", "dest length", "top_k rows"])
def test_cuda_routed_epilogue_wrappers_refuse_bad_operands(cuda, fault):
    """The epilogue wrappers raise a ValueError, before any launch, on an
    operand of the wrong dtype, a non-contiguous one, or a ``dest`` that
    does not hold one row for each of the product's rows."""
    from osteosarcoma_diffusionmodel_torch.ops import moe

    g = torch.Generator(device=cuda).manual_seed(7)
    rows, inter, n, k = 48, 32, 64, 3
    gu = torch.randn(rows, 2 * inter, generator=g, device=cuda).to(torch.bfloat16)
    y = torch.randn(rows, n, generator=g, device=cuda).to(torch.bfloat16)
    scale = torch.rand(rows, generator=g, device=cuda)
    src = torch.randperm(rows, generator=g, device=cuda)
    plan = moe.plan_from_counts(torch.tensor([rows, 0], device=cuda), rows)
    w_down = torch.randn(2, inter, n, generator=g, device=cuda).to(torch.bfloat16)
    calls = {
        "gu dtype": lambda: moe.silu_mul(gu.float()),
        "gu strides": lambda: moe.silu_mul(gu.t().contiguous().t()),
        "y dtype": lambda: moe.combine(y.float(), scale, src, k),
        "scale dtype": lambda: moe.combine(y, scale.to(torch.bfloat16), src, k),
        "src strides": lambda: moe.combine(y, scale, torch.stack([src, src], 1)[:, 0], k),
        "dest length": lambda: moe.grouped_down(gu[:, :inter].contiguous(), w_down, plan, scale,
                                                src[:-1], top_k=k),
        "top_k rows": lambda: moe.combine(y[:-1], scale[:-1], src[:-1], k),
    }
    launches = moe.SILU_MUL.launches, moe.COMBINE.launches
    with torch.no_grad(), pytest.raises(ValueError):
        calls[fault]()
    assert (moe.SILU_MUL.launches, moe.COMBINE.launches) == launches


@pytest.mark.cuda
def test_cuda_routed_epilogues_under_autograd_keep_the_eager_path(cuda):
    """Under autograd no epilogue kernel launches: ``grouped_down(...,
    top_k=k)`` is the eager composition followed by the sum over k, so its
    output and every gradient equal those of the view-and-sum path bit for
    bit (8 experts of 256 -> 2·128 -> 256, expert 5 with no row)."""
    from osteosarcoma_diffusionmodel_torch.ops import moe

    e, k, h, inter, t = 8, 2, 256, 128, 512
    g = torch.Generator(device=cuda).manual_seed(8)
    choice = torch.randint(0, e - 1, (t, k), generator=g, device=cuda)
    choice[choice >= 5] += 1
    plan, order, counts = moe.expert_plan(choice, e)
    leaves = [torch.randn(t, h, generator=g, device=cuda).to(torch.bfloat16),
              (torch.randn(e, h, 2 * inter, generator=g, device=cuda) / h ** 0.5).to(torch.bfloat16),
              (torch.randn(e, inter, h, generator=g, device=cuda) / inter ** 0.5).to(torch.bfloat16),
              torch.rand(t, k, generator=g, device=cuda)]
    dy = torch.randn(t, h, generator=g, device=cuda)

    def run(top_k):
        x, w_gu, w_down, weight = (v.clone().requires_grad_() for v in leaves)
        hid = moe.grouped_swiglu(x[order // k], w_gu, plan)
        args = (hid, w_down, plan, weight.reshape(-1)[order], order)
        y = moe.grouped_down(*args, top_k=k) if top_k else moe.grouped_down(*args).view(
            t, k, h).sum(1)
        y.backward(dy)
        return [y.detach()] + [v.grad for v in (x, w_gu, w_down, weight)]

    launches = moe.SILU_MUL.launches, moe.COMBINE.launches
    got, want = run(True), run(False)
    assert (moe.SILU_MUL.launches, moe.COMBINE.launches) == launches
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_denoiser_at_published_widths_matches_the_reference(cuda):
    """Two blocks of Moonlight-16B-A3B at its published widths (layer 0
    dense, layer 1 DeepSeekMoE with 64 experts, top 6, 2 shared) on the
    card against the plain reference given the program's expert choices.
    Both round the same operands to bf16; the card sums in other orders,
    and its attention rounds the softmax's probabilities to bf16 before
    the product with V where the reference keeps them in f32: ~1e-3 of
    the output through two layers."""
    import dataclasses

    from osteosarcoma_diffusionmodel_torch.config import TransformerConfig
    from osteosarcoma_diffusionmodel_torch.models.dit import MoonlightDiT
    from torch_reference_dit import Reference

    tc = TransformerConfig(num_hidden_layers=2)
    blocks = (62, 5054, 26)
    with torch.device("meta"):
        model = MoonlightDiT(tc, blocks, 3, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(5)
    weights = {}
    for name, t in model.state_dict().items():
        u = torch.rand(t.shape, generator=g, device=cuda, dtype=t.dtype) * 2 - 1
        if name.endswith("norm.weight"):
            u = 1 + 0.2 * u
        elif name.endswith("e_score_correction_bias"):
            u = 0.1 * u
        else:
            w = model.state_dict()[name[:-4] + "weight"] if name.endswith(".bias") else t
            u = u / w.shape[-2 if w.dim() == 3 else 1] ** 0.5
        weights[name] = u.to(t.dtype)
    model.load_state_dict(weights, assign=True)
    model.eval()
    routes = []
    layer = model.moe_layers()[0]
    inner = layer.route

    def route(x):
        choice, weight = inner(x)
        routes.append(choice)
        return choice, weight

    layer.route = route
    x = torch.randn(4, sum(blocks), device=cuda, generator=g)
    t = torch.rand(4, device=cuda, generator=g)
    c = torch.randn(4, 3, device=cuda, generator=g)
    with torch.no_grad():
        out = model(x, t, conditions=c)
    conf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    ref = Reference(weights, conf, blocks, cuda, bf16=True)
    with torch.no_grad():
        want = ref.forward(x, t, c, routes=routes)
    assert float((out - want).norm() / want.norm()) <= 1e-2


def _kda_inputs(device, b, length, heads, d=128, seed=0, steep=True):
    """Unit q and k, v ~ N(0, 1), β ~ U(0, 1), and a decay per channel as
    KDA draws it, g = −A·softplus(z), A ~ U(1, 16) a head (the published
    range), z ~ N(−3, 2) (or N(−6, 1) without ``steep``): channels from
    ≈ e^-0.00004 to ≈ e^-60 a token side by side."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    q = torch.nn.functional.normalize(randn(b, length, heads, d), dim=-1)
    k = torch.nn.functional.normalize(randn(b, length, heads, d), dim=-1)
    v = randn(b, length, heads, d)
    a = 1 + 15 * torch.rand(heads, generator=g, device=device)
    z = randn(b, length, heads, d) * (2.0 if steep else 1.0) + (-3.0 if steep else -6.0)
    decay = -a[:, None] * torch.nn.functional.softplus(z)
    beta = torch.rand(b, length, heads, generator=g, device=device)
    return q, k, v, decay, beta


def _kda_recurrence(q, k, v, g, beta, scale):
    """The gated delta rule token by token in float64."""
    b, length, heads, d = q.shape
    state = torch.zeros(b, heads, d, v.shape[-1], dtype=torch.float64, device=q.device)
    out = []
    for t in range(length):
        state = state * g[:, t].double().exp()[..., None]
        kt = k[:, t].double()
        kv = (kt[..., None] * state).sum(-2)
        state = state + kt[..., None] * (beta[:, t].double()[..., None] * (v[:, t].double() - kv))[
            ..., None, :]
        out.append((q[:, t].double()[..., None] * state).sum(-2) * scale)
    return torch.stack(out, 1)


@pytest.mark.cuda
def test_cuda_kda_kernel_matches_the_twin_at_the_cell_shape(cuda):
    """The KDA kernel (``csrc/kda_chunk.cu``), one launch, against its plain
    chunked twin at the hybrid cell's shape (6 sequences of 1,289 tokens,
    32 heads of 128, a ragged last chunk of 9): both f32, another order of
    sums and the kernel's exp2 (≤ 2 ulp): 1e-4 of the output's norm and
    of max(1, max|o|) an element; the same bits twice (no atomics)."""
    from osteosarcoma_diffusionmodel_torch.ops import kda

    q, k, v, g, beta = _kda_inputs(cuda, 6, 1289, 32)
    with torch.no_grad():
        before = kda.KDA.launches
        got = kda.kda_chunk(q, k, v, g, beta, 128 ** -0.5)
        assert kda.KDA.launches == before + 1
        again = kda.kda_chunk(q, k, v, g, beta, 128 ** -0.5)
        want = kda.kda_chunk_plain(q, k, v, g, beta, 128 ** -0.5)
    assert got.shape == want.shape and torch.equal(got, again)
    assert float((got - want).norm() / want.norm()) <= 1e-4
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 64, 130])
@pytest.mark.parametrize("steep", [True, False])
def test_cuda_kda_kernel_matches_the_recurrence(cuda, length, steep):
    """The KDA kernel against the token-by-token recurrence in float64 at a
    small shape (2 sequences, 3 heads of 128), with decays down to e^-60 a
    token: f32 sums against exact ones, 1e-4 of max(1, max|o|) an element."""
    from osteosarcoma_diffusionmodel_torch.ops import kda

    q, k, v, g, beta = _kda_inputs(cuda, 2, length, 3, seed=length, steep=steep)
    with torch.no_grad():
        got = kda.kda_chunk(q, k, v, g, beta, 128 ** -0.5)
    want = _kda_recurrence(q, k, v, g, beta, 128 ** -0.5)
    assert float((got.double() - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_kda_wrapper_refuses_other_widths_and_launches_under_autograd(cuda):
    """Heads of 64 are refused. Under autograd the kernel still runs the
    forward (one launch, the bits of a launch without autograd), and the
    gradients are those of the plain twin, which the backward recomputes:
    the upstream gradient is the same, so 1e-6 of each gradient's largest
    element (cuBLAS may take another algorithm for the same product)."""
    from osteosarcoma_diffusionmodel_torch.ops import kda

    q, k, v, g, beta = _kda_inputs(cuda, 1, 70, 2, d=64)
    with torch.no_grad(), pytest.raises(ValueError, match="width"):
        kda.kda_chunk(q, k, v, g, beta, 0.125)
    inputs = _kda_inputs(cuda, 1, 70, 2)
    with torch.no_grad():
        plain_out = kda.kda_chunk(*inputs, 128 ** -0.5)
    mine = [t.clone().requires_grad_(i in (0, 2, 3)) for i, t in enumerate(inputs)]
    theirs = [t.clone().requires_grad_(i in (0, 2, 3)) for i, t in enumerate(inputs)]
    before = kda.KDA.launches
    out = kda.kda_chunk(*mine, 128 ** -0.5)
    assert kda.KDA.launches == before + 1 and torch.equal(out, plain_out)
    out.sum().backward()
    kda.kda_chunk_plain(*theirs, 128 ** -0.5).sum().backward()
    assert kda.KDA.launches == before + 1
    for i, (a, b) in enumerate(zip(mine, theirs)):
        if i in (0, 2, 3):
            assert float((a.grad - b.grad).abs().max()) <= 1e-6 * float(b.grad.abs().max()), i
        else:
            assert a.grad is None, i


@pytest.mark.cuda
def test_cuda_routed_combine_sums_the_held_copies_only(cuda):
    """An expert share: the copies routed to experts held here (a quarter of
    64, by ``moe.held_plan``) through the grouped products, and the
    combine kernel summing 0 to k of them a token (copies held elsewhere
    marked −1): bit for bit its plain version, which adds 0·0 for them,
    and within a bf16 ulp of the full layer's combine with the other
    experts' rows weighted 0."""
    from osteosarcoma_diffusionmodel_torch.ops import moe

    e, held, first, h, inter, k, t = 64, 16, 16, 512, 256, 8, 1289
    g = torch.Generator(device=cuda).manual_seed(9)
    choice = torch.rand(t, e, generator=g, device=cuda).topk(k, dim=1).indices
    x = (torch.rand(t, h, generator=g, device=cuda) * 2 - 1).to(torch.bfloat16)
    weight = torch.rand(t, k, generator=g, device=cuda)
    w_gu = ((torch.rand(e, h, 2 * inter, generator=g, device=cuda) * 2 - 1) / h ** 0.5).to(
        torch.bfloat16)
    w_down = ((torch.rand(e, inter, h, generator=g, device=cuda) * 2 - 1) / inter ** 0.5).to(
        torch.bfloat16)
    with torch.no_grad():
        plan, dest, counts = moe.held_plan(choice, first, held)
        flat = choice.reshape(-1)
        assert plan.rows == int(((flat >= first) & (flat < first + held)).sum())
        hid = moe.grouped_swiglu(x[dest // k], w_gu[first:first + held], plan)
        row_scale = weight.reshape(-1)[dest]
        launches = moe.COMBINE.launches
        got = moe.grouped_down(hid, w_down[first:first + held], plan, row_scale, dest, top_k=k,
                               tokens=t)
        assert moe.COMBINE.launches == launches + 1 and got.shape == (t, h)
        y = torch._grouped_mm(hid, w_down[first:first + held], offs=plan.offs)
        src = torch.full((t * k,), -1, dtype=torch.int64, device=cuda)
        src.scatter_(0, dest, torch.arange(plan.rows, device=cuda))
        assert torch.equal(got, moe.combine_plain(y, row_scale, src, k))
        # The full layer with every copy outside the share weighted 0.
        fplan, order, _ = moe.expert_plan(choice, e)
        fscale = torch.where((flat >= first) & (flat < first + held), weight.reshape(-1),
                             torch.zeros_like(weight.reshape(-1)))[order]
        fhid = moe.grouped_swiglu(x[order // k], w_gu, fplan)
        full = moe.grouped_down(fhid, w_down, fplan, fscale, order, top_k=k)
    # The two grouped products may tile the same rows differently and round a
    # bf16 result the other way: one bf16 ulp (2^-7) of max(1, max|full|).
    assert float((got - full).abs().max()) <= 2.0 ** -7 * max(1.0, float(full.abs().max()))


@pytest.mark.cuda
def test_cuda_tiny_hybrid_denoiser_matches_the_reference(cuda):
    """The hybrid block stack at small widths with KDA heads of 128 (the
    kernel's width): layers KDA, KDA, MLA (NoPE), a share of 2 of 8 experts,
    bf16, on the card, against the plain reference given the program's
    routing: both round the same operands and results to bf16; 1e-2 of the
    output's norm (a rounding tipped the other way moves one activation by
    2^-8 and the output by less)."""
    import dataclasses

    from osteosarcoma_diffusionmodel_torch.config import TransformerConfig
    from osteosarcoma_diffusionmodel_torch.models.dit import MoonlightDiT
    from osteosarcoma_diffusionmodel_torch.ops import kda
    from torch_reference_kimi_linear import KimiReference

    from benchmark.kimi_weights import seeded_kimi_weights

    tc = TransformerConfig(
        hidden_size=256, num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, intermediate_size=512,
        moe_intermediate_size=128, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, patch_size=4, time_embed_dim=32, mla_use_nope=True,
        linear_attn_config=dict(kda_layers=[1, 2], full_attn_layers=[3], num_heads=2,
                                head_dim=128, short_conv_kernel_size=4), ep_size=4, ep_rank=1)
    blocks = (10, 100, 14)
    with torch.device("meta"):
        model = MoonlightDiT(tc, blocks, 3, torch.bfloat16)
    weights = seeded_kimi_weights(model, 3, cuda)
    model.load_state_dict(weights, assign=True)
    model.eval()
    routes = []
    for layer in model.moe_layers():
        inner = layer.route

        def route(x, inner=inner):
            choice, weight = inner(x)
            routes.append(choice)
            return choice, weight

        layer.route = route
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(4, sum(blocks), device=cuda, generator=g)
    t = torch.rand(4, device=cuda, generator=g)
    c = torch.randn(4, 3, device=cuda, generator=g)
    with torch.no_grad():
        before = kda.KDA.launches
        out = model(x, t, conditions=c)
        assert kda.KDA.launches == before + 2
    conf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    with torch.no_grad():
        want = KimiReference(weights, conf, blocks, cuda, bf16=True).forward(x, t, c,
                                                                             routes=routes)
    assert float((out - want).norm() / want.norm()) <= 1e-2
