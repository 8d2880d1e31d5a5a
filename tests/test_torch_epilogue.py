"""K2's and K3's work as epilogues of K1's and K6's products.

On CPU tensors the fused wrappers run the plain composition of the
kernels they merge (the product's plain version, then K2's or K3's), so
these tests hold the wrappers' plumbing -- strided views, the int8 split
product, every noise mode with and without the D3PM head -- to that
composition exactly, and the sampler that routes through them to the
JAX package's whole-loop sampler. On the card, tests/test_torch_cuda.py
holds the epilogues to the same compositions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops.fused_sampler import FusedSampler as JaxFusedSampler
from osteosarcoma_diffusionmodel_torch.ops import fused_sampler as fs
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
from torch_parity import TILE_B, make_pair


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _bf16(rng, *shape, scale=1.0):
    return _f32(rng, *shape, scale=scale).to(torch.bfloat16)


def _gn_vectors(rng, f):
    return 1.0 + 0.1 * _f32(rng, f), 0.1 * _f32(rng, f)


def _int8_operands(rng, a, n):
    """K5's codes of ``a`` and K-major codes of a random (K, n) weight."""
    qa, rs = sk.rowquant_s8(a)
    q, cs = sk.pack_int8(rng.standard_normal((a.shape[1], n)).astype(np.float32) / math.sqrt(n))
    return qa, rs, sk.kmajor_int8(q), cs


# ----------------------------------------------------------------------
# GroupNorm(8) + SiLU in the product's epilogue
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,f", [(5, 64, 64), (19, 128, 256), (33, 320, 512)])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_gemm_bf16_gn_silu_equals_plain_composition(m, k, f, layout):
    """K1 -> K2's plain versions, rounded once to bf16. "strided": A is the
    skip half of a decoder's [h | skip] buffer and the output the h half
    of the next one, so both are row-strided views; the rest of the output
    buffer is not written."""
    rng = np.random.default_rng(m + k + f)
    w, bias = _bf16(rng, k, f, scale=1 / math.sqrt(k)), _f32(rng, f)
    scale, shift = _gn_vectors(rng, f)
    if layout == "strided":
        a = torch.zeros(m, 2 * k, dtype=torch.bfloat16)[:, k:]
        a.copy_(_bf16(rng, m, k))
        buf = torch.zeros(m, f + 24, dtype=torch.bfloat16)
        out = buf[:, :f]
    else:
        a, out = _bf16(rng, m, k), None
    got = sk.gemm_bf16_gn_silu(a, w, bias, scale, shift, out=out)
    ref = sk.groupnorm8_silu_plain(sk.gemm_bf16_f32acc_plain(a, w, bias), scale, shift)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref.to(torch.bfloat16))
    if layout == "strided":
        assert got.data_ptr() == buf.data_ptr() and not buf[:, f:].any()


@pytest.mark.parametrize("split", [None, 40])
def test_gemm_s8_gn_silu_equals_plain_composition(split):
    """K6 -> K2's plain versions; with ``split`` the decoder's fc1 as two
    int8 products: the first into the f32 pre-activation, the second
    reading it back in its GN epilogue, without writing it."""
    rng = np.random.default_rng(11)
    m, k, f = 9, 72, 128
    a = _bf16(rng, m, k, scale=3.0)
    bias = _f32(rng, f)
    scale, shift = _gn_vectors(rng, f)
    cuts = [(0, k)] if split is None else [(0, split), (split, k)]
    parts = [_int8_operands(rng, a[:, lo:hi], f) for lo, hi in cuts]
    pre = torch.zeros(m, f)
    for part in parts[:-1]:
        sk.gemm_s8(*part, out=pre)
    before = pre.clone()
    got = sk.gemm_s8_gn_silu(*parts[-1], bias, scale, shift,
                             acc_into=pre if split is not None else None)
    v = sk.gemm_s8_plain(*parts[-1], bias, acc_into=before if split is not None else None)
    assert torch.equal(got, sk.groupnorm8_silu_plain(v, scale, shift).to(torch.bfloat16))
    assert torch.equal(pre, before)


@pytest.mark.parametrize("f", [24, 96, 384, 2048])
def test_gn_epilogue_rejects_groups_that_fit_no_width(f):
    """Groups of 3, 12, 48 or 256 columns: not a multiple of 8 dividing a
    width the GN epilogue is built at, so the wrapper raises (the sampler
    runs such a block apart)."""
    rng = np.random.default_rng(f)
    assert sk.gn_widths(f) == ()
    scale, shift = _gn_vectors(rng, f)
    with pytest.raises(ValueError, match="fit no block width"):
        sk.gemm_bf16_gn_silu(_bf16(rng, 4, 16), _bf16(rng, 16, f), None, scale, shift)
    qa, rs, qb, cs = _int8_operands(rng, _bf16(rng, 4, 16), f)
    with pytest.raises(ValueError, match="fit no block width"):
        sk.gemm_s8_gn_silu(qa, rs, qb, cs, None, scale, shift)


@pytest.mark.parametrize("f,widths", [(64, (128, 64)), (128, (128, 64)), (256, (128, 64)),
                                      (512, (128, 64)), (1024, (128,)), (2048, ()), (4096, ())])
def test_gn_widths_and_plan(f, widths):
    """The widths that hold whole groups of f/8 columns, and a plan among
    them at the paths' shapes (the plan never picks another width)."""
    assert sk.gn_widths(f) == widths
    for m, k in ((333, 256), (333, 768), (999, 512)):
        for kind in ("bf16", "int8"):
            if widths:
                assert sk.gemm_plan(m, f, k, 132, kind, widths).bn in widths
    with pytest.raises(ValueError, match="subset"):
        sk.gemm_plan(333, 256, 256, 132, "bf16", (96,))


# ----------------------------------------------------------------------
# The output product with the reverse step in its epilogue
# ----------------------------------------------------------------------
def _step_inputs(rng, b, d, steps=3):
    x = sk.pad16(d)
    carry = torch.zeros(b, x, dtype=torch.bfloat16)[:, :d]
    carry.copy_(_bf16(rng, b, d))
    b_out = _f32(rng, d)
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (steps, 6)).astype(np.float32))
    noise = _f32(rng, steps, b, d)
    return carry, b_out, coeffs, noise


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["philox", "buffer", "none"])
@pytest.mark.parametrize("mut_dim", [0, 12])
def test_posterior_epilogue_equals_plain_composition(kind, mode, mut_dim):
    """The product's plain version into an f32 acc, then K3's plain
    version on the padded carry: the same bits, in place, in every noise
    mode, with and without the D3PM bits."""
    rng = np.random.default_rng(3)
    m, k, d = 7, 48, 50
    h = _bf16(rng, m, k, scale=2.0)
    x, b_out, coeffs, noise = _step_inputs(rng, m, d)
    if mut_dim:
        x[:, :mut_dim] = torch.from_numpy(rng.uniform(size=(m, mut_dim)) < 0.5).to(torch.bfloat16)
    step = dict(b_out=b_out, coeffs=coeffs, step=1, mode=mode, noise=noise, seed=5, clip=3.0,
                mut_dim=mut_dim)
    start = x.clone()
    if kind == "bf16":
        w = _bf16(rng, k, d, scale=1 / math.sqrt(k))
        acc = sk.gemm_bf16_f32acc_plain(h, w)
        got = sk.gemm_bf16_posterior(h, w, x, **step)
    else:
        qa, rs, qb, cs = _int8_operands(rng, h, d)
        acc = sk.gemm_s8_plain(qa, rs, qb, cs)
        got = sk.gemm_s8_posterior(qa, rs, qb, cs, x, **step)
    ref = sk.x0_posterior_step_plain(acc, start, b_out, coeffs, 1, mode, noise, 5, 3.0, mut_dim)
    assert got is x and torch.equal(x, ref)
    assert not torch.equal(x, start)


def test_posterior_epilogue_checks_arguments():
    rng = np.random.default_rng(4)
    h, w = _bf16(rng, 4, 16), _bf16(rng, 16, 20)
    x, b_out, coeffs, noise = _step_inputs(rng, 4, 20)
    with pytest.raises(ValueError, match="noise mode"):
        sk.gemm_bf16_posterior(h, w, x, b_out, coeffs, 0, "gaussian")
    with pytest.raises(IndexError):
        sk.gemm_bf16_posterior(h, w, x, b_out, coeffs, 3, "none")
    with pytest.raises(ValueError, match="x must be"):
        sk.gemm_bf16_posterior(h, w, x[:3], b_out, coeffs, 0, "none")
    with pytest.raises(ValueError, match="buffer mode"):
        sk.gemm_bf16_posterior(h, w, x, b_out, coeffs, 0, "buffer", noise=noise[:2])


# ----------------------------------------------------------------------
# The sampler's step
# ----------------------------------------------------------------------
_WRAPPERS = ("gemm_bf16_f32acc", "gemm_bf16_gn_silu", "gemm_bf16_posterior", "gemm_s8",
             "gemm_s8_gn_silu", "gemm_s8_posterior", "gemm_s8q", "gemm_s8q_gn_silu",
             "gemm_s8q_posterior", "rowquant_s8", "groupnorm8_silu")


def _count_calls(monkeypatch):
    """Counts the sampler's calls of each kernel wrapper (a launch each
    on the card)."""
    calls = dict.fromkeys(_WRAPPERS, 0)
    for name in _WRAPPERS:
        real = getattr(fs, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(fs, name, spy)
    return calls


@pytest.mark.parametrize("quantize,launches", [
    (None, {"gemm_bf16_f32acc": 1, "gemm_bf16_gn_silu": 10, "gemm_bf16_posterior": 1}),
    ("out", {"gemm_bf16_f32acc": 1, "gemm_bf16_gn_silu": 10, "gemm_s8q_posterior": 1}),
    ("io", {"rowquant_s8": 1, "gemm_s8": 1, "gemm_bf16_gn_silu": 10, "gemm_s8q_posterior": 1}),
    ("all", {"rowquant_s8": 1, "gemm_s8": 1, "gemm_s8q": 2, "gemm_s8q_gn_silu": 10,
             "gemm_s8q_posterior": 1}),
])
def test_step_launches_by_mode(monkeypatch, quantize, launches):
    """One reverse step of the parity model (5 blocks; the decoders' fc1
    split in two under "all"): 12 launches in bf16 and under "out", 13
    under "io", 15 under "all". K6 quantizes its own A in every product
    but the input product, so the standalone K5 runs only there; the
    standalone K2 and K3 never run."""
    _, _, pmodel = make_pair(num_steps=6)
    sampler = FusedSampler(pmodel, "cpu", quantize=quantize)
    calls = _count_calls(monkeypatch)
    sampler.sample(torch.zeros(3, 3), torch.Generator().manual_seed(0), stop_after=1)
    assert {k: v for k, v in calls.items() if v} == launches
    assert sum(launches.values()) == {None: 12, "out": 12, "io": 13, "all": 15}[quantize]


def test_unfused_block_route_matches_jax(monkeypatch):
    """Hidden 128/192/128: groups of 24 columns fit no tile width, so the
    two 192-wide blocks run their products and K2 apart through the f32
    pre-activation, the three 128-wide ones fuse GN. The sampler in "buffer"
    mode still matches the TPU kernel in interpret mode at the bf16-carry
    tolerance (tests/test_torch_sampler.py)."""
    jmodel, params, pmodel = make_pair(num_steps=6, hidden=(128, 192, 128))
    sampler = FusedSampler(pmodel, "cpu")
    assert [b.fused for b in sampler.encoders + [sampler.bottleneck] + sampler.decoders] == [
        False, True, True, False, True]
    assert sampler._buffers(4)["pre"].numel() == 4 * 192
    b, d = 2 * TILE_B, sampler.data_dim
    rng = jax.random.PRNGKey(12)
    cond = np.random.default_rng(13).standard_normal((b, 3)).astype(np.float32)
    noise = np.random.default_rng(14).standard_normal((6, b, d)).astype(np.float32)
    ref = np.asarray(JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True,
                                     gn_mode="f32").sample(jnp.asarray(cond), rng,
                                                           noise=jnp.asarray(noise)))
    init_rng, _ = jax.random.split(rng)
    x_init = np.array(jax.random.normal(init_rng, (b, d), jnp.bfloat16).astype(jnp.float32))
    calls = _count_calls(monkeypatch)
    got = sampler.sample(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                         x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise)).numpy()
    assert calls["groupnorm8_silu"] == 6 * 4 and calls["gemm_bf16_gn_silu"] == 6 * 6
    np.testing.assert_allclose(got, ref, atol=0.15, rtol=0.05)
    assert float(np.std(ref)) > 0.05
