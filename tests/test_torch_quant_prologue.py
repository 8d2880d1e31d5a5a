"""K5's work as K6's quantizing prologue (the ``gemm_s8q`` wrappers).

On CPU tensors the wrappers run the plain composition they replace,
``rowquant_s8_plain`` then ``gemm_s8*_plain``, so these tests hold the
wrappers' plumbing -- row-strided [h | skip] views, ragged M, K parts of
256 and 512, the decoder's two-part fc1, every noise mode with and
without the D3PM head -- to K5 -> K6 bit for bit, the quantization to the
TPU's int8 ``mm``, and the int8 sampler's carry to the route where K5 runs
before every product. On the card, tests/test_torch_cuda.py holds the
kernels to K5 -> K6 the same way.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops import fused_sampler as jax_fs
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
from torch_parity import DATA_DIMS, TILE_B, make_pair

D = sum(DATA_DIMS)


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
        torch.bfloat16)


def _weight(rng, k, n):
    """K-major codes (pad16(n), pad16(k)) and column scales of a (k, n) weight."""
    q, cs = sk.pack_int8(rng.standard_normal((k, n)).astype(np.float32) / math.sqrt(k))
    return sk.kmajor_int8(q), cs


def _skip_half(rng, m, k, prev=64):
    """The skip half of a decoder's [h | skip] bf16 buffer: a row-strided view."""
    buf = torch.zeros(m, prev + k, dtype=torch.bfloat16)
    view = buf[:, prev:]
    view.copy_(_bf16(rng, m, k, scale=3.0))
    return view


@pytest.mark.parametrize("m", [37, 70])
@pytest.mark.parametrize("k", [256, 512])
@pytest.mark.parametrize("out_dtype,accumulate", [(torch.float32, False), (torch.bfloat16, False),
                                                  (torch.float32, True)])
def test_gemm_s8q_equals_k5_then_k6(m, k, out_dtype, accumulate):
    """The plain epilogue: + bias (+ row_add), f32 or bf16 out, and the
    accumulating form, on a strided A, bit for bit K5 -> K6."""
    rng = np.random.default_rng(m + k + accumulate)
    a = _skip_half(rng, m, k)
    qb, cs = _weight(rng, k, 96)
    bias = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    row_add = torch.from_numpy(rng.standard_normal((m, 96)).astype(np.float32))
    start = torch.from_numpy(rng.standard_normal((m, 96)).astype(np.float32))
    out = start.clone() if accumulate else torch.empty(m, 96, dtype=out_dtype)
    got = sk.gemm_s8q(a, qb, cs, out=out, bias=bias, row_add=row_add, accumulate=accumulate)
    qa, rs = sk.rowquant_s8_plain(a)
    ref = sk.gemm_s8_plain(qa, rs, qb, cs, bias, row_add, start if accumulate else None)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, ref.to(out_dtype))
    # The same through the standalone K5 wrapper and K6.
    qa2, rs2 = sk.rowquant_s8(a)
    assert torch.equal(qa2, qa) and torch.equal(rs2, rs)


@pytest.mark.parametrize("m", [37, 70])
@pytest.mark.parametrize("parts", [(256,), (512,), (512, 256)])
def test_gemm_s8q_gn_silu_equals_k5_then_k6(m, parts):
    """GroupNorm+SiLU in the epilogue; (512, 256) is the decoder's fc1 over
    [h | skip]: the first part into the f32 pre-activation with the plain
    epilogue, the last reading it back, each part quantized on its own."""
    rng = np.random.default_rng(m + sum(parts))
    f = 128
    a = torch.zeros(m, sum(parts) + 16, dtype=torch.bfloat16)[:, 16:]
    a.copy_(_bf16(rng, m, sum(parts), scale=3.0))
    bias = torch.from_numpy(rng.standard_normal(f).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(f)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.standard_normal(f)).astype(np.float32))
    cuts, lo = [], 0
    for size in parts:
        cuts.append((lo, lo + size, *_weight(rng, size, f)))
        lo += size
    out = torch.zeros(m, f + 8, dtype=torch.bfloat16)[:, :f]
    pre = torch.empty(m, f)
    ref_pre = None
    for lo, hi, qb, cs in cuts[:-1]:
        sk.gemm_s8q(a[:, lo:hi], qb, cs, out=pre)
        ref_pre = sk.gemm_s8_plain(*sk.rowquant_s8_plain(a[:, lo:hi]), qb, cs)
    lo, hi, qb, cs = cuts[-1]
    acc = pre if len(cuts) > 1 else None
    got = sk.gemm_s8q_gn_silu(a[:, lo:hi], qb, cs, bias, scale, shift, out=out, acc_into=acc)
    v = sk.gemm_s8_plain(*sk.rowquant_s8_plain(a[:, lo:hi]), qb, cs, bias, acc_into=ref_pre)
    ref = sk.groupnorm8_silu_plain(v, scale, shift).to(torch.bfloat16)
    assert torch.equal(got, ref) and got.data_ptr() == out.data_ptr()
    if acc is not None:
        assert torch.equal(pre, ref_pre)  # read, not written


@pytest.mark.parametrize("mode", ["philox", "buffer", "none"])
@pytest.mark.parametrize("mut", [0, 10])
def test_gemm_s8q_posterior_equals_k5_then_k6(mode, mut):
    """The output product with the reverse step on a padded carry: the
    carry equals the one K5 -> K6 -> K3's plain versions give, in every
    noise mode, with and without D3PM bits."""
    rng = np.random.default_rng(len(mode) + mut)
    m, k, d = 37, 256, 100
    h = _bf16(rng, m, k, scale=2.0)
    qb, cs = _weight(rng, k, d)
    x = torch.zeros(m, sk.pad16(d), dtype=torch.bfloat16)[:, :d]
    x.copy_(_bf16(rng, m, d))
    if mut:
        x[:, :mut] = torch.from_numpy((rng.uniform(size=(m, mut)) < 0.5).astype(np.float32))
    b_out = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, (4, 6)).astype(np.float32))
    coeffs[:, 4:] = torch.tensor([0.05, 0.7])
    noise = torch.from_numpy(rng.standard_normal((4, m, d)).astype(np.float32))
    step = dict(b_out=b_out, coeffs=coeffs, step=1, mode=mode, noise=noise, seed=3, mut_dim=mut)
    start = x.clone()
    sk.gemm_s8q_posterior(h, qb, cs, x, **step)
    acc = sk.gemm_s8_plain(*sk.rowquant_s8_plain(h), qb, cs)
    ref = sk.x0_posterior_step_plain(acc, start, b_out, coeffs, 1, mode, noise, 3, 30.0, mut)
    assert torch.equal(x, ref) and not torch.equal(x, start)


def _jax_mm_quant(xf):
    """The TPU kernel's activation quantization (fused_sampler.py:336-339)."""
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-6)
    q = jnp.round(xf * (127.0 / amax)).astype(jnp.int8)
    return q, amax * (1.0 / 127.0)


@pytest.mark.parametrize("k", [256, 512])
def test_gemm_s8q_matches_jax_int8_mm(k):
    """The prologue's quantization and K6's product against the TPU's int8
    ``mm`` (:336-346) on the same bf16 activations, with exact .5 ties and
    a zero row: equal, as tests/test_torch_quant.py holds K5."""
    rng = np.random.default_rng(k)
    x = (3 * rng.standard_normal((21, k))).astype(np.float32)
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    x[1] = 0.0
    a = torch.from_numpy(x).to(torch.bfloat16)
    w = rng.standard_normal((k, 37)).astype(np.float32)
    q, cs = sk.pack_int8(w)
    jq, jrs = _jax_mm_quant(jnp.asarray(a.float().numpy()))
    jqw, jsw = jax_fs._pack_mat(w, True)
    acc = jax.lax.dot_general(jq, jqw, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    ref = np.asarray(acc.astype(jnp.float32) * jrs * jsw)
    np.testing.assert_array_equal(sk.gemm_s8q(a, sk.kmajor_int8(q), cs).numpy(), ref)


def test_gemm_s8q_checks_arguments():
    rng = np.random.default_rng(9)
    qb, cs = _weight(rng, 1040, 32)
    with pytest.raises(ValueError, match="prologue takes K"):
        sk.gemm_s8q(_bf16(rng, 4, 1040), qb, cs)  # K past the shared-memory strip
    qb, cs = _weight(rng, 256, 32)
    with pytest.raises(ValueError, match="qb must be"):
        sk.gemm_s8q(_bf16(rng, 4, 240), qb, cs)  # codes of another K
    with pytest.raises(TypeError):
        sk.gemm_s8q(_bf16(rng, 4, 256).float(), qb, cs)  # the prologue reads bf16
    with pytest.raises(ValueError):
        sk.gemm_s8q(_bf16(rng, 4, 256), qb, cs, out=torch.empty(4, 32, dtype=torch.bfloat16),
                    accumulate=True)


def _without_prologue(sampler):
    """The same sampler routed as before K6 quantized its own A: K5 before
    every int8 product."""
    blocks = sampler.encoders + [sampler.bottleneck] + sampler.decoders
    for w in [sampler.w_in, sampler.w_out] + [b.fc1 for b in blocks] + [b.fc2 for b in blocks]:
        w.prologue = False
    return sampler


@pytest.mark.parametrize("mode,discrete", [("out", False), ("io", False), ("all", False),
                                           ("all", True)])
def test_int8_sampler_carry_equals_the_k5_route(mode, discrete):
    """DDPM with buffer noise and DDIM under each int8 mode (and "all" with
    the D3PM head): the carry through K6's prologue equals the carry with
    K5 before every product, bit for bit; the prologue runs on every block
    and output product, K5 only on the input product."""
    _, _, pmodel = make_pair(num_steps=6, discrete=discrete)
    cond = torch.from_numpy(np.random.default_rng(6).standard_normal((TILE_B, 3))
                            .astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal((6, TILE_B, D))
                             .astype(np.float32))
    for ddim, kw in ((None, dict(noise=noise)), (3, {})):
        fused = FusedSampler(pmodel, "cpu", ddim_steps=ddim, quantize=mode)
        blocks = fused.encoders + [fused.bottleneck] + fused.decoders
        assert not fused.w_in.prologue and fused.w_out.prologue
        assert all(b.fc1.prologue == (mode == "all") for b in blocks)
        apart = _without_prologue(FusedSampler(pmodel, "cpu", ddim_steps=ddim, quantize=mode))
        got = fused.sample(cond, torch.Generator().manual_seed(5), **kw)
        ref = apart.sample(cond, torch.Generator().manual_seed(5), **kw)
        assert torch.equal(got, ref) and torch.isfinite(got).all()
