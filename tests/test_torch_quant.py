"""The int8 ``quantize`` variants of the port's sampler against the JAX package.

The weight packing (the TPU's ``_pack_mat``), K5's activation
quantization and K6's integer product with its dequantization (the
TPU's int8 ``mm``) through their plain versions, the decoder's split fc1,
and whole samplers in "out", "io" and "all" against the TPU kernel in
interpret mode, at the bounds of the JAX package's own quantized-sampler
test (tests/test_fused_quant.py:76-96).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops import fused_sampler as jax_fs
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler, quant_flags
from torch_parity import DATA_DIMS, TILE_B, make_pair

D = sum(DATA_DIMS)
B = 2 * TILE_B
MODES = ["out", "io", "all"]


@pytest.fixture(scope="module")
def pair():
    return make_pair(num_steps=6)


@pytest.mark.parametrize("mode", [None] + MODES)
def test_quant_flags_match_jax(mode):
    assert quant_flags(mode) == jax_fs._quant_flags(mode)


def test_unknown_quantize_mode_raises(pair):
    _, _, pmodel = pair
    with pytest.raises(ValueError):
        FusedSampler(pmodel, "cpu", quantize="weights")
    with pytest.raises(ValueError):
        quant_flags("none")  # the config's "none" is the sampler's None


def test_pack_int8_matches_jax_pack_mat():
    """Codes and scales identical to the TPU packing (the same float32
    numpy), a zero column included (scale floor 1e-8); padding is zeros."""
    w = np.random.default_rng(0).normal(size=(70, 37)).astype(np.float32)
    w[:, 5] = 0.0
    q, scale = sk.pack_int8(w)
    jq, js = jax_fs._pack_mat(w, True)
    assert q.shape == (80, 48) and q.dtype == torch.int8
    np.testing.assert_array_equal(q[:70, :37].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js).reshape(-1))
    assert not q[70:].any() and not q[:, 37:].any()


def _jax_mm_quant(xf):
    """The TPU kernel's activation quantization (fused_sampler.py:336-339)."""
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-6)
    q = jnp.round(xf * (127.0 / amax)).astype(jnp.int8)
    return q, amax * (1.0 / 127.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rowquant_matches_jax_mm_quantization(dtype):
    """Equal codes and scales, with exact .5 ties rounding to even (row 0:
    amax 127, so the codes are the values), a zero row (amax floor 1e-6),
    the D3PM transform 2x - 1 on the first columns, and a strided view."""
    rng = np.random.default_rng(1)
    base = (3 * rng.standard_normal((9, 90))).astype(np.float32)
    base[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    base[1] = 0.0
    base[2:, :10] = (rng.uniform(size=(7, 10)) < 0.5)
    x = torch.from_numpy(base).to(dtype)
    view = x[:, 7:77]
    for a, mut in ((x, 0), (x, 10), (view, 0)):
        q, scale = sk.rowquant_s8(a, mut_cols=mut)
        xf = sk.mutation_transform(a, mut).numpy()
        jq, js = _jax_mm_quant(jnp.asarray(xf))
        k = a.shape[1]
        assert q.shape == (a.shape[0], sk.pad16(k)) and not q[:, k:].any()
        np.testing.assert_array_equal(q[:, :k].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js).reshape(-1))
    q, _ = sk.rowquant_s8(x)
    assert q[0, :6].tolist() == [127, 2, -4, 0, 0, 2]


def test_gemm_s8_matches_jax_int8_dot():
    """The s8·s8 -> s32 product and dequantization of the TPU's ``mm``
    (:340-346): exact integers, the same f32 operations, so equal."""
    rng = np.random.default_rng(2)
    x = (2 * rng.standard_normal((21, 70))).astype(np.float32)
    w = rng.standard_normal((70, 37)).astype(np.float32)
    qa, rs = sk.rowquant_s8(torch.from_numpy(x))
    qb, cs = sk.pack_int8(w)
    got = sk.gemm_s8(qa, rs, qb, cs)
    jq, jrs = _jax_mm_quant(jnp.asarray(x))
    jqw, jsw = jax_fs._pack_mat(w, True)
    acc = jax.lax.dot_general(jq, jqw, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    ref = acc.astype(jnp.float32) * jrs * jsw
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gemm_s8_epilogue_and_accumulate():
    """Bias, row add, bf16 out, and the split product: two parts summed in
    f32 equal the plain sum of the two dequantized products."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32))
    w = rng.standard_normal((48, 24)).astype(np.float32)
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    row_add = torch.from_numpy(rng.standard_normal((5, 24)).astype(np.float32))
    parts = [(0, 32), (32, 48)]
    terms = []
    for lo, hi in parts:
        qa, rs = sk.rowquant_s8(h[:, lo:hi])
        qb, cs = sk.pack_int8(w[lo:hi])
        terms.append((qa, rs, qb, cs))
    out = torch.empty(5, 24)
    sk.gemm_s8(*terms[0], out=out)
    sk.gemm_s8(*terms[1], out=out, bias=bias, row_add=row_add, accumulate=True)
    ref = (sk.gemm_s8_plain(*terms[0]) + sk.gemm_s8_plain(*terms[1])) + bias + row_add
    assert torch.equal(out, ref)
    b16 = sk.gemm_s8(*terms[0], out=torch.empty(5, 24, dtype=torch.bfloat16), bias=bias)
    assert torch.equal(b16, (sk.gemm_s8_plain(*terms[0]) + bias).to(torch.bfloat16))
    with pytest.raises(ValueError):
        sk.gemm_s8(*terms[0], out=b16, accumulate=True)


def test_all_mode_packs_every_product_like_jax(pair):
    """Under "all" every product is int8 and each decoder's fc1 is two
    parts split at [h | skip] with their own scales, as the TPU's
    ``_block_weights`` packs them."""
    jmodel, params, pmodel = pair
    sampler = FusedSampler(pmodel, "cpu", quantize="all")
    p = jax.tree_util.tree_map(np.asarray, params)
    for j, blk in enumerate(sampler.decoders):
        prev = (sampler.bottleneck if j == 0 else sampler.decoders[j - 1]).features
        skip = sampler.encoders[len(sampler.encoders) - 1 - j].features
        ref = jax_fs._block_weights(p[f"dec_{j}"], [prev, skip], True)
        assert len(blk.fc1.parts) == 2
        for (lo, hi, q, scale), (jq, js) in zip(blk.fc1.parts, (ref[0:2], ref[2:4])):
            np.testing.assert_array_equal(q[: hi - lo, : scale.shape[0]].numpy(), np.asarray(jq))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(js).reshape(-1))
    assert sampler.w_in.parts and sampler.w_out.parts and sampler.encoders[0].fc2.parts
    out_only = FusedSampler(pmodel, "cpu", quantize="out")
    assert out_only.w_out.parts and not out_only.w_in.parts and not out_only.encoders[0].fc1.parts


@pytest.mark.parametrize("mode", MODES)
def test_quantized_sampler_tracks_jax_interpret(pair, mode):
    """Same weights, x_T and noise; the port's kernel sampler (plain
    versions) and its plain int8 loop against the TPU kernel in interpret
    mode with the same ``quantize``: elementwise correlation > 0.99, RMS
    < 8% of the spread, per-column mean and std within 0.08 (the JAX
    package's own bounds, tests/test_fused_quant.py:88-96)."""
    jmodel, params, pmodel = pair
    cond = np.random.default_rng(4).standard_normal((B, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(2)
    noise = np.random.default_rng(5).standard_normal((6, B, D)).astype(np.float32)
    ref = np.asarray(jax_fs.FusedSampler(jmodel, params, tile_b=TILE_B, interpret=True,
                                         gn_mode="f32", quantize=mode)
                     .sample(jnp.asarray(cond), rng, noise=jnp.asarray(noise)))
    init_rng, _ = jax.random.split(rng)
    x_init = torch.from_numpy(np.array(jax.random.normal(init_rng, (B, D), jnp.bfloat16)
                                       .astype(jnp.float32)))
    args = (torch.from_numpy(cond), torch.Generator().manual_seed(0))
    kw = dict(x_init=x_init, noise=torch.from_numpy(noise))
    for got in (FusedSampler(pmodel, "cpu", quantize=mode).sample(*args, **kw).numpy(),
                pmodel.sample(*args, **kw, quantize=mode).numpy()):
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99
        assert float(np.sqrt(((got - ref) ** 2).mean())) < 0.08 * float(ref.std())
        np.testing.assert_allclose(got.mean(0), ref.mean(0), atol=0.08)
        np.testing.assert_allclose(got.std(0), ref.std(0), atol=0.08)


def test_quantized_ddim_runs_and_differs_from_bf16(pair):
    """DDIM under each mode: finite, the same shape, and not the bf16
    result (the int8 products are in the loop)."""
    _, _, pmodel = pair
    cond = torch.zeros(5, 3)
    base = FusedSampler(pmodel, "cpu", ddim_steps=3).sample(cond, torch.Generator().manual_seed(1))
    for mode in MODES:
        out = FusedSampler(pmodel, "cpu", ddim_steps=3, quantize=mode).sample(
            cond, torch.Generator().manual_seed(1))
        assert out.shape == base.shape and torch.isfinite(out).all()
        assert not torch.equal(out, base)


def test_d3pm_with_int8_out_keeps_bits_binary():
    """The TPU test of the same name (tests/test_fused_quant.py:99-114):
    the D3PM head with quantize "out", buffer noise, bits stay 0/1; and
    the port's "all" with the head quantizes the input's 2b - 1 view."""
    _, _, pmodel = make_pair(num_steps=6, discrete=True)
    m = DATA_DIMS[0]
    cond = torch.from_numpy(np.random.default_rng(6).standard_normal((TILE_B, 3)).astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal((6, TILE_B, D))
                             .astype(np.float32))
    for mode in ("out", "all"):
        out = FusedSampler(pmodel, "cpu", quantize=mode).sample(
            cond, torch.Generator().manual_seed(5), noise=noise)
        assert set(torch.unique(out[:, :m]).tolist()) <= {0.0, 1.0}
        assert torch.isfinite(out).all()
