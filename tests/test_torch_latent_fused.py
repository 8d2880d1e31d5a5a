"""The latent step on one launch (``gemm_bf16_latent_step``: both of the
step's products with K7's work as the epilogue of K1's mainloop), through
its plain version on the CPU.

The fused step moves K7's draw one step on: a priming draw gives zeta_0
before the loop, and step k's launch adds w_k·h_k and draws zeta_{k+1}.
Its plain version must give the old composition's bits (K1 -> K7 draw ->
K1 -> K7 update a step) over a whole segment, priming draw and last step
included; the card tests (tests/test_torch_cuda.py) hold the kernel to it.
The sampler built on it is held to the JAX package in
tests/test_torch_latent.py.
"""

import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_torch.ops import fused_sampler as fs
from osteosarcoma_diffusionmodel_torch.ops import latent_sampler as ls
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk
from osteosarcoma_diffusionmodel_torch.ops.latent_sampler import LatentFusedSampler
from torch_parity import make_pair

M, H = 10, 24  # H a multiple of 8, as the kernel needs


def _segment(n_lat, seed=0):
    """Seeded operands of an n_lat-step segment: weights, coefficients,
    the initial state, a buffer of zeta draws and a stand-in for the
    hidden stack (the next h depends on h_in, as the sampler's does)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    w_stack = f(H, H) / np.sqrt(H)
    ops = dict(
        m2=(f(H, H) / np.sqrt(H)).bfloat16(), m_b=f(H), l_t=(f(H, H) / np.sqrt(H)).bfloat16(),
        c_proj=f(M, H), t_add=f(n_lat + 1, H),
        coeffs=torch.from_numpy(rng.uniform(0.1, 1.0, (n_lat, 5)).astype(np.float32)),
        zeta=f(n_lat, M, H),
    )
    s0 = f(M, H)

    def stack(h_in):
        return torch.tanh(h_in.float() @ w_stack).bfloat16()

    return ops, s0, stack


def _old_loop(ops, s0, stack, mode, seed):
    """The composition before the fusion: per step K1, draw, K1, update."""
    n_lat = ops["coeffs"].shape[0]
    s = s0.clone()
    h_in = (s + ops["t_add"][0] + ops["c_proj"]).bfloat16()
    h_acc, xi = torch.zeros(M, H), torch.zeros(M, H)
    zeta_bf = torch.empty(M, H, dtype=torch.bfloat16)
    o_lat, n_inj = torch.empty(M, H), torch.empty(M, H)
    for k in range(n_lat):
        h = stack(h_in)
        sk.gemm_bf16_f32acc(h, ops["m2"], out=o_lat, bias=ops["m_b"])
        sk.latent_draw(h, h_acc, xi, zeta_bf, ops["coeffs"], k, mode, zeta=ops["zeta"], seed=seed)
        sk.gemm_bf16_f32acc(zeta_bf, ops["l_t"], out=n_inj)
        sk.latent_update(s, o_lat, n_inj, ops["c_proj"], ops["t_add"], ops["coeffs"], k, h_in)
    return s, h_in, h_acc, xi


def _fused_loop(ops, s0, stack, mode, seed):
    """The sampler's loop: one priming draw, then one fused step a step,
    the zeta buffers alternating by parity."""
    n_lat = ops["coeffs"].shape[0]
    s = s0.clone()
    h_in = (s + ops["t_add"][0] + ops["c_proj"]).bfloat16()
    h_acc, xi = torch.zeros(M, H), torch.zeros(M, H)
    zeta_bf = [torch.full((M, H), float("nan"), dtype=torch.bfloat16) for _ in range(2)]
    sk.latent_draw(None, None, xi, zeta_bf[0], ops["coeffs"], 0, mode, zeta=ops["zeta"], seed=seed)
    for k in range(n_lat):
        h = stack(h_in)
        sk.gemm_bf16_latent_step(h, ops["m2"], ops["m_b"], zeta_bf[k % 2], ops["l_t"], s,
                                 ops["c_proj"], ops["t_add"], ops["coeffs"], k, h_in, h_acc, xi,
                                 zeta_bf[(k + 1) % 2], mode, zeta=ops["zeta"], seed=seed)
    return s, h_in, h_acc, xi


@pytest.mark.parametrize("mode", ["philox", "buffer"])
@pytest.mark.parametrize("n_lat", [1, 2, 5])
def test_fused_step_equals_the_old_composition(mode, n_lat):
    """Over a whole segment (the priming draw, every step, the last one
    drawing nothing) the carry s, h_in, H_acc and xi equal the old loop's
    bit for bit, and no kernel counted a launch (CPU tensors)."""
    ops, s0, stack = _segment(n_lat, seed=n_lat)
    before = (sk.GEMM_LATENT.launches, sk.LATENT.launches, sk.GEMM.launches)
    old = _old_loop(ops, s0, stack, mode, seed=123)
    new = _fused_loop(ops, s0, stack, mode, seed=123)
    for name, a, b in zip(("s", "h_in", "h_acc", "xi"), old, new):
        assert torch.equal(a, b), name
    assert bool(torch.isfinite(new[0]).all()) and float(new[3].abs().max()) > 0
    assert (sk.GEMM_LATENT.launches, sk.LATENT.launches, sk.GEMM.launches) == before


@pytest.mark.parametrize("mode", ["philox", "buffer"])
def test_fused_step_plain_written_out(mode):
    """One fused step against the same arithmetic written out: the two
    products in f32, w_k·h into H_acc, zeta_{k+1} (Philox keyed by
    (seed, k + 1) at row·H + col, or zeta[k + 1]) into xi and the other
    buffer, then the update. The last step leaves xi and that buffer alone."""
    ops, s0, stack = _segment(3, seed=7)
    h = stack((s0 + ops["c_proj"]).bfloat16())
    zcur = torch.randn(M, H, generator=torch.Generator().manual_seed(1)).bfloat16()
    cf = ops["coeffs"]
    for k in (1, 2):
        s, h_acc, xi = s0.clone(), torch.ones(M, H), torch.full((M, H), 0.5)
        h_in = torch.empty(M, H, dtype=torch.bfloat16)
        znext = torch.zeros(M, H, dtype=torch.bfloat16)
        sk.gemm_bf16_latent_step(h, ops["m2"], ops["m_b"], zcur, ops["l_t"], s, ops["c_proj"],
                                 ops["t_add"], cf, k, h_in, h_acc, xi, znext, mode,
                                 zeta=ops["zeta"], seed=5)
        o = h.float() @ ops["m2"].float() + ops["m_b"]
        n = zcur.float() @ ops["l_t"].float()
        want_s = cf[k, 0] * s0 + cf[k, 1] * o + cf[k, 2] * n
        assert torch.equal(s, want_s)
        assert torch.equal(h_in, (want_s + ops["t_add"][k + 1] + ops["c_proj"]).bfloat16())
        assert torch.equal(h_acc, 1.0 + cf[k, 3] * h.float())
        if k + 1 < cf.shape[0]:
            z = (ops["zeta"][k + 1] if mode == "buffer"
                 else sk.philox_uniform_noise(5, k + 1, M, H))
            assert torch.equal(xi, 0.5 + cf[k + 1, 4] * z)
            assert torch.equal(znext, z.bfloat16())
        else:
            assert torch.equal(xi, torch.full((M, H), 0.5))
            assert not znext.any()


def test_priming_draw_leaves_h_acc_alone():
    ops, _, _ = _segment(3)
    xi, zbf = torch.zeros(M, H), torch.empty(M, H, dtype=torch.bfloat16)
    sk.latent_draw(None, None, xi, zbf, ops["coeffs"], 0, "buffer", zeta=ops["zeta"])
    assert torch.equal(zbf, ops["zeta"][0].bfloat16())
    assert torch.equal(xi, ops["coeffs"][0, 4] * ops["zeta"][0])
    with pytest.raises(ValueError):  # h without hacc
        sk.latent_draw(zbf, None, xi, zbf, ops["coeffs"], 0, "buffer", zeta=ops["zeta"])


def test_fused_step_arguments_are_checked():
    ops, s0, stack = _segment(3)
    h = stack(s0.bfloat16())
    z = torch.zeros(M, H, dtype=torch.bfloat16)
    state = dict(s=s0.clone(), c_proj=ops["c_proj"], t_add=ops["t_add"], coeffs=ops["coeffs"],
                 h_in=torch.empty(M, H, dtype=torch.bfloat16), h_acc=torch.zeros(M, H),
                 xi=torch.zeros(M, H))

    def call(**kw):
        args = dict(h=h, m2=ops["m2"], m_b=ops["m_b"], zeta_bf_cur=z, l_t=ops["l_t"], **state,
                    step=0, zeta_bf_next=torch.zeros(M, H, dtype=torch.bfloat16), mode="philox")
        args.update(kw)
        sk.gemm_bf16_latent_step(**args)

    call()
    with pytest.raises(ValueError):  # the buffer the launch reads
        call(zeta_bf_next=z)
    with pytest.raises(ValueError):
        call(mode="none")
    with pytest.raises(ValueError):  # buffer mode without zeta
        call(mode="buffer")
    with pytest.raises(IndexError):
        call(step=3)
    with pytest.raises(ValueError):  # t_add has no row after the step
        call(t_add=ops["t_add"][:2], step=1)
    with pytest.raises(ValueError):  # H not a multiple of 8
        call(h=h[:, :20], m2=ops["m2"][:20, :20], l_t=ops["l_t"][:20, :20],
             zeta_bf_cur=z[:, :20].contiguous())
    with pytest.raises(TypeError):
        call(m2=ops["m2"].float())


def _count_calls(monkeypatch):
    """Spies on every kernel wrapper the latent sampler reaches (its own
    module's, and the fused sampler's, which the head and the stack call)."""
    calls = {}
    for mod, names in ((ls, ("gemm_bf16_latent_step", "latent_draw")),
                       (fs, ("gemm_bf16_f32acc", "gemm_bf16_gn_silu", "gemm_bf16_posterior",
                             "groupnorm8_silu", "gemm_s8", "gemm_s8q_gn_silu", "rowquant_s8"))):
        for name in names:
            real = getattr(mod, name)
            calls[name] = 0

            def spy(*args, _name=name, _real=real, **kw):
                calls[_name] += 1
                return _real(*args, **kw)

            monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("head", [1, 3])
@pytest.mark.parametrize("buffer", [False, True])
def test_latent_step_launches(monkeypatch, head, buffer):
    """The parity model's stack has five blocks (hidden 128/256/128), so a
    latent step is 11 launches: 10 block products with the GN epilogue and
    one fused step; one priming draw a call; the head's steps are the
    data-space sampler's 12 each, and the final stack (h0) adds 10. The
    sampler reaches no other wrapper: not K7's standalone update (the
    module does not import it), nor K2 apart, nor an int8 product."""
    _, _, pmodel = make_pair(num_steps=8, compute_dtype="float32")
    sampler = LatentFusedSampler(pmodel, head, "cpu")
    n_lat = sampler.n_lat
    calls = _count_calls(monkeypatch)
    zeta = torch.zeros(n_lat, 4, sampler.H0) if buffer else None
    out = sampler.sample(torch.zeros(4, 3), torch.Generator().manual_seed(0), zeta=zeta)
    assert out.shape == (4, sampler.tables.data_dim) and bool(torch.isfinite(out).all())
    assert calls == {"gemm_bf16_latent_step": n_lat, "latent_draw": 1,
                     "gemm_bf16_f32acc": head, "gemm_bf16_posterior": head,
                     "gemm_bf16_gn_silu": 10 * (head + n_lat + 1), "groupnorm8_silu": 0,
                     "gemm_s8": 0, "gemm_s8q_gn_silu": 0, "rowquant_s8": 0}
    latent_launches = calls["gemm_bf16_gn_silu"] - 10 * (head + 1) + calls["gemm_bf16_latent_step"]
    assert latent_launches == 11 * n_lat
