"""The hybrid transformer denoiser (Kimi-Linear-48B-A3B's block pattern,
``model.transformer.linear_attn_config``; models/kda.py, ops/kda.py,
models/dit.py) against its plain reference
(tests/torch_reference_kimi_linear.py), at tiny widths on the CPU.

The chunked KDA twin against the reference's token-by-token recurrence
(lengths 1, 63, 64, 65 and 130, chunks 64 and 16, decays down to e^-60 a
token); the tiny hybrid model (KDA and NoPE MLA layers read from
``linear_attn_config``, an expert share) against the reference on seeded
weights, and through the scan DDIM; the four expert shares adding up to
the uncut layer; the refusals of ``check_transformer``; the preset at
published widths (on the meta device) and through the generator and the
CLI at tiny widths.
"""

import dataclasses

import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config, TransformerConfig
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.dit import (
    MLAttention,
    MoEFeedForward,
    MoonlightDiT,
    check_transformer,
)
from osteosarcoma_diffusionmodel_torch.models.kda import KimiDeltaAttention
from osteosarcoma_diffusionmodel_torch.ops import kda as kda_ops
from osteosarcoma_diffusionmodel_torch.ops import moe
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS
from torch_reference_kimi_linear import KimiReference, ddim_chain

LINEAR = dict(kda_layers=[1, 2, 4], full_attn_layers=[3], num_heads=2, head_dim=8,
              short_conv_kernel_size=4)
TINY = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, intermediate_size=64,
            moe_intermediate_size=16, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, patch_size=2, time_embed_dim=16, mla_use_nope=True,
            linear_attn_config=LINEAR, ep_size=4, ep_rank=1)
BLOCKS = (10, 100, 14)  # 5 + 50 + 7 patches: 64 tokens, one whole chunk of 64
D = sum(BLOCKS)
C = 3
B = 4
# float32: the same operations as the reference in another order of sums
# (the chunked delta rule against the recurrence, a token's experts by slot
# against by expert, attention in PyTorch's kernel): a few float32 ulps
# through 4 layers.
F32 = dict(rtol=1e-4, atol=1e-5)
# bfloat16: both round the same operands and results to bf16; a rounding
# that another order of sums tips the other way moves one activation by one
# bf16 ulp (2^-8 relative); in a KDA layer such a flip in q or k passes
# through the L2 norm and the decayed sums of every later token, so the
# output moves by up to two ulps, 2^-7.
BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny_tc(**over) -> TransformerConfig:
    return TransformerConfig(**{**TINY, **over})


def conf_dict(tc: TransformerConfig) -> dict:
    return {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}


@torch.no_grad()
def seed_weights(module: torch.nn.Module, seed: int) -> None:
    """Weights and biases U(±1/sqrt(fan_in)) (a convolution's fan-in its
    taps), RMSNorm scales 1 + 0.2·U(±1), correction biases 0.1·U(±1), KDA's
    A_log and dt_bias as published (A ~ U(1, 16), dt ~ logU(0.001, 0.1))."""
    g = torch.Generator().manual_seed(seed)
    state = module.state_dict()
    for name, t in state.items():
        u = torch.rand(t.shape, generator=g) * 2 - 1
        if name.endswith("A_log"):
            u = torch.log(1 + 15 * (u + 1) / 2)
        elif name.endswith("dt_bias"):
            dt = torch.exp(np.log(1e-3) + (np.log(1e-1) - np.log(1e-3)) * (u + 1) / 2)
            u = dt + torch.log(-torch.expm1(-dt))
        elif name.endswith("norm.weight"):
            u = 1 + 0.2 * u
        elif name.endswith("e_score_correction_bias"):
            u = 0.1 * u
        else:
            w = state[name[:-4] + "weight"] if name.endswith(".bias") else t
            u = u / w.shape[1] ** 0.5
        t.copy_(u.to(t.dtype))


def make_dit(dtype=torch.float32, seed=0, **over) -> MoonlightDiT:
    m = MoonlightDiT(tiny_tc(**over), BLOCKS, C, dtype).eval()
    seed_weights(m, seed)
    return m


def inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, D, generator=g), torch.rand(B, generator=g),
            torch.randn(B, C, generator=g))


def record_routes(model: MoonlightDiT, calls: list):
    for layer in model.moe_layers():
        inner = layer.route

        def route(x, inner=inner):
            choice, weight = inner(x)
            calls[-1].append(choice.clone())
            return choice, weight

        layer.route = route


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def kda_inputs(b, length, heads, d, seed, steep=True):
    """Unit q and k, v ~ N(0, 1), β ~ U(0, 1), and g = −A·softplus(z), A ~
    U(1, 16) a head, z ~ N(−3, 2): channels from ≈ e^-0.00004 to ≈ e^-60 a
    token side by side (z ~ N(−6, 1) without ``steep``)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(b, length, heads, d, generator=g), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(b, length, heads, d, generator=g), dim=-1)
    v = torch.randn(b, length, heads, d, generator=g)
    a = 1 + 15 * torch.rand(heads, generator=g)
    z = torch.randn(b, length, heads, d, generator=g) * (2.0 if steep else 1.0) + (
        -3.0 if steep else -6.0)
    decay = -a[:, None] * torch.nn.functional.softplus(z)
    beta = torch.rand(b, length, heads, generator=g)
    return q, k, v, decay, beta


# ----------------------------------------------------------------------
# The chunked twin
# ----------------------------------------------------------------------
@pytest.mark.parametrize("length", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("chunk", [64, 16])
def test_twin_matches_the_recurrence(length, chunk):
    """Both float32; the twin forms each decay over a run of tokens as one
    exp of a difference of cumulative sums, the recurrence as a product of
    per-token factors: 1e-5 of max(1, max|o|) an element (measured ≈ 1e-6
    against float64)."""
    q, k, v, g, beta = kda_inputs(2, length, 3, 16, seed=length + chunk)
    assert float(g.min()) < -30  # steep channels beside slow ones
    want = KimiReference.delta_rule(q, k, v, g, beta, 0.25)
    got = kda_ops.kda_chunk_plain(q, k, v, g, beta, 0.25, chunk=chunk)
    assert got.shape == want.shape == (2, length, 3, 16)
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("steep", [True, False])
def test_wrapper_takes_the_twin_on_the_cpu_and_under_autograd(steep):
    q, k, v, g, beta = kda_inputs(1, 70, 2, 8, seed=5, steep=steep)
    launches = kda_ops.KDA.launches
    with torch.no_grad():
        out = kda_ops.kda_chunk(q, k, v, g, beta, 0.3)
    assert torch.equal(out, kda_ops.kda_chunk_plain(q, k, v, g, beta, 0.3))
    v.requires_grad_(True)
    kda_ops.kda_chunk(q, k, v, g, beta, 0.3).square().sum().backward()
    assert v.grad is not None and bool(torch.isfinite(v.grad).all())
    assert kda_ops.KDA.launches == launches


@pytest.mark.parametrize("needs", ["qkvgb", "v", "gb"])
def test_kernel_forward_differentiates_through_the_twin(needs):
    """The card's autograd path (``_KernelForward``: a launch forward, the
    twin recomputed backward), with the twin standing in for the launch:
    the same output and the same gradients as autograd through the twin,
    bit for bit (the same operations on the same inputs), and no gradient
    for an input that needs none."""
    inputs = kda_inputs(1, 70, 2, 8, seed=7, steep=True)
    names = "qkvgb"
    mine = [t.clone().requires_grad_(n in needs) for t, n in zip(inputs, names)]
    theirs = [t.clone().requires_grad_(n in needs) for t, n in zip(inputs, names)]
    got = kda_ops._KernelForward.apply(kda_ops.kda_chunk_plain, *mine, 0.3)
    want = kda_ops.kda_chunk_plain(*theirs, 0.3)
    assert torch.equal(got, want)
    weight = torch.linspace(-1.0, 1.0, want.numel()).view_as(want)
    (got * weight).sum().backward()
    (want * weight).sum().backward()
    for a, b, n in zip(mine, theirs, names):
        if n in needs:
            assert a.grad is not None and torch.equal(a.grad, b.grad), n
        else:
            assert a.grad is None, n


@pytest.mark.parametrize("fault", ["dtype", "strides", "beta shape"])
def test_wrapper_refuses_bad_operands(fault):
    q, k, v, g, beta = kda_inputs(1, 10, 2, 8, seed=6)
    args = {"dtype": (q.double(), k, v, g, beta),
            "strides": (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, g, beta),
            "beta shape": (q, k, v, g, beta[..., :1])}[fault]
    with pytest.raises(ValueError):
        kda_ops.kda_chunk(*args, 0.3)


def test_kda_sublayer_counts_its_chunks():
    m = make_dit()
    layer = m.layers[0].attn
    assert isinstance(layer, KimiDeltaAttention)
    before = COUNTERS["kda.chunks"]
    with torch.no_grad():
        layer(torch.randn(3, 130, 32).float())
    assert COUNTERS["kda.chunks"] - before == 3 * 2 * 3  # sequences x heads x ceil(130 / 64)


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------
def test_layer_pattern_is_read_from_linear_attn_config():
    m = make_dit()
    kinds = [type(blk.attn) for blk in m.layers]
    assert kinds == [KimiDeltaAttention, KimiDeltaAttention, MLAttention, KimiDeltaAttention]
    assert [blk.attn_span for blk in m.layers] == ["dit.kda", "dit.kda", "dit.attn", "dit.kda"]
    assert not m.layers[2].attn.rotary and MLAttention(tiny_tc(mla_use_nope=False),
                                                       torch.float32).rotary
    assert m.seq_len == 2 + 5 + 50 + 7
    for layer in m.moe_layers():
        assert (layer.experts, layer.held, layer.first) == (8, 2, 2)
        assert layer.w_gate_up.shape == (2, 32, 32) and layer.gate.weight.shape == (8, 32)


@pytest.mark.parametrize("dtype,routing", [(torch.float32, "free"), (torch.float32, "given"),
                                           (torch.bfloat16, "given")])
def test_tiny_hybrid_matches_the_reference(dtype, routing):
    model = make_dit(dtype)
    x, t, c = inputs()
    calls = [[]]
    record_routes(model, calls)
    with torch.no_grad():
        out = model(x, t, conditions=c)
    ref = KimiReference(model.state_dict(), conf_dict(model.config), BLOCKS, "cpu",
                        bf16=dtype == torch.bfloat16)
    with torch.no_grad():
        want = ref.forward(x, t, c, routes=calls[0] if routing == "given" else None)
    assert out.shape == (B, D) and out.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, **F32)
    else:
        assert rel(out, want) <= BF16_REL
    for choice in calls[0]:  # global ids over every routed expert
        assert int(choice.max()) >= 4 and int(choice.min()) <= 1


def test_bf16_choices_match_the_references_scores_up_to_near_ties():
    """In bf16 the router reads activations rounded as the reference rounds
    them; a choice may flip only where two biased scores tie within the
    rounding (the benchmark's ``route_gap_max``, under 1e-2)."""
    from torch_reference_dit import route_gaps

    model = make_dit(torch.bfloat16)
    x, t, c = inputs()
    calls = [[]]
    record_routes(model, calls)
    with torch.no_grad():
        model(x, t, conditions=c)
        scores = []
        KimiReference(model.state_dict(), conf_dict(model.config), BLOCKS, "cpu",
                      bf16=True).forward(x, t, c, routes=calls[0], scores_out=scores)
    gaps = [float(route_gaps(b, ch, 2).max()) for ch, b in zip(calls[0], scores)]
    assert len(gaps) == 3 and max(gaps) < 1e-2


@pytest.mark.parametrize("change", ["rope", "scalar decay", "other share"])
def test_the_reference_tells_the_mechanisms_apart(change):
    """What the hybrid adds moves the output well past the tolerances: RoPE
    in the MLA layer, a decay per head in place of per channel, another
    card's share of the experts."""
    model = make_dit()
    x, t, c = inputs()
    with torch.no_grad():
        want = model(x, t, conditions=c)
        state = model.state_dict()
        conf = conf_dict(model.config)
        if change == "rope":
            conf["mla_use_nope"] = False
        elif change == "scalar decay":
            for name in [n for n in state if n.endswith("dt_bias")]:
                state[name] = state[name].view(2, 8).mean(1, keepdim=True).expand(2, 8).reshape(-1)
        else:
            conf["ep_rank"] = 2
        got = KimiReference(state, conf, BLOCKS, "cpu", bf16=False).forward(x, t, c)
    assert rel(got, want) > 0.02


def test_expert_shares_add_up_to_the_uncut_layer():
    """Four cards' shares of a routed layer, each computing its 2 of the 8
    experts for the copies routed to them: their outputs, with the shared
    expert counted once, add up to the reference's uncut layer (every
    expert on one card), in float32 (another order of sums: 1e-5)."""
    torch.manual_seed(0)
    shares = [MoEFeedForward(tiny_tc(ep_rank=r), torch.float32) for r in range(4)]
    full = MoEFeedForward(tiny_tc(ep_size=1, ep_rank=0), torch.float32)
    seed_weights(full, 3)
    fs = full.state_dict()
    for r, layer in enumerate(shares):
        own = {k: (v[2 * r:2 * r + 2] if k in ("w_gate_up", "w_down") else v) for k, v in fs.items()}
        layer.load_state_dict(own)
    x = torch.randn(40, 32)
    with torch.no_grad():
        shared = full.shared(x)
        parts = [layer(x) - shared for layer in shares]
        got = sum(parts) + shared
        before = COUNTERS["moe.held_rows"], COUNTERS["moe.routed_rows"]
        shares[0](x)
    held = COUNTERS["moe.held_rows"] - before[0]
    assert COUNTERS["moe.routed_rows"] - before[1] == 80 and 0 < held < 80
    conf = conf_dict(tiny_tc(ep_size=1, ep_rank=0))
    weights = {f"layers.1.mlp.{k}": v for k, v in fs.items()}
    ref = KimiReference(weights, conf, BLOCKS, "cpu", bf16=False)
    with torch.no_grad():
        want = ref.moe(x, 1, None, None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert min(float(p.norm()) for p in parts) > 0  # every share computes copies


def test_every_expert_held_keeps_the_uncut_path(monkeypatch):
    """With ``ep_size`` 1, as Moonlight's layers are, no copy is dropped and
    the share's plan is never built: the same path and launches as
    before."""
    called = []
    monkeypatch.setattr(moe, "held_plan", lambda *a: called.append(a))
    layer = MoEFeedForward(tiny_tc(ep_size=1, ep_rank=0), torch.float32)
    seed_weights(layer, 4)
    before = COUNTERS["moe.held_rows"], COUNTERS["moe.routed_rows"]
    with torch.no_grad():
        layer(torch.randn(30, 32))
    assert not called
    assert COUNTERS["moe.held_rows"] - before[0] == COUNTERS["moe.routed_rows"] - before[1] == 60


def test_combine_adds_nothing_for_copies_held_elsewhere():
    """``combine_plain`` and ``grouped_down(..., tokens=T)`` with copies
    marked −1: each token sums its held copies only, left to right."""
    g = torch.Generator().manual_seed(8)
    t, k, n, rows = 6, 3, 5, 7
    y = torch.randn(rows, n, generator=g).to(torch.bfloat16)
    scale = torch.rand(rows, generator=g)
    dest = torch.randperm(t * k, generator=g)[:rows]
    src = torch.full((t * k,), -1, dtype=torch.int64)
    src[dest] = torch.arange(rows)
    got = moe.combine_plain(y, scale, src, k)
    want = torch.zeros(t, n)
    for slot, r in enumerate(src.tolist()):
        if r >= 0:
            want[slot // k] += scale[r] * y[r].float()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(moe.combine(y, scale, src, k), got)


# ----------------------------------------------------------------------
# Configuration
# ----------------------------------------------------------------------
@pytest.mark.parametrize("over", [
    {"linear_attn_config": {**LINEAR, "num_v_heads": 2}},
    {"linear_attn_config": {k: v for k, v in LINEAR.items() if k != "short_conv_kernel_size"}},
    {"linear_attn_config": {**LINEAR, "kda_layers": [1, 2]}},
    {"linear_attn_config": {**LINEAR, "kda_layers": [1, 2, 3, 4]}},
    {"linear_attn_config": {**LINEAR, "num_heads": 0}},
    {"ep_size": 3},
    {"ep_rank": 4},
    {"mla_use_nope": "yes"},
])
def test_unimplemented_kimi_values_raise(over):
    with pytest.raises(ValueError, match="model.transformer"):
        check_transformer(tiny_tc(**over))


def _preset(**transformer) -> Config:
    raw = yaml.safe_load(open("config/kimi_linear_dit.yaml"))
    raw["model"]["transformer"].update(transformer)
    return Config.from_dict(raw)


def test_preset_at_published_widths():
    """config/kimi_linear_dit.yaml on the meta device: 20 KDA and 7 NoPE MLA
    layers, 64 of 256 experts held, 1,289 tokens a patient, ≈ 13.0 B
    parameters held."""
    cfg = _preset()
    tc = cfg.model.transformer
    assert (tc.hidden_size, tc.n_routed_experts, tc.num_experts_per_tok, tc.ep_size) == \
        (2304, 256, 8, 4)
    with torch.device("meta"):
        m = MoonlightDiT(tc, (62, 5054, 26), 3, torch.bfloat16)
    assert m.seq_len == 1289 and m.patches == [16, 1264, 7]
    assert sum(isinstance(b.attn, KimiDeltaAttention) for b in m.layers) == 20
    assert [i + 1 for i, b in enumerate(m.layers) if isinstance(b.attn, MLAttention)] == \
        [4, 8, 12, 16, 20, 24, 27]
    assert all(layer.held == 64 and layer.gate.weight.shape[0] == 256 for layer in m.moe_layers())
    assert abs(sum(p.numel() for p in m.parameters()) - 13.0e9) < 0.1e9


@pytest.fixture(scope="module")
def cohort():
    c = make_dummy_cohort(30, *BLOCKS, seed=3)
    data, conditions, dims = cohort_arrays(c, Config())
    return c, data, conditions, dims


def _tiny_preset(compute_dtype="float32") -> Config:
    cfg = _preset(**{k: v for k, v in TINY.items()})
    cfg.model.compute_dtype = compute_dtype
    cfg.model.diffusion.num_steps = 20
    cfg.generation.sampling_steps = 5
    return cfg


def test_ddim_chain_matches_the_reference(cohort):
    _, _, conditions, dims = cohort
    cfg = _tiny_preset()
    model = ConditionalDiffusion.from_config(cfg, dims)
    seed_weights(model.denoiser, 2)
    g = torch.Generator().manual_seed(4)
    x_T = torch.randn(B, dims.data_dim, generator=g)
    cond = torch.from_numpy(conditions[:B])
    calls = []
    record_routes(model.denoiser, calls)
    inner = model.denoiser.forward

    def forward(*a, **k):
        calls.append([])
        return inner(*a, **k)

    model.denoiser.forward = forward
    out = model.scan_sample_ddim(cond, num_sampling_steps=5, draws={"x_T": x_T})
    ref = KimiReference(model.denoiser.state_dict(), conf_dict(cfg.model.transformer), BLOCKS,
                        "cpu", bf16=False)
    want = ddim_chain(ref, x_T, cond, schedule="cosine", num_steps=20, ddim_steps=5, clip=30.0,
                      routes=calls)
    torch.testing.assert_close(out, want, **F32)


def test_generator_runs_the_preset_and_counts(cohort):
    c, data, conditions, dims = cohort
    cfg = _tiny_preset("bfloat16")
    model = ConditionalDiffusion.from_config(cfg, dims)
    seed_weights(model.denoiser, 7)
    gen = SyntheticPatientGenerator(model, cfg, dims,
                                    ckpt.data_stats_from_arrays(data, conditions,
                                                                dims.mutation_dim), device="cpu")
    keys = ("dit.tokens", "kda.chunks", "moe.routed_rows", "moe.held_rows", "sampler.steps")
    before = {key: COUNTERS[key] for key in keys}
    out = gen.generate_scenarios(cfg.generation.scenarios, 2, seed=11)
    grew = {key: COUNTERS[key] - before[key] for key in keys}
    seq = model.denoiser.seq_len
    calls = grew["sampler.steps"] * len(cfg.generation.scenarios) * 2
    assert grew["sampler.steps"] == 5 and grew["dit.tokens"] == calls * seq
    assert grew["kda.chunks"] == 5 * 3 * 6 * 2  # steps x KDA layers x sequences x heads, 1 chunk
    assert grew["moe.routed_rows"] == grew["dit.tokens"] * 3 * 2  # 3 routed layers, top 2
    assert 0 < grew["moe.held_rows"] < grew["moe.routed_rows"]
    for s in cfg.generation.scenarios:
        assert out[s.name]["expression"].shape == (2, BLOCKS[1])
        assert np.isin(out[s.name]["mutations"], (0.0, 1.0)).all()
        assert np.isfinite(out[s.name]["expression"]).all()


def test_cli_trains_and_generates_with_the_preset(cohort, tmp_path):
    """The port's CLI on config/kimi_linear_dit.yaml with the transformer at
    tiny widths: training from the published initialisation of the decay,
    then the generate step's calibrated cohorts."""
    write_processed(cohort[0], tmp_path / "processed")
    raw = yaml.safe_load(open("config/kimi_linear_dit.yaml"))
    raw["model"]["transformer"].update(TINY)
    raw["model"]["diffusion"] = {"num_steps": 20}
    raw["data"] = {"processed_dir": str(tmp_path / "processed")}
    raw["training"] = {"save_dir": str(tmp_path / "ckpt"), "num_epochs": 2,
                       "epochs_per_dispatch": 1}
    raw["generation"].update(num_synthetic_samples=6, sampling_steps=3)
    raw["output"] = {"results_dir": str(tmp_path / "results"),
                     "synthetic_data_dir": str(tmp_path / "synthetic"), "export_formats": ["csv"]}
    path = tmp_path / "kimi.yaml"
    path.write_text(yaml.safe_dump(raw))
    cli.main(["--config", str(path), "--steps", "train", "generate", "--device", "cpu"])
    meta = ckpt.load_metadata(tmp_path / "ckpt")
    assert meta["config"]["model"]["transformer"]["linear_attn_config"] == LINEAR
    # A = exp(A_log) drawn in [1, 16]; two epochs of AdamW at 1e-4 move it little.
    a = ckpt.load_weights(tmp_path / "ckpt")["layers.0.attn.A_log"].exp()
    assert bool(((a > 0.9) & (a < 17)).all()) and float(a.max() - a.min()) > 1
    expr = np.genfromtxt(next((tmp_path / "synthetic").rglob("*_expression.csv")),
                         delimiter=",", skip_header=1)
    assert expr.shape[1] == BLOCKS[1] and np.isfinite(expr).all()
