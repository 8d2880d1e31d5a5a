"""The transformer denoiser (``model.denoiser: moonlight_dit``,
models/dit.py) against its plain reference (tests/torch_reference_dit.py),
at tiny widths on the CPU: hidden 32, 4 heads, 2 layers (layer 0 dense),
8 experts top-2 with 1 shared, patch 4, seeded random weights.

The denoiser's output with routing free and given; the experts chosen,
with a correction bias that changes the choice; the DDIM chain from a
given x_T; the x0 loss and its gradients through one trainer step; the
refusals; the generator's route and the CLI at tiny widths.
"""

import dataclasses

import numpy as np
import pytest
import torch
import yaml

from benchmark.dit_readings import fault, fp8_round
from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config, TransformerConfig
from osteosarcoma_diffusionmodel_torch.data.dataset import prepare_arrays
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module
from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.dit import MoonlightDiT
from osteosarcoma_diffusionmodel_torch.ops import moe
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model
from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS
from torch_reference_dit import Reference, ddim_chain, route_gaps

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, intermediate_size=64,
            moe_intermediate_size=16, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, patch_size=4, time_embed_dim=16)
BLOCKS = (10, 40, 14)
D = sum(BLOCKS)
C = 3
B = 6
# float32: the same operations as the reference in another summation order
# (a token's routed experts summed by slot here, by expert there; attention
# in PyTorch's kernel): a few float32 ulps through 2 layers.
F32 = dict(rtol=1e-4, atol=1e-5)
# bfloat16: both round the same operands and results to bf16; a rounding
# that another summation order tips the other way moves one activation by
# one bf16 ulp (2^-8 relative) and the output by less than that.
BF16_REL = 4e-3


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
    """Weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), RMSNorm
    scales 1 + 0.2·U(-1, 1), correction biases 0.1·U(-1, 1)."""
    g = torch.Generator().manual_seed(seed)
    state = module.state_dict()
    for name, t in state.items():
        u = torch.rand(t.shape, generator=g) * 2 - 1
        if name.endswith("norm.weight"):
            u = 1 + 0.2 * u
        elif name.endswith("e_score_correction_bias"):
            u = 0.1 * u
        else:
            w = state[name[:-4] + "weight"] if name.endswith(".bias") else t
            u = u / w.shape[-2 if w.dim() == 3 else 1] ** 0.5
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
    """Wrap each routed layer's ``route``: its choices appended to
    ``calls[-1]`` (the caller appends a list per denoiser call)."""
    for layer in model.moe_layers():
        inner = layer.route

        def route(x, inner=inner):
            choice, weight = inner(x)
            calls[-1].append(choice.clone())
            return choice, weight

        layer.route = route


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("routing", ["free", "given"])
def test_denoiser_matches_the_reference(dtype, routing):
    model = make_dit(dtype)
    x, t, c = inputs()
    calls = [[]]
    record_routes(model, calls)
    with torch.no_grad():
        out = model(x, t, conditions=c)
    ref = Reference(model.state_dict(), conf_dict(model.config), BLOCKS, "cpu",
                    bf16=dtype == torch.bfloat16)
    want = ref.forward(x, t, c, routes=calls[0] if routing == "given" else None)
    assert out.shape == (B, D) and out.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, **F32)
    else:
        assert rel(out, want) <= BF16_REL
    if routing == "given":  # another routing gives another output: the routes are read
        other = [(r + 1) % TINY["n_routed_experts"] for r in calls[0]]
        assert rel(ref.forward(x, t, c, routes=other), want) > 0.05


def test_choices_match_the_reference_and_the_bias_changes_them():
    model = make_dit()
    x, t, c = inputs()
    calls = [[]]
    record_routes(model, calls)
    with torch.no_grad():
        model(x, t, conditions=c)
    ref = Reference(model.state_dict(), conf_dict(model.config), BLOCKS, "cpu", bf16=False)
    scores = []
    ref.forward(x, t, c, routes=calls[0], scores_out=scores)
    k = TINY["num_experts_per_tok"]
    for choice, biased in zip(calls[0], scores):
        assert float(route_gaps(biased, choice, k).max()) == 0.0
        assert torch.equal(choice.sort(1).values, biased.topk(k, dim=1).indices.sort(1).values)
    # The correction bias: without it a share of the tokens choose other
    # experts; with expert 3 raised by 1 every token chooses expert 3.
    layer = model.moe_layers()[0]
    m = torch.randn(50, TINY["hidden_size"]).to(layer.gate.weight.dtype)
    with torch.no_grad():
        biased_choice = layer.route(m)[0]
        bias = layer.e_score_correction_bias.clone()
        layer.e_score_correction_bias.zero_()
        plain_choice = layer.route(m)[0]
        layer.e_score_correction_bias.copy_(bias)
        layer.e_score_correction_bias[3] += 1.0
        raised = layer.route(m)[0]
    differ = (biased_choice.sort(1).values != plain_choice.sort(1).values).any(1)
    assert 0 < float(differ.float().mean()) < 1
    assert bool((raised == 3).any(1).all())


def test_router_weights_are_the_normalised_scaled_scores():
    layer = make_dit().moe_layers()[0]
    m = torch.randn(20, TINY["hidden_size"])
    with torch.no_grad():
        choice, weight = layer.route(m)
        scores = torch.sigmoid(m @ layer.gate.weight.T)
    chosen = scores.gather(1, choice)
    torch.testing.assert_close(weight, 2.446 * chosen / chosen.sum(1, keepdim=True))
    assert torch.equal(choice[:, 0], (scores + layer.e_score_correction_bias).argmax(1))


def test_grouped_products_equal_a_loop_over_experts():
    """The grouped products (``torch._grouped_mm`` over the expert-sorted
    rows) against one product per expert, with an expert that gets no
    token and one that gets most."""
    g = torch.Generator().manual_seed(0)
    e, k, h, inter, t = 5, 2, 16, 8, 30
    choice = torch.stack([torch.full((t,), 4), torch.randint(0, 3, (t,), generator=g)], 1)
    w_gu = torch.randn(e, h, 2 * inter, generator=g)
    w_down = torch.randn(e, inter, h, generator=g)
    x = torch.randn(t, h, generator=g)
    weight = torch.rand(t, k, generator=g)
    plan, order, counts = moe.expert_plan(choice, e)
    assert counts.tolist() == [int((choice == i).sum()) for i in range(e)] and counts[3] == 0
    assert plan.offs.dtype == torch.int32 and plan.offs.tolist() == counts.cumsum(0).tolist()
    y = moe.grouped_down(moe.grouped_swiglu(x[order // k], w_gu, plan), w_down, plan,
                         weight.reshape(-1)[order], order).view(t, k, h).sum(1)
    want = torch.zeros(t, h)
    for i in range(t):
        for j in range(k):
            gu = x[i] @ w_gu[choice[i, j]]
            want[i] += weight[i, j] * ((torch.nn.functional.silu(gu[:inter]) * gu[inter:])
                                       @ w_down[choice[i, j]])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_grouped_products_backward_equals_autograd_of_the_loop():
    """The experts' backward (autograd through ``torch._grouped_mm``, the
    SwiGLU, the routing weights and the scatter) against autograd through
    one product per expert, in f32, with an expert that gets no token: the
    same sums in other orders."""
    g = torch.Generator().manual_seed(1)
    e, k, h, inter, t = 5, 2, 16, 8, 30
    choice = torch.stack([torch.full((t,), 4), torch.randint(0, 3, (t,), generator=g)], 1)
    plan, order, _ = moe.expert_plan(choice, e)
    leaves = [torch.randn(t, h, generator=g), torch.randn(e, h, 2 * inter, generator=g),
              torch.randn(e, inter, h, generator=g), torch.rand(t, k, generator=g)]
    dy = torch.randn(t, h, generator=g)

    def grads(swiglu, down):
        x, w_gu, w_down, weight = (v.clone().requires_grad_() for v in leaves)
        y = down(swiglu(x[order // k], w_gu, plan), w_down, plan, weight.reshape(-1)[order],
                 order)
        y.view(t, k, h).sum(1).backward(dy)
        return [x.grad, w_gu.grad, w_down.grad, weight.grad]

    got = grads(moe.grouped_swiglu, moe.grouped_down)
    want = grads(moe.grouped_swiglu_plain, moe.grouped_down_plain)
    assert float(got[1][3].abs().max()) == 0.0 and float(got[2][3].abs().max()) == 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_grouped_products_in_bf16_are_repeatable_and_tell_fp8_operands_apart():
    """bf16 at 8 experts of 256 -> 2·128 -> 256, expert 7 with no token:
    the grouped products against their plain versions, which round the
    same products to bf16 (the two differ by summation order, far inside
    2e-3 in relative norm); two calls, and a call without autograd, give
    equal bits; the benchmark's ``fp8-experts`` rounding of the operands
    moves both outputs past 2e-3."""
    g = torch.Generator().manual_seed(2)
    e, k, h, inter, t = 8, 2, 256, 128, 512
    choice = torch.randint(0, e - 1, (t, k), generator=g)
    plan, order, counts = moe.expert_plan(choice, e)
    assert int(counts[e - 1]) == 0

    def uniform(*shape, fan_in=1):
        return ((torch.rand(shape, generator=g) * 2 - 1) / fan_in ** 0.5).to(torch.bfloat16)

    a = uniform(t, h)[order // k]
    w_gu, w_down = uniform(e, h, 2 * inter, fan_in=h), uniform(e, inter, h, fan_in=inter)
    scale = torch.rand(t * k, generator=g)

    def products(swiglu, down):
        hid = swiglu(a, w_gu, plan)
        return hid, down(hid, w_down, plan, scale, order)

    def rel(p, q):
        return float((p.float() - q.float()).norm() / q.float().norm())

    got = products(moe.grouped_swiglu, moe.grouped_down)
    want = products(moe.grouped_swiglu_plain, moe.grouped_down_plain)
    with torch.no_grad():
        again = products(moe.grouped_swiglu, moe.grouped_down)
    fp8 = products(lambda x, w, p: moe.grouped_swiglu(fp8_round(x, 1), fp8_round(w, (1, 2)), p),
                   lambda x, w, p, *rest: moe.grouped_down(fp8_round(x, 1), fp8_round(w, (1, 2)),
                                                           p, *rest))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for i in range(2):
        assert torch.equal(got[i], again[i])
        assert rel(got[i], want[i]) <= 2e-3 < rel(fp8[i], want[i])


def routed_bf16(seed: int, e=6, k=3, h=32, inter=16, t=40) -> dict:
    """bf16 operands of a routed layer: t tokens choosing k of e experts,
    expert 2 chosen by none; the permuted activations, both weights, the
    permuted routing weights, and the plan and order."""
    g = torch.Generator().manual_seed(seed)
    choice = torch.randint(0, e - 1, (t, k), generator=g)
    choice[choice >= 2] += 1
    plan, order, counts = moe.expert_plan(choice, e)
    assert int(counts[2]) == 0

    def uniform(*shape, fan_in=1):
        return ((torch.rand(shape, generator=g) * 2 - 1) / fan_in ** 0.5).to(torch.bfloat16)

    x = uniform(t, h)
    return dict(a=x[order // k], w_gu=uniform(e, h, 2 * inter, fan_in=h),
                w_down=uniform(e, inter, h, fan_in=inter), plan=plan, order=order,
                scale=torch.rand(t, k, generator=g).reshape(-1)[order], k=k, t=t)


def reassociation_bound(terms: torch.Tensor) -> torch.Tensor:
    """The largest gap between two orders of an f32 sum over dim 1 of
    ``terms`` (T, k, N): 2·γ_{k−1}·Σ_j|term_j|, γ_n = n·2^-24 / (1 − n·2^-24)."""
    nu = (terms.shape[1] - 1) * 2.0 ** -24
    return 2 * nu / (1 - nu) * terms.abs().sum(1)


def test_plain_epilogues_equal_the_eager_composition():
    """The epilogue kernels' plain versions, which the wrappers take on the
    CPU: ``silu_mul_plain`` bit for bit the eager no-grad SwiGLU branch
    (f32 SiLU in place, the mixed-dtype multiply rounded once to bf16);
    ``combine_plain`` (its products, then a left-to-right sum over k)
    against the eager gathers, multiply and ``.sum(dim=1)``, which may sum
    k in another order, within the bound on two orders of an f32 sum."""
    o = routed_bf16(3)
    plan, k, t = o["plan"], o["k"], o["t"]
    gu = torch._grouped_mm(o["a"], o["w_gu"], offs=plan.offs)
    g, u = gu.chunk(2, dim=1)
    eager = torch.mul(torch.nn.functional.silu(g.float(), inplace=True), u,
                      out=torch.empty(u.shape, dtype=u.dtype))
    hid = moe.silu_mul_plain(gu)
    assert torch.equal(hid, eager) and torch.equal(moe.silu_mul(gu), hid)
    y = torch._grouped_mm(hid, o["w_down"], offs=plan.offs)
    src = torch.empty_like(o["order"]).scatter_(0, o["order"], torch.arange(t * k))
    terms = (y.index_select(0, src) * o["scale"].index_select(0, src)[:, None]).view(t, k, -1)
    got = moe.combine_plain(y, o["scale"], src, k)
    assert torch.equal(moe.combine(y, o["scale"], src, k), got)
    assert bool(((got - terms.sum(1)).abs() <= reassociation_bound(terms)).all())


@pytest.mark.parametrize("grad", [False, True])
def test_grouped_down_sums_each_tokens_copies_with_top_k(grad):
    """``grouped_down(..., top_k=k)`` against ``grouped_down(...)`` viewed
    (t, k, N) and summed over k, with an expert that gets no row: under
    autograd the same eager ops (equal bits); without it the plain combine,
    within the bound on two orders of an f32 sum."""
    o = routed_bf16(4)
    args = (o["w_down"], o["plan"], o["scale"], o["order"])
    with torch.set_grad_enabled(grad):
        hid = moe.grouped_swiglu(o["a"], o["w_gu"], o["plan"])
        got = moe.grouped_down(hid, *args, top_k=o["k"])
        rows = moe.grouped_down(hid, *args)
    terms = rows.view(o["t"], o["k"], -1)
    assert got.shape == (o["t"], o["w_down"].shape[2]) and got.dtype == torch.float32
    if grad:
        assert torch.equal(got, terms.sum(1))
    else:
        assert bool(((got - terms.sum(1)).abs() <= reassociation_bound(terms)).all())


@pytest.mark.parametrize("grad", [False, True])
def test_routed_layers_count_the_path_of_their_epilogues(grad):
    """A bf16 denoiser call counts each routed layer once under
    ``moe.epilogue_fused`` without autograd (the kernels' wrappers, their
    plain versions on the CPU) and under ``moe.epilogue_eager`` with it."""
    model = make_dit(torch.bfloat16)
    routed = len(model.moe_layers())
    x, t, c = inputs()
    before = dict(COUNTERS)
    with torch.set_grad_enabled(grad):
        model(x, t, conditions=c)
    grew = {key: COUNTERS[key] - before.get(key, 0)
            for key in ("moe.epilogue_fused", "moe.epilogue_eager")}
    assert routed >= 1
    assert grew == {"moe.epilogue_fused": 0 if grad else routed,
                    "moe.epilogue_eager": routed if grad else 0}


def test_fp8_experts_control_passes_top_k_through():
    """The benchmark's ``fp8-experts`` control wraps ``grouped_down`` and
    hands the new keyword on: under it, the summed result equals the plain
    call on operands rounded to fp8."""
    o = routed_bf16(5)
    args = (o["plan"], o["scale"], o["order"])
    with torch.no_grad():
        hid = moe.grouped_swiglu(o["a"], o["w_gu"], o["plan"])
        want = moe.grouped_down(fp8_round(hid, 1), fp8_round(o["w_down"], (1, 2)), *args,
                                top_k=o["k"])
        with fault("fp8-experts"):
            got = moe.grouped_down(hid, o["w_down"], *args, top_k=o["k"])
    assert got.shape == (o["t"], o["w_down"].shape[2]) and torch.equal(got, want)


def _config(**over) -> Config:
    cfg = Config()
    cfg.model.denoiser = "moonlight_dit"
    cfg.model.transformer = tiny_tc()
    cfg.model.compute_dtype = over.pop("compute_dtype", "float32")
    cfg.model.diffusion.num_steps = 20
    cfg.generation.sampler = "ddim"
    cfg.generation.sampling_steps = 5
    cfg.generation.batch_scenarios = True
    cfg.generation.calibration_backend = "device"
    for key, value in over.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section) if section != "diffusion" else cfg.model.diffusion,
                name, value)
    return cfg


@pytest.fixture(scope="module")
def cohort():
    c = make_dummy_cohort(30, *BLOCKS, seed=3)
    data, conditions, dims = cohort_arrays(c, Config())
    return c, data, conditions, dims


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_ddim_chain_matches_the_reference(cohort, compute_dtype):
    _, _, conditions, dims = cohort
    cfg = _config(compute_dtype=compute_dtype)
    model = ConditionalDiffusion.from_config(cfg, dims)
    assert isinstance(model.denoiser, MoonlightDiT)
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
    assert len(calls) == 5
    bf16 = compute_dtype == "bfloat16"
    ref = Reference(model.denoiser.state_dict(), conf_dict(cfg.model.transformer), BLOCKS,
                    "cpu", bf16=bf16)
    want = ddim_chain(ref, x_T, cond, schedule="cosine", num_steps=20, ddim_steps=5, clip=30.0,
                      routes=calls)
    if bf16:
        assert rel(out, want) <= 5 * BF16_REL  # five composed calls
    else:
        torch.testing.assert_close(out, want, **F32)


def test_x0_loss_and_gradients_through_a_trainer_step(cohort, tmp_path):
    c = cohort[0]
    write_processed(c, tmp_path / "processed")
    cfg = _config()
    cfg.data.processed_dir = str(tmp_path / "processed")
    cfg.model.constraints.enabled = False
    cfg.training.augmentation.mixup_alpha = 0.0
    cfg.training.augmentation.pathway_noise = 0.0
    cfg.training.grad_clip_norm = 1e9
    cfg.training.save_dir = str(tmp_path / "ckpt")
    arrays, dims = prepare_arrays(cfg)
    trainer = Trainer(build_model(cfg, dims), arrays, dims, cfg, "cpu")
    module = trainer.module
    assert float(module.layers[1].mlp.e_score_correction_bias.abs().max()) == 0.0
    seed_weights(module, 5)  # nonzero correction biases and norm scales
    before = {k: v.detach().clone() for k, v in module.state_dict().items()}
    x0 = torch.from_numpy(arrays.data[:8])
    cond = torch.from_numpy(arrays.conditions[:8])
    t = torch.tensor([0, 3, 7, 11, 15, 19, 2, 9])
    noise = torch.randn(8, dims.data_dim, generator=torch.Generator().manual_seed(6))
    metrics = trainer.train_step(x0, cond, t=t, noise=noise)
    grads = {n: p.grad for n, p in module.named_parameters()}
    # The reference: the same loss on the same weights, differentiated.
    weights = {k: v.clone().requires_grad_(v.is_floating_point() and "correction" not in k)
               for k, v in before.items()}
    ref = Reference(weights, conf_dict(cfg.model.transformer), BLOCKS, "cpu", bf16=False)
    acp = torch.from_numpy(np.cumprod(1 - trainer.model.schedule.betas)).float()
    x_t = acp[t].sqrt()[:, None] * x0 + (1 - acp[t]).sqrt()[:, None] * noise
    with torch.enable_grad():
        loss = ((ref.forward(x_t, t.float() / 20, cond) - x0) ** 2).mean()
        loss.backward()
    assert float(metrics["diffusion_loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    for name, g in grads.items():
        torch.testing.assert_close(g, weights[name].grad, rtol=1e-3, atol=1e-6, msg=name)
    after = module.state_dict()
    assert all(not torch.equal(after[n], before[n]) for n in grads)  # one AdamW step moved each
    assert torch.equal(after["layers.1.mlp.e_score_correction_bias"],
                       before["layers.1.mlp.e_score_correction_bias"])


@pytest.mark.parametrize("over", [
    {"diffusion.discrete_mutation_head": True}, {"diffusion.ar_mutation_head": True},
    {"diffusion.latent_factor_dim": 2}, {"diffusion.learn_sigma": True},
    {"diffusion.low_rank_sigma_dim": 2}, {"model.cfg_dropout_prob": 0.1},
    {"generation.fused_quantize": "out"}, {"model.denoiser": "transformer"},
])
def test_unsupported_combinations_raise(cohort, over):
    with pytest.raises(ValueError):
        ConditionalDiffusion.from_config(_config(**over), cohort[3])


@pytest.mark.parametrize("arch", ["cvae", "flow"])
def test_other_architectures_refuse_the_transformer(cohort, arch):
    with pytest.raises(ValueError, match="moonlight_dit"):
        build_model(_config(**{"model.architecture": arch}), cohort[3])


@pytest.mark.parametrize("key,value", [("n_group", 2), ("scoring_func", "softmax"),
                                       ("q_lora_rank", 64), ("topk_method", "greedy")])
def test_unimplemented_moonlight_keys_raise(key, value):
    with pytest.raises(ValueError, match=key):
        MoonlightDiT(tiny_tc(**{key: value}), BLOCKS, C, torch.float32)


def test_published_widths_and_the_config_round_trip():
    tc = TransformerConfig()
    assert (tc.hidden_size, tc.num_hidden_layers, tc.n_routed_experts, tc.num_experts_per_tok,
            tc.n_shared_experts, tc.moe_intermediate_size, tc.intermediate_size) == \
        (2048, 27, 64, 6, 2, 1408, 11264)
    raw = Config().to_dict()
    raw["model"]["denoiser"] = "moonlight_dit"
    raw["model"]["transformer"] = dict(TINY)
    back = Config.from_dict(raw)
    assert back.model.denoiser == "moonlight_dit" and back.model.transformer == tiny_tc()
    with torch.device("meta"):
        m = MoonlightDiT(tc, (62, 5054, 26), 3, torch.bfloat16)
    assert m.seq_len == 324 and m.patches == [4, 316, 2]
    assert abs(sum(p.numel() for p in m.parameters()) - 15.3e9) < 0.05e9


def test_generator_takes_the_scan_sampler_and_counts(cohort):
    c, data, conditions, dims = cohort
    cfg = _config(compute_dtype="bfloat16")
    model = ConditionalDiffusion.from_config(cfg, dims)
    seed_weights(model.denoiser, 7)
    gen = SyntheticPatientGenerator(model, cfg, dims,
                                    ckpt.data_stats_from_arrays(data, conditions,
                                                                dims.mutation_dim), device="cpu")
    assert not gen.uses_kernels()
    from osteosarcoma_diffusionmodel_torch.utils.profiling import COUNTERS

    before = dict(gen_module.SAMPLERS), dict(COUNTERS)
    out = gen.generate_scenarios(cfg.generation.scenarios, 4, seed=11)
    assert gen_module.SAMPLERS["scan"] == before[0].get("scan", 0) + 1
    tokens = 4 * len(cfg.generation.scenarios) * model.denoiser.seq_len
    grew = {k: COUNTERS[k] - before[1].get(k, 0) for k in
            ("dit.tokens", "moe.routed_rows", "moe.max_expert_rows", "sampler.steps")}
    assert grew["dit.tokens"] == 5 * tokens and grew["sampler.steps"] == 5
    assert grew["moe.routed_rows"] == 5 * tokens * 2
    assert 5 * tokens * 2 / 8 <= grew["moe.max_expert_rows"] <= 5 * tokens
    for s in cfg.generation.scenarios:
        assert out[s.name]["expression"].shape == (4, BLOCKS[1])
        assert np.isin(out[s.name]["mutations"], (0.0, 1.0)).all()


def test_cli_trains_generates_and_exports_and_serves_at_tiny_widths(cohort, tmp_path):
    """The port's CLI (``python -m osteosarcoma_diffusionmodel_torch.cli``)
    on a config that overrides the shipped preset's transformer section,
    then the server's service on the checkpoint it wrote."""
    write_processed(cohort[0], tmp_path / "processed")
    raw = yaml.safe_load(open("config/dit_moonlight.yaml"))
    raw["model"]["transformer"] = dict(TINY)
    raw["model"]["diffusion"] = {"num_steps": 20}
    raw["data"] = {"processed_dir": str(tmp_path / "processed")}
    raw["training"] = {"save_dir": str(tmp_path / "ckpt"), "num_epochs": 2,
                       "epochs_per_dispatch": 1}
    raw["generation"].update(num_synthetic_samples=12, sampling_steps=4)
    raw["output"] = {"results_dir": str(tmp_path / "results"),
                     "synthetic_data_dir": str(tmp_path / "synthetic"), "export_formats": ["csv"]}
    path = tmp_path / "dit.yaml"
    path.write_text(yaml.safe_dump(raw))
    cli.main(["--config", str(path), "--steps", "train", "generate", "--device", "cpu"])
    meta = ckpt.load_metadata(tmp_path / "ckpt")
    assert meta["config"]["model"]["denoiser"] == "moonlight_dit"
    written = sorted(p.name for p in (tmp_path / "synthetic").rglob("*.csv"))
    assert written and any("expression" in n for n in written)
    expr = np.genfromtxt(next((tmp_path / "synthetic").rglob("*_expression.csv")),
                         delimiter=",", skip_header=1)
    assert expr.shape[1] == BLOCKS[1] and np.isfinite(expr).all()
    from osteosarcoma_diffusionmodel_torch.serving.server import GenerationService

    service = GenerationService(tmp_path / "ckpt", device="cpu")
    assert isinstance(service.generator.model.denoiser, MoonlightDiT)
    out = service.generate(5, {"survival_time": 300, "event_occurred": 1})
    assert out["expression"].shape == (5, BLOCKS[1]) and np.isfinite(out["expression"]).all()
