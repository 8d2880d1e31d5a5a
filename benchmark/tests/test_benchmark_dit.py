"""The transformer cell (kind ``dit_cohort``) at tiny widths on the CPU:
hidden 32, 4 heads, 3 layers (layer 0 dense, two routed, so that the fp8
control's error on the experts adds up past the cell's limit as at the
published widths), 8 experts top-2 with 1 shared, patch 4, T = 20 and
DDIM-5, a 30-patient cohort at 10/40/14.

The kind's set-up, window and comparison read ``correct`` true; each
control of ``benchmark/dit_readings.py`` reads it false, by the number it
should, and so does the timed path broken underneath (a DDIM step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced); the seven readers return values from a recorded context and
nothing without one; a program without the transformer denoiser fails at
once."""

import copy
import sys

import pytest

from benchmark import dit_readings, harness
from benchmark.roofline_dit import attention, flops_per_token, grouped_bound_s, grouped_products
from benchmark.tests.tiny import TINY_COHORT, cpu
from osteosarcoma_diffusionmodel_torch.utils import profiling

CELL = "moonlight-dit-ddim50-3x8"
SEED = 2**31 + 707
TINY = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, intermediate_size=64,
            moe_intermediate_size=16, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, patch_size=4, time_embed_dim=16)
METRICS = ("experts_ms.dit", "attn_ms.dit", "router_ms.dit", "expert_load_ratio.dit",
           "moe_grouped_roofline", "mla_attn_roofline", "dit_mfu_pct.dit")


def tiny_dit_cell(rows: int = 4):
    cell = copy.deepcopy(harness.load_cell(CELL))
    conf = cell.config["config"]
    conf["model"]["transformer"].update(TINY)
    conf["model"]["diffusion"]["num_steps"] = 20
    conf["generation"]["sampling_steps"] = 5
    cell.config["cohort"] = dict(TINY_COHORT)
    cell.traffic = dict(cell.traffic, rows=rows)
    return cell


def _run(cell, variant="program", trace=False, monkeypatch=None):
    """A whole run but the look for a card, under ``variant``'s fault (the
    program's configuration with one expert fewer for ``top5``, the
    reference's unchanged)."""
    numbers = {}
    if variant == "top5":
        from benchmark.traffic import dit_cohort

        setup = dit_cohort.setup
        cfg = dit_readings.program_config(cell, variant)
        monkeypatch.setattr(dit_cohort, "setup", lambda c, s, d: setup(c, s, d, cfg=cfg))
    with dit_readings.fault(variant):
        result = harness.run_cell(cell, SEED, 0.2, trace, 0.0, device=cpu(), numbers_out=numbers)
    return result, numbers


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    cell = tiny_dit_cell()
    result, numbers = _run(cell, trace=trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(cell.limits)
    # Attention rounds its probabilities to bf16 where the reference keeps
    # f32: a rounding tipped the other way moves one activation by one bf16
    # ulp (2^-8 relative), and the output by less.
    assert numbers["route_gap_max"] == 0.0 and numbers["call_rel_rms"] < 2.0 ** -8
    if not trace:
        assert set(result["metrics"]) == {"cohort_patients_per_s", "setup_s"}


@pytest.mark.parametrize("variant,number", [("fp8-experts", "call_rel_rms"),
                                            ("top5", "route_gap_max"),
                                            ("no-shared", "call_rel_rms"),
                                            ("no-bias", "route_gap_max")])
def test_each_control_is_not_correct(variant, number, monkeypatch):
    cell = tiny_dit_cell()
    result, numbers = _run(cell, variant, monkeypatch=monkeypatch)
    assert not result["correct"], result["checks"]
    assert numbers[number] > cell.limits[number], numbers


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    """Every step of the scan DDIM loop returns its state unchanged: the
    chain gives back x_T."""
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion

    prior, chain = ConditionalDiffusion._x_prior, ConditionalDiffusion.ddim_chain
    drawn = {}

    def x_prior(self, *args, **kwargs):
        drawn["x_T"] = prior(self, *args, **kwargs)
        return drawn["x_T"]

    def unchanged(self, *args, **kwargs):
        chain(self, *args, **kwargs)
        return drawn["x_T"].clone()

    monkeypatch.setattr(ConditionalDiffusion, "_x_prior", x_prior)
    monkeypatch.setattr(ConditionalDiffusion, "ddim_chain", unchanged)
    cell = tiny_dit_cell()
    result, numbers = _run(cell)
    assert not result["correct"], result["checks"]
    assert numbers["chain_rel_rms"] > 0.1


def test_fault_half_the_batch_left_out(monkeypatch):
    """The denoiser computes the first half of the rows and returns them
    in the second half's place too (a check row lies in each half)."""
    from osteosarcoma_diffusionmodel_torch.models.dit import MoonlightDiT

    inner = MoonlightDiT.forward

    def half(self, x, *args, **kwargs):
        out = inner(self, x, *args, **kwargs)
        h = (out.shape[0] + 1) // 2
        out[h:] = out[: out.shape[0] - h]
        return out

    monkeypatch.setattr(MoonlightDiT, "forward", half)
    cell = tiny_dit_cell()
    result, numbers = _run(cell)
    assert not result["correct"], result["checks"]
    assert numbers["call_rel_rms"] > cell.limits["call_rel_rms"]


def test_fault_answer_altered_where_produced(monkeypatch):
    """One patient's calibrated profile is shifted by the calibrator."""
    import numpy as np

    from osteosarcoma_diffusionmodel_torch.ops.copula_device import DeviceCalibrator

    inner = DeviceCalibrator.joint

    def altered(self, raw, seed):
        bits, cont = inner(self, raw, seed)
        cont = np.array(cont)
        cont[7] += 0.5 * np.abs(cont).mean()
        return bits, cont

    monkeypatch.setattr(DeviceCalibrator, "joint", altered)
    cell = tiny_dit_cell()
    result, numbers = _run(cell)
    assert not result["correct"], result["checks"]
    assert numbers["calib_row_gap"] > cell.limits["calib_row_gap"]


def test_a_program_without_the_transformer_fails_at_once(monkeypatch):
    """The parent of the transformer denoiser has no models/dit.py: set-up
    fails on its import, before any weight or request."""
    monkeypatch.setitem(sys.modules, "osteosarcoma_diffusionmodel_torch.models.dit", None)
    with pytest.raises(ImportError):
        harness.run_cell(tiny_dit_cell(), SEED, 0.2, False, 0.0, device=cpu())


def test_a_config_that_builds_the_mlp_is_refused():
    cell = tiny_dit_cell()
    cell.config["config"]["model"]["denoiser"] = "mlp"
    with pytest.raises(ValueError, match="moonlight_dit"):
        harness.run_cell(cell, SEED, 0.2, False, 0.0, device=cpu())


def test_published_widths_are_refused_on_the_cpu():
    with pytest.raises(ValueError, match="card only"):
        harness.run_cell(harness.load_cell(CELL), SEED, 0.2, False, 0.0, device=cpu())


class _Event:
    def __init__(self, t):
        self.t = t

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.t - self.t


def test_readers_on_a_recorded_context(monkeypatch):
    t = harness.load_cell(CELL).config["config"]["model"]["transformer"]
    records = profiling.deque()
    monkeypatch.setattr(profiling, "_RECORDS", records)
    for root, t0 in ((1, 10.0), (100, 20.0)):
        records.append({"name": "sampler.prior", "id": root + 1, "parent": root, "root": root,
                        "t0": t0, "t1": t0, "counts": {}, "events": None})
        for i, (name, ms) in enumerate((("dit.experts", 2.0), ("dit.attn", 1.0),
                                        ("dit.router", 0.5)) * 3):
            records.append({"name": name, "id": root + 2 + i, "parent": root, "root": root,
                            "t0": t0, "t1": t0, "counts": {},
                            "events": (_Event(0.0), _Event(ms))})
        records.append({"name": "generate", "id": root, "parent": None, "root": root,
                        "t0": t0, "t1": t0 + 5.0, "counts": {}, "events": None})
    tokens = 24 * 324
    grouped_s = 2 * grouped_bound_s(t, tokens) / 0.5  # two calls at half the bound's rate
    attn_s = 2 * 27 * max(attention(t, 24, 324)[0] / 989e12, attention(t, 24, 324)[1] / 3.35e12)
    ctx = {"rows": 24, "seq_len": 324, "tokens_per_call": tokens, "transformer": t,
           "patches": 322, "spans": [],
           "requests": [{"i": 0, "t0": 9.0, "t1": 15.0}, {"i": 1, "t0": 19.0, "t1": 25.0}],
           "counters": {"dit.tokens": 2 * tokens, "moe.routed_rows": 26 * 2 * tokens * 6,
                        "moe.max_expert_rows": int(1.5 * 26 * 2 * tokens * 6 / 64)},
           "trace": {"window_s": 1.0, "busy_s": 1.0, "kernels": {
               "void osdm::moe::moe_grouped_kernel<256, 0>(x)": {"seconds": grouped_s / 2,
                                                                  "count": 52},
               "void osdm::moe::moe_grouped_kernel<256, 1>(x)": {"seconds": grouped_s / 2,
                                                                  "count": 52},
               "void pytorch_flash::flash_fwd_kernel<x>(y)": {"seconds": attn_s / 0.25,
                                                              "count": 54}}}}
    read = {m: harness.metric_reader(m)(ctx) for m in METRICS}
    assert read["experts_ms.dit"] == pytest.approx(6.0)
    assert read["attn_ms.dit"] == pytest.approx(3.0)
    assert read["router_ms.dit"] == pytest.approx(1.5)
    assert read["expert_load_ratio.dit"] == pytest.approx(1.5, rel=1e-4)
    assert read["moe_grouped_roofline"] == pytest.approx(50.0)
    assert read["mla_attn_roofline"] == pytest.approx(25.0)
    mfu = 100 * 2 * tokens * flops_per_token(t, 324, 322) / 989e12
    assert read["dit_mfu_pct.dit"] == pytest.approx(mfu)
    # A request whose first span the bounded buffer dropped is left out.
    records.popleft()
    assert harness.metric_reader("experts_ms.dit")(ctx) == pytest.approx(6.0)
    records.clear()
    empty = dict(ctx, counters={}, trace={"window_s": 0.0, "busy_s": 0.0, "kernels": {}})
    assert all(harness.metric_reader(m)(empty) is None for m in METRICS)


def test_the_bound_file_counts_the_published_model():
    t = harness.load_cell(CELL).config["config"]["model"]["transformer"]
    assert len(grouped_products(t, 1)) == 52  # 2 launches a routed layer
    gflop = flops_per_token(t, 324, 322) / 1e9
    assert 4.4 < gflop < 4.7  # 4.49 GFLOP of products a token, plus attention at 324 tokens
    tokens = 7776
    share = sum(f for _, f, _ in grouped_products(t, tokens)) / (tokens * gflop * 1e9)
    assert 0.57 < share < 0.61  # the routed experts' share of a token's operations
