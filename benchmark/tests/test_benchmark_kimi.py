"""The hybrid cell (kind ``kimi_dit_cohort``) at tiny widths on the CPU:
hidden 32, 4 layers (layer 1 dense, layers 1, 3 and 4 KDA with 2 heads
of 8, layer 2 NoPE MLA with rope parts of 8, layers 2-4 routed), 8 experts top-2 of which this card
holds 2 (ep_size 4), 1 shared, patch 1, so 2 + 226 tokens a patient and 4
chunks of 64 a sequence, T = 20 and DDIM-5, a 30-patient cohort at
10/200/14, in float32: at hidden 32 a bf16 rounding moves the sound
readings near the cell's limits, which are set at the published widths
(the port's bf16 path at tiny widths is held to the reference in
tests/test_torch_kimi.py).

The kind's set-up, window and comparison read ``correct`` true; each
control of ``benchmark/kimi_readings.py`` reads it false, by the number it
should; the three readers return values from a recorded context and
nothing without one; a program without KDA fails at once."""

import copy
import sys

import pytest

from benchmark import harness, kimi_readings
from benchmark.roofline_kda import flops_per_token, kda_chunk, kda_chunk_bound_s
from benchmark.tests.tiny import cpu
from osteosarcoma_diffusionmodel_torch.utils import profiling

CELL = "kimi-linear-dit-ddim50-3x2"
SEED = 2**31 + 909
TINY = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=4, qk_rope_head_dim=8, v_head_dim=8, intermediate_size=64,
            moe_intermediate_size=16, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, patch_size=1, time_embed_dim=16, mla_use_nope=True,
            linear_attn_config=dict(kda_layers=[1, 3, 4], full_attn_layers=[2], num_heads=2,
                                    head_dim=8, short_conv_kernel_size=4),
            ep_size=4, ep_rank=0)
COHORT = {"patients": 30, "mutation_genes": 10, "expression_genes": 200, "pathways": 14}
METRICS = ("kda_ms.kimi", "kda_chunk_roofline", "kimi_mfu_pct.kimi")


def tiny_kimi_cell():
    cell = copy.deepcopy(harness.load_cell(CELL))
    conf = cell.config["config"]
    conf["model"]["transformer"].update(copy.deepcopy(TINY))
    conf["model"]["compute_dtype"] = "float32"
    conf["model"]["diffusion"]["num_steps"] = 20
    conf["generation"]["sampling_steps"] = 5
    cell.config["cohort"] = dict(COHORT)
    return cell


def _run(cell, variant="program", trace=False):
    numbers = {}
    with kimi_readings.fault(variant):
        result = harness.run_cell(cell, SEED, 0.2, trace, 0.0, device=cpu(), numbers_out=numbers)
    return result, numbers


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    cell = tiny_kimi_cell()
    result, numbers = _run(cell, trace=trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(cell.limits)
    # The kernel's twin against the recurrence, both f32: a few f32 ulps.
    assert numbers["kda_rel_rms"] < 1e-5
    if not trace:
        assert set(result["metrics"]) == {"cohort_patients_per_s", "setup_s"}


@pytest.mark.parametrize("variant,number", [("scalar-decay", "kda_rel_rms"),
                                            ("no-delta", "kda_rel_rms"),
                                            ("bf16-state", "kda_rel_rms"),
                                            ("rope-mla", "call_rel_rms"),
                                            ("top8-held", "route_gap_max"),
                                            ("fp8-experts", "call_rel_rms")])
def test_each_control_is_not_correct(variant, number):
    cell = tiny_kimi_cell()
    result, numbers = _run(cell, variant)
    assert not result["correct"], result["checks"]
    assert numbers[number] > cell.limits[number], numbers


def test_a_program_without_kda_fails_at_once(monkeypatch):
    """The parent of the hybrid denoiser has no models/kda.py: set-up fails
    on its import, before any weight or request."""
    monkeypatch.setitem(sys.modules, "osteosarcoma_diffusionmodel_torch.models.kda", None)
    with pytest.raises(ImportError):
        harness.run_cell(tiny_kimi_cell(), SEED, 0.2, False, 0.0, device=cpu())


def test_a_config_without_kda_layers_is_refused():
    cell = tiny_kimi_cell()
    cell.config["config"]["model"]["transformer"]["linear_attn_config"] = None
    with pytest.raises(ValueError, match="KDA"):
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
        for i, (name, ms) in enumerate((("dit.kda", 2.0), ("dit.attn", 1.0)) * 3):
            records.append({"name": name, "id": root + 2 + i, "parent": root, "root": root,
                            "t0": t0, "t1": t0, "counts": {},
                            "events": (_Event(0.0), _Event(ms))})
        records.append({"name": "generate", "id": root, "parent": None, "root": root,
                        "t0": t0, "t1": t0 + 5.0, "counts": {}, "events": None})
    tokens = 6 * 1289
    kda_s = 2 * 20 * kda_chunk_bound_s(t, 6, 1289) / 0.4  # 40 launches at 40% of the bound
    ctx = {"rows": 6, "seq_len": 1289, "tokens_per_call": tokens, "transformer": t,
           "patches": 1287, "spans": [],
           "requests": [{"i": 0, "t0": 9.0, "t1": 15.0}, {"i": 1, "t0": 19.0, "t1": 25.0}],
           "counters": {"dit.tokens": 2 * tokens},
           "trace": {"window_s": 1.0, "busy_s": 1.0, "kernels": {
               "(anonymous namespace)::kda_chunk_kernel(float const*, ...)": {
                   "seconds": kda_s, "count": 40}}}}
    read = {m: harness.metric_reader(m)(ctx) for m in METRICS}
    assert read["kda_ms.kimi"] == pytest.approx(6.0)
    assert read["kda_chunk_roofline"] == pytest.approx(40.0)
    mfu = 100 * 2 * tokens * flops_per_token(t, 1289, 1287) / 989e12
    assert read["kimi_mfu_pct.kimi"] == pytest.approx(mfu)
    records.clear()
    empty = dict(ctx, counters={}, trace={"window_s": 0.0, "busy_s": 0.0, "kernels": {}})
    assert all(harness.metric_reader(m)(empty) is None for m in METRICS)
    moonlight = dict(ctx, transformer=harness.load_cell("moonlight-dit-ddim50-3x8").config[
        "config"]["model"]["transformer"])
    assert harness.metric_reader("kda_chunk_roofline")(moonlight) is None


def test_the_bound_file_counts_the_published_model():
    t = harness.load_cell(CELL).config["config"]["model"]["transformer"]
    gflop = flops_per_token(t, 1289, 1287) / 1e9
    assert 3.45 < gflop < 3.6  # products of 20 KDA and 7 MLA layers, 2 of 8 routed copies held
    flops, nbytes = kda_chunk(t, 6, 1289)
    # 20 whole chunks and one of 9 rows, 6 x 32 heads; 2,564 bytes a token-head
    assert 34e9 < flops < 35e9 and nbytes == 4 * 6 * 1289 * 32 * (5 * 128 + 1)
    assert kda_chunk_bound_s(t, 6, 1289) == pytest.approx(flops / 67e12)
