"""The port's profiling utilities: the program's spans and counters on the
cohort path (nothing recorded outside a profiler session, the request's
tree under one, each span on the profiler's timeline, the step and byte
counters), ``profile_trace`` on the CPU (a Chrome trace written, none when
disabled), ``--profile`` on a one-epoch CPU train and on the generation
after it (the same history, weights and cohort as without it) and
``device_memory_stats`` without a card."""

import json
from collections import defaultdict

import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.utils import profiling
from osteosarcoma_diffusionmodel_torch.utils.profiling import (
    COUNTERS,
    device_memory_stats,
    profile_trace,
    span,
    spans,
)

ROWS = 16
SCENARIO = {"survival_time": 300, "event_occurred": 1, "metastasis_at_diagnosis": 1}


@pytest.fixture(scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny_gen(one_thread):
    """A generator whose cohorts take the kernel sampler's plain path
    (hidden 128/256/128, T = 6) and the device calibrator on the CPU."""
    cfg = Config()
    cfg.model.hidden_dims = [128, 256, 128]
    cfg.model.diffusion.num_steps = 6
    cfg.generation.calibration_backend = "device"
    cohort = make_dummy_cohort(30, 10, 40, 14, seed=3)
    data, conditions, dims = cohort_arrays(cohort, cfg)
    torch.manual_seed(0)
    model = ConditionalDiffusion.from_config(cfg, dims)
    gen = SyntheticPatientGenerator(
        model, cfg, dims, ckpt.data_stats_from_arrays(data, conditions, dims.mutation_dim),
        device="cpu")
    assert gen.uses_kernels()
    return gen


def _generate(gen):
    return gen.generate(ROWS, SCENARIO, torch.Generator().manual_seed(7))


@pytest.fixture(scope="module")
def profiled(tiny_gen):
    """One generate under torch.profiler: its records and the profiler's
    events."""
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _generate(tiny_gen)
    return spans(), list(prof.events()), out


def test_outside_a_profiler_a_span_records_nothing_and_counters_count(tiny_gen, monkeypatch):
    """No range, no event, no record: only the check that no profiler
    records. The step counter counts all the same."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span outside a profiler session did more than one check")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    profiling.clear()
    steps = COUNTERS["sampler.steps"]
    assert span("a") is span("b", torch.device("cpu"))
    out = _generate(tiny_gen)
    assert spans() == []
    assert COUNTERS["sampler.steps"] - steps == tiny_gen.sampler().n_loop
    assert out["expression"].shape[0] == ROWS


def test_under_a_profiler_spans_form_the_request_tree(profiled, tiny_gen):
    records, _, _ = profiled
    by_name = {r["name"]: r for r in records}
    assert sorted(by_name) == sorted(r["name"] for r in records)  # one of each
    assert set(by_name) == {"generate", "sample_raw", "sampler.prior", "sampler.steps",
                            "calibrate", "calibrate.whiten", "calibrate.download"}
    root = by_name["generate"]
    assert root["parent"] is None and root["root"] == root["id"]
    parents = {"sample_raw": "generate", "sampler.prior": "sample_raw",
               "sampler.steps": "sample_raw", "calibrate": "generate",
               "calibrate.whiten": "calibrate", "calibrate.download": "calibrate"}
    for child, parent in parents.items():
        rec = by_name[child]
        assert rec["parent"] == by_name[parent]["id"], child
        assert rec["root"] == root["id"], child
        assert by_name[parent]["t0"] <= rec["t0"] <= rec["t1"] <= by_name[parent]["t1"], child
        assert rec["device_ms"] is None, child  # no CUDA device
    n_loop = tiny_gen.sampler().n_loop
    assert by_name["sampler.steps"]["counts"] == {"sampler.steps": n_loop}
    assert root["counts"]["sampler.steps"] == n_loop
    assert spans(since=root["t0"]) == records and spans(since=root["t0"] + 1e-9) == []


def test_every_span_lies_on_the_profiler_timeline(profiled):
    """Each record has its ``osdm.<name>`` range among the profiler's
    events, and the two clocks give it the same length within 1 ms."""
    records, events, _ = profiled
    ranges = defaultdict(list)
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.name.startswith("osdm."):
            ranges[e.name[5:]].append(e.time_range.elapsed_us())
    assert sorted(ranges) == sorted(r["name"] for r in records)
    for name, lengths in ranges.items():
        mine = [1e6 * (r["t1"] - r["t0"]) for r in records if r["name"] == name]
        assert len(mine) == len(lengths) == 1, name
        assert abs(mine[0] - lengths[0]) < 1e3, (name, mine, lengths)


def test_profiling_leaves_the_cohort_unchanged(profiled, tiny_gen):
    _, _, traced = profiled
    plain = _generate(tiny_gen)
    for key in plain:
        np.testing.assert_array_equal(plain[key], traced[key], err_msg=key)


def test_generate_scenarios_is_one_root_over_each_generate(tiny_gen):
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tiny_gen.generate_scenarios(tiny_gen.config.generation.scenarios, 4, seed=5)
    records = spans()
    (root,) = [r for r in records if r["parent"] is None]
    inner = [r for r in records if r["name"] == "generate" and r is not root]
    assert len(inner) == len(tiny_gen.config.generation.scenarios)
    assert all(r["parent"] == root["id"] for r in inner)
    assert all(r["root"] == root["id"] for r in records)


@pytest.mark.parametrize("ddim_steps, stop_after", [(None, None), (None, 2), (3, None)])
def test_step_counter_advances_by_the_steps_run(tiny_gen, ddim_steps, stop_after):
    sampler = FusedSampler(tiny_gen.model, "cpu", ddim_steps=ddim_steps)
    cond = torch.zeros(4, tiny_gen.dims.condition_dim)
    before = COUNTERS["sampler.steps"]
    sampler.sample(cond, torch.Generator().manual_seed(1), stop_after=stop_after)
    assert COUNTERS["sampler.steps"] - before == (sampler.n_loop if stop_after is None
                                                 else stop_after)


def test_scan_ddim_records_prior_and_steps_and_counts_its_steps(one_thread):
    """The scan sampler's DDIM loop (``ConditionalDiffusion.ddim_chain``,
    the route of a model the kernel sampler does not take: here an MLP of
    hidden 96/192/96) has the kernel sampler's ``sampler.prior`` and
    ``sampler.steps`` spans under ``sample_raw`` and counts its steps."""
    cfg = Config()
    cfg.model.hidden_dims = [96, 192, 96]
    cfg.model.diffusion.num_steps = 12
    cfg.generation.sampler = "ddim"
    cfg.generation.sampling_steps = 4
    cfg.generation.calibration_backend = "device"
    cohort = make_dummy_cohort(30, 10, 40, 14, seed=3)
    data, conditions, dims = cohort_arrays(cohort, cfg)
    torch.manual_seed(0)
    gen = SyntheticPatientGenerator(
        ConditionalDiffusion.from_config(cfg, dims), cfg, dims,
        ckpt.data_stats_from_arrays(data, conditions, dims.mutation_dim), device="cpu")
    assert not gen.uses_kernels()
    before = COUNTERS["sampler.steps"]
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _generate(gen)
    assert COUNTERS["sampler.steps"] - before == 4
    by_name = {r["name"]: r for r in spans()}
    assert {"sampler.prior", "sampler.steps"} <= set(by_name)
    assert by_name["sampler.prior"]["parent"] == by_name["sampler.steps"]["parent"] == \
        by_name["sample_raw"]["id"]
    assert by_name["sampler.steps"]["counts"] == {"sampler.steps": 4}
    assert by_name["sampler.prior"]["t1"] <= by_name["sampler.steps"]["t0"]


def test_device_calibrator_records_whiten_and_download_and_counts_bytes(tiny_gen):
    m = tiny_gen.dims.mutation_dim
    cal = tiny_gen._get_device_joint_cal(m)
    raw = torch.randn(24, tiny_gen.dims.data_dim, generator=torch.Generator().manual_seed(2))
    before = COUNTERS["copy.d2h_bytes"]
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        bits, cont = cal.joint(raw, 11)
    got = COUNTERS["copy.d2h_bytes"] - before
    assert got == bits.nbytes + cont.nbytes == 24 * tiny_gen.dims.data_dim * 4
    records = {r["name"]: r for r in spans()}
    assert set(records) == {"calibrate.whiten", "calibrate.download"}
    assert records["calibrate.download"]["counts"] == {"copy.d2h_bytes": got}


def test_device_calibrator_download_on_the_cpu_returns_the_tensors_memory(tiny_gen):
    """On a CPU calibrator the copy back is ``.cpu().numpy()`` as it was: the
    tensors' own memory, a strided view too, and none of the page-locked
    path's counters moves."""
    cal = tiny_gen._get_device_joint_cal(tiny_gen.dims.mutation_dim)
    g = torch.Generator().manual_seed(4)
    tensors = (torch.randn(24, 10, generator=g), torch.randn(24, 41, generator=g)[:, 1:])
    keys = ("copy.d2h_pinned", "copy.d2h_pageable", "copy.host_allocs")
    before = {k: COUNTERS[k] for k in keys}
    out = cal._download(*tensors)
    assert {k: COUNTERS[k] for k in keys} == before
    for a, t in zip(out, tensors):
        assert np.shares_memory(a, t.numpy())
        np.testing.assert_array_equal(a, t.numpy())


def test_spans_keep_a_bounded_buffer(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDS", profiling.deque(maxlen=3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [r["name"] for r in spans()] == ["s2", "s3", "s4"]
    profiling.clear()
    assert spans() == []


def _traces(log_dir):
    return sorted(log_dir.glob("*.pt.trace.json")) if log_dir.exists() else []


def test_profile_trace_writes_on_cpu(tmp_path):
    with profile_trace(tmp_path / "trace", device="cpu"):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    (trace,) = _traces(tmp_path / "trace")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_profile_trace_disabled(tmp_path):
    with profile_trace(tmp_path / "trace", enabled=False, device="cpu"):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert not (tmp_path / "trace").exists()


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert device_memory_stats() == {}


def _train(root, profile: bool):
    make = root / "processed"
    if not make.exists():
        write_processed(make_dummy_cohort(24, 6, 20, 6), make)
    raw = {
        "data": {"processed_dir": str(make)},
        "model": {"hidden_dims": [64, 128, 64], "latent_dim": 16,
                  "diffusion": {"num_steps": 8}},
        "training": {"save_dir": str(root / f"ckpt_{profile}"), "num_epochs": 1},
        "output": {"results_dir": str(root / f"results_{profile}")},
    }
    path = root / f"config_{profile}.yaml"
    path.write_text(yaml.safe_dump(raw))
    torch.manual_seed(0)  # the denoiser's dropout draws from the global generator
    return cli.train_model(Config.from_yaml(path), device="cpu", profile=profile)


def test_profile_changes_neither_history_nor_weights(tmp_path, one_thread):
    plain, profiled = _train(tmp_path, False), _train(tmp_path, True)
    assert profiled.train_loss == plain.train_loss and profiled.val_loss == plain.val_loss
    a, b = ckpt.load_weights(tmp_path / "ckpt_False"), ckpt.load_weights(tmp_path / "ckpt_True")
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert _traces(tmp_path / "results_True" / "profile")
    assert not (tmp_path / "results_False" / "profile").exists()
    assert np.isfinite(plain.train_loss).all()


def test_profile_traces_the_generation_and_keeps_its_cohort(tmp_path, one_thread):
    """``generate_synthetic_patients(..., profile=True)`` after the one-epoch
    train: a trace under ``<results_dir>/profile`` holding the program's
    ``osdm.generate`` range, and the cohort generated without the flag."""
    _train(tmp_path, False)
    config = Config.from_yaml(tmp_path / "config_False.yaml")
    config.generation.num_synthetic_samples = 24
    cohorts = {}
    for profile in (False, True):
        config.output.results_dir = str(tmp_path / f"gen_results_{profile}")
        config.output.synthetic_data_dir = str(tmp_path / f"synthetic_{profile}")
        cohorts[profile] = cli.generate_synthetic_patients(config, device="cpu",
                                                            profile=profile)
    assert not (tmp_path / "gen_results_False" / "profile").exists()
    (trace,) = _traces(tmp_path / "gen_results_True" / "profile")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "osdm.generate" for e in events)
    assert list(cohorts[True]) == list(cohorts[False])
    for name, cohort in cohorts[False].items():
        for key in cohort:
            np.testing.assert_array_equal(cohorts[True][name][key], cohort[key],
                                          err_msg=f"{name} {key}")
