"""The benchmark's files parse and keep their rules, each traffic kind runs
a short window at tiny widths, and the command refuses to run without a
card or without the program."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.trace import _union_seconds, kernel_class, seconds_by_class

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"])) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_run_length():
    by_name = {m["name"]: m for m in SPEC["end_to_end"]}
    assert by_name["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in CELLS:
        mine = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in mine and len(mine) >= 2, cell
        layers = [m for m in SPEC["per_layer"] if cell in m.get("workloads", [cell])]
        assert layers, cell
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS), (m["name"], cell)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_files_are_found_by_name():
    paths = SPEC["paths"]
    for word in SPEC["command"][1:]:
        assert any(word.startswith(p + "/") for p in paths)
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    for cell in CELLS:
        loaded = harness.load_cell(cell)
        assert harness.kind_module(loaded) and loaded.limits, cell
    for m in SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_kernel_names_and_interval_union():
    assert kernel_class("void gemm_kernel<__nv_bfloat16, 64, true, 2, false>"
                        "(CUtensorMap, CUtensorMap, Args)") == "k1_posterior"
    assert kernel_class("void gemm_kernel<__nv_bfloat16, 128, true, 1, false>(...)") == "k1_gn"
    assert kernel_class("_Z11gemm_kernelI13__nv_bfloat16Li64ELb1ELi0ELb0EEv14CUtensorMap_st") == "k1"
    assert kernel_class("void gemm_kernel<signed char, 64, true, 2, true>(...)") is None
    assert kernel_class("Memcpy HtoD (Pageable -> Device)") is None
    busy, gaps = _union_seconds(torch.tensor([0, 5, 20]).numpy(), torch.tensor([10, 12, 30]).numpy())
    assert busy == pytest.approx(22e-9) and gaps == [(12, 20)]
    kernels = {"void gemm_kernel<__nv_bfloat16, 64, true, 2, false>(x)": {"seconds": 2.0, "count": 4},
               "other": {"seconds": 1.0, "count": 1}}
    assert seconds_by_class(kernels) == {"k1_posterior": (2.0, 4)}


def test_readers_return_nothing_without_a_trace():
    ctx = {"rows": 16, "hidden": [256, 512, 256], "data_dim": 5142, "noise": "philox",
           "macs_per_row": 4205568, "spans": [], "counters": {}, "requests": [],
           "trace": {"kernels": {}, "busy_s": 0.0, "window_s": 0.0}}
    for m in SPEC["per_layer"]:
        assert harness.metric_reader(m["name"])(ctx) is None, m["name"]


def test_readers_on_a_synthetic_trace():
    rows = 32768
    name = "void gemm_kernel<__nv_bfloat16, 64, true, 2, false>(x)"
    ctx = {"rows": rows, "hidden": [256, 512, 256], "data_dim": 5142, "noise": "philox",
           "macs_per_row": 4205568, "counters": {"k1_posterior": 10}, "requests": [],
           "spans": [{"name": "request", "req": 0, "t0": 0.0, "t1": 3.0},
                     {"name": "sample_raw", "req": 0, "t0": 0.0, "t1": 2.0}],
           "trace": {"kernels": {name: {"seconds": 10 * 0.2070e-3 / 0.5, "count": 10}},
                     "busy_s": 1.0, "window_s": 4.0}}
    read = {m["name"]: harness.metric_reader(m["name"])(ctx)
            for m in SPEC["per_layer"]}
    assert read["k1_posterior_roofline"] == pytest.approx(50.0, rel=1e-3)
    assert read["device_idle_pct.cohort"] == pytest.approx(75.0)
    assert read["sampler_ms.cohort"] == pytest.approx(2000.0)
    assert read["calibrate_ms.cohort"] == pytest.approx(1000.0)
    mfu = 100 * 10 * rows * 2 * 4205568 / (4.0 * 989e12)
    assert read["cohort_mfu_pct.cohort"] == pytest.approx(mfu)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_a_short_window_at_tiny_widths(cell, trace):
    from benchmark.tests.tiny import cpu, tiny_cell

    result = harness.run_cell(tiny_cell(cell), 2**31 + 11, 0.2, trace, 0.0, device=cpu())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0
    loaded = harness.load_cell(cell)
    expected = [m["name"] for m in (loaded.per_layer if trace else loaded.end_to_end)]
    assert set(result["metrics"]) <= set(expected)
    if not trace:
        assert set(result["metrics"]) == set(expected)
    for v in result["checks"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                          text=True, cwd=cwd, timeout=300)


def test_no_card_no_result():
    out = _run(["--workload", CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1",
                "--trace", "0"], ROOT)
    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without a card")
    assert out.returncode == 3 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone:
    the run fails on the program's import, and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness; "
            f"harness.run_cell(harness.load_cell({CELLS[0]!r}), 1, 1.0, False, 0.0, "
            "device=__import__('torch').device('cpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "osteosarcoma_diffusionmodel_torch" in out.stderr
    assert out.stdout.strip() == ""
    out = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
               tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
