"""The benchmark's harness, driven by data.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
harness finds the configuration's file (``configs[].file``), the mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names the generator
``benchmark/traffic/<kind>.py``), the cell's limits on the compared
numbers (``benchmark/workloads/<cell>.json``) and each per-layer metric's
reader (``benchmark/metrics/<metric>.py``) by name, so a later cell, mix
or metric is a new file.

A run: set-up (the kind's ``setup``: the program built from the seed and
the cell's shapes warmed up), the measured window (``window``), then,
with the window closed and the peak memory read, the program's state
freed (``release``) and its outputs judged against the plain reference
(``compare``). ``--trace 1`` profiles the window and reports the cell's
per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# Top-level modules that may not be loaded in a run: JAX, its libraries
# and the JAX package (compared by whole top-level name: the port's name
# begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "osteosarcoma_diffusionmodel_tpu")


class NoCard(RuntimeError):
    """The run needs more CUDA devices than this process sees."""


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Record:
    """What a window leaves: its start (host clock), the requests' host
    spans, named spans inside them, counters, failures."""
    t0: float = 0.0
    t_end: float = 0.0
    requests: List[Dict[str, float]] = field(default_factory=list)
    spans: List[Dict[str, Any]] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    failed: int = 0
    errors: List[str] = field(default_factory=list)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, spec: Optional[dict] = None) -> Cell:
    spec = spec or load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = root / "benchmark" / "workloads" / f"{name}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else {}
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=dict(limits),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def program_config(cell: Cell):
    """The port's ``Config`` of the cell's configuration file."""
    from osteosarcoma_diffusionmodel_torch.config import Config

    return Config.from_dict(cell.config["config"])


def kind_module(cell: Cell):
    """The traffic kind's generator, ``benchmark/traffic/<kind>.py``."""
    return importlib.import_module(f"benchmark.traffic.{cell.traffic['kind']}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def request_seed(seed: int, *index: int) -> int:
    """A 64-bit seed for (run seed, index...): independent streams."""
    state = np.random.SeedSequence([int(seed), *map(int, index)]).generate_state(2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them ("" where
    nvidia-smi is missing)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def check_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} seen")
    return torch.device("cuda", 0)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (a number is within it at or
    below the limit; a NaN never is)."""
    out = {}
    for key, limit in limits.items():
        value = numbers.get(key, float("nan"))
        out[key] = {"value": value, "limit": limit}
    return out


def within(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(v["value"] <= v["limit"] for v in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, numbers_out: Optional[dict] = None) -> dict:
    """One run of ``cell``; returns the result line's object. Every number
    the comparison computed, judged or not, goes into ``numbers_out``."""
    import torch

    dev = device if device is not None else check_device(cell.chips)
    _log(f"imports and device found at {time.perf_counter() - t_start:.2f} s; card: "
         + (card_line() if dev.type == "cuda" else "none (the CPU)"))
    kind = kind_module(cell)
    state = kind.setup(cell, seed, dev)
    _log(f"set-up done at {time.perf_counter() - t_start:.2f} s")
    rec = Record()
    summary = None
    if trace:
        from benchmark.trace import TracedWindow

        counters0 = kind.counters()
        with TracedWindow(dev) as traced:
            kind.window(state, seconds, rec, traced=True)
        rec.counters = {k: v - counters0.get(k, 0) for k, v in kind.counters().items()}
        summary = traced.summary()
    else:
        kind.window(state, seconds, rec, traced=False)
    setup_s = rec.t0 - t_start
    on_card = dev.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run: {', '.join(found)}")
    context = kind.layer_context(state, rec)
    e2e = kind.end_to_end(state, rec)
    _log(f"window done at {time.perf_counter() - t_start:.2f} s: {len(rec.requests)} requests, "
         f"{rec.failed} failed {rec.errors[:2]}")
    kind.release(state)
    numbers = kind.compare(state, rec)
    _log(f"comparison done at {time.perf_counter() - t_start:.2f} s: "
         + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
    if numbers_out is not None:
        numbers_out.update(numbers)
    checks = judge(numbers, cell.limits)
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        ctx = dict(context, trace=summary, spans=rec.spans, counters=rec.counters,
                   requests=rec.requests)
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e and e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result: Dict[str, Any] = {
        "correct": within(checks) and rec.failed == 0 and bool(rec.requests),
        "attempted": len(rec.requests) + rec.failed,
        "failed": rec.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result
