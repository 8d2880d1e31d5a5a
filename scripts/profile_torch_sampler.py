"""Where the PyTorch port's generate and validate steps spend their time
on one NVIDIA card.

    python scripts/profile_torch_sampler.py [--out results/profile_torch_sampler.json]

At full model width (data 62/5054/26, hidden 256/512/256, T = 1000) with
seeded weights: wall time of whole ``FusedSampler.sample`` calls (DDPM-1000
and DDIM-50, at 333 and 999 rows; with the D3PM mutation head; with each
int8 ``quantize`` mode), a torch.profiler trace of one DDIM-50 call per
variant (device time by kernel), the MMD of 100 real against 9999
synthetic rows through kernel K4, and the DDPM-1000 generate and validate
steps of ``chip_smoke.py``'s workload split by layer (sampler,
calibration on the card as "auto" takes it at 333 rows, CSV, validator
parts), with the host calibration of the same cohorts beside it
(``generate.calibrate_host``, not part of the step) and the target's
one-time host fit apart (``generate.fit_target``). Needs a CUDA device; prints one JSON
object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion  # noqa: E402
from osteosarcoma_diffusionmodel_torch.models.networks import init_weights  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops import _build  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops.pallas_kernels import mmd_rbf  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv  # noqa: E402

DATA_DIMS = (62, 5054, 26)


def wall(fn, repeats: int = 2) -> float:
    """Best host wall time of ``fn`` over ``repeats``, synchronized."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def step_breakdown(dev) -> dict:
    """Seconds by layer of chip_smoke.py's DDPM-1000 generate (3 x 333)
    and validate steps, each part synchronized."""
    import chip_smoke
    from osteosarcoma_diffusionmodel_torch.cli import _concat, _header
    from osteosarcoma_diffusionmodel_torch.generation.generator import (
        SyntheticPatientGenerator, load_trained_model, seeded_generator)
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import load_data_stats
    from osteosarcoma_diffusionmodel_torch.validation.validator import BiologicalValidator

    times = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        cfg = chip_smoke.prepare_workdir(Path(tmp), None)
        model, cfg, dims = load_trained_model(cfg.training.save_dir, cfg)
        gen = SyntheticPatientGenerator(model, cfg, dims, device=dev,
                                        data_stats=load_data_stats(cfg.training.save_dir))
        proc = Path(cfg.data.processed_dir)
        names = {"mutation_genes": _header(proc / "mutation_matrix_aligned.csv"),
                 "expression_genes": _header(proc / "expression_matrix_aligned.csv"),
                 "pathway_names": _header(proc / "pathway_scores.csv")}
        parts = {"mutations": [], "expression": [], "pathways": []}
        # The target's host fit, once per checkpoint, apart from the
        # cohorts' calibrations on either backend.
        timed("generate.fit_target", lambda: gen._joint_fit(dims.mutation_dim))
        for i, scenario in enumerate(cfg.generation.scenarios):
            g = seeded_generator(cfg.training.random_seed, i)
            cond = gen.create_conditions(333, scenario.conditions, g)
            raw = timed("generate.sampler", lambda: gen.sample_raw(cond, g))  # on the card
            out = timed("generate.calibrate", lambda: gen._postprocess(raw, cond))
            cfg.generation.calibration_backend = "numpy"  # the host path, for comparison
            timed("generate.calibrate_host", lambda: gen._postprocess(raw, cond))
            cfg.generation.calibration_backend = "auto"
            timed("generate.write_csv", lambda: gen.save_synthetic_data(
                out, Path(tmp) / "synthetic" / scenario.name, names, prefix=scenario.name))
            for key in parts:
                path = Path(tmp) / "synthetic" / scenario.name / f"{scenario.name}_{key}.csv"
                parts[key].append(timed("validate.read_csv",
                                        lambda: read_matrix_csv(path, index_col=None)))
        real = [timed("validate.read_csv", lambda: read_matrix_csv(proc / f)) for f in (
            "mutation_matrix_aligned.csv", "expression_matrix_aligned.csv", "pathway_scores.csv")]
        synth = [_concat(parts[k]) for k in ("mutations", "expression", "pathways")]
        val = BiologicalValidator(cfg, device=dev)
        timed("validate.cooccurrence", lambda: val.validate_mutation_cooccurrence(real[0], synth[0]))
        timed("validate.rules", lambda: val.validate_mutation_expression_correlation(
            synth[0], synth[2]))
        rc = np.concatenate([m.values for m in real], axis=1).astype(np.float32)
        sc = np.concatenate([m.values for m in synth], axis=1).astype(np.float32)
        timed("validate.statistical_tests", lambda: val.statistical_tests(rc, sc))
        timed("validate.novelty", lambda: val.novelty_metrics(rc, sc))
    return times


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="results/profile_torch_sampler.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()

    cfg = Config()
    dims = cfg.freeze_dims(*DATA_DIMS, ["survival_days_norm", "event_occurred",
                                        "metastasis_at_diagnosis"])
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(dev)
    d3pm = dataclasses.replace(model, discrete_head=True)
    samplers = {
        "DDPM-1000": FusedSampler(model, dev), "DDIM-50": FusedSampler(model, dev, 50),
        "d3pm DDPM-1000": FusedSampler(d3pm, dev), "d3pm DDIM-50": FusedSampler(d3pm, dev, 50),
    }
    for mode in ("out", "io", "all"):
        samplers[f"int8-{mode} DDPM-1000"] = FusedSampler(model, dev, quantize=mode)
        samplers[f"int8-{mode} DDIM-50"] = FusedSampler(model, dev, 50, quantize=mode)
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    report = {"card": card, "build_seconds": time.perf_counter() - t0, "sampler_seconds": {},
              "profile_ddim50_x333": {}}
    # Warm-up: first launches, allocator and cuBLAS handles are set-up.
    for label, sampler in samplers.items():
        if "DDIM" in label:
            sampler.sample(torch.randn(333, 3), torch.Generator().manual_seed(0))
    for rows in (333, 999):
        cond = torch.randn(rows, 3, generator=torch.Generator().manual_seed(rows))
        for label, sampler in samplers.items():
            gen = torch.Generator().manual_seed(1)
            seconds = wall(lambda: sampler.sample(cond, gen), repeats=2 if "DDIM" in label else 1)
            report["sampler_seconds"][f"{label} x{rows}"] = {
                "seconds": seconds, "patients_per_sec": rows / seconds,
                "ms_per_step": 1e3 * seconds / sampler.n_loop}

    cond = torch.randn(333, 3, generator=torch.Generator().manual_seed(5))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, sampler in samplers.items():
        if "DDIM" not in label:
            continue
        gen = torch.Generator().manual_seed(2)
        sampler.sample(cond, gen)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            t0 = time.perf_counter()
            sampler.sample(cond, gen)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        kernels = {}
        for evt in prof.key_averages():
            dev_us = getattr(evt, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "cuda_time_total", 0.0)
            if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
                kernels[evt.key] = {"device_ms": dev_us / 1e3, "count": evt.count}
        busy_ms = sum(v["device_ms"] for v in kernels.values())
        report["profile_ddim50_x333"][label] = {
            "wall_ms": window * 1e3, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (window * 1e3),
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])),
        }

    real = torch.randn(100, sum(DATA_DIMS), device=dev)
    synth = torch.randn(9999, sum(DATA_DIMS), device=dev) * 1.05
    mmd_rbf(real, synth)
    report["mmd_100_vs_9999_seconds"] = wall(lambda: mmd_rbf(real, synth))

    report["steps_ddpm1000_3x333"] = step_breakdown(dev)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
