"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py [--weights DIR]

Phases (each prints one line; any failure raises and exits non-zero):

1. the card, as nvidia-smi reports its name and power limit;
2. the build of the hand-written CUDA kernels from ``csrc/``;
3. each kernel (K1-K4) against its plain PyTorch version on the card, at
   the shapes the main path gives it, with the stated tolerance and both
   times;
4. the main path at full model width (data dims 62/5054/26, hidden
   256/512/256, T = 1000, cosine schedule): the port's CLI step
   functions generate -> calibrate (copula_joint) -> validate on a
   temporary directory holding a seeded structured cohort of 100
   patients, with DDPM-1000 for 3 scenarios x 333 patients and then
   DDIM-50. Every kernel's launch count must rise during that run.

The last two lines are the kernel report and
``{"ok": true, "device": {...}}``. There is no CPU branch: without a
CUDA device the script raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from osteosarcoma_diffusionmodel_torch.cli import (
    generate_synthetic_patients,
    validate_synthetic_patients,
)
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import (
    cohort_arrays,
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
from osteosarcoma_diffusionmodel_torch.ops import _build
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler, coefficient_table
from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule
from osteosarcoma_diffusionmodel_torch.ops.pallas_kernels import (
    RBF,
    rbf_kernel_sum,
    rbf_kernel_sum_plain,
)
from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import (
    GEMM,
    GROUPNORM,
    POSTERIOR,
    gemm_bf16_f32acc,
    gemm_bf16_f32acc_plain,
    groupnorm8_silu,
    groupnorm8_silu_plain,
    philox_uniform_noise,
    x0_posterior_step,
    x0_posterior_step_plain,
)
from osteosarcoma_diffusionmodel_torch.training.checkpoint import (
    data_stats_from_arrays,
    load_metadata,
    load_weights,
    metadata_to_dims,
    save_data_stats,
    save_metadata,
    save_weights,
)
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv

KERNELS = (GEMM, GROUPNORM, POSTERIOR, RBF)
BATCH = 333  # rows per scenario: 1000 // 3
DATA_DIMS = (62, 5054, 26)
D = sum(DATA_DIMS)
BF16_ULP = 2.0 ** -7  # one bf16 unit in the last place at 1.0


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after one warm-up call. A ~50 ms device sleep is queued first, so
    the host has enqueued every call before the start event runs and
    the events time the device, not the host's launch rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _report(kernel, case: str, err: float, tol: float, ms: float, plain_ms: float) -> dict:
    ok = bool(err <= tol)
    print(f"[kernel] {kernel.name} {case}: max|diff| {err:.3e} (tol {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if not ok:
        raise AssertionError(f"{kernel.name} {case}: max|diff| {err} > tol {tol}")
    return {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_gemm(dev, g) -> list:
    """K1 at the sampler's product shapes, as the main path calls it: the
    input product with the step's t_add row as bias and c_proj as the row
    add, written in bf16; the block products with a bias, one of them on
    a row-strided view, into f32; the output product into f32.
    Tolerance: both sides sum bf16-exact products in f32, in different
    orders, so an f32 result differs by f32 rounding of the sum, 1e-3
    relative to max(1, |ref|); a bf16 result is the plain f32 result
    rounded once to bf16, and a sum that lands near a rounding boundary
    may round the other way: 2^-7 of max(1, |ref|)."""
    out = []
    cases = [
        ("333x5142.5142x256 +t_add +c_proj ->bf16", 5142, 256, True, True, False,
         torch.bfloat16),
        ("333x1024.1024x256 +bias", 1024, 256, True, False, False, torch.float32),
        ("333x512(view of 1024).512x256 +bias", 512, 256, True, False, True, torch.float32),
        ("333x256.256x5142", 256, 5142, False, False, False, torch.float32),
    ]
    for case, k, n, has_bias, has_row_add, strided, out_dtype in cases:
        if strided:
            base = torch.randn(BATCH, 2 * k, generator=g).to(dev, torch.bfloat16)
            a = base[:, k:]
        else:
            a = torch.randn(BATCH, k, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(k, n, generator=g) / math.sqrt(k)).to(dev, torch.bfloat16)
        bias = torch.randn(n, generator=g).to(dev) if has_bias else None
        row_add = (torch.randn(BATCH, n, generator=g).to(dev, torch.bfloat16).float()
                   if has_row_add else None)
        buf = torch.empty(BATCH, n, dtype=out_dtype, device=dev)
        got = gemm_bf16_f32acc(a, w, out=buf, bias=bias, row_add=row_add).float()
        ref = gemm_bf16_f32acc_plain(a, w, bias, row_add).to(out_dtype).float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = BF16_ULP if out_dtype == torch.bfloat16 else 1e-3
        tol = rel * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: gemm_bf16_f32acc(a, w, out=buf, bias=bias, row_add=row_add))
        plain_ms = time_ms(lambda: gemm_bf16_f32acc_plain(a, w, bias, row_add).to(out_dtype))
        out.append(_report(GEMM, case, err, tol, ms, plain_ms))
    return out


def check_groupnorm(dev, g) -> list:
    """K2 at the block widths. Tolerance: the kernel stores bf16, the
    plain version is f32 rounded to bf16 once; f32 statistics in another
    order can move a value across one bf16 rounding boundary, so 2^-7 of
    max(1, |ref|): one to two bf16 ulps of the largest value."""
    out = []
    for f in (512, 256):
        h = (3.0 * torch.randn(BATCH, f, generator=g) + 1.0).to(dev)
        scale = (1.0 + 0.1 * torch.randn(f, generator=g)).to(dev)
        bias = (0.1 * torch.randn(f, generator=g)).to(dev)
        got = groupnorm8_silu(h, scale, bias).float()
        ref = groupnorm8_silu_plain(h, scale, bias)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = BF16_ULP * max(1.0, float(ref.abs().max()))
        buf = torch.empty(BATCH, f, dtype=torch.bfloat16, device=dev)
        ms = time_ms(lambda: groupnorm8_silu(h, scale, bias, out=buf))
        plain_ms = time_ms(lambda: groupnorm8_silu_plain(h, scale, bias).to(torch.bfloat16))
        out.append(_report(GROUPNORM, f"333x{f}", err, tol, ms, plain_ms))
    return out


def check_posterior(dev, g) -> list:
    """K3 at 333 x 5142 in its three noise modes. Tolerance: both sides
    compute in f32 and round once to bf16; fused multiply-adds can move a
    value across one rounding boundary, so 2^-7 of max(1, |ref|). The
    Philox stream must equal the plain generator's exactly, repeat for a
    repeated seed, and have mean ~0 (|mean| < 0.005, 6 standard errors at
    1.7M draws), variance ~1 (|var - 1| < 0.01) and |z| <= sqrt(3) + one
    bf16 ulp."""
    sched = DiffusionSchedule.create("cosine", 1000)
    gains = torch.randn(1000, generator=g).numpy() * 0.3
    coeffs = torch.from_numpy(coefficient_table(sched, gains)).to(dev)
    acc = (3.0 * torch.randn(BATCH, D, generator=g)).to(dev)
    x0 = torch.randn(BATCH, D, generator=g).to(dev, torch.bfloat16)
    b_out = (0.1 * torch.randn(D, generator=g)).to(dev)
    out = []
    for mode, step in (("philox", 17), ("buffer", 0), ("none", 999)):
        if mode == "buffer":
            noise = torch.randn(1, BATCH, D, generator=g).to(dev)
            table = coeffs[17:18].contiguous()
        else:
            noise = None
            table = coeffs
        x = x0.clone()
        x0_posterior_step(acc, x, b_out, table, step, mode, noise=noise, seed=1234)
        ref = x0_posterior_step_plain(acc, x0, b_out, table, step, mode, noise, seed=1234)
        torch.cuda.synchronize()
        err = float((x.float() - ref.float()).abs().max())
        tol = BF16_ULP * max(1.0, float(ref.float().abs().max()))
        xb = x0.clone()
        ms = time_ms(lambda: x0_posterior_step(acc, xb, b_out, table, step, mode,
                                               noise=noise, seed=1234))
        plain_ms = time_ms(lambda: x0_posterior_step_plain(acc, x0, b_out, table, step, mode,
                                                           noise, seed=1234))
        out.append(_report(POSTERIOR, f"333x5142 {mode}", err, tol, ms, plain_ms))

    # The noise alone: a row (c0, c1, sv, g) = (0, 0, 1, 0) leaves x = z.
    unit = torch.tensor([[0.0, 0.0, 1.0, 0.0, 0.0, 0.0]] * 3, device=dev)
    zs = []
    for _ in range(2):
        z = x0.clone()
        x0_posterior_step(acc, z, b_out, unit, 2, "philox", seed=99)
        zs.append(z.float())
    plain_z = philox_uniform_noise(99, 2, BATCH, D, device=dev).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    z = zs[0]
    mean, var, zmax = float(z.mean()), float(z.var()), float(z.abs().max())
    same_seed = bool(torch.equal(zs[0], zs[1]))
    exact = bool(torch.equal(z, plain_z))
    bound = math.sqrt(3.0) + 2.0 ** -7
    ok = abs(mean) < 0.005 and abs(var - 1.0) < 0.01 and zmax <= bound and same_seed and exact
    print(f"[kernel] {POSTERIOR.name} philox noise: mean {mean:.2e} var {var:.5f} "
          f"max|z| {zmax:.5f} (<= {bound:.5f}) repeatable {same_seed} "
          f"equals plain {exact} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("Philox noise check failed")
    return out


def check_rbf(dev, g) -> list:
    """K4 at the validate step's shapes (real n = 100, synthetic m = 999,
    d = 5142) against the float64 plain version. Tolerance: f32 cross
    products in the kernel against f64: 1e-5 relative to the sum."""
    x = torch.randn(100, D, generator=g).to(dev)
    y = (torch.randn(999, D, generator=g) * 1.05 + 0.02).to(dev)
    gamma = 1.0 / D
    out = []
    for case, a, b in (("xx 100x100", x, x), ("yy 999x999", y, y), ("xy 100x999", x, y)):
        got = float(rbf_kernel_sum(a, b, gamma))
        ref = float(rbf_kernel_sum_plain(a, b, gamma))
        again = float(rbf_kernel_sum(a, b, gamma))
        if got != again:
            raise AssertionError(f"rbf_kernel_sum not deterministic: {got} vs {again}")
        err = abs(got - ref)
        tol = 1e-5 * abs(ref)
        ms = time_ms(lambda: rbf_kernel_sum(a, b, gamma))
        plain_ms = time_ms(lambda: rbf_kernel_sum_plain(a, b, gamma))
        out.append(_report(RBF, f"{case}x{D}", err, tol, ms, plain_ms))
    return out


def check_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    return {
        GEMM.name: check_gemm(dev, g),
        GROUPNORM.name: check_groupnorm(dev, g),
        POSTERIOR.name: check_posterior(dev, g),
        RBF.name: check_rbf(dev, g),
    }


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def prepare_workdir(root: Path, weights: str | None) -> Config:
    """Processed tables of the seeded structured cohort (100 patients,
    62/5054/26) and a checkpoint directory: seeded weights at full width,
    or the exported checkpoint in ``weights``."""
    cfg = Config()
    cohort = make_dummy_cohort(100, *DATA_DIMS, seed=0)
    write_processed(cohort, root / "processed")
    data, conditions, dims = cohort_arrays(cohort, cfg)
    cfg.data.processed_dir = str(root / "processed")
    cfg.output.results_dir = str(root / "results")
    cfg.output.synthetic_data_dir = str(root / "synthetic")
    if weights is not None:
        meta = load_metadata(weights)
        if meta is None or metadata_to_dims(meta).data_dim != D:
            raise ValueError(f"{weights} holds no checkpoint with data dim {D}")
        cfg.training.save_dir = str(weights)
        return cfg
    ckpt = root / "checkpoint"
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    save_weights(ckpt, model.denoiser.state_dict())
    save_metadata(ckpt, cfg, dims)
    save_data_stats(ckpt, data_stats_from_arrays(data, conditions, dims.mutation_dim))
    cfg.training.save_dir = str(ckpt)
    return cfg


def check_outputs(cfg: Config, results: dict, label: str) -> None:
    """Every synthetic table has the expected shape and finite values;
    every metric is finite; mutations are bits."""
    per = cfg.generation.num_synthetic_samples // len(cfg.generation.scenarios)
    widths = dict(zip(("mutations", "expression", "pathways"), DATA_DIMS))
    widths["conditions"] = len(cfg.model.condition_on)
    for scenario in cfg.generation.scenarios:
        for key, width in widths.items():
            path = Path(cfg.output.synthetic_data_dir) / scenario.name / f"{scenario.name}_{key}.csv"
            values = read_matrix_csv(path, index_col=None).values
            if values.shape != (per, width) or not np.isfinite(values).all():
                raise AssertionError(f"{label} {path.name}: shape {values.shape}, "
                                     f"finite {np.isfinite(values).all()}")
            if key == "mutations" and not np.isin(values, (0.0, 1.0)).all():
                raise AssertionError(f"{label} {path.name}: mutation values are not bits")
    bad = {k: v for k, v in results.items() if not math.isfinite(v)}
    if bad or "mmd" not in results:
        raise AssertionError(f"{label}: non-finite or missing metrics {bad}")


def run_step(fn, cfg: Config, dev) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(cfg, device=str(dev))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_main_path(cfg: Config, dev) -> dict:
    """generate -> calibrate -> validate through the port's CLI step
    functions, DDPM-1000 and then DDIM-50."""
    report = {}
    n = cfg.generation.num_synthetic_samples // len(cfg.generation.scenarios) * len(
        cfg.generation.scenarios)
    for sampler in ("ddpm", "ddim"):
        cfg.generation.sampler = sampler
        cfg.output.synthetic_data_dir = str(Path(cfg.output.results_dir).parent / f"synthetic_{sampler}")
        label = "DDPM-1000" if sampler == "ddpm" else f"DDIM-{cfg.generation.sampling_steps}"
        _, gen_s = run_step(generate_synthetic_patients, cfg, dev)
        results, val_s = run_step(validate_synthetic_patients, cfg, dev)
        check_outputs(cfg, results, label)
        print(f"[main] {label}: generate+calibrate {gen_s:.2f} s for {n} patients "
              f"({n / gen_s:.1f} patients/sec end to end), validate {val_s:.2f} s", flush=True)
        print(f"[main] {label} metrics: " + json.dumps(
            {k: round(v, 6) for k, v in results.items()}), flush=True)
        report[label] = {"generate_s": gen_s, "validate_s": val_s,
                         "patients_per_sec": n / gen_s, "metrics": results}
    return report


def check_against_plain_loop(cfg: Config, dev) -> None:
    """The kernel sampler against the plain PyTorch loop (the module in
    f32) at the main path's shapes and tiling: 333 patients at full
    width, with a 20-step schedule, the same x_T and noise. Tolerance:
    atol 0.15 / rtol 0.05, the bf16-carry tolerance of the JAX package's
    fused-sampler parity test."""
    meta = load_metadata(cfg.training.save_dir)
    dims = metadata_to_dims(meta)
    small = Config.from_dict(meta["config"])
    small.model.diffusion.num_steps = 20
    small.model.compute_dtype = "float32"
    ref_model = ConditionalDiffusion.from_config(small, dims)
    ref_model.denoiser.load_state_dict(load_weights(cfg.training.save_dir))
    ref_model.denoiser.to(dev)
    g = torch.Generator().manual_seed(7)
    cond = torch.randn(BATCH, dims.condition_dim, generator=g)
    x_init = torch.randn(BATCH, D, generator=g)
    noise = torch.randn(20, BATCH, D, generator=g)
    for label, ddim in (("DDPM-20", None), ("DDIM-10", 10)):
        sampler = FusedSampler(ref_model, dev, ddim_steps=ddim)
        got = sampler.sample(cond, g, x_init=x_init, noise=None if ddim else noise)
        if ddim:
            ref = ref_model.sample_ddim(cond, g, 10, x_init=x_init)
        else:
            ref = ref_model.sample(cond, g, x_init=x_init, noise=noise)
        err = (got - ref).abs()
        bound = 0.15 + 0.05 * ref.abs()
        ok = bool((err <= bound).all()) and bool(torch.isfinite(got).all())
        print(f"[reference] {label} {BATCH}x{D}: kernel sampler vs plain loop max|diff| "
              f"{float(err.max()):.4f}, within atol 0.15 / rtol 0.05: {ok}; "
              f"std {float(ref.std()):.3f}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: kernel sampler disagrees with the plain loop")


def kernel_report(cases: dict) -> list:
    out = []
    for k in KERNELS:
        rows = cases[k.name]
        out.append({
            "name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": k.launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
        })
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", default=None,
                        help="checkpoint dir written by scripts/export_jax_checkpoint.py")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    logging.basicConfig(level=logging.WARNING)

    print(card_line(), flush=True)  # name, power limit: as nvidia-smi prints them
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    print(f"[build] {_build.LIB_NAME} from csrc/ in {time.perf_counter() - t0:.1f} s", flush=True)

    cases = check_kernels(dev)

    with tempfile.TemporaryDirectory(prefix="osdm_chip_smoke_") as tmp:
        cfg = prepare_workdir(Path(tmp), args.weights)
        for k in KERNELS:
            k.launches = 0
        run_main_path(cfg, dev)
        launches = {k.name: k.launches for k in KERNELS}
        print(f"[main] kernel launches during the main path: {json.dumps(launches)}", flush=True)
        missing = [name for name, count in launches.items() if count == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: {missing}")
        report = kernel_report(cases)
        check_against_plain_loop(cfg, dev)

    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
