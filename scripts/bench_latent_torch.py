#!/usr/bin/env python3
"""Latent-tail sampler bench of the PyTorch port, on one NVIDIA card.

    python scripts/bench_latent_torch.py --out results/bench_latent_torch.json \
        [--batch 999] [--steps 1000] [--head 0] [--reps 3] [--device cuda] [--profile]

Counterpart of scripts/bench_latent.py (which stays the JAX package's
script and keeps writing BENCH_LATENT.json; this one writes only
``--out``). At full width (data 62/5054/26, hidden 256/512/256, cosine
schedule, ``--steps`` DDPM steps) with weights made from seed 0, on
``--batch`` rows of zero conditions:

- the clip-headroom probe ``calibrate_head_steps`` on 256 rows (plain
  PyTorch, as the JAX probe runs in XLA); ``--head`` N > 0 overrides its
  head length;
- best wall time over ``--reps`` calls, after one warm-up call, of the
  port's data-space kernel sampler ``FusedSampler`` (all steps), the plain
  ``LatentTailSampler`` (the reference, as the JAX script's XLA row) and
  the kernel ``LatentFusedSampler`` (head and stack on K1 with the GN
  and posterior epilogues; each latent step's products and K7's work in
  one more K1 launch, after one priming K7 draw a call),
  each with the kernel launches of its calls by kernel and mode;
- with ``--profile``: one call of each kernel sampler under
  torch.profiler, its device time by kernel and its busy share (device
  time over the unprofiled best wall).

``--device`` is ``cuda`` unless given; there is no fallback. Random draws
come from a generator on that device. Prints one JSON line of timings.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion  # noqa: E402
from osteosarcoma_diffusionmodel_torch.models.networks import init_weights  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops import sampler_kernels as sk  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler  # noqa: E402
from osteosarcoma_diffusionmodel_torch.ops.latent_sampler import (  # noqa: E402
    LatentFusedSampler,
    LatentTailSampler,
    calibrate_head_steps,
)

DATA_DIMS = (62, 5054, 26)
CONDITIONS = ["survival_days_norm", "event_occurred", "metastasis_at_diagnosis"]
PROBE_ROWS = 256
KERNELS = (sk.GEMM, sk.GEMM_GN, sk.GEMM_POSTERIOR, sk.GROUPNORM, sk.POSTERIOR, sk.ROWQUANT,
           sk.GEMM_S8, sk.GEMM_S8_GN, sk.GEMM_S8_POSTERIOR, sk.GEMM_S8Q, sk.GEMM_S8Q_GN,
           sk.GEMM_S8Q_POSTERIOR, sk.LATENT, sk.GEMM_LATENT)


def build_model(steps: int, dev) -> ConditionalDiffusion:
    cfg = Config()
    cfg.model.diffusion.num_steps = steps
    model = ConditionalDiffusion.from_config(cfg, cfg.freeze_dims(*DATA_DIMS, CONDITIONS))
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(dev)
    return model


def launches() -> dict:
    return {k.name: {m: n for m, n in k.modes.items() if n} for k in KERNELS if k.launches}


def profile_call(fn, dev, best_wall: float) -> dict:
    """One call under torch.profiler: device time by kernel name, and the
    busy share against the unprofiled best wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        fn()
        torch.cuda.synchronize(dev)
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels[evt.key] = {"device_ms": dev_us / 1e3, "count": evt.count}
    busy_ms = sum(v["device_ms"] for v in kernels.values())
    return {"device_busy_ms": busy_ms, "device_busy_share": busy_ms / (best_wall * 1e3),
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"]))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=999)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--head", type=int, default=0, help="fixed head steps (0 = use the probe)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="JSON report path")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    if args.profile and not cuda:
        raise ValueError("--profile measures the card: it needs --device cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    model = build_model(args.steps, dev)
    conditions = torch.zeros(args.batch, len(CONDITIONS))
    report = {"device": str(dev), "batch": args.batch, "steps": args.steps, "timings": {}}
    if cuda:
        report["device_name"] = torch.cuda.get_device_name(dev)
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    sync()
    t0 = time.perf_counter()
    head, profile = calibrate_head_steps(model, conditions[:PROBE_ROWS], gen(9), device=dev)
    sync()
    report["probe"] = {
        "head_steps": head, "seconds": time.perf_counter() - t0,
        "profile_max": float(profile.max()),
        "profile_p99_row": int(np.argmax(profile > 0.99 * profile.max())),
        "profile": profile.tolist(),
    }
    print(f"probe: head_steps={head} max|x0_pred|={profile.max():.2f} "
          f"({report['probe']['seconds']:.2f}s)", flush=True)
    if args.head:
        head = args.head
    report["head_steps"] = head

    latent = LatentFusedSampler(model, head, dev)
    samplers = {
        "fused_dataspace": (FusedSampler(model, dev).sample, None),
        f"latent_plain_head{head}": (LatentTailSampler(model, head, dev).sample, "reference"),
        f"latent_kernel_head{head}": (latent.sample, None),
    }
    for name, (fn, role) in samplers.items():
        for k in KERNELS:
            k.reset()
        out = fn(conditions, gen(1))  # warm-up
        sync()
        if out.shape != (args.batch, sum(DATA_DIMS)) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output {tuple(out.shape)} is not finite and (B, D)")
        times = []
        for i in range(args.reps):
            sync()
            t0 = time.perf_counter()
            fn(conditions, gen(2 + i))
            sync()
            times.append(time.perf_counter() - t0)
        best = min(times)
        entry = {"seconds": best, "patients_per_sec": args.batch / best,
                 "calls": args.reps + 1, "launches": launches()}
        if role:
            entry["role"] = role
        if name.startswith("latent"):
            entry["n_lat"] = latent.n_lat
        if args.profile:
            entry["profile"] = profile_call(lambda: fn(conditions, gen(99)), dev, best)
        report["timings"][name] = entry
        print(f"{name}{' (reference)' if role else ''}: {best:.3f}s = "
              f"{args.batch / best:,.0f} patients/sec", flush=True)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: {"seconds": v["seconds"], "patients_per_sec": v["patients_per_sec"]}
                      for k, v in report["timings"].items()}), flush=True)
    return report


if __name__ == "__main__":
    main()
