"""Sampler wall time and device busy share of one checkout of the port, for
comparing two checkouts on one card.

    python scripts/ab_sampler_wall.py [--root DIR] [--rows 333] [--reps 3] [--out FILE]

Imports ``osteosarcoma_diffusionmodel_torch`` from ``--root`` (this
checkout by default; an unpacked ``git archive`` of another commit to
compare), builds the seeded full-width model (data 62/5054/26, hidden
256/512/256, T = 1000) and times whole ``FusedSampler.sample`` calls:
DDPM-1000 and DDIM-50, best of ``--reps`` after a warm-up call. One more
DDIM-50 call runs under torch.profiler: device time, busy share (device
time over the window's wall) and kernel launches. Run the two checkouts
in turns in one session (A, B, B, A): the wall follows the host, which
varies more than the card. Needs a CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--rows", type=int, default=333)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.models.networks import init_weights
    from osteosarcoma_diffusionmodel_torch.ops import _build
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.LIBRARY.get()
    cfg = Config()
    dims = cfg.freeze_dims(62, 5054, 26, list(cfg.model.condition_on))
    model = ConditionalDiffusion.from_config(cfg, dims)
    init_weights(model.denoiser, torch.Generator().manual_seed(0))
    model.denoiser.to(dev)
    cond = torch.randn(args.rows, dims.condition_dim, generator=torch.Generator().manual_seed(1))
    report = {"root": args.root, "card": card, "rows": args.rows, "wall_s": {}}
    for label, steps in (("DDPM-1000", None), ("DDIM-50", 50)):
        sampler = FusedSampler(model, dev, steps)
        sampler.sample(cond, torch.Generator().manual_seed(2))
        best = float("inf")
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampler.sample(cond, torch.Generator().manual_seed(2))
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        report["wall_s"][label] = best
        report[f"{label}_ms_per_step"] = 1e3 * best / sampler.n_loop

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sampler.sample(cond, torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    busy_us, launches = 0.0, 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            busy_us += dev_us
            launches += evt.count
    report["DDIM-50_profiled"] = {"wall_ms": 1e3 * window, "device_ms": busy_us / 1e3,
                                  "busy_share": busy_us / 1e3 / (1e3 * window),
                                  "device_ops": launches}
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
