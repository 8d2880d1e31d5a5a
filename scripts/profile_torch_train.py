#!/usr/bin/env python3
"""Where the port's train step spends its time, at full width on one card.

    python3 scripts/profile_torch_train.py [--epochs 20] [--architecture diffusion]
        [--out results/train_profile.json]

The production training settings (config defaults: batch 16, AdamW 1e-4,
clip 1.0, constraints on, dropout 0.2, mixup 0.2, pathway noise 0.05) on
the seeded structured cohort of 100 patients at 62/5054/26 with hidden
256/512/256 and T = 1000, for the diffusion model, the cVAE (latent 128)
or the flow (six couplings of width 512). After two warm-up epochs it
reports

- epochs as the trainer runs them (``train_epoch`` + ``validate`` + one
  host read): seconds an epoch and train steps a second;
- one periodic checkpoint write and one ``best_model.npz`` write, in
  seconds;
- 20 train steps on one batch: wall ms a step without the profiler, and
  under torch.profiler the wall ms a step, the device's kernel ms a step
  and its busy share (kernel time over the profiled wall time, both from
  that window), kernel launches a step, PyTorch operator calls a step
  (nested calls counted), and the eight kernels with the most device
  time;

with the card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from osteosarcoma_diffusionmodel_torch.cli import build_constraint_spec  # noqa: E402
from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dataset import OsteosarcomaArrays  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dummy import (  # noqa: E402
    cohort_arrays,
    make_dummy_cohort,
)
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer, build_model  # noqa: E402

PROFILED_STEPS = 20


def make_trainer(save_dir: Path, device, dims=(62, 5054, 26), config: Config | None = None):
    cfg = config or Config()
    cfg.training.save_dir = str(save_dir)
    cohort = make_dummy_cohort(100, *dims, seed=0)
    data, conditions, fdims = cohort_arrays(cohort, cfg)
    arrays = OsteosarcomaArrays(
        data, conditions, np.asarray(cohort.clinical["survival_days"], np.float32),
        cohort.sample_ids, cohort.mutation_genes, cohort.expression_genes,
        cohort.pathway_names, fdims.condition_names)
    model = build_model(cfg, fdims, build_constraint_spec(cfg, arrays))
    return Trainer(model, arrays, fdims, cfg, device)


def run(tr: Trainer, epochs: int) -> dict:
    sync = torch.cuda.synchronize if tr.device.type == "cuda" else (lambda: None)
    for epoch in range(2):  # warm-up
        torch.stack([tr.train_epoch(epoch), *tr.validate()]).tolist()
    steps_per_epoch = len(tr.epoch_batches(0))
    seconds = []
    for epoch in range(2, 2 + epochs):
        sync()
        t0 = time.perf_counter()
        torch.stack([tr.train_epoch(epoch), *tr.validate()]).tolist()
        seconds.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    tr.save_checkpoint(epochs + 1, 0.0)
    checkpoint_s = time.perf_counter() - t0
    best = {k: v.detach().clone() for k, v in tr.module.state_dict().items()}
    t0 = time.perf_counter()
    tr.write_best(best)
    best_s = time.perf_counter() - t0

    idx = torch.from_numpy(tr.epoch_batches(0)[0]).to(tr.device)
    data, cond, surv = tr._data[idx], tr._cond[idx], tr._surv[idx]
    activities = [torch.profiler.ProfilerActivity.CPU]
    if tr.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS):
        tr.train_step(data, cond, surv)
    sync()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            tr.train_step(data, cond, surv)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    events = prof.key_averages()
    # Device events that also name a host range (Optimizer.step#...) are
    # annotations of a span, not kernels.
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILED_STEPS
    launches = sum(e.count for e in kernels) / PROFILED_STEPS
    ops = sum(e.count for e in events if e.key.startswith("aten::")) / PROFILED_STEPS
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "epochs_timed": epochs,
        "steps_per_epoch": steps_per_epoch,
        "seconds_per_epoch_median": float(np.median(seconds)),
        "seconds_per_epoch_mean": float(np.mean(seconds)),
        "train_steps_per_sec": steps_per_epoch / float(np.median(seconds)),
        "checkpoint_write_s": checkpoint_s,
        "best_model_write_s": best_s,
        "profiled_steps": PROFILED_STEPS,
        "step_wall_ms_unprofiled": plain_wall_ms,
        "step_wall_ms": wall_ms,
        "step_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches_per_step": launches,
        "aten_ops_per_step": ops,
        "top_kernels_ms_per_step": {e.key[:90]: e.self_device_time_total / 1e3 / PROFILED_STEPS
                                    for e in top},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--architecture", default="diffusion", choices=("diffusion", "cvae", "flow"))
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_train.py measures the card; no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="osdm_train_profile_") as tmp:
        cfg = Config()
        cfg.model.architecture = args.architecture
        out = {"card": card, "architecture": args.architecture,
               **run(make_trainer(Path(tmp), "cuda", config=cfg), args.epochs)}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
