#!/usr/bin/env python3
"""The AR mutation head's cost beside the default model's, on the port.

    [PROFILE_N=400 PROFILE_EPOCHS=75 PROFILE_BLOCK=25 PROFILE_GEN=10002 PROFILE_EXPR=5054] \
        python3 scripts/profile_ar_torch.py [--out PROFILE_AR_TORCH.json] [--device cpu]

Counterpart of scripts/profile_ar.py: the default and the AR presets back
to back in one process, on the seed-0 structured cohort of ``PROFILE_N``
patients at 62 / ``PROFILE_EXPR`` / 26, with ``Config()`` otherwise
(calibration off, the scenarios batched):

- train: ``PROFILE_EPOCHS`` epochs in blocks of ``PROFILE_BLOCK``
  (``training.epochs_per_dispatch``), and 10 epochs one at a time; the
  first block's seconds an epoch, the later epochs' (None where there is
  none), steps a second;
- generate, from the block run's weights: whether cohorts take the kernel
  sampler (``uses_kernels``, with the seconds to build it), the raw
  sample of ``PROFILE_GEN`` rows first and again (steady), its kernel
  launches by kernel and mode (the counts set to 0 before the first call
  and read after the steady one), the read-back to the host and, for the
  AR preset, its bits first and steady and the postprocess.

Every time synchronizes the device on both sides. The record (the JAX
record's keys, ``platform`` "cuda" or "cpu", and ``device``: the card's
name and power limit) goes to ``--out`` (default PROFILE_AR_TORCH.json at
the repo's root). It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from osteosarcoma_diffusionmodel_torch.cli import default_device  # noqa: E402
from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dataset import prepare_arrays  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dummy import (  # noqa: E402
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.generation.generator import (  # noqa: E402
    SyntheticPatientGenerator,
    seeded_generator,
)
from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion  # noqa: E402
from osteosarcoma_diffusionmodel_torch.training.trainer import Trainer  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.card import KERNELS  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.quality import device_stamp, timed  # noqa: E402

PER_EPOCH_EPOCHS = 10  # the per-epoch dispatch run's length


def knobs(env=os.environ) -> dict:
    """The JAX script's ``PROFILE_*`` knobs, with its defaults."""
    return {"n_cohort": int(env.get("PROFILE_N", 400)), "epochs": int(env.get("PROFILE_EPOCHS", 75)),
            "block": int(env.get("PROFILE_BLOCK", 25)), "n_gen": int(env.get("PROFILE_GEN", 10002)),
            "n_expression": int(env.get("PROFILE_EXPR", 5054))}


def build(workdir: Path, device: str, ar: bool, epochs_per_dispatch: int, num_epochs: int):
    """(config, dims, model, trainer) of one preset on ``workdir/processed``."""
    cfg = Config()
    cfg.data.processed_dir = str(workdir / "processed")
    cfg.training.num_epochs = num_epochs
    cfg.training.patience = num_epochs
    cfg.training.epochs_per_dispatch = epochs_per_dispatch
    cfg.training.save_dir = str(workdir / ("ckpt_ar" if ar else "ckpt"))
    cfg.model.diffusion.ar_mutation_head = ar
    cfg.generation.calibrate_marginals = False
    cfg.generation.batch_scenarios = True
    arrays, dims = prepare_arrays(cfg)
    model = ConditionalDiffusion.from_config(cfg, dims)
    return cfg, dims, model, Trainer(model, arrays, dims, cfg, device)


def profile_training(trainer: Trainer, label: str, out: dict) -> None:
    history, wall = timed(trainer.train, str(trainer.device))
    es = history.epoch_seconds
    k = trainer.config.training.epochs_per_dispatch
    # The first block holds the first epoch's set-up; with no epoch after
    # it there is no steady sample: None, not the first block's mean.
    steady = float(np.mean(es[k:])) if len(es) > k else None
    n_batches = len(trainer.epoch_batches(0))
    out[label] = {
        "wall_sec": wall,
        "first_block_sec_per_epoch": float(np.mean(es[:k])),
        "steady_sec_per_epoch": steady,
        "steady_steps_per_sec": n_batches / steady if steady else None,
        "reported_steps_per_sec": history.steps_per_sec,
        "epochs": len(es),
    }
    print(label, json.dumps(out[label]), flush=True)


def profile_generation(gen: SyntheticPatientGenerator, n_gen: int, label: str,
                       out: dict) -> None:
    device = str(gen.device)
    cond = gen.create_conditions(n_gen, None, torch.Generator().manual_seed(7))
    uses, probe = timed(lambda: gen.uses_kernels() and gen.sampler() is not None, device)
    res = {"fused_engaged": bool(uses), "fused_probe_sec": probe}
    for k in KERNELS:
        k.reset()
    _, res["raw_sample_first_sec"] = timed(lambda: gen.sample_raw(cond, seeded_generator(7, 1)),
                                           device)
    s, res["raw_sample_steady_sec"] = timed(lambda: gen.sample_raw(cond, seeded_generator(7, 2)),
                                            device)
    res["raw_patients_per_sec_steady"] = n_gen / res["raw_sample_steady_sec"]
    res["kernel_launches"] = {k.name: {m: n for m, n in k.modes.items() if n}
                              for k in KERNELS if k.launches}
    s_host, res["readback_sec"] = timed(lambda: s.float().cpu().numpy(), device)
    if gen.model.ar_head:
        continuous = s_host[:, gen.dims.mutation_dim:]
        _, res["ar_bits_first_sec"] = timed(
            lambda: gen._ar_bits(continuous, cond, seeded_generator(7, 3)), device)
        bits, res["ar_bits_steady_sec"] = timed(
            lambda: gen._ar_bits(continuous, cond, seeded_generator(7, 4)), device)
        res["ar_bits_mean"] = float(bits.mean())
        _, res["postprocess_sec"] = timed(
            lambda: gen._postprocess(s_host, cond, seeded_generator(7, 5)), device)
    out[label] = res
    print(label, json.dumps(res), flush=True)


def run(device: str, env=os.environ) -> dict:
    """Both presets on ``device``; returns the record."""
    kn = knobs(env)
    out = {**kn, "platform": torch.device(device).type, "device": device_stamp(device)}
    with tempfile.TemporaryDirectory(prefix="osdm_profile_ar_") as tmp:
        workdir = Path(tmp)
        write_processed(make_dummy_cohort(kn["n_cohort"], 62, kn["n_expression"], 26, seed=0),
                        workdir / "processed")
        for ar in (False, True):
            tag = "ar" if ar else "default"
            cfg, dims, model, trainer = build(workdir, device, ar, kn["block"], kn["epochs"])
            profile_training(trainer, f"train_{tag}_block{kn['block']}", out)
            # The per-epoch run trains a model of its own.
            per_epoch = build(workdir, device, ar, 1, PER_EPOCH_EPOCHS)[3]
            profile_training(per_epoch, f"train_{tag}_per_epoch", out)
            gen = SyntheticPatientGenerator(model, cfg, dims, device=device)
            profile_generation(gen, kn["n_gen"], f"gen_{tag}", out)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(REPO / "PROFILE_AR_TORCH.json"))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or default_device()
    t0 = time.perf_counter()
    out = run(device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))
    print(f"wrote {args.out} in {time.perf_counter() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
