#!/usr/bin/env python3
"""The production preset end to end on the PyTorch port, on one card.

    python3 scripts/production_run_torch.py [--assert] [--out PRODUCTION_RUN_TORCH.json]

Counterpart of scripts/production_run.py (the protocol behind
PRODUCTION_RUN.json) with the port's CLI steps: ``config/production.yaml``
through the YAML loader; the seeded structured cohort of 100 patients at
62 mutation genes, 5,054 expression genes and 26 pathway columns
(``data/dummy.py``, the draws of the JAX ``make_dummy_data``); the CLI's
pathways step (pathway scores recomputed from the expression table,
``gene_pathway_matrix.csv``), which leaves 29 pathway columns; then
train (600 epochs, patience 600), generate (10,002 patients, DDIM-50,
``batch_scenarios``, ``copula_joint``) and validate. The JAX protocol's
report step is not ported and not run.

It writes one JSON object: the validator's metrics, the training history
(epochs, first and last losses, steps/sec, seconds an epoch), the seconds
of each step, the backend of generate's calibration (the card, under
"auto", for the batched cohort of 10,002 rows), and the card's name and
power limit as nvidia-smi reports them (``utils/quality.py``, shared with
the demo scripts). ``--assert`` exits 1 unless overall_biological_score
>= 0.85 and mmd < 0.15, the gate of scripts/demo_full_scale.py. The steps run on the
card; ``--device cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from osteosarcoma_diffusionmodel_torch.cli import (  # noqa: E402
    compute_pathway_features,
    default_device,
    generate_synthetic_patients,
    train_model,
    validate_synthetic_patients,
)
from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.dummy import (  # noqa: E402
    make_dummy_cohort,
    write_processed,
)
from osteosarcoma_diffusionmodel_torch.generation.generator import CALIBRATIONS  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.quality import (  # noqa: E402
    apply_gate,
    device_stamp,
    gate_failures,  # noqa: F401 (the gate, for the tests)
    timed,
)


def run(workdir: Path, device: str, epochs: int = 600, samples: int = 10002,
        dims=(62, 5054, 26), config: Config | None = None) -> dict:
    """The protocol in ``workdir``; returns the result object."""
    cohort = make_dummy_cohort(100, *dims, seed=0)
    processed = workdir / "processed"
    write_processed(cohort, processed)

    cfg = config or Config.from_yaml(REPO / "config" / "production.yaml")
    cfg.data.processed_dir = str(processed)
    n_pathways = len(compute_pathway_features(cfg).columns)
    cfg.training.num_epochs = epochs
    cfg.training.patience = epochs
    cfg.training.save_dir = str(workdir / "ckpt")
    cfg.generation.num_synthetic_samples = samples
    cfg.output.results_dir = str(workdir / "results")
    cfg.output.synthetic_data_dir = str(workdir / "results" / "synthetic")

    t_start = time.perf_counter()
    history, train_s = timed(lambda: train_model(cfg, device=device), device)
    CALIBRATIONS.clear()
    _, generate_s = timed(lambda: generate_synthetic_patients(cfg, device=device), device)
    calibrations = dict(CALIBRATIONS)
    results, validate_s = timed(lambda: validate_synthetic_patients(cfg, device=device), device)
    wall = time.perf_counter() - t_start

    n = len(history.train_loss)
    return {
        "config": ("config/production.yaml (ddim-50, batch_scenarios, copula_joint; "
                   "epochs_per_dispatch 25: 25-epoch blocks)"),
        "protocol": (f"scripts/production_run_torch.py (pathways train generate validate); "
                     f"100x{dims[0] + dims[1] + n_pathways} structured cohort, {epochs} epochs, "
                     f"{samples} generated"),
        "device": device_stamp(device),
        "train_epochs": n,
        "training": {
            "steps_per_sec": history.steps_per_sec,
            "seconds_per_epoch_mean": float(np.mean(history.epoch_seconds)),
            "seconds_per_epoch_median": float(np.median(history.epoch_seconds)),
            "train_loss_first_last": [history.train_loss[0], history.train_loss[-1]],
            "val_loss_first_last_best": [history.val_loss[0], history.val_loss[-1],
                                         min(history.val_loss)],
        },
        "step_seconds": {"train": train_s, "generate": generate_s, "validate": validate_s},
        "generate_calibrations": calibrations,
        "pipeline_wall_clock_sec": wall,
        "validation": {k: float(v) for k, v in results.items()},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--assert", dest="gate", action="store_true",
                        help="exit 1 unless overall >= 0.85 and MMD < 0.15")
    parser.add_argument("--out", default=str(REPO / "PRODUCTION_RUN_TORCH.json"))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or default_device()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    with tempfile.TemporaryDirectory(prefix="osdm_prod_torch_") as tmp:
        out = run(Path(tmp), device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))
    return apply_gate(out["validation"]) if args.gate else 0


if __name__ == "__main__":
    sys.exit(main())
