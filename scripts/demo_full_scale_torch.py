#!/usr/bin/env python3
"""The full-scale demonstration on the PyTorch port, on one card.

    [DEMO_N=400 DEMO_EPOCHS=600 DEMO_...=...] [OSDM_DUMP_RAW=raw.npz] \
        python3 scripts/demo_full_scale_torch.py [--assert] [--out DEMO.json] [--device cpu]

Counterpart of scripts/demo_full_scale.py (the protocol behind the
``DEMO_*.json`` records) with the port's CLI steps: the structured cohort
of ``DEMO_N`` patients (default 100) at 62 mutation genes, 5,054
expression genes and 26 pathway columns from seed ``DEMO_SEED`` (default
0; ``data/dummy.py``, the draws of the JAX ``make_dummy_data``), the
pathways step, training for ``DEMO_EPOCHS`` epochs (default 200, patience
the same), generation of 10,002 patients over the three scenarios in one
batch (``batch_scenarios``) and validation. A ``DEMO_SEED`` other than 0
also sets ``training.random_seed`` to 42 + seed. The model, training and
generation knobs are the JAX script's (``utils/quality.apply_demo_knobs``).

The work directory (``processed/``, ``ckpt/``, ``results/``) is a fresh
temporary directory, printed and kept, as the JAX script keeps it:
scripts/replay_calibration_torch.py reads it with an ``OSDM_DUMP_RAW``
dump. The result, the JAX record's keys with ``device`` (the card's name
and power limit) in place of ``platform``, goes to ``--out`` (default
``$DEMO_OUT``, else DEMO_FULL_SCALE_TORCH.json at the repo's root).
``--assert`` exits 1 unless overall_biological_score >= 0.85 and
mmd < 0.15. The steps run on the card; ``--device cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
from pathlib import Path
from typing import Mapping, Optional, Tuple

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
from osteosarcoma_diffusionmodel_torch.utils.quality import (  # noqa: E402
    DIMS,
    SYNTHETIC,
    apply_demo_knobs,
    apply_gate,
    demo_paths,
    device_stamp,
    floats,
    timed,
)


def run(workdir: Path, device: str, n_samples: int = 100, epochs: int = 200,
        dims: Tuple[int, int, int] = DIMS, synthetic: int = SYNTHETIC,
        ddim_steps: Optional[int] = None, env: Mapping[str, str] = os.environ) -> dict:
    """The protocol in ``workdir``; returns the record. ``env`` holds the
    ``DEMO_*`` knobs (the cohort's seed among them)."""
    out = {"device": device_stamp(device)}
    demo_seed = int(env.get("DEMO_SEED", 0))
    _, out["make_data_sec"] = timed(lambda: write_processed(
        make_dummy_cohort(n_samples, *dims, seed=demo_seed), workdir / "processed"), "cpu")
    out["n_samples"] = n_samples
    out["demo_seed"] = demo_seed

    cfg = Config()
    if demo_seed:  # seed-robustness runs vary the training, split and generation seeds too
        cfg.training.random_seed = 42 + demo_seed
    apply_demo_knobs(cfg, env)
    demo_paths(cfg, workdir, workdir / "processed", epochs, synthetic, ddim_steps)

    _, out["pathways_sec"] = timed(lambda: compute_pathway_features(cfg), "cpu")
    history, out["train_sec"] = timed(lambda: train_model(cfg, device=device), device)
    out["train_epochs"] = len(history.train_loss)
    out["train_steps_per_sec"] = history.steps_per_sec
    out["final_train_loss"] = history.train_loss[-1]
    _, out["generate_10k_sec"] = timed(
        lambda: generate_synthetic_patients(cfg, device=device), device)
    out["patients_per_sec_e2e"] = synthetic / out["generate_10k_sec"]
    results, out["validate_sec"] = timed(
        lambda: validate_synthetic_patients(cfg, device=device), device)
    out["validation"] = floats(results)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--assert", dest="gate", action="store_true",
                        help="exit 1 unless overall >= 0.85 and MMD < 0.15")
    parser.add_argument("--out", default=os.environ.get(
        "DEMO_OUT", str(REPO / "DEMO_FULL_SCALE_TORCH.json")))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or default_device()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    workdir = Path(tempfile.mkdtemp(prefix="osdm_demo_torch_"))
    print(f"workdir: {workdir}", flush=True)
    out = run(workdir, device, n_samples=int(os.environ.get("DEMO_N", 100)),
              epochs=int(os.environ.get("DEMO_EPOCHS", 200)))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))
    return apply_gate(out["validation"]) if args.gate else 0


if __name__ == "__main__":
    sys.exit(main())
