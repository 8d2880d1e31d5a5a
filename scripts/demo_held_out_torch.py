#!/usr/bin/env python3
"""The held-out and novelty protocol on the PyTorch port, on one card.

    [DEMO_N=100 DEMO_EPOCHS=200 DEMO_CALIBRATE=... DEMO_BLOCK=... DEMO_AR=...] \
        python3 scripts/demo_held_out_torch.py [--out DEMO_HELD_OUT.json] [--device cpu]

Counterpart of scripts/demo_held_out.py (the protocol behind
DEMO_HELD_OUT.json) with the port's CLI steps:

1. the structured cohort of 2 x ``DEMO_N`` patients (default 100 a half;
   62 / 5,054 / 26 features, seed 0), its three ``*_aligned.csv`` tables
   split row-wise into a fit and a holdout half by the JAX ``_split_csvs``
   rule (``default_rng(0).permutation(n)``, each half in sorted order),
   and the pathways step on both halves;
2. training (``DEMO_EPOCHS``, default 200) and calibration on the fit
   half only, then ``DEMO_SAMPLES`` patients (default 10,002) in one
   batch;
3. the validator three ways, novelty metrics included: synthetic against
   the fit half (the in-sample number), synthetic against the holdout
   half (generalization), and the fit half as if synthetic against the
   holdout half (the real-vs-real floor).

The knobs are the JAX script's (DEMO_CALIBRATE, DEMO_BLOCK, DEMO_AR,
``utils/quality.apply_demo_knobs``). The record holds the JAX record's
keys with ``device`` (the card's name and power limit) in place of
``platform``; it goes to ``--out`` (default ``$DEMO_OUT``, else
DEMO_HELD_OUT_TORCH.json at the repo's root). The steps run on the card;
``--device cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys
import tempfile
from pathlib import Path
from typing import Mapping, Optional, Tuple

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
from osteosarcoma_diffusionmodel_torch.utils.io import (  # noqa: E402
    read_matrix_csv,
    write_matrix_csv,
)
from osteosarcoma_diffusionmodel_torch.utils.quality import (  # noqa: E402
    DIMS,
    SYNTHETIC,
    apply_demo_knobs,
    demo_paths,
    device_stamp,
    floats,
    timed,
)
from osteosarcoma_diffusionmodel_torch.validation.validator import (  # noqa: E402
    BiologicalValidator,
)

TABLES = ("mutation_matrix_aligned.csv", "expression_matrix_aligned.csv",
          "clinical_aligned.csv")
KNOBS = ("DEMO_CALIBRATE", "DEMO_BLOCK", "DEMO_AR")  # demo_held_out.py:90-115


def split_halves(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The fit and holdout rows of an n-row cohort (JAX ``_split_csvs``)."""
    perm = np.random.default_rng(seed).permutation(n)
    return np.sort(perm[: n // 2]), np.sort(perm[n // 2:])


def split_tables(src: Path, fit_dir: Path, holdout_dir: Path, seed: int = 0) -> Tuple[int, int]:
    """Every ``*_aligned.csv`` of ``src`` split row-wise into the two
    halves, index and values as read (``%.17g`` round-trips them)."""
    fit_dir.mkdir(parents=True, exist_ok=True)
    holdout_dir.mkdir(parents=True, exist_ok=True)
    fit_idx, hold_idx = split_halves(len(read_matrix_csv(src / TABLES[0]).index), seed)
    for name in TABLES:
        table = read_matrix_csv(src / name)
        for rows, dest in ((fit_idx, fit_dir), (hold_idx, holdout_dir)):
            write_matrix_csv(dest / name, table.values[rows], table.columns,
                             index=[table.index[i] for i in rows],
                             index_label=table.index_name, fmt="%.17g")
    return len(fit_idx), len(hold_idx)


def run(workdir: Path, device: str, n_half: int = 100, epochs: int = 200,
        dims: Tuple[int, int, int] = DIMS, synthetic: int = SYNTHETIC,
        ddim_steps: Optional[int] = None, env: Mapping[str, str] = os.environ) -> dict:
    """The protocol in ``workdir``; returns the record."""
    out = {"n_per_half": n_half, "device": device_stamp(device)}

    def prepare():
        write_processed(make_dummy_cohort(2 * n_half, *dims, seed=0), workdir / "full")
        n_fit, n_hold = split_tables(workdir / "full", workdir / "fit", workdir / "holdout")
        out["split"] = {"fit": n_fit, "holdout": n_hold}
        cfg = apply_demo_knobs(Config(), {k: env[k] for k in KNOBS if k in env})
        demo_paths(cfg, workdir, workdir / "fit", epochs, synthetic, ddim_steps)
        # The holdout validation needs its own pathway scores and membership matrix.
        hold_cfg = copy.deepcopy(cfg)
        hold_cfg.data.processed_dir = str(workdir / "holdout")
        hold_cfg.output.results_dir = str(workdir / "results_holdout")
        compute_pathway_features(cfg)
        compute_pathway_features(hold_cfg)
        return cfg, hold_cfg

    (cfg, hold_cfg), out["prep_sec"] = timed(prepare, "cpu")
    _, out["train_sec"] = timed(lambda: train_model(cfg, device=device), device)
    _, out["generate_sec"] = timed(lambda: generate_synthetic_patients(cfg, device=device), device)

    def validate():
        out["validation_vs_fit"] = floats(validate_synthetic_patients(cfg, device=device))
        out["validation_vs_holdout"] = floats(
            validate_synthetic_patients(hold_cfg, device=device))
        # The real-vs-real floor: the fit half "as synthetic" against the holdout half.
        fit, hold = ({name: read_matrix_csv(workdir / half / f"{name}.csv") for name in (
            "mutation_matrix_aligned", "expression_matrix_aligned", "pathway_scores")}
            for half in ("fit", "holdout"))
        out["real_vs_real_floor"] = floats(BiologicalValidator(cfg, device=device).validate_all(
            real_mutations=hold["mutation_matrix_aligned"],
            real_expression=hold["expression_matrix_aligned"],
            real_pathways=hold["pathway_scores"],
            synth_mutations=fit["mutation_matrix_aligned"],
            synth_expression=fit["expression_matrix_aligned"],
            synth_pathways=fit["pathway_scores"],
            pathway_gene_matrix=read_matrix_csv(workdir / "holdout" / "gene_pathway_matrix.csv"),
        ))

    _, out["validate_sec"] = timed(validate, device)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.environ.get(
        "DEMO_OUT", str(REPO / "DEMO_HELD_OUT_TORCH.json")))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or default_device()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    workdir = Path(tempfile.mkdtemp(prefix="osdm_heldout_torch_"))
    print(f"workdir: {workdir}", flush=True)
    out = run(workdir, device, n_half=int(os.environ.get("DEMO_N", 100)),
              epochs=int(os.environ.get("DEMO_EPOCHS", 200)),
              synthetic=int(os.environ.get("DEMO_SAMPLES", SYNTHETIC)))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
