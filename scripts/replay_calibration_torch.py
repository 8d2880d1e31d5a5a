#!/usr/bin/env python3
"""Replay calibration modes on a dumped raw cohort with the PyTorch port.

    OSDM_DUMP_RAW=/tmp/raw.npz DEMO_N=400 DEMO_EPOCHS=600 python3 scripts/demo_full_scale_torch.py
    python3 scripts/replay_calibration_torch.py /tmp/raw.npz <demo workdir> \
        [copula_joint copula_full quantile ...] [--out replay.json] [--device cpu]

Counterpart of scripts/replay_calibration.py. A demo run with
``OSDM_DUMP_RAW`` set leaves the model's pre-calibration cohort (the
generator's debug hook) and prints its work directory (``processed/``,
``ckpt/``). Each listed mode (default copula_joint and copula_full;
"false" for none) then runs through a bare generator's ``_postprocess``
on the host (``calibration_backend`` "numpy": ``ops/copula.py``, as the
JAX script's CPU run takes), with the fitted copulas reset per mode, and
prints the metrics the JAX script prints: the within-pathway coherence of
the first ten Hallmark pathways (synthetic mean, real mean, and the
correlation of the two patterns) and the correlation of the chi-square
co-occurrence patterns over 50 seeded genes, as the validator computes
them, and the directional mutation -> pathway rules (TP53 -> P53 pathway
negative, MYC -> MYC targets positive). The statistics run on the card
(``--device cpu``: on the CPU); ``--out`` also writes them as JSON with
the card's stamp.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from osteosarcoma_diffusionmodel_torch.cli import default_device  # noqa: E402
from osteosarcoma_diffusionmodel_torch.config import Config  # noqa: E402
from osteosarcoma_diffusionmodel_torch.data.pathways import gene_pathway_matrix  # noqa: E402
from osteosarcoma_diffusionmodel_torch.generation.generator import (  # noqa: E402
    SyntheticPatientGenerator,
)
from osteosarcoma_diffusionmodel_torch.training.checkpoint import load_data_stats  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.io import Matrix, read_matrix_csv  # noqa: E402
from osteosarcoma_diffusionmodel_torch.utils.quality import device_stamp  # noqa: E402
from osteosarcoma_diffusionmodel_torch.validation.validator import (  # noqa: E402
    BiologicalValidator,
)

DEFAULT_MODES = ("copula_joint", "copula_full")
RULES = (("TP53", "HALLMARK_P53_PATHWAY", -1), ("MYC", "HALLMARK_MYC_TARGETS_V1", +1))


class _Stub:
    """A bare model: only ``_postprocess``/``_calibrate`` run, which read
    no weights (the generator sees no diffusion model, so no head)."""

    module = torch.nn.Module()


def replay(raw_path: Path, work: Path, modes: Sequence[str],
           device: str) -> Iterator[Tuple[str, dict]]:
    """(mode, metrics) for each mode in turn, on the dump ``raw_path``
    against the demo work directory ``work``: the validator's coherence
    and co-occurrence metrics, and each rule's correlation."""
    raw = np.load(raw_path)["samples"]
    stats = load_data_stats(work / "ckpt")
    mut = read_matrix_csv(work / "processed" / "mutation_matrix_aligned.csv")
    expr = read_matrix_csv(work / "processed" / "expression_matrix_aligned.csv")
    pz_cols = read_matrix_csv(work / "processed" / "pathway_scores.csv").columns
    m, e = len(mut.columns), len(expr.columns)
    membership, genes, pathways = gene_pathway_matrix()
    validator = BiologicalValidator(Config(), device=device)

    cfg = Config()
    cfg.generation.calibration_backend = "numpy"
    dims = cfg.freeze_dims(m, e, raw.shape[1] - m - e, ["a", "b", "c"])
    gen = SyntheticPatientGenerator(_Stub(), cfg, dims, data_stats=stats, device=device)
    for mode in modes:
        t0 = time.perf_counter()
        cfg.generation.calibrate_marginals = False if mode == "false" else mode
        gen._copula = gen._cont_chol = gen._joint = None
        out = gen._postprocess(raw, np.zeros((raw.shape[0], 3), np.float32))
        coherence = validator.validate_pathway_coherence(
            expr, Matrix(out["expression"], expr.columns), Matrix(membership, pathways, genes))
        cooc = validator.validate_mutation_cooccurrence(mut, Matrix(out["mutations"], mut.columns))
        rules = {}
        for gene, pathway, want in RULES:
            if gene in mut.columns and pathway in pz_cols:
                c = float(np.corrcoef(out["mutations"][:, mut.columns.index(gene)],
                                      out["pathways"][:, pz_cols.index(pathway)])[0, 1])
                rules[gene] = (round(c, 3), "OK" if np.sign(c) == want else "VIOL")
        yield mode, {
            "coherence_synthetic": coherence["synthetic_pathway_coherence"],
            "coherence_real": coherence["real_pathway_coherence"],
            "coherence_pattern_corr": coherence["pathway_coherence_correlation"],
            "cooccurrence_pattern_corr": cooc["cooccurrence_pattern_correlation"],
            "rules": rules,
            "rows": int(raw.shape[0]),
            "seconds": time.perf_counter() - t0,
        }


def line(mode: str, r: dict) -> str:
    """One mode's result as scripts/replay_calibration.py prints it."""
    return (f"[{mode}] coherence synth={r['coherence_synthetic']:.3f} (real "
            f"{r['coherence_real']:.3f}) pattern_corr={r['coherence_pattern_corr']:.3f} "
            f"cooc={r['cooccurrence_pattern_corr']:.3f} rules={r['rules']} "
            f"({r['seconds']:.0f}s)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("raw", type=Path, help="the OSDM_DUMP_RAW dump (.npz)")
    parser.add_argument("work", type=Path, help="the demo's work directory")
    parser.add_argument("modes", nargs="*", default=list(DEFAULT_MODES))
    parser.add_argument("--out", default=None, help="also write the metrics as JSON here")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or default_device()
    results = {}
    for mode, metrics in replay(args.raw, args.work, args.modes, device):
        results[mode] = metrics
        print(line(mode, metrics), flush=True)
    if args.out:
        record = {"device": device_stamp(device), "modes": results}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
