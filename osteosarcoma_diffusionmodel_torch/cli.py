"""Pipeline CLI of the PyTorch port: the generate and validate steps.

    python -m osteosarcoma_diffusionmodel_torch.cli --config config/config.yaml \
        --steps generate validate [--device cuda]

Counterpart of osteosarcoma_diffusionmodel_tpu/cli.py (:280-398). It
reads the port's checkpoint directory (``training.save_dir``: weights
``best_model.npz``, ``metadata.json``, ``data_stats.npz``) and a processed
directory in the JAX layout (``data.processed_dir``), and writes the JAX
CLI's files: ``<synthetic_data_dir>/<scenario>/<scenario>_{mutations,
expression,pathways,conditions}.csv`` and
``<results_dir>/validation_results.csv``. The model section of the config
always comes from the checkpoint's metadata (the JAX CLI also consults
``config/config_updated.yaml``, which the port does not). Training and
the other steps are not ported yet.
"""

from __future__ import annotations

import argparse
import csv
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .config import Config
from .generation.generator import SyntheticPatientGenerator, load_trained_model
from .training.checkpoint import load_data_stats
from .utils.io import Matrix, read_matrix_csv
from .validation.validator import BiologicalValidator

logger = logging.getLogger(__name__)

STEPS = ("generate", "validate")


def default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _header(path: Path) -> list:
    with open(path, newline="") as f:
        return next(csv.reader(f))[1:]


def generate_synthetic_patients(config: Config, device: Optional[str] = None):
    logger.info("STEP 5: Generating synthetic patients")
    save_dir = Path(config.training.save_dir)
    model, config, dims = load_trained_model(save_dir, config)
    generator = SyntheticPatientGenerator(
        model, config, dims, data_stats=load_data_stats(save_dir),
        device=device or default_device(),
    )
    scenarios = config.generation.scenarios
    per_scenario = config.generation.num_synthetic_samples // len(scenarios)
    all_synthetic = generator.generate_scenarios(scenarios, per_scenario)

    processed = Path(config.data.processed_dir)
    gene_names = {
        "mutation_genes": _header(processed / "mutation_matrix_aligned.csv"),
        "expression_genes": _header(processed / "expression_matrix_aligned.csv"),
        "pathway_names": _header(processed / "pathway_scores.csv"),
    }
    output_dir = Path(config.output.synthetic_data_dir)
    for name, synthetic in all_synthetic.items():
        generator.save_synthetic_data(synthetic, output_dir / name, gene_names, prefix=name)
    logger.info("Synthetic data saved to %s", output_dir)
    return all_synthetic


def _concat(parts) -> Matrix:
    return Matrix(np.concatenate([p.values for p in parts], axis=0), parts[0].columns)


def validate_synthetic_patients(config: Config, device: Optional[str] = None) -> Dict[str, float]:
    logger.info("STEP 6: Validating synthetic patients")
    processed = Path(config.data.processed_dir)
    real_mut = read_matrix_csv(processed / "mutation_matrix_aligned.csv")
    real_expr = read_matrix_csv(processed / "expression_matrix_aligned.csv")
    real_path = read_matrix_csv(processed / "pathway_scores.csv")

    output_dir = Path(config.output.synthetic_data_dir)
    tables = {"mutations": [], "expression": [], "pathways": []}
    for scenario in config.generation.scenarios:
        for key, parts in tables.items():
            parts.append(read_matrix_csv(
                output_dir / scenario.name / f"{scenario.name}_{key}.csv", index_col=None))
    gpm_path = processed / "gene_pathway_matrix.csv"
    gene_pathway = read_matrix_csv(gpm_path) if gpm_path.exists() else None

    validator = BiologicalValidator(config, device=device or default_device())
    results = validator.validate_all(
        real_mutations=real_mut, real_expression=real_expr, real_pathways=real_path,
        synth_mutations=_concat(tables["mutations"]),
        synth_expression=_concat(tables["expression"]),
        synth_pathways=_concat(tables["pathways"]),
        pathway_gene_matrix=gene_pathway,
    )
    results_dir = Path(config.output.results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    with open(results_dir / "validation_results.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(results))
        writer.writerow([repr(float(v)) for v in results.values()])
    logger.info("Validation results saved to %s", results_dir / "validation_results.csv")
    return results


STEP_FUNCTIONS = {
    "generate": generate_synthetic_patients,
    "validate": validate_synthetic_patients,
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Osteosarcoma synthetic-patient pipeline (PyTorch port: generate, validate)")
    parser.add_argument("--config", default="config/config.yaml", help="YAML configuration")
    parser.add_argument("--steps", nargs="+", default=list(STEPS), choices=STEPS)
    parser.add_argument("--device", default=None, help="cuda or cpu (default: cuda if present)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    config = Config.from_yaml(args.config)
    for step in args.steps:
        STEP_FUNCTIONS[step](config, device=args.device)


if __name__ == "__main__":
    main()
