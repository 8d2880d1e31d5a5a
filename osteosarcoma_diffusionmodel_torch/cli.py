"""Pipeline CLI of the PyTorch port: the train, generate and validate steps.

    python -m osteosarcoma_diffusionmodel_torch.cli --config config/config.yaml \
        --steps train generate validate [--resume] [--device cpu]

Counterpart of osteosarcoma_diffusionmodel_tpu/cli.py (:150-398). It
reads a processed directory in the JAX layout (``data.processed_dir``)
and writes the port's checkpoint directory (``training.save_dir``:
weights ``best_model.npz``, ``metadata.json``, ``data_stats.npz`` and the
periodic ``checkpoint_epoch_<n>/``), ``<results_dir>/training_history.csv``,
and the JAX CLI's files: ``<synthetic_data_dir>/<scenario>/<scenario>_
{mutations,expression,pathways,conditions}.csv`` and
``<results_dir>/validation_results.csv``. ``--steps all`` is ``train
generate validate``. The model section of the config always comes from
the checkpoint's metadata: the train step does not write the JAX CLI's
``config/config_updated.yaml``. The three architectures of
``model.architecture`` (diffusion, cvae, flow) and every variant of the
diffusion model train, generate and validate (the AR and latent-factor
heads, CFG, the parameterizations, learned and low-rank sigma);
sample-path fine-tuning is not ported and is rejected before training,
except where the JAX CLI skips it with a warning (the cVAE, the flow, the
D3PM, latent-factor and AR heads). The download, preprocess, pathways,
report and doctor steps are not ported yet. The steps run on the CUDA
card; the CPU runs them only when asked (``--device cpu``): without a
card and without that flag the CLI raises before it reads or writes
anything.
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
from .data.dataset import OsteosarcomaArrays, prepare_arrays
from .data.pathways import HALLMARK_GENE_SETS
from .generation.generator import SyntheticPatientGenerator, load_trained_model
from .models.constraints import ConstraintSpec
from .models.diffusion import finetune_skip_reason
from .training.checkpoint import load_data_stats
from .training.trainer import TrainLog, Trainer, build_model
from .utils.io import Matrix, read_matrix_csv, write_matrix_csv
from .validation.validator import BiologicalValidator

logger = logging.getLogger(__name__)

STEPS = ("train", "generate", "validate")


def default_device() -> str:
    """The card. Raises when none is present: the CPU runs the port only
    when the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu (device='cpu') "
                           "to run the PyTorch port on the CPU")
    return "cuda"


def build_constraint_spec(config: Config, arrays: OsteosarcomaArrays) -> ConstraintSpec:
    """The constraint losses' index structures for this cohort (JAX
    ``cli.py:136``): Hallmark gene sets, the configured exclusive pairs
    and directional rules, the cohort's mutation correlation."""
    return ConstraintSpec.build(
        mutation_genes=arrays.mutation_genes,
        expression_genes=arrays.expression_genes,
        pathway_names=arrays.pathway_names,
        gene_sets=dict(HALLMARK_GENE_SETS),
        exclusive_gene_pairs=config.evaluation.mutually_exclusive_pairs,
        correlation_rules=config.evaluation.required_correlations,
        mutation_data=arrays.data[:, : len(arrays.mutation_genes)],
    )


def train_model(config: Config, device: Optional[str] = None, resume: bool = False) -> TrainLog:
    """Train on ``data.processed_dir``, write the checkpoint directory and
    ``<results_dir>/training_history.csv``; returns the history."""
    device = device or default_device()
    logger.info("STEP 4: Training model")
    arrays, dims = prepare_arrays(config)
    logger.info("Model configured with: Mut=%d, Expr=%d, Path=%d, Cond=%d",
                dims.mutation_dim, dims.expression_dim, dims.pathway_dim, dims.condition_dim)
    model = build_model(config, dims, build_constraint_spec(config, arrays))
    history = Trainer(model, arrays, dims, config, device).train(resume=resume)
    skip = finetune_skip_reason(config, dims)
    if config.training.sample_path_finetune.enabled and skip:
        # The JAX CLI skips it there (cli.py:193-225); elsewhere the trainer
        # has already rejected it as unported.
        logger.warning(skip)
    results_dir = Path(config.output.results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    n = len(history.train_loss)
    write_matrix_csv(
        results_dir / "training_history.csv",
        np.column_stack([np.arange(n), history.train_loss, history.val_loss,
                         history.epoch_seconds]),
        ["epoch", "train_loss", "val_loss", "epoch_seconds"], fmt="%r")
    logger.info("Training complete!")
    return history


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
    "train": train_model,
    "generate": generate_synthetic_patients,
    "validate": validate_synthetic_patients,
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Osteosarcoma synthetic-patient pipeline (PyTorch port: train, generate, "
                    "validate)")
    parser.add_argument("--config", default="config/config.yaml", help="YAML configuration")
    parser.add_argument("--steps", nargs="+", default=list(STEPS), choices=STEPS + ("all",),
                        help="steps to run in order; 'all' runs train, generate, validate")
    parser.add_argument("--resume", action="store_true",
                        help="train from the latest checkpoint_epoch_<n>/ of training.save_dir")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device or default_device()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    config = Config.from_yaml(args.config)
    steps = list(STEPS) if "all" in args.steps else args.steps
    for step in steps:
        if step == "train":
            train_model(config, device=device, resume=args.resume)
        else:
            STEP_FUNCTIONS[step](config, device=device)


if __name__ == "__main__":
    main()
