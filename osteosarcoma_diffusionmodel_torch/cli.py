"""Pipeline CLI of the PyTorch port: the JAX CLI's steps.

    python -m osteosarcoma_diffusionmodel_torch.cli --config config/config.yaml \
        --steps {download,preprocess,pathways,train,generate,validate,all,report,doctor} \
        [--resume | --resume-training] [--profile] [--device cpu]

    torchrun --nproc-per-node N -m osteosarcoma_diffusionmodel_torch.cli --config ...

Counterpart of osteosarcoma_diffusionmodel_tpu/cli.py, under the same step
names; ``all`` (the default) is the JAX ``ALL_STEPS``:

- ``download``: the TARGET-OS files (and each pretraining cohort that is a
  GDC project id) from the GDC API into ``data.data_dir/raw`` (needs
  network access);
- ``preprocess``: the raw files of ``data.raw_dir`` into the processed
  tables of ``data.processed_dir`` (:mod:`.data.preprocessor`), and the
  raw files of each pretraining project into
  ``data.data_dir/pretrain/<project>/processed``;
- ``pathways``: ``pathway_scores.csv``, ``pathway_mutation_scores.csv``
  and ``gene_pathway_matrix.csv`` in the processed directory;
- ``train``: the checkpoint directory (``training.save_dir``: weights
  ``best_model.npz``, ``metadata.json``, ``data_stats.npz`` and the
  ``checkpoint_epoch_<n>/``) and ``<results_dir>/training_history.csv``;
  cross-cancer pretraining first (STEP 4a, into ``save_dir/pretrain``)
  and sample-path fine-tuning of the best model after (STEP 4b: the
  model before it kept as ``best_model_prefinetune.npz``), where the JAX
  CLI runs them;
- ``generate``: ``<synthetic_data_dir>/<scenario>/<scenario>_
  {mutations,expression,pathways,conditions}.csv``;
- ``validate``: ``<results_dir>/validation_results.csv``.

Two more steps, outside ``all`` as in the JAX CLI:

- ``report``: the notebook's figures in ``output.figures_dir`` (skipped
  without matplotlib) and ``<results_dir>/summary_report.txt`` graded from
  ``validation_results.csv`` (:mod:`.analysis.report`);
- ``doctor``: the consistency of the config, the processed tables, the
  checkpoint's ``metadata.json`` and the scenarios' conditions, one "OK",
  "MISMATCH", "MISSING" or "UNKNOWN CONDITIONS" entry each.

``--profile`` writes a ``torch.profiler`` trace of the main training under
``<results_dir>/profile`` (:func:`.utils.profiling.profile_trace`).

The model section of the config always comes from the checkpoint's
metadata: the train step does not write the JAX CLI's
``config/config_updated.yaml``.

Several devices (JAX ``cli.py:303-316``): under a launcher (torchrun sets
``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) every process
joins the process group (NCCL on the cards, gloo with ``--device cpu``)
and drives one device. With ``training.num_devices`` > 1 and that many
ranks, ``train`` runs the trainer's data parallelism and ``generate``
samples over ``parallel.make_mesh(num_devices)``; rank 0 alone writes the
checkpoint, CSVs and figures. The unsharded steps (download, preprocess,
pathways, validate, report, doctor) run on rank 0 while the other ranks
wait at a barrier. A ``training.num_devices`` above the devices visible
trains and generates on one, as the JAX trainer does. The download,
preprocess, pathways, report and doctor steps run on the host. The others run on the CUDA card; the CPU runs them
only when asked (``--device cpu``): without a card and without that flag
the CLI raises before it reads or writes anything.
"""

from __future__ import annotations

import argparse
import copy
import csv
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import Config
from .data.dataset import OsteosarcomaArrays, load_pretrain_arrays, prepare_arrays
from .data.gdc_loader import GDCDataLoader
from .data.pathways import (
    HALLMARK_GENE_SETS,
    gene_pathway_matrix,
    pathway_scores_from_expression,
    pathway_scores_from_mutations,
)
from .data.preprocessor import OsteosarcomaPreprocessor
from .generation.generator import SyntheticPatientGenerator, load_trained_model
from .models.constraints import ConstraintSpec
from .models.diffusion import finetune_skip_reason, visible_devices
from .parallel.mesh import initialize_distributed, is_writer, make_mesh
from .training import checkpoint as ckpt
from .training.finetune import sample_path_finetune
from .training.trainer import TrainLog, Trainer, build_model
from .utils.io import (
    Matrix,
    header_names,
    read_first_row,
    read_matrix_csv,
    read_typed_columns,
    write_matrix_csv,
)
from .utils.profiling import profile_trace
from .validation.validator import BiologicalValidator

logger = logging.getLogger(__name__)

ALL_STEPS = ("download", "preprocess", "pathways", "train", "generate", "validate")
HOST_STEPS = ("download", "preprocess", "pathways", "report", "doctor")
# Steps the JAX package runs unsharded: rank 0 alone under a launcher.
RANK0_STEPS = HOST_STEPS + ("validate",)


def _barrier() -> None:
    """Wait for every rank of the process group (no-op without one)."""
    if dist.is_initialized():
        dist.barrier()


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


def _pretrain_projects(config: Config) -> list:
    """The ``pretrain_datasets`` entries that are GDC project ids (not
    local directories), which the download and preprocess steps handle."""
    aug = config.training.augmentation
    if not (aug.cross_cancer_pretrain and aug.pretrain_datasets):
        return []
    return [e for e in aug.pretrain_datasets if not Path(e).is_dir()]


def download_data(config: Config) -> Dict[str, Path]:
    """STEP 1: the GDC files of ``data.gdc_project`` and of each pretraining
    project (network access needed)."""
    logger.info("STEP 1: Downloading TARGET-OS data from GDC")
    results = GDCDataLoader(project_id=config.data.gdc_project,
                            data_dir=config.data.data_dir).download_all(
        include_copy_number=config.data.download.copy_number)
    for project in _pretrain_projects(config):
        logger.info("Downloading pretrain cohort %s", project)
        GDCDataLoader(project_id=project,
                      data_dir=Path(config.data.data_dir) / "pretrain" / project).download_all()
    logger.info("Downloaded data to: %s", results)
    return results


def preprocess_data(config: Config) -> dict:
    """STEP 2: the processed tables, of the primary cohort and of each
    pretraining project that has raw files."""
    logger.info("STEP 2: Preprocessing data")
    processed = OsteosarcomaPreprocessor(Path(config.data.raw_dir),
                                         Path(config.data.processed_dir), config).process_all()
    for project in _pretrain_projects(config):
        base = Path(config.data.data_dir) / "pretrain" / project
        if not (base / "raw").exists():
            logger.warning("Pretrain cohort %s has no raw data; skipping", project)
            continue
        logger.info("Preprocessing pretrain cohort %s", project)
        OsteosarcomaPreprocessor(base / "raw", base / "processed", config).process_all()
    logger.info("Processed %d samples", len(processed["mutation_matrix"].index))
    return processed


def compute_pathway_features(config: Config) -> Matrix:
    """STEP 3: pathway scores from the aligned expression and mutation
    tables, and the gene-pathway membership matrix."""
    logger.info("STEP 3: Computing pathway features")
    processed = Path(config.data.processed_dir)
    expr = read_matrix_csv(processed / "expression_matrix_aligned.csv")
    mut = read_matrix_csv(processed / "mutation_matrix_aligned.csv")
    scores, names = pathway_scores_from_expression(expr.values, expr.columns)
    write_matrix_csv(processed / "pathway_scores.csv", scores, names, index=expr.index,
                     index_label=expr.index_name, fmt="%r")
    mut_scores, mut_names = pathway_scores_from_mutations(mut.values, mut.columns)
    write_matrix_csv(processed / "pathway_mutation_scores.csv", mut_scores, mut_names,
                     index=mut.index, index_label=mut.index_name, fmt="%r")
    membership, genes, pathways = gene_pathway_matrix()
    write_matrix_csv(processed / "gene_pathway_matrix.csv", membership, pathways, index=genes,
                     fmt="%d")
    logger.info("Computed %d pathway features", len(names))
    return Matrix(scores, names, expr.index)


def _finetune(config: Config, model, trainer: Trainer) -> Optional[Dict[str, list]]:
    """STEP 4b where the JAX CLI runs it (cli.py:190-262): the best model
    backed up as ``best_model_prefinetune.npz``, fine-tuned on the
    trainer's training rows, saved as ``best_model.npz``. Returns the
    fine-tuning history, or None where it is off or skipped."""
    ftc = config.training.sample_path_finetune
    if not ftc.enabled:
        return None
    skip = finetune_skip_reason(config, trainer.dims)
    if skip:
        logger.warning(skip)
        return None
    logger.info("STEP 4b: Sample-path fine-tuning (differentiable DDIM)")
    state = ckpt.load_weights(trainer.save_dir)
    trainer.module.load_state_dict(state)
    ckpt.save_weights(trainer.save_dir, state, name=f"{ckpt.BEST_NAME}_prefinetune")
    rows = torch.from_numpy(trainer.train_idx).to(trainer.device)
    generator = torch.Generator(device=trainer.device).manual_seed(
        config.training.random_seed + 77)
    history = sample_path_finetune(
        model, trainer._data[rows], trainer._cond[rows], generator,
        steps=ftc.steps, ddim_steps=ftc.ddim_steps, sample_batch=ftc.sample_batch,
        learning_rate=ftc.learning_rate, soft_tau=ftc.soft_tau,
        cooccurrence_weight=ftc.cooccurrence_weight, anchor_weight=ftc.anchor_weight)
    trainer.write_best(trainer.module.state_dict())
    if history["cooccurrence"]:
        logger.info("Fine-tune done: cooccurrence %.4f -> %.4f",
                    history["cooccurrence"][0], history["cooccurrence"][-1])
    return history


def train_model(config: Config, device: Optional[str] = None, resume: bool = False,
                profile: bool = False) -> TrainLog:
    """STEP 4: train on ``data.processed_dir`` (after STEP 4a, pretraining,
    where it is on; STEP 4b, fine-tuning, after), write the checkpoint
    directory and ``<results_dir>/training_history.csv``; returns the
    history, with the pretraining's under ``pretrain`` and the
    fine-tuning's under ``finetune``. ``profile``: the main training (not
    STEP 4a or 4b) under :func:`profile_trace` into
    ``<results_dir>/profile``, as the JAX CLI does."""
    device = device or default_device()
    logger.info("STEP 4: Training model")
    arrays, dims = prepare_arrays(config)
    logger.info("Model configured with: Mut=%d, Expr=%d, Path=%d, Cond=%d",
                dims.mutation_dim, dims.expression_dim, dims.pathway_dim, dims.condition_dim)
    model = build_model(config, dims, build_constraint_spec(config, arrays))
    # The main trainer first: a Trainer initializes the shared module, so
    # the pre-trainer, built after it, hands the main training its final
    # weights (JAX cli.py:161, :179).
    trainer = Trainer(model, arrays, dims, config, device)
    pretrain_arrays = load_pretrain_arrays(config, arrays)
    pretrain = None
    if pretrain_arrays is not None:
        logger.info("STEP 4a: Cross-cancer pretraining (%d samples)", pretrain_arrays.n_samples)
        pre_cfg = copy.deepcopy(config)
        pre_cfg.training.num_epochs = config.training.pretrain_epochs
        pre_cfg.training.patience = config.training.pretrain_epochs
        pre_cfg.training.save_dir = str(Path(config.training.save_dir) / "pretrain")
        pretrain = Trainer(model, pretrain_arrays, dims, pre_cfg, device).train()
    with profile_trace(Path(config.output.results_dir) / "profile",
                       enabled=profile and trainer.writer, device=device):
        history = trainer.train(resume=resume)
    history.pretrain = pretrain
    if trainer.writer:
        history.finetune = _finetune(config, model, trainer)
        results_dir = Path(config.output.results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        n = len(history.train_loss)
        write_matrix_csv(
            results_dir / "training_history.csv",
            np.column_stack([np.arange(n), history.train_loss, history.val_loss,
                             history.epoch_seconds]),
            ["epoch", "train_loss", "val_loss", "epoch_seconds"], fmt="%r")
    _barrier()  # the other ranks read rank 0's checkpoint after this
    logger.info("Training complete!")
    return history


def _header(path: Path) -> list:
    with open(path, newline="") as f:
        return header_names(next(csv.reader(f)))[1:]


def generate_synthetic_patients(config: Config, device: Optional[str] = None):
    logger.info("STEP 5: Generating synthetic patients")
    save_dir = Path(config.training.save_dir)
    device = device or default_device()
    model, config, dims = load_trained_model(save_dir, config)
    mesh = None
    wanted = config.training.num_devices or 1
    if wanted > 1 and visible_devices(device) >= wanted:
        mesh = make_mesh(wanted)
        logger.info("Generation mesh: %s", dict(zip(mesh.mesh_dim_names, mesh.shape)))
    generator = SyntheticPatientGenerator(
        model, config, dims, data_stats=ckpt.load_data_stats(save_dir), device=device, mesh=mesh)
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
    if is_writer():
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


def _clinical_survival(path: Path) -> Optional[tuple]:
    """(survival_days, event_occurred) of the clinical table as float
    arrays, or None where it lacks either column. Raises
    FileNotFoundError where the table is missing."""
    columns = read_typed_columns(path)
    if "survival_days" not in columns or "event_occurred" not in columns:
        return None
    return tuple(np.asarray(columns[name], np.float64)
                 for name in ("survival_days", "event_occurred"))


def analysis_report(config: Config) -> Dict[str, float]:
    """Extra step (JAX ``cli.py:401-460``): the notebook's figures in
    ``output.figures_dir`` and, where ``validation_results.csv`` exists,
    ``<results_dir>/summary_report.txt``; returns that file's first row."""
    logger.info("REPORT: analysis figures + summary")
    from .analysis.report import (
        AnalysisReport,
        common_columns,
        select,
        write_summary_report,
    )

    processed = Path(config.data.processed_dir)
    results_dir = Path(config.output.results_dir)
    real_mut = read_matrix_csv(processed / "mutation_matrix_aligned.csv")
    real_expr = read_matrix_csv(processed / "expression_matrix_aligned.csv")
    real_path = read_matrix_csv(processed / "pathway_scores.csv")
    clinical = _clinical_survival(processed / "clinical_aligned.csv")

    output_dir = Path(config.output.synthetic_data_dir)
    tables = {"mutations": [], "expression": [], "pathways": []}
    scenario_survival = {}
    if clinical is not None:
        scenario_survival["real_cohort"] = clinical
    for scenario in config.generation.scenarios:
        scenario_dir = output_dir / scenario.name
        if not (scenario_dir / f"{scenario.name}_mutations.csv").exists():
            continue
        for key, parts in tables.items():
            parts.append(read_matrix_csv(
                scenario_dir / f"{scenario.name}_{key}.csv", index_col=None))
        n = len(tables["mutations"][-1].values)
        surv = float(scenario.conditions.get("survival_time", 800))
        event = int(scenario.conditions.get("event_occurred", 0))
        scenario_survival[scenario.name] = (np.full(n, surv), np.full(n, event))
    if not tables["mutations"]:
        raise FileNotFoundError("No synthetic scenario data; run generate first")
    synth_mut, synth_expr, synth_path = (_concat(parts) for parts in tables.values())

    report = AnalysisReport(config)
    report.mutation_frequency_scatter(real_mut, synth_mut)
    report.driver_gene_bars(real_mut, synth_mut)
    report.pathway_histograms(real_path, synth_path)
    common_expr = common_columns(real_expr.columns, synth_expr.columns)
    report.embedding_plot(select(real_expr, common_expr), select(synth_expr, common_expr))
    report.km_curves(scenario_survival)

    validation_path = results_dir / "validation_results.csv"
    results: Dict[str, float] = {}
    if validation_path.exists():
        results = read_first_row(validation_path)
        report.validation_bars(results)
        write_summary_report(results, results_dir / "summary_report.txt")
    logger.info("Analysis artifacts in %s", config.output.figures_dir)
    return results


def doctor(config: Config) -> Dict[str, str]:
    """Dimension-consistency checks (JAX ``cli.py:463-521``): the same keys
    and strings."""
    logger.info("DOCTOR: config / data / checkpoint consistency")
    report: Dict[str, str] = {}
    processed = Path(config.data.processed_dir)

    dims_from_data: Optional[Dict[str, int]] = None
    try:
        mut = _header(processed / "mutation_matrix_aligned.csv")
        expr = _header(processed / "expression_matrix_aligned.csv")
        path = _header(processed / "pathway_scores.csv")
        with open(processed / "clinical_aligned.csv", newline="") as f:
            clin = header_names(next(csv.reader(f)))
        dims_from_data = {"mutation": len(mut), "expression": len(expr), "pathway": len(path)}
        report["data"] = f"OK {dims_from_data}"
        cond_cols = config.resolve_condition_columns(clin + ["survival_days_norm"])
        report["conditions"] = (
            f"OK {cond_cols}" if len(cond_cols) == len(config.model.condition_on)
            else f"MISMATCH config={config.model.condition_on} data={cond_cols}"
        )
    except FileNotFoundError as e:
        report["data"] = f"MISSING {e}"

    meta = ckpt.load_metadata(Path(config.training.save_dir))
    if meta is None:
        report["checkpoint"] = "MISSING (no metadata.json)"
    else:
        ck = meta["dims"]
        report["checkpoint"] = (
            f"OK mut={ck['mutation_dim']} expr={ck['expression_dim']} "
            f"path={ck['pathway_dim']} cond={len(ck['condition_names'])}"
        )
        if dims_from_data is not None:
            consistent = (
                ck["mutation_dim"] == dims_from_data["mutation"]
                and ck["expression_dim"] == dims_from_data["expression"]
                and ck["pathway_dim"] == dims_from_data["pathway"]
            )
            report["checkpoint_vs_data"] = "OK" if consistent else "MISMATCH"

    for scenario in config.generation.scenarios:
        unknown = [k for k in scenario.conditions if k not in config.model.condition_on]
        if unknown:
            report[f"scenario:{scenario.name}"] = f"UNKNOWN CONDITIONS {unknown}"

    for key, value in report.items():
        logger.info("%-22s %s", key, value)
    return report


STEP_FUNCTIONS = {
    "download": download_data,
    "preprocess": preprocess_data,
    "pathways": compute_pathway_features,
    "train": train_model,
    "generate": generate_synthetic_patients,
    "validate": validate_synthetic_patients,
    "report": analysis_report,
    "doctor": doctor,
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Osteosarcoma synthetic-patient pipeline (PyTorch port)")
    parser.add_argument("--config", default="config/config.yaml", help="YAML configuration")
    parser.add_argument("--steps", nargs="+", default=["all"],
                        choices=ALL_STEPS + ("all", "report", "doctor"),
                        help="steps to run in order; 'all' runs " + ", ".join(ALL_STEPS))
    parser.add_argument("--resume", "--resume-training", dest="resume", action="store_true",
                        help="train from the latest checkpoint_epoch_<n>/ of training.save_dir")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of training to <results_dir>/profile")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    steps = list(ALL_STEPS) if "all" in args.steps else args.steps
    device = None
    if any(step not in HOST_STEPS for step in steps):
        device = args.device or default_device()
    on_card = device is not None and torch.device(device).type == "cuda"
    initialize_distributed(backend="nccl" if on_card else "gloo")
    logging.basicConfig(level=logging.INFO if is_writer() else logging.WARNING,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    config = Config.from_yaml(args.config)
    for step in steps:
        if step in RANK0_STEPS:
            if is_writer():
                if step in HOST_STEPS:
                    STEP_FUNCTIONS[step](config)
                else:
                    STEP_FUNCTIONS[step](config, device=device)
            _barrier()
        elif step == "train":
            train_model(config, device=device, resume=args.resume, profile=args.profile)
        else:
            STEP_FUNCTIONS[step](config, device=device)


if __name__ == "__main__":
    main()
