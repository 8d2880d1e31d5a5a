"""Typed configuration: the part of the JAX package's schema that the
pipeline's steps read.

Counterpart of osteosarcoma_diffusionmodel_tpu/config.py, under the same
field names and defaults, so a ``metadata.json`` written by either
package and ``config/*.yaml`` load into it: keys this schema does not
hold (fused-kernel scheduling knobs, ...) are ignored on load. The field
comments there explain each knob. ``model.gnn`` holds the GAT encoder's
type, layers and heads (:mod:`models.gnn`, which no architecture wires
in) beside the denoiser's dropout. ``num_devices`` above the devices
visible trains on one device with a warning, as the JAX trainer does;
with that many ranks in the process group, the trainer and the CLI's
generate build a (data, model) mesh (:mod:`parallel`).

YAML is read by :meth:`Config.from_yaml`, which imports ``yaml`` only
when called.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

CONDITION_COLUMN_MAP = {
    "survival_time": "survival_days_norm",
    "event_occurred": "event_occurred",
    "age": "age_years",
    "metastasis_at_diagnosis": "metastasis_at_diagnosis",
}


@dataclass
class DownloadConfig:
    mutations: bool = True
    rna_seq: bool = True
    clinical: bool = True
    copy_number: bool = False


@dataclass
class DataConfig:
    gdc_project: str = "TARGET-OS"
    data_dir: str = "./data"
    raw_dir: str = "./data/raw"
    processed_dir: str = "./data/processed"
    download: DownloadConfig = field(default_factory=DownloadConfig)
    min_samples_per_gene: int = 3
    min_var_expression: float = 0.1
    pathway_database: str = "msigdb_hallmark"


@dataclass
class GNNConfig:
    # ``dropout`` is also the denoiser blocks' dropout rate; the rest sizes
    # the optional PathwayGraphEncoder (models/gnn.py).
    type: str = "GAT"
    num_layers: int = 3
    heads: int = 4
    dropout: float = 0.2


@dataclass
class DiffusionConfig:
    num_steps: int = 1000
    beta_schedule: str = "cosine"
    loss_type: str = "l2"  # l1 | l2 | huber
    parameterization: str = "x0"  # x0 | epsilon | v
    # Learned per-feature residual sigma of x0 (a second output head).
    learn_sigma: bool = False
    sigma_loss_weight: float = 1.0
    # Latent-factor conditioning: k factors of an x0 encoder appended to
    # the conditions; generation draws them from a fitted Gaussian prior.
    latent_factor_dim: int = 0
    latent_encoder_input: str = "full"  # full | mutations
    # Low-rank correlated residual sigma s(t)^2 (diag(d) + U U^T).
    low_rank_sigma_dim: int = 0
    low_rank_sigma_weight: float = 1.0
    low_rank_sigma_scope: str = "full"  # full | mutations
    clip_denoised: bool = True
    denoised_clip_value: float = 30.0
    block_loss_weighting: str = "none"  # balanced | none
    discrete_mutation_head: bool = False
    discrete_ce_weight: float = 1.0
    # Autoregressive (FVSBN) mutation head, trained by teacher-forced CE
    # under its own constant-rate Adam (ar_lr), drawn bit by bit at
    # generation.
    ar_mutation_head: bool = False
    ar_ce_weight: float = 1.0
    ar_context: str = "pathways"  # pathways | continuous | none
    ar_context_hidden: int = 64
    ar_l2: float = 1e-5
    ar_lr: float = 1e-2
    ar_ctx_l2: float = 1e-2


@dataclass
class ConstraintConfig:
    pathway_coherence_weight: float = 1.0
    mutation_expression_weight: float = 0.5
    survival_prediction_weight: float = 0.3  # read by the cVAE only
    gene_network_weight: float = 0.2  # weighs the mutual-exclusivity term
    cooccurrence_weight: float = 0.0
    enabled: bool = True


@dataclass
class ModelConfig:
    architecture: str = "diffusion"
    latent_dim: int = 128
    hidden_dims: List[int] = field(default_factory=lambda: [256, 512, 256])
    gnn: GNNConfig = field(default_factory=GNNConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    condition_on: List[str] = field(
        default_factory=lambda: [
            "survival_time",
            "event_occurred",
            "metastasis_at_diagnosis",
        ]
    )
    constraints: ConstraintConfig = field(default_factory=ConstraintConfig)
    compute_dtype: str = "bfloat16"
    # Classifier-free guidance: the share of training rows whose
    # condition vector is zeroed; > 0 makes generation honor
    # generation.guidance_scale.
    cfg_dropout_prob: float = 0.0
    denoiser_input_skip: bool = True


@dataclass
class AugmentationConfig:
    mixup_alpha: float = 0.2
    pathway_noise: float = 0.05
    # Pretrain on these cohorts (processed directories, or GDC project ids
    # under data_dir/pretrain/<project>/) before the main training.
    cross_cancer_pretrain: bool = False
    pretrain_datasets: List[str] = field(default_factory=list)


@dataclass
class SamplePathFinetuneConfig:
    # Fine-tune the best model through a short differentiable DDIM chain
    # (training/finetune.py) after the main training.
    enabled: bool = False
    steps: int = 300
    ddim_steps: int = 8
    sample_batch: int = 256
    learning_rate: float = 1e-5
    soft_tau: float = 0.1
    cooccurrence_weight: float = 5.0
    anchor_weight: float = 1.0


@dataclass
class TrainingConfig:
    batch_size: int = 16
    num_epochs: int = 2000
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    patience: int = 100
    min_delta: float = 1e-4
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    val_split: float = 0.2
    random_seed: int = 42
    save_dir: str = "./results/checkpoints"
    save_frequency: int = 10
    pretrain_epochs: int = 200
    lr_plateau_factor: float = 0.5
    lr_plateau_patience: int = 10
    grad_clip_norm: float = 1.0
    # More devices than are visible: one device with a warning; as many
    # cards as are visible: refused (check_supported).
    num_devices: Optional[int] = None
    # Epochs a block: host work (checkpoints, the early-stopping break)
    # waits for the block's end, as in the JAX trainer's block loop.
    epochs_per_dispatch: int = 1
    sample_path_finetune: SamplePathFinetuneConfig = field(
        default_factory=SamplePathFinetuneConfig
    )


@dataclass
class CorrelationRule:
    mutation: str
    pathway: str
    direction: str  # positive | negative


@dataclass
class EvaluationConfig:
    ks_mode: str = "auto"
    check_mutation_cooccurrence: bool = True
    check_pathway_coherence: bool = True
    check_driver_mutations: bool = True
    check_novelty: bool = True
    ks_size_matched_resamples: int = 5
    driver_genes: List[str] = field(
        default_factory=lambda: ["TP53", "RB1", "ATRX", "DLG2", "PTEN"]
    )
    mutually_exclusive_pairs: List[List[str]] = field(
        default_factory=lambda: [["TP53", "MDM2"]]
    )
    required_correlations: List[CorrelationRule] = field(
        default_factory=lambda: [
            CorrelationRule("TP53", "HALLMARK_P53_PATHWAY", "negative"),
            CorrelationRule("MYC", "HALLMARK_MYC_TARGETS_V1", "positive"),
        ]
    )


@dataclass
class Scenario:
    name: str
    conditions: Dict[str, float]


@dataclass
class GenerationConfig:
    num_synthetic_samples: int = 1000
    guidance_scale: float = 7.5
    sampling_steps: int = 50
    sampler: str = "ddpm"  # ddpm | ddim
    condition_normalization: str = "train_stats"  # train_stats | fixed
    batch_scenarios: bool = False
    noise_type: str = "uniform"  # uniform | normal (the scan sampler's step noise)
    calibrate_marginals: Any = "copula_joint"
    calibration_backend: str = "auto"
    fused_quantize: str = "none"  # none | out | io | all
    # The scan sampler's carry; the kernel sampler's carry is bf16 always.
    sample_dtype: str = "bfloat16"
    scenarios: List[Scenario] = field(
        default_factory=lambda: [
            Scenario(
                "early_stage_good_prognosis",
                {"survival_time": 2000, "event_occurred": 0, "metastasis_at_diagnosis": 0},
            ),
            Scenario(
                "metastatic_poor_prognosis",
                {"survival_time": 300, "event_occurred": 1, "metastasis_at_diagnosis": 1},
            ),
            Scenario(
                "typical_patient",
                {"survival_time": 800, "event_occurred": 0, "metastasis_at_diagnosis": 0},
            ),
        ]
    )


@dataclass
class OutputConfig:
    results_dir: str = "./results"
    figures_dir: str = "./results/figures"
    models_dir: str = "./results/models"
    synthetic_data_dir: str = "./results/synthetic"
    export_formats: List[str] = field(default_factory=lambda: ["csv"])


@dataclass
class FrozenDims:
    """Data dims frozen at training time (persisted in metadata.json)."""

    mutation_dim: int
    expression_dim: int
    pathway_dim: int
    condition_dim: int
    condition_names: List[str] = field(default_factory=list)
    survival_mean: float = 800.0
    survival_std: float = 500.0

    @property
    def data_dim(self) -> int:
        return self.mutation_dim + self.expression_dim + self.pathway_dim


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    output: OutputConfig = field(default_factory=OutputConfig)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        return cls(
            data=_build(DataConfig, raw.get("data", {}), {"download": DownloadConfig}),
            model=_build(ModelConfig, raw.get("model", {}), {
                "gnn": GNNConfig, "diffusion": DiffusionConfig, "constraints": ConstraintConfig}),
            training=_build(TrainingConfig, raw.get("training", {}), {
                "augmentation": AugmentationConfig,
                "sample_path_finetune": SamplePathFinetuneConfig}),
            evaluation=_build_evaluation(raw.get("evaluation", {})),
            generation=_build_generation(raw.get("generation", {})),
            output=_build(OutputConfig, raw.get("output", {}), {}),
        )

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def freeze_dims(
        self,
        mutation_dim: int,
        expression_dim: int,
        pathway_dim: int,
        condition_names: List[str],
        survival_mean: float = 800.0,
        survival_std: float = 500.0,
    ) -> FrozenDims:
        return FrozenDims(
            mutation_dim=mutation_dim,
            expression_dim=expression_dim,
            pathway_dim=pathway_dim,
            condition_dim=len(condition_names),
            condition_names=list(condition_names),
            survival_mean=float(survival_mean),
            survival_std=float(survival_std),
        )

    def resolve_condition_columns(self, available_columns: List[str]) -> List[str]:
        """Map ``condition_on`` names onto available clinical columns."""
        resolved = []
        for name in self.model.condition_on:
            col = CONDITION_COLUMN_MAP.get(name, name)
            if col in available_columns:
                resolved.append(col)
        return resolved


def _build(cls, raw: Dict[str, Any], nested: Dict[str, type]):
    """Construct dataclass ``cls`` from a dict, ignoring unknown keys."""
    if not isinstance(raw, dict):
        raw = {}
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in raw.items():
        if key not in known:
            continue
        if key in nested and isinstance(value, dict):
            kwargs[key] = _build(nested[key], value, {})
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _build_evaluation(raw: Dict[str, Any]) -> EvaluationConfig:
    cfg = _build(EvaluationConfig, raw, {})
    rules = raw.get("required_correlations")
    if rules is not None:
        cfg.required_correlations = [
            CorrelationRule(r["mutation"], r["pathway"], r["direction"]) for r in rules
        ]
    return cfg


def _build_generation(raw: Dict[str, Any]) -> GenerationConfig:
    cfg = _build(GenerationConfig, raw, {})
    scenarios = raw.get("scenarios")
    if scenarios is not None:
        cfg.scenarios = [
            Scenario(s["name"], dict(s["conditions"])) for s in scenarios
        ]
    return cfg
