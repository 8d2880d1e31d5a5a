"""Typed configuration: the part of the JAX package's schema that the
generate and validate steps read.

Counterpart of osteosarcoma_diffusionmodel_tpu/config.py, under the same
field names and defaults, so a ``metadata.json`` written by either
package and ``config/*.yaml`` load into it: keys this schema does not
hold (training, download, GNN, fused-kernel scheduling knobs, ...) are
ignored on load. The field comments there explain each knob. A few
fields are kept only so :func:`models.diffusion.check_supported` can
reject the features the port does not implement yet.

YAML is read by :meth:`Config.from_yaml`, which imports ``yaml`` only
when called.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

CONDITION_COLUMN_MAP = {
    "survival_time": "survival_days_norm",
    "event_occurred": "event_occurred",
    "age": "age_years",
    "metastasis_at_diagnosis": "metastasis_at_diagnosis",
}


@dataclass
class DataConfig:
    processed_dir: str = "./data/processed"


@dataclass
class DiffusionConfig:
    num_steps: int = 1000
    beta_schedule: str = "cosine"
    parameterization: str = "x0"
    clip_denoised: bool = True
    denoised_clip_value: float = 30.0
    # Rejected when set (check_supported).
    learn_sigma: bool = False
    latent_factor_dim: int = 0
    low_rank_sigma_dim: int = 0
    discrete_mutation_head: bool = False
    ar_mutation_head: bool = False


@dataclass
class ModelConfig:
    architecture: str = "diffusion"
    latent_dim: int = 128
    hidden_dims: List[int] = field(default_factory=lambda: [256, 512, 256])
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    condition_on: List[str] = field(
        default_factory=lambda: [
            "survival_time",
            "event_occurred",
            "metastasis_at_diagnosis",
        ]
    )
    compute_dtype: str = "bfloat16"
    cfg_dropout_prob: float = 0.0
    denoiser_input_skip: bool = True


@dataclass
class TrainingConfig:
    random_seed: int = 42
    save_dir: str = "./results/checkpoints"


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
    sampling_steps: int = 50
    sampler: str = "ddpm"  # ddpm | ddim
    condition_normalization: str = "train_stats"  # train_stats | fixed
    batch_scenarios: bool = False
    noise_type: str = "uniform"
    calibrate_marginals: Any = "copula_joint"
    calibration_backend: str = "auto"
    # Rejected when set away from the default (check_supported).
    sample_dtype: str = "bfloat16"
    fused_quantize: str = "none"
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
            data=_build(DataConfig, raw.get("data", {}), {}),
            model=_build(ModelConfig, raw.get("model", {}), {"diffusion": DiffusionConfig}),
            training=_build(TrainingConfig, raw.get("training", {}), {}),
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
