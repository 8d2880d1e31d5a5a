"""Synthetic patient generation: scenarios -> conditions -> cohorts.

Counterpart of osteosarcoma_diffusionmodel_tpu/generation/generator.py
for the diffusion model: scenario conditions (:90-134), sampling
(:189-331), calibration against the training cohort (:333-704, host
numpy path), the per-scenario and batched loops (:705-768), the
modality split and the CSV export (:771-820), and checkpoint loading.

Sampling always runs the kernel sampler (``ops/fused_sampler.py``): DDPM
over all T steps, or eta = 0 DDIM over ``generation.sampling_steps``. The
JAX package's 4096/8192-row thresholds choose between two TPU programs;
here there is one sampler at every batch size. Calibration runs the
float64 numpy path of ``ops/copula.py`` (``calibration_backend`` "auto"
and "numpy"; "device" is not ported yet). Random streams come from
explicit ``torch.Generator``s seeded from ``training.random_seed``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, FrozenDims, Scenario
from ..models.diffusion import ConditionalDiffusion
from ..ops.copula import (
    correlation_transplant,
    fit_binary_copula,
    fit_continuous_copula_chol,
    fit_joint_copula,
    gaussian_transplant,
    joint_transplant,
)
from ..ops.fused_sampler import FusedSampler
from ..training.checkpoint import load_metadata, load_weights, metadata_to_dims
from ..utils.io import write_matrix_csv

logger = logging.getLogger(__name__)


def seeded_generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of integers (independent
    streams for (seed, scenario) pairs)."""
    state = np.random.SeedSequence(list(entropy)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class SyntheticPatientGenerator:
    """Generate synthetic patient cohorts from a trained model on ``device``."""

    def __init__(self, model: ConditionalDiffusion, config: Config, dims: FrozenDims,
                 data_stats: Optional[Dict[str, np.ndarray]] = None, device="cpu"):
        self.model = model
        self.config = config
        self.dims = dims
        self.data_stats = data_stats
        self.device = torch.device(device)
        model.denoiser.to(self.device)
        self._samplers: Dict[Optional[int], FusedSampler] = {}
        self._copula = None
        self._cont_chol = None
        self._joint = None
        backend = config.generation.calibration_backend
        if backend == "device":
            raise NotImplementedError(
                "calibration_backend 'device' (ops/copula_device.py) is not ported yet")
        if backend == "auto":
            logger.info("calibration_backend 'auto': the PyTorch port calibrates "
                        "on the host (float64 numpy, ops/copula.py)")

    # ------------------------------------------------------------------
    def create_conditions(self, num_samples: int, scenario: Optional[Dict] = None,
                          generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Encode a scenario dict into a (num_samples, C) float32 batch."""
        cdim = self.dims.condition_dim
        if scenario is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            return torch.randn((num_samples, cdim), generator=generator).numpy()
        if self.config.generation.condition_normalization == "fixed":
            s_mean, s_std = 800.0, 500.0
        else:
            s_mean, s_std = self.dims.survival_mean, self.dims.survival_std
        defaults = {"event_occurred": 0, "age": 15.0, "metastasis_at_diagnosis": 0}
        values: List[float] = []
        for name in self.config.model.condition_on:
            if name == "survival_time":
                values.append((scenario.get("survival_time", 800) - s_mean) / s_std)
            else:
                values.append(float(scenario.get(name, defaults.get(name, 0.0))))
        if len(values) != cdim:
            logger.warning("Condition mismatch: expected %d, got %d — padding/truncating",
                           cdim, len(values))
            values = (values + [0.0] * cdim)[:cdim]
        return np.tile(np.asarray(values, np.float32), (num_samples, 1))

    # ------------------------------------------------------------------
    def sampler(self) -> FusedSampler:
        gen = self.config.generation
        steps = gen.sampling_steps if gen.sampler == "ddim" else None
        if steps not in self._samplers:
            self._samplers[steps] = FusedSampler(self.model, self.device, ddim_steps=steps)
        return self._samplers[steps]

    def sample_raw(self, conditions: np.ndarray, generator: torch.Generator) -> np.ndarray:
        out = self.sampler().sample(torch.from_numpy(conditions), generator)
        return out.cpu().numpy()

    def generate(self, num_samples: int, scenario: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
        """Generate one cohort and split it into modality blocks."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.training.random_seed)
        logger.info("Generating %d synthetic patients...", num_samples)
        conditions = self.create_conditions(num_samples, scenario, generator)
        samples = self.sample_raw(conditions, generator)
        return self._postprocess(samples, conditions)

    def _postprocess(self, samples: np.ndarray, conditions: np.ndarray) -> Dict[str, np.ndarray]:
        """Calibrate (per config) and split a raw sample matrix."""
        samples = np.asarray(samples, np.float32)
        m, e = self.dims.mutation_dim, self.dims.expression_dim
        mode = self.config.generation.calibrate_marginals
        if mode is True:
            mode = "copula_joint"
        if bool(mode) and self.data_stats is not None and samples.shape[0] > 1:
            mutations, continuous = self._calibrate(samples, m, str(mode))
        else:
            mutations = (samples[:, :m] > 0.5).astype(np.float32)
            continuous = samples[:, m:]
        return {
            "mutations": mutations,
            "expression": continuous[:, :e],
            "pathways": continuous[:, e:],
            "conditions": np.asarray(conditions),
        }

    def _calibrate(self, samples: np.ndarray, m: int, mode: str):
        """Marginal (and joint, for the copula modes) calibration against
        the training cohort; see the JAX `_calibrate` for each mode."""
        stats = self.data_stats
        raw_mut = samples[:, :m]
        if (mode == "copula_joint" and "mutation_matrix" in stats and "data_matrix" in stats
                and samples.shape[0] > 2 and m > 1):
            if self._joint is None:
                real = np.asarray(stats["data_matrix"])
                self._joint = fit_joint_copula(real[:, :m], real[:, m:])
                logger.info("Joint copula fitted (shrink=%.3g)", self._joint[3])
            freq, chol, tetra, _ = self._joint
            mutations, cont = joint_transplant(
                samples, chol, freq, m, tetra=tetra,
                tie_rng=np.random.default_rng(self._tie_seed()),
            )
            return mutations, self._quantile_map_continuous(cont, m)
        if (mode in ("copula", "copula_full", "copula_joint") and "mutation_matrix" in stats
                and raw_mut.shape[0] > 2 and m > 1):
            if self._copula is None:
                self._copula = fit_binary_copula(np.asarray(stats["mutation_matrix"]))
            freq, corr = self._copula
            mutations = correlation_transplant(
                raw_mut, corr, freq, rng=np.random.default_rng(self._tie_seed()))
        else:
            freq = np.clip(np.asarray(stats["mutation_freq"], np.float64), 0.0, 1.0)
            thresholds = np.quantile(raw_mut, 1.0 - freq, axis=0).diagonal()
            mutations = (raw_mut > thresholds[None, :]).astype(np.float32)

        cont = samples[:, m:]
        if (mode in ("copula_full", "copula_joint") and "data_matrix" in stats
                and cont.shape[0] > 2 and cont.shape[1] > 1):
            if self._cont_chol is None:
                self._cont_chol = fit_continuous_copula_chol(np.asarray(stats["data_matrix"])[:, m:])
            cont = gaussian_transplant(
                cont, self._cont_chol, tie_rng=np.random.default_rng(self._tie_seed()))
        return np.asarray(mutations), self._quantile_map_continuous(np.asarray(cont), m, mode)

    def _tie_seed(self) -> int:
        """Seed for random rank tie-breaking (same as the JAX package)."""
        return int(self.config.training.random_seed) + 104729

    def _quantile_map_continuous(self, cont: np.ndarray, m: int,
                                 mode: str = "copula_joint") -> np.ndarray:
        """Within-cohort ranks onto the real per-feature quantile grid, or
        moment matching when the sorted grid is unavailable."""
        stats = self.data_stats
        if mode in ("quantile", "copula", "copula_full", "copula_joint") and "feature_sorted" in stats:
            sorted_real = np.asarray(stats["feature_sorted"], np.float32)[:, m:]
            n_real = sorted_real.shape[0]
            order = np.argsort(cont, axis=0)
            ranks = np.empty_like(order)
            np.put_along_axis(ranks, order, np.arange(cont.shape[0])[:, None], axis=0)
            pos = (ranks + 0.5) / cont.shape[0] * (n_real - 1)
            lo = np.floor(pos).astype(np.int64)
            hi = np.minimum(lo + 1, n_real - 1)
            frac = (pos - lo).astype(np.float32)
            continuous = (np.take_along_axis(sorted_real, lo, axis=0) * (1.0 - frac)
                          + np.take_along_axis(sorted_real, hi, axis=0) * frac)
        else:
            real_mean = np.asarray(stats["feature_mean"], np.float32)[m:]
            real_std = np.asarray(stats["feature_std"], np.float32)[m:]
            synth_mean = cont.mean(axis=0)
            synth_std = cont.std(axis=0)
            scale = np.where(synth_std > 1e-6, real_std / np.maximum(synth_std, 1e-6), 1.0)
            continuous = (cont - synth_mean) * scale + real_mean
        return continuous.astype(np.float32)

    # ------------------------------------------------------------------
    def generate_scenarios(self, scenarios: List[Scenario], samples_per_scenario: int,
                           seed: Optional[int] = None) -> Dict[str, Dict[str, np.ndarray]]:
        if seed is None:
            seed = self.config.training.random_seed
        if self.config.generation.batch_scenarios and len(scenarios) > 1:
            return self._generate_scenarios_batched(scenarios, samples_per_scenario, seed)
        results = {}
        for i, scenario in enumerate(scenarios):
            logger.info("Scenario: %s", scenario.name)
            results[scenario.name] = self.generate(
                samples_per_scenario, scenario.conditions, seeded_generator(seed, i))
        return results

    def _generate_scenarios_batched(self, scenarios: List[Scenario], samples_per_scenario: int,
                                    seed: int) -> Dict[str, Dict[str, np.ndarray]]:
        """All scenarios in one sampler call; calibration on the combined
        cohort, then split back per scenario."""
        conds = np.concatenate([
            self.create_conditions(samples_per_scenario, s.conditions, seeded_generator(seed, i))
            for i, s in enumerate(scenarios)
        ])
        logger.info("Generating %d synthetic patients (%d scenarios in one batch)...",
                    conds.shape[0], len(scenarios))
        samples = self.sample_raw(conds, seeded_generator(seed, 10_000))
        combined = self._postprocess(samples, conds)
        results = {}
        for i, scenario in enumerate(scenarios):
            sl = slice(i * samples_per_scenario, (i + 1) * samples_per_scenario)
            results[scenario.name] = {k: v[sl] for k, v in combined.items()}
        return results

    # ------------------------------------------------------------------
    def save_synthetic_data(self, synthetic: Dict[str, np.ndarray], output_dir: str | Path,
                            gene_names: Dict[str, List[str]], prefix: str = "synthetic") -> None:
        """Per-modality CSV tables ``<prefix>_<modality>.csv``."""
        formats = [f.lower() for f in self.config.output.export_formats] or ["csv"]
        if set(formats) - {"csv"}:
            raise NotImplementedError(
                f"export formats {sorted(set(formats) - {'csv'})}: the port writes CSV only")
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        tables = {}
        for key, names in (("mutations", "mutation_genes"), ("expression", "expression_genes"),
                           ("pathways", "pathway_names")):
            if names in gene_names:
                tables[key] = gene_names[names]
        tables["conditions"] = self.dims.condition_names or self.config.model.condition_on
        for name, columns in tables.items():
            path = output_dir / f"{prefix}_{name}.csv"
            write_matrix_csv(path, synthetic[name], columns)
            logger.info("Saved %s", path.name)


def load_trained_model(checkpoint_dir: str | Path, config: Optional[Config] = None):
    """Rebuild the model from ``metadata.json`` and load ``best_model.npz``.
    The model section of the config comes from the checkpoint; the other
    sections from ``config`` when given. Returns (model, config, dims)."""
    checkpoint_dir = Path(checkpoint_dir)
    meta = load_metadata(checkpoint_dir)
    if meta is None:
        raise FileNotFoundError(f"No metadata.json in {checkpoint_dir}; cannot self-configure")
    dims = metadata_to_dims(meta)
    meta_config = Config.from_dict(meta["config"])
    if config is None:
        config = meta_config
    else:
        config.model = meta_config.model
    model = ConditionalDiffusion.from_config(config, dims)
    model.denoiser.load_state_dict(load_weights(checkpoint_dir))
    model.denoiser.eval()
    logger.info("Loaded checkpoint %s", checkpoint_dir)
    return model, config, dims
