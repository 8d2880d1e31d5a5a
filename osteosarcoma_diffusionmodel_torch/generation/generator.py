"""Synthetic patient generation: scenarios -> conditions -> cohorts.

Counterpart of osteosarcoma_diffusionmodel_tpu/generation/generator.py
for the three model families: scenario conditions (:90-134), sampling
(:189-331), calibration against the training cohort (:333-704), the
per-scenario and batched loops (:705-768), the modality split and the
export in each configured format (:771-823), and checkpoint loading
(:825-874, through :func:`~..training.trainer.build_model`).

The cVAE and the flow sample in one pass on the generator's device, before
anything of the diffusion model is read (JAX :217-233): the cVAE decodes
z ~ N(0, I) (route "cvae"), the flow inverts it (route "plain"); no
sampler kernel runs. Their cohorts are calibrated as the diffusion
model's are. The rest of this note is the diffusion model's.

Sampling (:235-298) takes the kernel sampler (``ops/fused_sampler.py``)
for every model that :func:`~..ops.fused_sampler.supports_fused` accepts
at guidance 1, with guidance ``generation.guidance_scale`` where the model
was trained with condition dropout (``cfg_dropout_prob`` > 0) and 1
otherwise: DDPM over all T steps, or eta = 0 DDIM over
``generation.sampling_steps``, with the int8 products of
``generation.fused_quantize``, and a bf16 carry whatever ``sample_dtype``
says. Every other model (v/epsilon, learned or low-rank sigma, no clip, no
input skip, normal noise, CFG at guidance != 1) takes the scan sampler
(``ConditionalDiffusion.scan_sample``/``scan_sample_ddim``) on the same
device, as the JAX package takes its ``lax.scan`` sampler where it has no
Pallas kernel. Any ``generation.sampler`` other than "ddim" is DDPM, as in
the JAX generator (:242, :266). The JAX package's 4096/8192-row
thresholds and ``generation.fused_sampler`` are crossovers measured on a
TPU; the port decides by configuration alone. ``SAMPLERS`` counts cohorts
by route.

A latent-factor model's conditions are widened with draws from a
Gaussian prior fitted once on the training cohort's encoded latents
(:165-210). With the D3PM mutation head the model's bits are kept as they
come out of the sampler; with the AR head the mutation block is drawn by
``ConditionalDiffusion.ar_sample`` after calibration, conditioned on the
calibrated continuous block (:376-437), from a generator seeded apart from
the sampler's. Calibration then reshapes the continuous block only (the
JAX `_calibrate`, :481-489, :523-532, :557-586). Calibration takes the JAX
package's decision (``_device_calibration_enabled``, JAX :595-632):
``ops/copula_device.py`` on the sampler's device ("auto" on the card at
256 rows or more, "device" always, up to ``DeviceCalibrator.MAX_ROWS``),
with the raw cohort kept on the card until it is calibrated; otherwise
the float64 numpy path of ``ops/copula.py``. A device calibration that
fails raises; it never falls back to the host. Random streams come from
explicit ``torch.Generator``s seeded from ``training.random_seed``.

Under a ``mesh`` (``parallel.make_mesh``, one process per device; JAX
:211-213, :241-297), each rank of the data axis samples its block of the
cohort's rows and the blocks are all-gathered: the kernel route through
``FusedSampler.sample_sharded``, the scan samplers, the cVAE and the flow
with every draw made for the whole cohort and the rank's rows kept. The
route is decided as without a mesh. Calibration then runs on the host
(JAX :605-611), on rank 0 of the data axis, which sends the finished
cohort to the other ranks.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, FrozenDims, Scenario
from ..models.cvae import BiologyConstrainedVAE
from ..models.diffusion import ConditionalDiffusion
from ..ops.copula import (
    correlation_transplant,
    fit_binary_copula,
    fit_continuous_copula_chol,
    fit_joint_copula,
    gaussian_transplant,
    joint_transplant,
)
from ..ops.copula_device import DeviceCalibrator
from ..ops.fused_sampler import FusedSampler, supports_fused
from ..parallel.batch import RowBlock, gather_rows
from ..parallel.mesh import DATA_AXIS, axis_group, axis_rank, axis_size, is_writer
from ..training.checkpoint import load_metadata, load_weights, metadata_to_dims
from ..training.trainer import build_model
from ..utils.io import write_matrix_csv

logger = logging.getLogger(__name__)

# Calibrations by backend ("device", "host") since the last reset: which
# path each cohort took, for callers that drive the generator through the
# CLI (chip_smoke.py reads it as it reads the kernels' launch counts).
CALIBRATIONS: Counter = Counter()
# Cohorts by sampler route since the last reset: "kernel", "scan" (the
# diffusion model), "cvae", "plain" (the flow).
SAMPLERS: Counter = Counter()


def seeded_generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of integers (independent
    streams for (seed, scenario) pairs)."""
    state = np.random.SeedSequence(list(entropy)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class SyntheticPatientGenerator:
    """Generate synthetic patient cohorts from a trained model on ``device``
    (the card unless the caller passes the CPU)."""

    def __init__(self, model, config: Config, dims: FrozenDims,
                 data_stats: Optional[Dict[str, np.ndarray]] = None, device="cuda", mesh=None):
        """``model``: a ConditionalDiffusion, BiologyConstrainedVAE or
        ConditionalFlow; ``mesh``: a ``DeviceMesh`` whose data axis splits
        each cohort (every rank of it calls the generator alike)."""
        self.model = model
        self.mesh = mesh
        self.config = config
        self.dims = dims
        self.data_stats = data_stats
        self.device = torch.device(device)
        self.is_diffusion = isinstance(model, ConditionalDiffusion)
        model.module.to(self.device)
        self._samplers: Dict[tuple, FusedSampler] = {}
        self._copula = None
        self._cont_chol = None
        self._joint = None
        self._device_joint_cal: Optional[DeviceCalibrator] = None
        self._device_cont_cal: Optional[DeviceCalibrator] = None
        self._latent_prior: Optional[tuple] = None
        # Cohorts dumped under OSDM_DUMP_RAW: repeat calls get an _s{i}
        # suffix, so a per-scenario loop keeps every dump (JAX :80-82).
        self._dump_count = 0

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
        quantize = None if gen.fused_quantize in ("none", None) else gen.fused_quantize
        if (steps, quantize) not in self._samplers:
            self._samplers[steps, quantize] = FusedSampler(
                self.model, self.device, ddim_steps=steps, quantize=quantize)
        return self._samplers[steps, quantize]

    def guidance(self) -> float:
        """``generation.guidance_scale`` for a model trained with condition
        dropout, else 1 (JAX :241-243)."""
        if self.model.cfg_dropout_prob > 0:
            return float(self.config.generation.guidance_scale)
        return 1.0

    def uses_kernels(self) -> bool:
        """True when cohorts take the kernel sampler: a diffusion model that
        the JAX package's ``supports_fused`` accepts, at guidance 1."""
        return (self.is_diffusion and supports_fused(self.model)
                and self.guidance() == 1.0)

    def _head(self, name: str):
        """A diffusion model's head flag (``ar_head``, ``discrete_head``,
        ``latent_factor_dim``); off for the other families, as the JAX
        generator's ``getattr(self.model, name, False)``."""
        return getattr(self.model, name) if self.is_diffusion else 0

    def _latent_prior_draw(self, num_samples: int, generator: torch.Generator) -> torch.Tensor:
        """(num_samples, k) latent factors on the device from the Gaussian
        prior fitted once on the training cohort's encoded latents (JAX
        :165-187): their mean, the biased covariance + 1e-6·I, its Cholesky
        factor."""
        if self._latent_prior is None:
            stats = self.data_stats
            if stats is None or "data_matrix" not in stats:
                raise ValueError(
                    f"This checkpoint was trained with latent_factor_dim="
                    f"{self.model.latent_factor_dim} but the generator has no "
                    "data_stats['data_matrix'] to fit the latent prior on. Pass the training "
                    "cohort stats (saved next to the checkpoint as data_stats.npz) to the "
                    "generator.")
            real = torch.as_tensor(np.asarray(stats["data_matrix"], np.float32),
                                   device=self.device)
            with torch.no_grad():
                h = self.model.encode_latents(real).cpu().numpy()
            mu = h.mean(axis=0)
            cov = np.atleast_2d(np.cov(h, rowvar=False, bias=True)) + 1e-6 * np.eye(h.shape[1])
            self._latent_prior = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                for a in (mu, np.linalg.cholesky(cov)))
            logger.info("Latent-factor prior fitted on %d cohort latents (k=%d)", *h.shape)
        mu, chol = self._latent_prior
        z = torch.randn((num_samples, mu.shape[0]), generator=generator, device=generator.device)
        return mu[None, :] + z.to(self.device) @ chol.T

    def _rows(self, n: int) -> Optional[RowBlock]:
        """This rank's block of an n-row cohort under a mesh, else None."""
        if self.mesh is None:
            return None
        return RowBlock.of(n, axis_size(self.mesh, DATA_AXIS), axis_rank(self.mesh, DATA_AXIS))

    def _gathered(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The cohort from each rank's block (``local`` itself without a
        mesh)."""
        if self.mesh is None:
            return local
        return gather_rows(axis_group(self.mesh, DATA_AXIS), local, n)

    def sample_raw(self, conditions: np.ndarray, generator: torch.Generator) -> torch.Tensor:
        """The sampler's (N, D) float32 output, on the sampler's device (the
        whole cohort on every rank under a mesh)."""
        cond = torch.from_numpy(conditions)
        n = cond.shape[0]
        rows = self._rows(n)
        if not self.is_diffusion:
            SAMPLERS["cvae" if isinstance(self.model, BiologyConstrainedVAE) else "plain"] += 1
            return self._gathered(self.model.sample(cond.to(self.device), generator, rows=rows), n)
        if self.model.latent_factor_dim > 0:
            cond = torch.cat([cond.to(self.device),
                              self._latent_prior_draw(cond.shape[0], generator)], dim=1)
        if self.uses_kernels():
            SAMPLERS["kernel"] += 1
            if self.mesh is not None:
                return self.sampler().sample_sharded(self.mesh, cond, generator)
            return self.sampler().sample(cond, generator)
        SAMPLERS["scan"] += 1
        gen = self.config.generation
        if gen.sampler == "ddim":
            out = self.model.scan_sample_ddim(cond, generator, gen.sampling_steps,
                                              self.guidance(), rows=rows)
        else:
            out = self.model.scan_sample(cond, generator, self.guidance(), rows=rows)
        return self._gathered(out, n)

    def generate(self, num_samples: int, scenario: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
        """Generate one cohort and split it into modality blocks."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.training.random_seed)
        logger.info("Generating %d synthetic patients...", num_samples)
        conditions = self.create_conditions(num_samples, scenario, generator)
        ar_generator = None
        if self._head("ar_head"):
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
            ar_generator = seeded_generator(seed, 424_243)
        samples = self.sample_raw(conditions, generator)
        return self._postprocess(samples, conditions, ar_generator)

    def _postprocess(self, samples: Union[torch.Tensor, np.ndarray], conditions: np.ndarray,
                     ar_generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
        """Calibrate (per config) and split a raw sample matrix, a host array
        or a tensor on the device. It goes to where calibration reads it,
        once: to the device when the device path calibrates it, else to the
        host. With the AR head the mutation block is then drawn from
        ``ar_generator`` (JAX :376-386). Under a mesh of several data ranks,
        rank 0 of the data axis does it and sends the result to the others.
        With ``OSDM_DUMP_RAW`` set, the rank that writes files dumps the raw
        cohort first (:meth:`_dump_raw`)."""
        if self.mesh is None or axis_size(self.mesh, DATA_AXIS) == 1:
            return self._finish(samples, conditions, ar_generator)
        group = axis_group(self.mesh, DATA_AXIS)
        box = [self._finish(samples, conditions, ar_generator)
               if axis_rank(self.mesh, DATA_AXIS) == 0 else None]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
        return box[0]

    def _finish(self, samples: Union[torch.Tensor, np.ndarray], conditions: np.ndarray,
                ar_generator: Optional[torch.Generator]) -> Dict[str, np.ndarray]:
        if os.environ.get("OSDM_DUMP_RAW") and is_writer():
            self._dump_raw(samples, conditions)
        on_device = self._device_calibration_enabled(samples.shape[0])
        if on_device:
            samples = torch.as_tensor(samples, dtype=torch.float32).to(self.device)
        elif torch.is_tensor(samples):
            samples = samples.cpu().numpy()
        else:
            samples = np.asarray(samples, np.float32)
        m, e = self.dims.mutation_dim, self.dims.expression_dim
        mode = self.config.generation.calibrate_marginals
        if mode is True:
            mode = "copula_joint"
        if bool(mode) and self.data_stats is not None and samples.shape[0] > 1:
            calibrate = self._calibrate_device if on_device else self._calibrate
            mutations, continuous = calibrate(samples, m, str(mode))
        else:
            mutations = (samples[:, :m] > 0.5).astype(np.float32)
            continuous = samples[:, m:]
        if self._head("ar_head") and m > 0 and samples.shape[0] > 0:
            mutations = self._ar_bits(continuous, conditions, ar_generator)
        return {
            "mutations": mutations,
            "expression": continuous[:, :e],
            "pathways": continuous[:, e:],
            "conditions": np.asarray(conditions),
        }

    def _dump_raw(self, samples: Union[torch.Tensor, np.ndarray], conditions: np.ndarray) -> None:
        """Debug hook (JAX :345-365): the pre-calibration cohort (float32,
        read back from the device) and its conditions into
        ``$OSDM_DUMP_RAW`` as ``savez_compressed(samples=, conditions=)``,
        for replaying calibration modes on the host
        (scripts/replay_calibration_torch.py). The first call writes the
        path itself, call i > 0 ``<stem>_s{i}.npz``."""
        dump = Path(os.environ["OSDM_DUMP_RAW"])
        n_prev = self._dump_count
        self._dump_count += 1
        if n_prev:
            stem = dump.name[:-4] if dump.name.endswith(".npz") else dump.name
            dump = dump.with_name(f"{stem}_s{n_prev}.npz")
        if torch.is_tensor(samples):
            samples = samples.float().cpu().numpy()
        dump.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(dump, samples=np.asarray(samples, np.float32),
                            conditions=np.asarray(conditions))
        logger.info("Raw samples dumped to %s", dump)

    def _ar_bits(self, continuous: np.ndarray, conditions: np.ndarray,
                 generator: Optional[torch.Generator]) -> np.ndarray:
        """The AR head's bits on the device, conditioned on the columns of
        the continuous block its context reads (JAX :396-437); without a
        ``generator``, from one seeded by ``training.random_seed``."""
        model = self.model
        if model.ar_context == "pathways" and model.pathway_dim > 0:
            ctx = continuous[:, -model.pathway_dim:]
        elif model.ar_context == "none":
            ctx = continuous[:, :0]
        else:
            ctx = continuous
        if generator is None:
            generator = seeded_generator(self.config.training.random_seed, 424_243)
        bits = model.ar_sample(
            torch.as_tensor(np.ascontiguousarray(ctx, np.float32), device=self.device),
            torch.as_tensor(np.asarray(conditions, np.float32), device=self.device), generator)
        return bits.cpu().numpy()

    def _calibrate(self, samples: np.ndarray, m: int, mode: str):
        """Marginal (and joint, for the copula modes) calibration against
        the training cohort on the host; see the JAX `_calibrate` for each
        mode. With the D3PM head the model owns the bits: they pass through
        (``raw > 0.5`` of exact 0/1 values, on the host), and "copula_joint"
        takes the "copula_full" route for the continuous block."""
        CALIBRATIONS["host"] += 1
        if self._joint_branch(mode, samples.shape[0], m):
            freq, chol, tetra, _ = self._joint_fit(m)
            mutations, cont = joint_transplant(
                samples, chol, freq, m, tetra=tetra,
                tie_rng=np.random.default_rng(self._tie_seed()),
            )
            return mutations, self._quantile_map_continuous(cont, m)
        mutations = self._host_mutations(samples[:, :m], m, mode)
        cont = samples[:, m:]
        if self._cont_branch(mode, cont.shape):
            cont = gaussian_transplant(
                cont, self._cont_fit(m), tie_rng=np.random.default_rng(self._tie_seed()))
        return mutations, self._quantile_map_continuous(np.asarray(cont), m, mode)

    def _calibrate_device(self, samples: torch.Tensor, m: int, mode: str):
        """The device path (JAX :510-517, :575-578): ``samples`` on the
        device; only the calibrated cohort (and, outside the joint branch,
        the m mutation columns) comes back to the host. A failure raises:
        nothing falls back to numpy."""
        CALIBRATIONS["device"] += 1
        if self._joint_branch(mode, samples.shape[0], m):
            return self._get_device_joint_cal(m).joint(samples, self._tie_seed())
        mutations = self._host_mutations(samples[:, :m].cpu().numpy(), m, mode)
        cont = samples[:, m:]
        if self._cont_branch(mode, cont.shape):
            return mutations, self._get_device_cont_cal(m).continuous(cont, self._tie_seed())
        return mutations, self._quantile_map_continuous(cont.cpu().numpy(), m, mode)

    def _joint_branch(self, mode: str, n: int, m: int) -> bool:
        """Every precondition of the joint copula: no D3PM or AR head, more
        than one gene, the real mutation block and cohort, more than two
        rows."""
        stats = self.data_stats
        return (mode == "copula_joint" and not self._head("discrete_head")
                and not self._head("ar_head") and "mutation_matrix" in stats
                and "data_matrix" in stats and n > 2 and m > 1)

    def _cont_branch(self, mode: str, shape) -> bool:
        return (mode in ("copula_full", "copula_joint") and "data_matrix" in self.data_stats
                and shape[0] > 2 and shape[1] > 1)

    def _joint_fit(self, m: int):
        if self._joint is None:
            real = np.asarray(self.data_stats["data_matrix"])
            self._joint = fit_joint_copula(real[:, :m], real[:, m:])
            logger.info("Joint copula fitted (shrink=%.3g)", self._joint[3])
        return self._joint

    def _cont_fit(self, m: int) -> np.ndarray:
        if self._cont_chol is None:
            self._cont_chol = fit_continuous_copula_chol(
                np.asarray(self.data_stats["data_matrix"])[:, m:])
        return self._cont_chol

    def _host_mutations(self, raw_mut: np.ndarray, m: int, mode: str) -> np.ndarray:
        """The mutation block outside the joint copula, on the host: the
        D3PM head's bits as they are, the thresholded scores that the AR
        head's draw replaces, the tetrachoric transplant, or per-gene
        quantile thresholds."""
        stats = self.data_stats
        if self._head("discrete_head") or self._head("ar_head"):
            return (raw_mut > 0.5).astype(np.float32)
        if (mode in ("copula", "copula_full", "copula_joint") and "mutation_matrix" in stats
                and raw_mut.shape[0] > 2 and m > 1):
            if self._copula is None:
                self._copula = fit_binary_copula(np.asarray(stats["mutation_matrix"]))
            freq, corr = self._copula
            return correlation_transplant(
                raw_mut, corr, freq, rng=np.random.default_rng(self._tie_seed()))
        freq = np.clip(np.asarray(stats["mutation_freq"], np.float64), 0.0, 1.0)
        thresholds = np.quantile(raw_mut, 1.0 - freq, axis=0).diagonal()
        return (raw_mut > thresholds[None, :]).astype(np.float32)

    def _device_calibration_enabled(self, n: int) -> bool:
        """True when an n-row cohort is calibrated on the device
        (``ops/copula_device.py``; JAX :595-632). ``calibration_backend``:
        "numpy" never; "device" always (on the CPU too, as the tests use
        it); "auto" on the card from 256 rows. Only the copula_joint and
        copula_full modes, with the quantile grid and the real cohort in
        ``data_stats``, more than two rows and at most
        ``DeviceCalibrator.MAX_ROWS``. Never under a mesh: there rank 0
        calibrates on the host (JAX :605-611)."""
        if self.mesh is not None:
            return False
        mode = self.config.generation.calibrate_marginals
        if mode is True:
            mode = "copula_joint"
        stats = self.data_stats
        if not mode or stats is None or n <= 2:
            return False
        if str(mode) not in ("copula_joint", "copula_full"):
            return False
        if "feature_sorted" not in stats or "data_matrix" not in stats:
            return False
        backend = self.config.generation.calibration_backend
        if backend == "numpy" or not DeviceCalibrator.accepts(n):
            return False
        if backend == "device":
            return True
        return self.device.type == "cuda" and n >= 256

    def _sorted_real_cont(self, m: int) -> np.ndarray:
        return np.asarray(self.data_stats["feature_sorted"], np.float32)[:, m:]

    def _get_device_joint_cal(self, m: int) -> DeviceCalibrator:
        if self._device_joint_cal is None:
            freq, chol, tetra, _ = self._joint_fit(m)
            self._device_joint_cal = DeviceCalibrator(
                m, self._sorted_real_cont(m), freq=freq, joint_chol=chol, tetra=tetra,
                device=self.device)
            logger.info("Joint calibration on %s", self.device)
        return self._device_joint_cal

    def _get_device_cont_cal(self, m: int) -> DeviceCalibrator:
        if self._device_cont_cal is None:
            self._device_cont_cal = DeviceCalibrator(
                m, self._sorted_real_cont(m), cont_chol=self._cont_fit(m), device=self.device)
            logger.info("Continuous calibration on %s", self.device)
        return self._device_cont_cal

    def _tie_seed(self) -> int:
        """Seed for random rank tie-breaking (same as the JAX package)."""
        return int(self.config.training.random_seed) + 104729

    def _quantile_map_continuous(self, cont: np.ndarray, m: int,
                                 mode: str = "copula_joint") -> np.ndarray:
        """Within-cohort ranks onto the real per-feature quantile grid, or
        moment matching when the sorted grid is unavailable."""
        stats = self.data_stats
        if mode in ("quantile", "copula", "copula_full", "copula_joint") and "feature_sorted" in stats:
            sorted_real = self._sorted_real_cont(m)
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
        combined = self._postprocess(samples, conds, seeded_generator(seed, 10_001))
        results = {}
        for i, scenario in enumerate(scenarios):
            sl = slice(i * samples_per_scenario, (i + 1) * samples_per_scenario)
            results[scenario.name] = {k: v[sl] for k, v in combined.items()}
        return results

    # ------------------------------------------------------------------
    def save_synthetic_data(self, synthetic: Dict[str, np.ndarray], output_dir: str | Path,
                            gene_names: Dict[str, List[str]], prefix: str = "synthetic") -> None:
        """Per-modality tables ``<prefix>_<modality>`` in each of
        ``output.export_formats`` (JAX :771-823): ``.csv`` where "csv" is
        listed, ``.pkl`` (``DataFrame.to_pickle``) for "pickle", ``.h5``
        (``to_hdf``) for "h5", or ``np.savez_compressed(values=,
        columns=)`` into ``.npz`` where pytables is missing. pandas is
        imported here only: without it "h5" writes the npz and "pickle"
        raises."""
        formats = [f.lower() for f in self.config.output.export_formats] or ["csv"]
        pd = None
        if "pickle" in formats or "h5" in formats:
            try:
                import pandas as pd
            except ImportError:
                if "pickle" in formats:
                    raise ImportError("output.export_formats 'pickle' needs pandas, "
                                      "which is not installed") from None
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        tables = {}
        for key, names in (("mutations", "mutation_genes"), ("expression", "expression_genes"),
                           ("pathways", "pathway_names")):
            if names in gene_names:
                tables[key] = gene_names[names]
        tables["conditions"] = self.dims.condition_names or self.config.model.condition_on
        for name, columns in tables.items():
            base = output_dir / f"{prefix}_{name}"
            values = np.asarray(synthetic[name])
            frame = pd.DataFrame(values, columns=list(columns)) if pd is not None else None
            if "csv" in formats:
                write_matrix_csv(base.with_suffix(".csv"), values, columns)
            if "pickle" in formats:
                frame.to_pickle(base.with_suffix(".pkl"))
            if "h5" in formats:
                _write_h5(frame, values, columns, base, name)
            logger.info("Saved %s (%s)", base.name, ", ".join(formats))


def _write_h5(frame, values: np.ndarray, columns, base: Path, key: str) -> None:
    """``frame.to_hdf`` into ``<base>.h5``; where pytables (or pandas) is
    missing, the JAX fallback ``savez_compressed(values=, columns=)`` into
    ``<base>.npz``."""
    if frame is not None:
        try:
            frame.to_hdf(base.with_suffix(".h5"), key=key, mode="w")
            return
        except ImportError:
            pass
    np.savez_compressed(base.with_suffix(".npz"), values=values,
                        columns=np.asarray(list(columns), dtype=object))


def load_trained_model(checkpoint_dir: str | Path, config: Optional[Config] = None):
    """Rebuild the model from ``metadata.json`` (any of the three
    architectures, through ``build_model``) and load ``best_model.npz``,
    the cVAE's BatchNorm statistics included. The model section of the
    config comes from the checkpoint; the other sections from ``config``
    when given. Returns (model, config, dims); the module is in eval mode."""
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
    model = build_model(config, dims)
    model.module.load_state_dict(load_weights(checkpoint_dir))
    logger.info("Loaded checkpoint %s", checkpoint_dir)
    return model, config, dims
