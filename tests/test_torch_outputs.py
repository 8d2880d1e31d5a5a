"""The generator's export formats, its ``OSDM_DUMP_RAW`` hook and the
validator's ``compute_mmd`` against the JAX package.

- Export (JAX ``generation/generator.py:771-823``): every table in each of
  ``output.export_formats``. The pickle reads back equal to the CSV (the
  counterpart of tests/test_pipeline_e2e.py's ``test_export_formats``;
  the CSV holds ``%.6g``, so rtol 1e-5); "h5" writes ``to_hdf`` or, where
  pytables is missing, the npz fallback, whose keys and arrays equal the
  JAX generator's on the same table; without pandas "h5" writes the same
  npz and "pickle" raises an error naming pandas.
- The dump (JAX :80-82, :345-365): the pre-calibration cohort and its
  conditions, the first call at the path, call i at ``<stem>_s{i}.npz``
  (the counterpart of tests/test_generator.py's
  ``test_dump_raw_per_scenario_suffix``), the same file as the JAX
  generator's; nothing without the variable. Under a mesh only data-rank 0
  writes (tests/test_torch_sharded.py).
- ``compute_mmd(x, y, gamma)`` and ``mmd_rbf(..., gamma)`` against JAX
  ``BiologicalValidator.compute_mmd`` and ``mmd_rbf_pallas`` in interpret
  mode, at gamma = 0.37/d and the default 1/d, relative tolerance 1e-5
  (the port's plain version sums in float64, JAX in float32 over cohorts
  far enough apart that the MMD carries no cancellation).
"""

import importlib.util
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.generation.generator import (
    SyntheticPatientGenerator as JaxGenerator,
)
from osteosarcoma_diffusionmodel_tpu.ops.pallas_kernels import mmd_rbf_pallas
from osteosarcoma_diffusionmodel_tpu.validation.validator import (
    BiologicalValidator as JaxValidator,
)
from osteosarcoma_diffusionmodel_torch.cli import generate_synthetic_patients
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort, write_processed
from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
from osteosarcoma_diffusionmodel_torch.ops.pallas_kernels import mmd_rbf
from osteosarcoma_diffusionmodel_torch.utils.card import seeded_checkpoint
from osteosarcoma_diffusionmodel_torch.validation.validator import BiologicalValidator
from torch_parity import CONDITIONS, DATA_DIMS, _configure, make_pair

MODALITIES = ("mutations", "expression", "pathways", "conditions")


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port generator on the same tiny model, a table of
    each modality and its gene names."""
    jmodel, params, pmodel = make_pair()
    jc = _configure(JaxConfig(), 6, "bfloat16")
    pc = _configure(Config(), 6, "bfloat16")
    jdims = jc.freeze_dims(*DATA_DIMS, CONDITIONS)
    pdims = pc.freeze_dims(*DATA_DIMS, CONDITIONS)
    rng = np.random.default_rng(3)
    m, e, p = DATA_DIMS
    synthetic = {
        "mutations": (rng.random((7, m)) < 0.3).astype(np.float32),
        "expression": rng.standard_normal((7, e)).astype(np.float32),
        "pathways": rng.standard_normal((7, p)).astype(np.float32),
        "conditions": rng.standard_normal((7, len(CONDITIONS))).astype(np.float32),
    }
    names = {"mutation_genes": [f"M{i}" for i in range(m)],
             "expression_genes": [f"E{i}" for i in range(e)],
             "pathway_names": [f"P{i}" for i in range(p)]}
    return (JaxGenerator(jmodel, params, jc, jdims), SyntheticPatientGenerator(
        pmodel, pc, pdims, device="cpu"), synthetic, names)


def _save(gen, formats, synthetic, names, out):
    gen.config.output.export_formats = list(formats)
    try:
        gen.save_synthetic_data(synthetic, out, names, prefix="s")
    finally:
        gen.config.output.export_formats = ["csv"]


# ----------------------------------------------------------------------
# Export formats
# ----------------------------------------------------------------------
def test_cli_exports_pickle_equal_to_csv(tmp_path):
    """The generate step with ``[csv, pickle, h5]``: each table's pickle
    reads back as the CSV does, under the CSV's column names; "h5" leaves
    its file (or the npz where pytables is missing)."""
    cfg = _configure(Config(), 6, "bfloat16")
    cfg.model.constraints.enabled = False
    cfg.generation.sampler, cfg.generation.sampling_steps = "ddim", 3
    cfg.generation.num_synthetic_samples = 30
    cfg.output.export_formats = ["csv", "pickle", "h5"]
    cohort = make_dummy_cohort(20, *DATA_DIMS)
    write_processed(cohort, tmp_path / "processed")
    cfg.data.processed_dir = str(tmp_path / "processed")
    cfg.training.save_dir = str(seeded_checkpoint(tmp_path / "ckpt", cfg, cohort))
    cfg.output.synthetic_data_dir = str(tmp_path / "synthetic")
    generate_synthetic_patients(cfg, device="cpu")
    scen = tmp_path / "synthetic" / "typical_patient"
    h5 = importlib.util.find_spec("tables") is not None
    for name in MODALITIES:
        base = scen / f"typical_patient_{name}"
        frame = pd.read_pickle(base.with_suffix(".pkl"))
        csv = pd.read_csv(base.with_suffix(".csv"))
        assert frame.shape == (10, csv.shape[1])
        assert list(frame.columns) == list(csv.columns)
        np.testing.assert_allclose(frame.values, csv.values, rtol=1e-5, atol=1e-6)
        assert base.with_suffix(".h5" if h5 else ".npz").exists()
    assert list(pd.read_pickle(scen / "typical_patient_mutations.pkl").columns[:2]) == [
        "TP53", "RB1"]


def test_h5_export_equals_jax(pair, tmp_path):
    """"h5" as the JAX generator writes it: the same files, keys and arrays
    (the npz fallback where pytables is missing)."""
    jgen, pgen, synthetic, names = pair
    _save(jgen, ["h5"], synthetic, names, tmp_path / "jax")
    _save(pgen, ["h5"], synthetic, names, tmp_path / "port")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    for name in MODALITIES:
        if importlib.util.find_spec("tables") is not None:
            pd.testing.assert_frame_equal(pd.read_hdf(tmp_path / "port" / f"s_{name}.h5"),
                                          pd.read_hdf(tmp_path / "jax" / f"s_{name}.h5"))
            continue
        with np.load(tmp_path / "port" / f"s_{name}.npz", allow_pickle=True) as got, \
                np.load(tmp_path / "jax" / f"s_{name}.npz", allow_pickle=True) as ref:
            assert sorted(got.files) == sorted(ref.files) == ["columns", "values"]
            assert got["values"].dtype == ref["values"].dtype
            np.testing.assert_array_equal(got["values"], ref["values"])
            assert got["columns"].dtype == object
            assert list(got["columns"]) == list(ref["columns"])


def test_without_pandas(pair, tmp_path, monkeypatch):
    """pandas hidden: "h5" writes the npz fallback as with pandas, "csv"
    still writes, and "pickle" raises an ImportError that names pandas."""
    jgen, pgen, synthetic, names = pair
    _save(pgen, ["h5"], synthetic, names, tmp_path / "with")
    monkeypatch.setitem(sys.modules, "pandas", None)
    _save(pgen, ["csv", "h5"], synthetic, names, tmp_path / "without")
    for name in MODALITIES:
        assert (tmp_path / "without" / f"s_{name}.csv").exists()
        if (tmp_path / "with" / f"s_{name}.npz").exists():
            with np.load(tmp_path / "with" / f"s_{name}.npz", allow_pickle=True) as ref, \
                    np.load(tmp_path / "without" / f"s_{name}.npz", allow_pickle=True) as got:
                for key in ("values", "columns"):
                    np.testing.assert_array_equal(got[key], ref[key])
    with pytest.raises(ImportError, match="pandas"):
        _save(pgen, ["csv", "pickle"], synthetic, names, tmp_path / "pickle")


# ----------------------------------------------------------------------
# OSDM_DUMP_RAW
# ----------------------------------------------------------------------
def test_dump_raw_per_scenario_suffix(pair, tmp_path, monkeypatch):
    """Two cohorts through ``_postprocess``: the first at the path, the
    second at ``raw_s1.npz``, each the raw samples and conditions, each
    file equal to the JAX generator's."""
    jgen, pgen, _, _ = pair
    d = sum(DATA_DIMS)
    s1 = np.random.default_rng(0).normal(size=(4, d)).astype(np.float32)
    s2 = np.random.default_rng(1).normal(size=(4, d)).astype(np.float32)
    cond = np.arange(12, dtype=np.float32).reshape(4, 3)
    for gen, where in ((pgen, "port"), (jgen, "jax")):
        monkeypatch.setenv("OSDM_DUMP_RAW", str(tmp_path / where / "raw.npz"))
        gen._dump_count = 0
        gen._postprocess(s1, cond)
        gen._postprocess(torch.from_numpy(s2) if gen is pgen else s2, cond)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["raw.npz", "raw_s1.npz"]
    for name, samples in (("raw.npz", s1), ("raw_s1.npz", s2)):
        with np.load(tmp_path / "port" / name) as got, np.load(tmp_path / "jax" / name) as ref:
            assert sorted(got.files) == sorted(ref.files) == ["conditions", "samples"]
            np.testing.assert_array_equal(got["samples"], samples)
            assert got["samples"].dtype == np.float32
            for key in ref.files:
                np.testing.assert_array_equal(got[key], ref[key])


def test_dump_raw_holds_the_cohort_before_calibration(tmp_path, monkeypatch):
    """Batched scenarios: one dump, the sampler's output before the
    copula, with every scenario's conditions; one scenario at a time: one
    dump a scenario. Unset: no file."""
    _, _, pmodel = make_pair()
    cfg = _configure(Config(), 6, "bfloat16")
    cfg.generation.sampler, cfg.generation.sampling_steps = "ddim", 3
    cohort = make_dummy_cohort(20, *DATA_DIMS)
    from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays

    data, conditions, dims = cohort_arrays(cohort, cfg)
    stats = data_stats_from_arrays(data, conditions, DATA_DIMS[0])
    scenarios = cfg.generation.scenarios
    gen = SyntheticPatientGenerator(pmodel, cfg, dims, data_stats=stats, device="cpu")
    raw = []
    real_sample_raw = gen.sample_raw
    monkeypatch.setattr(gen, "sample_raw", lambda *a: raw.append(real_sample_raw(*a)) or raw[-1])

    monkeypatch.delenv("OSDM_DUMP_RAW", raising=False)
    gen.generate_scenarios(scenarios, 5)
    assert gen._dump_count == 0

    monkeypatch.setenv("OSDM_DUMP_RAW", str(tmp_path / "batched" / "raw.npz"))
    cfg.generation.batch_scenarios = True
    out = gen.generate_scenarios(scenarios, 5)
    assert [p.name for p in (tmp_path / "batched").iterdir()] == ["raw.npz"]
    with np.load(tmp_path / "batched" / "raw.npz") as f:
        np.testing.assert_array_equal(f["samples"], raw[-1].numpy())
        np.testing.assert_array_equal(
            f["conditions"], np.concatenate([out[s.name]["conditions"] for s in scenarios]))
        assert not np.array_equal(f["samples"][:5, DATA_DIMS[0]:DATA_DIMS[0] + DATA_DIMS[1]],
                                  out[scenarios[0].name]["expression"])  # calibrated after

    monkeypatch.setenv("OSDM_DUMP_RAW", str(tmp_path / "each" / "raw"))
    cfg.generation.batch_scenarios = False
    gen._dump_count = 0
    gen.generate_scenarios(scenarios, 5)
    assert sorted(p.name for p in (tmp_path / "each").iterdir()) == [
        "raw.npz", "raw_s1.npz", "raw_s2.npz"]


# ----------------------------------------------------------------------
# compute_mmd and gamma
# ----------------------------------------------------------------------
def _cohorts():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 30)).astype(np.float32)
    y = (1.3 * rng.standard_normal((60, 30)) + 0.4).astype(np.float32)
    return x, y


@pytest.mark.parametrize("scale", [0.37, None])
def test_compute_mmd_matches_jax(scale):
    x, y = _cohorts()
    gamma = None if scale is None else scale / x.shape[1]
    ref = JaxValidator(JaxConfig()).compute_mmd(x, y, gamma=gamma)
    got = BiologicalValidator(Config(), device="cpu").compute_mmd(x, y, gamma=gamma)
    assert isinstance(got, float)
    assert got == pytest.approx(ref, rel=1e-5)
    assert got > 0.1


def test_mmd_gamma_matches_pallas_interpret():
    """``mmd_rbf`` at gamma = 0.37/d against JAX ``mmd_rbf_pallas`` in
    interpret mode (as tests/test_pallas_kernels.py runs it); another
    gamma gives another MMD, and None is 1/d."""
    x, y = _cohorts()
    gamma = 0.37 / x.shape[1]
    ref = float(mmd_rbf_pallas(jnp.asarray(x), jnp.asarray(y), gamma=gamma, interpret=True))
    got = mmd_rbf(torch.from_numpy(x), torch.from_numpy(y), gamma=gamma)
    assert got == pytest.approx(ref, rel=1e-5)
    default = mmd_rbf(torch.from_numpy(x), torch.from_numpy(y))
    assert default == mmd_rbf(torch.from_numpy(x), torch.from_numpy(y), gamma=1.0 / x.shape[1])
    assert abs(default - got) > 1e-3
