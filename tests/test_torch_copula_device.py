"""The port's device calibration (ops/copula_device.py) against the JAX
package's DeviceCalibrator and the float64 numpy path, on the CPU.

The three take the same fitted targets and the same raw cohort, a seeded
two-factor cohort read back as bf16 (as the sampler's carry is), so that
rows tie. Their marginals must agree by construction: equal per-gene bit
counts and sorted continuous columns within 1e-4. Their tie-break streams
differ (JAX keys, numpy and torch generators), so the imposed joint is
compared by its correlation pattern: > 0.95, max |Δ| < 0.25. Both
whitening branches run: the dual N x N Gram at N < D and the primal
D x D Gram at N > D. The generator's choice of path ("numpy", "device",
"auto" on the CPU) and the marginals each path returns are held against
the JAX generator's on the same data_stats.
"""

import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops import copula as jax_copula
from osteosarcoma_diffusionmodel_tpu.ops.copula_device import DeviceCalibrator as JaxCalibrator
from osteosarcoma_diffusionmodel_torch.ops import copula as C
from osteosarcoma_diffusionmodel_torch.ops import copula_device as cd
from osteosarcoma_diffusionmodel_torch.ops.copula_device import DeviceCalibrator

M, D_CONT, N_REAL = 10, 40, 200
D = M + D_CONT
ROWS = {"dual": 30, "primal": 300}  # N < D and N > D


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _structured_cohort(rng, n, m, d_cont):
    """Latent 2-factor cohort: correlated bits and coupled continuous
    columns (tests/test_copula_device.py)."""
    load_m = rng.normal(size=(2, m)) * 1.2
    load_c = rng.normal(size=(2, d_cont))
    z = rng.normal(size=(n, 2))
    bits = ((z @ load_m + rng.normal(size=(n, m))) > 0.3).astype(np.float64)
    return bits, z @ load_c + rng.normal(size=(n, d_cont)) * 0.7


def _np_quantile_map(cont, sorted_real):
    """The generator's numpy quantile map, inlined."""
    n, n_real = cont.shape[0], sorted_real.shape[0]
    order = np.argsort(cont, axis=0)
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.broadcast_to(np.arange(n)[:, None], order.shape), axis=0)
    pos = (ranks + 0.5) / n * (n_real - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_real - 1)
    frac = (pos - lo).astype(np.float32)
    return (np.take_along_axis(sorted_real, lo, axis=0) * (1.0 - frac)
            + np.take_along_axis(sorted_real, hi, axis=0) * frac)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(7)
    real_bits, real_cont = _structured_cohort(rng, N_REAL, M, D_CONT)
    real_bits[:, real_bits.mean(0) < 0.05] = rng.random((N_REAL,))[:, None] < 0.2
    fit = C.fit_joint_copula(real_bits, real_cont)
    sorted_real = np.sort(real_cont, axis=0).astype(np.float32)
    raw = {}
    for branch, n in ROWS.items():
        bits, cont = _structured_cohort(rng, n, M, D_CONT)
        raw[branch] = _bf16(np.concatenate([bits + 0.3 * rng.normal(size=bits.shape), cont], 1))
    cont_chol = C.fit_continuous_copula_chol(real_cont)
    return fit, sorted_real, raw, cont_chol


def _pattern(a_blocks, b_blocks):
    """(pattern correlation, max |Δ|) of two cohorts' correlation matrices
    (columns constant in either cohort left out)."""
    a = np.corrcoef(np.concatenate(a_blocks, 1), rowvar=False)
    b = np.corrcoef(np.concatenate(b_blocks, 1), rowvar=False)
    iu = np.triu_indices_from(a, k=1)
    a, b = a[iu], b[iu]
    ok = np.isfinite(a) & np.isfinite(b)
    return np.corrcoef(a[ok], b[ok])[0, 1], np.max(np.abs(a[ok] - b[ok]))


def _assert_same_marginals(bits, cont, ref_bits, ref_cont):
    if ref_bits is not None:
        np.testing.assert_array_equal(bits.sum(0), ref_bits.sum(0))
    np.testing.assert_allclose(np.sort(cont, axis=0), np.sort(ref_cont, axis=0),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tetra", [True, False], ids=["tetra", "no_tetra"])
@pytest.mark.parametrize("branch", list(ROWS))
def test_joint_matches_numpy_and_jax(fitted, branch, tetra):
    (freq, chol, tetra_m, _), sorted_real, raw, _ = fitted
    raw = raw[branch]
    tetra_m = tetra_m if tetra else None
    bits_np, z_cont = C.joint_transplant(raw, chol, freq, M, tetra=tetra_m,
                                         tie_rng=np.random.default_rng(1))
    cont_np = _np_quantile_map(z_cont, sorted_real)
    bits_jax, cont_jax = JaxCalibrator(M, sorted_real, freq=freq, joint_chol=chol,
                                       tetra=tetra_m).joint(raw, seed=1)
    cal = DeviceCalibrator(M, sorted_real, freq=freq, joint_chol=chol, tetra=tetra_m,
                           device="cpu")
    bits, cont = cal.joint(torch.from_numpy(raw), seed=1)
    assert bits.shape == (raw.shape[0], M) and cont.shape == (raw.shape[0], D_CONT)
    assert bits.dtype == cont.dtype == np.float32 and set(np.unique(bits)) <= {0.0, 1.0}
    for ref_bits, ref_cont in ((bits_np, cont_np), (bits_jax, cont_jax)):
        _assert_same_marginals(bits, cont, ref_bits, ref_cont)
        pattern, delta = _pattern([bits, cont], [ref_bits, ref_cont])
        assert pattern > 0.95 and delta < 0.25, (pattern, delta)


@pytest.mark.parametrize("branch", list(ROWS))
def test_continuous_matches_numpy_and_jax(fitted, branch):
    _, sorted_real, raw, cont_chol = fitted
    cont_raw = raw[branch][:, M:]
    cont_np = _np_quantile_map(
        C.gaussian_transplant(cont_raw, cont_chol, tie_rng=np.random.default_rng(2)), sorted_real)
    cont_jax = JaxCalibrator(M, sorted_real, cont_chol=cont_chol).continuous(cont_raw, seed=2)
    cal = DeviceCalibrator(M, sorted_real, cont_chol=cont_chol, device="cpu")
    cont = cal.continuous(torch.from_numpy(raw[branch])[:, M:], seed=2)
    for ref in (cont_np, cont_jax):
        _assert_same_marginals(None, cont, None, ref)
        pattern, delta = _pattern([cont], [ref])
        assert pattern > 0.95 and delta < 0.25, (pattern, delta)


@pytest.mark.parametrize("branch", list(ROWS))
def test_whitening_matches_numpy(fitted, branch):
    """Both branches whiten as copula._whiten_exact does: the same columns
    up to float32 rounding, and an identity correlation."""
    u = C._normal_scores(fitted[2][branch]).astype(np.float32)
    u /= u.std(axis=0, keepdims=True)
    ref = C._whiten_exact(u)
    got = cd._whiten_exact(torch.from_numpy(u.copy())).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_ties_break_at_random_not_by_row():
    """Columns rounded to bf16 around 12 (spacing 1/16): most values tie.
    Within each tie group the ranks must not follow row order: their
    correlation with the row index is near 0, where a row-order tie-break
    (a stable sort alone) gives 1."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_bf16(12.0 + rng.normal(size=(4000, 3))))
    u = cd._normal_scores(x, torch.Generator().manual_seed(0))
    ranks = u.argsort(dim=0).argsort(dim=0).numpy()
    row_order = x.argsort(dim=0, stable=True).argsort(dim=0).numpy()
    rows = np.arange(x.shape[0])
    got, stable, tied = [], [], 0
    for j in range(x.shape[1]):
        col = x[:, j].numpy()
        for value in np.unique(col):
            group = np.flatnonzero(col == value)
            if group.size >= 20:
                tied += group.size
                order = np.arange(group.size)  # the group's rows in row order
                got.append(np.corrcoef(ranks[group, j], order)[0, 1])
                stable.append(np.corrcoef(row_order[group, j], order)[0, 1])
    assert tied > 0.9 * x.numel()
    np.testing.assert_allclose(stable, 1.0)
    assert abs(np.mean(got)) < 0.05 and np.max(np.abs(got)) < 0.5, (np.mean(got), np.max(got))
    # The scores are the van der Waerden scores of distinct ranks (float32
    # ndtri of a float32 probability: ~2e-5 off the float64 ppf in the tails).
    np.testing.assert_allclose(np.sort(u.numpy(), axis=0)[:, 0],
                               np.sort(C._norm_ppf((rows + 0.5) / rows.size)), atol=1e-4)


def test_accepts_row_bound(fitted):
    (freq, chol, tetra, _), sorted_real, _, _ = fitted
    assert DeviceCalibrator.MAX_ROWS == JaxCalibrator.MAX_ROWS
    for n in (1, 1024, DeviceCalibrator.MAX_ROWS, DeviceCalibrator.MAX_ROWS + 1):
        assert DeviceCalibrator.accepts(n) == JaxCalibrator.accepts(n)
    assert not DeviceCalibrator.accepts(DeviceCalibrator.MAX_ROWS + 1)


def test_refuses_a_host_array(fitted):
    """The device path never takes a numpy array by accident."""
    (freq, chol, tetra, _), sorted_real, raw, cont_chol = fitted
    cal = DeviceCalibrator(M, sorted_real, freq=freq, joint_chol=chol, tetra=tetra,
                           cont_chol=cont_chol, device="cpu")
    with pytest.raises(TypeError):
        cal.joint(raw["dual"], seed=1)
    with pytest.raises(TypeError):
        cal.continuous(raw["dual"][:, M:], seed=1)


def test_tetra_constant_matches_host_fit(fitted):
    (freq, chol, tetra, _), sorted_real, _, _ = fitted
    cal = DeviceCalibrator(M, sorted_real, freq=freq, joint_chol=chol, tetra=tetra, device="cpu")
    ref = np.linalg.cholesky(jax_copula.nearest_corr_psd(tetra)).astype(np.float32)
    np.testing.assert_array_equal(cal._tetra_chol.numpy(), ref)


# ----------------------------------------------------------------------
# The generator's choice of path and its marginals, against the JAX
# generator's on the same data_stats (torch_parity's tiny model).

@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data, prepare_arrays
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays
    from torch_parity import _configure, make_pair

    proc = tmp_path_factory.mktemp("processed")
    make_dummy_data(proc, n_samples=40, n_mutation_genes=10, n_expression_genes=40,
                    n_pathways=14)
    jc = _configure(JaxConfig(), 6, "bfloat16")
    jc.data.processed_dir = str(proc)
    arrays, jdims = prepare_arrays(jc)
    stats = data_stats_from_arrays(arrays.data, arrays.conditions, len(arrays.mutation_genes))
    pairs = {}
    for head in (False, True):
        jmodel, params, pmodel = make_pair(discrete=head)
        jcfg = _configure(JaxConfig(), 6, "bfloat16", discrete=head)
        pcfg = _configure(Config(), 6, "bfloat16", discrete=head)
        pdims = pcfg.freeze_dims(jdims.mutation_dim, jdims.expression_dim, jdims.pathway_dim,
                                 jdims.condition_names, jdims.survival_mean, jdims.survival_std)
        pairs[head] = (jmodel, params, jcfg, pmodel, pcfg, pdims)
    return pairs, jdims, stats


def _pair(generators, head, stats_drop=(), **generation):
    """(JAX generator, port generator) on the same data_stats, with the
    generation settings applied to both."""
    from osteosarcoma_diffusionmodel_tpu.generation.generator import (
        SyntheticPatientGenerator as JaxGenerator,
    )
    from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator

    pairs, jdims, stats = generators
    jmodel, params, jcfg, pmodel, pcfg, pdims = pairs[head]
    stats = {k: v for k, v in stats.items() if k not in stats_drop}
    for cfg in (jcfg, pcfg):
        for key, value in generation.items():
            setattr(cfg.generation, key, value)
    return (JaxGenerator(jmodel, params, jcfg, jdims, data_stats=stats),
            SyntheticPatientGenerator(pmodel, pcfg, pdims, data_stats=stats, device="cpu"))


@pytest.mark.parametrize("stats_drop", [(), ("feature_sorted",), ("data_matrix",)])
@pytest.mark.parametrize("mode", ["copula_joint", "copula_full", "copula", "quantile", False])
@pytest.mark.parametrize("backend", ["numpy", "device", "auto"])
def test_generator_path_choice_matches_jax(generators, backend, mode, stats_drop):
    jgen, pgen = _pair(generators, False, stats_drop, calibration_backend=backend,
                       calibrate_marginals=mode)
    for n in (1, 2, 3, 64, 255, 256, 1024, DeviceCalibrator.MAX_ROWS,
              DeviceCalibrator.MAX_ROWS + 1):
        assert pgen._device_calibration_enabled(n) == jgen._device_calibration_enabled(n), n


def _raw(n, head, seed=5):
    from torch_parity import DATA_DIMS

    rng = np.random.default_rng(seed)
    raw = _bf16(rng.standard_normal((n, sum(DATA_DIMS))))
    m = DATA_DIMS[0]
    raw[:, :m] = ((rng.uniform(size=(n, m)) < 0.3) if head
                  else _bf16((raw[:, :m] > 0.3) * 0.9 + 0.05 * raw[:, :m]))
    return raw, rng.standard_normal((n, 3)).astype(np.float32)


@pytest.mark.parametrize("case", ["joint_dual", "joint_primal", "full", "d3pm_joint",
                                  "no_mutation_matrix"])
def test_generator_device_path_matches_jax_and_numpy(generators, case):
    """The port's generator under "device" calibrates on its calibrator
    (the JAX generator on its own); both return the numpy path's
    marginals. With the D3PM head the bits pass through unchanged; without
    ``mutation_matrix`` the joint branch is not taken (neither generator
    builds a joint calibrator) and the continuous block still calibrates
    on the device."""
    from osteosarcoma_diffusionmodel_torch.generation import generator as pg

    head = case == "d3pm_joint"
    mode = "copula_full" if case == "full" else "copula_joint"
    drop = ("mutation_matrix",) if case == "no_mutation_matrix" else ()
    raw, conds = _raw(30 if case == "joint_dual" else 100, head)
    jgen, pgen = _pair(generators, head, drop, calibration_backend="device",
                       calibrate_marginals=mode)
    before = pg.CALIBRATIONS["device"]
    got = pgen._postprocess(torch.from_numpy(raw), conds)
    assert pg.CALIBRATIONS["device"] == before + 1
    joint = case.startswith("joint")
    assert (pgen._device_joint_cal is not None) == joint
    assert (pgen._device_cont_cal is not None) == (not joint)
    ref = jgen._postprocess(raw, conds)
    _, host = _pair(generators, head, drop, calibration_backend="numpy", calibrate_marginals=mode)
    want = host._postprocess(raw, conds)
    assert host._device_joint_cal is None and host._device_cont_cal is None
    for other in (ref, want):
        assert set(got) == set(other)
        for key in got:
            assert got[key].shape == np.asarray(other[key]).shape, key
            assert got[key].dtype == np.asarray(other[key]).dtype, key
        np.testing.assert_array_equal(got["conditions"], np.asarray(other["conditions"]))
        _assert_same_marginals(got["mutations"], got["expression"],
                               np.asarray(other["mutations"]), np.asarray(other["expression"]))
        _assert_same_marginals(None, got["pathways"], None, np.asarray(other["pathways"]))
    if head:
        np.testing.assert_array_equal(got["mutations"], raw[:, :10])
