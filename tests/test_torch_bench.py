"""The port's measuring entry point (osteosarcoma_diffusionmodel_torch/bench.py)
against the JAX package's root ``bench.py`` and ``scripts/bench_suite.py``.

At tiny sizes on the CPU, where the kernel wrappers run their plain
versions: data dims 8/40/6 and hidden 128/256/128 (the narrowest widths
the kernel sampler takes: its first hidden width is a multiple of 128, as
in the JAX package), at most 20 steps. The bench's model carries the JAX
bench's model's parameters (``init_params(PRNGKey(0))``) over through
``convert.flax_params_to_state_dict``. The tests draw nothing from the
session ``rng`` fixture.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.models.diffusion import ConditionalDiffusion as JaxDiffusion
from osteosarcoma_diffusionmodel_tpu.ops.fused_sampler import FusedSampler as JaxFusedSampler
from osteosarcoma_diffusionmodel_torch import bench
from osteosarcoma_diffusionmodel_torch.convert import flax_params_to_state_dict
from osteosarcoma_diffusionmodel_torch.ops import pallas_kernels
from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler, coefficient_table
from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule

REPO = Path(__file__).resolve().parent.parent
DIMS = (8, 40, 6)
D = sum(DIMS)
HIDDEN = (128, 256, 128)
B = 32
TILE_B = 16
# The bf16-carry tolerance of tests/test_fused_sampler.py:101: the kernel
# sampler rounds its carry to bf16 every step and the two sides round
# their products and sums at different points.
ATOL, RTOL = 0.15, 0.05
TINY = bench.SuiteSizes(dims=DIMS, hidden=HIDDEN, num_steps=4, ddim_steps=2, row_divisor=256)


def _root_bench():
    """The JAX package's root bench.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pair(num_steps: int):
    """(JAX model, its Flax params as numpy, the port bench's model on
    those params): the JAX bench's model (bench.py:129-138: the defaults,
    ``num_steps``, constraints off, the three clinical conditions) at the
    tiny dims and widths, and :func:`bench.bench_model` of
    :func:`bench.bench_config` at the same."""
    jc = JaxConfig()
    jc.model.diffusion.num_steps = num_steps
    jc.model.constraints.enabled = False
    jc.model.hidden_dims = list(HIDDEN)
    jdims = jc.freeze_dims(*DIMS, list(bench.CONDITION_NAMES))
    jmodel = JaxDiffusion.from_config(jc, jdims)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jdims.condition_dim))
    pmodel = bench.bench_model(bench.bench_config(num_steps, HIDDEN), DIMS, "cpu")
    pmodel.denoiser.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def pair20():
    return _pair(20)


def _conditions(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, 3)).astype(np.float32)


def _close(got: np.ndarray, ref: np.ndarray) -> None:
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert np.isfinite(got).all()
    assert float(np.std(ref)) > 0.05  # the comparison sees real signal


@pytest.mark.parametrize("ddim", [None, 10])
def test_bench_model_tables_match_jax(pair20, ddim):
    """The host tables of the bench's kernel sampler against the JAX
    sampler's on the JAX bench's model. t_add and the skip gains: the same
    numpy arithmetic on the same f32 weights (1e-6). The coefficient table
    from the JAX schedule's own f32 values: 1e-6; from the port's float64
    schedule: within the schedules' f32 rounding (1e-3 relative where
    they cancel, tests/test_torch_schedules.py)."""
    jmodel, params, pmodel = pair20
    ref = JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True, ddim_steps=ddim)
    got = FusedSampler(pmodel, "cpu", ddim_steps=ddim)
    want = np.asarray(ref.coeffs)
    np.testing.assert_allclose(got.t_add.numpy(), np.asarray(ref.t_add), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.coeffs.numpy()[:, 3], want[:, 3], rtol=1e-6, atol=1e-6)
    jsched = DiffusionSchedule(**{
        f.name: np.asarray(getattr(jmodel.schedule, f.name), np.float64)
        for f in dataclasses.fields(DiffusionSchedule)})
    table = coefficient_table(jsched, want[:, 3], ddim)
    np.testing.assert_allclose(table[:, :3], want[:, :3], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.coeffs.numpy()[:, :3], want[:, :3], rtol=1e-3, atol=1e-6)
    assert got.n_loop == (20 if ddim is None else 10)


def test_bench_ddim_matches_jax_sample_ddim(pair20):
    """DDIM-10 (eta 0) of the bench's kernel sampler from the x_T that the
    JAX ``sample_ddim`` draws (normal(split(rng, 3)[0]), f32) against it."""
    jmodel, params, pmodel = pair20
    rng = jax.random.PRNGKey(3)
    cond = _conditions(4)
    ref = np.asarray(jmodel.sample_ddim(jax.tree_util.tree_map(jnp.asarray, params),
                                        jnp.asarray(cond), rng, 10))
    init_rng, _, _ = jax.random.split(rng, 3)
    x_init = np.array(jax.random.normal(init_rng, (B, D), jnp.float32))
    got = FusedSampler(pmodel, "cpu", ddim_steps=10).sample(
        torch.from_numpy(cond), torch.Generator(), x_init=torch.from_numpy(x_init))
    _close(got.numpy(), ref)


def test_bench_ddpm_matches_jax_fused_sampler_on_injected_noise():
    """DDPM (T = 6) of the bench's kernel sampler against the JAX bench's
    sampler (the TPU kernel in interpret mode, f32 GroupNorm statistics)
    on the same x_T and transition noise."""
    jmodel, params, pmodel = _pair(6)
    rng = jax.random.PRNGKey(5)
    cond = _conditions(6)
    noise = np.random.default_rng(7).standard_normal((6, B, D)).astype(np.float32)
    ref = np.asarray(JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True,
                                     gn_mode="f32").sample(jnp.asarray(cond), rng,
                                                           noise=jnp.asarray(noise)))
    init_rng, _ = jax.random.split(rng)
    x_init = np.array(jax.random.normal(init_rng, (B, D), jnp.bfloat16).astype(jnp.float32))
    got = FusedSampler(pmodel, "cpu").sample(torch.from_numpy(cond), torch.Generator(),
                                             x_init=torch.from_numpy(x_init),
                                             noise=torch.from_numpy(noise))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("baseline", ["measured", "absent"])
def test_headline_line_is_bench_pys(baseline, monkeypatch, tmp_path):
    """The headline line has bench.py's four keys and metric; vs_baseline
    divides by BASELINE_MEASURED.json's reference throughput, or by the
    1.7 fallback without the file, as the root bench.py's
    ``reference_baseline`` does; every draw is from a generator on the
    sampler's device."""
    root = _root_bench()
    if baseline == "absent":
        monkeypatch.setattr(bench, "BASELINE_FILE", tmp_path / "BASELINE_MEASURED.json")
        monkeypatch.setattr(root, "REPO", tmp_path)
        assert bench.reference_baseline() == root.reference_baseline() == 1.7
    else:
        want = json.loads((REPO / "BASELINE_MEASURED.json").read_text())
        assert bench.reference_baseline() == root.reference_baseline() == pytest.approx(
            want["reference_cpu_patients_per_sec"])
    generators, real = [], FusedSampler.sample

    def spy(self, conditions, generator, **kw):
        generators.append((generator.device, self.device, kw))
        return real(self, conditions, generator, **kw)

    monkeypatch.setattr(FusedSampler, "sample", spy)
    line, stats = bench.headline("cpu", batch=8, dims=DIMS, num_steps=4, hidden=HIDDEN)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "sampled_patients_per_sec_1000step_ddpm"
    assert line["unit"] == "patients/sec"
    assert len(stats["seconds"]) == bench.HEADLINE_REPS and stats["best"] == min(stats["seconds"])
    assert line["value"] == round(8 / stats["best"], 2)
    assert line["vs_baseline"] == pytest.approx(8 / stats["best"] / bench.reference_baseline(),
                                                abs=0.005)
    assert len(generators) == 1 + bench.HEADLINE_REPS  # the warm-up and the timed calls
    assert all(g == s == torch.device("cpu") and kw == {} for g, s, kw in generators)


def test_main_prints_one_json_line_last(monkeypatch, capsys):
    """``--device cpu``: the card's stand-in line, the calls' line, and the
    headline's JSON, the only JSON line, last."""
    monkeypatch.setattr(bench, "headline", functools.partial(
        bench.headline, batch=8, dims=DIMS, num_steps=4, hidden=HIDDEN))
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    parsed = [json.loads(x) for x in lines if x.startswith("{")]
    assert len(parsed) == 1 and json.loads(lines[-1]) == parsed[0]
    assert set(parsed[0]) == {"metric", "value", "unit", "vs_baseline"}
    assert lines[0].startswith("cpu") and "median" in lines[1]


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(REPO)
    return env


@pytest.mark.parametrize("argv", [[], ["--suite"]])
def test_without_a_card_exits_1_with_the_error_line(argv, monkeypatch, capsys, tmp_path):
    """No card and no ``--device cpu``: the module prints bench.py's
    structured error line and exits 1, in process (no run may start) and
    as ``python -m`` (nothing written)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def refuse(*args, **kw):
        raise AssertionError("a run started without a card")

    monkeypatch.setattr(bench, "headline", refuse)
    monkeypatch.setattr(bench, "run_suite", refuse)
    monkeypatch.setattr(bench, "FusedSampler", refuse)
    out = tmp_path / "suite.json"
    assert bench.main(argv + ["--out", str(out)]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert line["value"] is None and "no CUDA device" in line["error"]

    proc = subprocess.run([sys.executable, "-m", "osteosarcoma_diffusionmodel_torch.bench",
                           *argv, "--out", str(out)], cwd=tmp_path, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["value"] is None and "no CUDA device" in last["error"]
    assert not out.exists()


def test_suite_keys_are_the_jax_suites():
    """The suite at tiny sizes: every key of BENCH_SUITE.json but the
    omitted ones (the JAX suite's staggered cases, bench_suite.py:145-150),
    each with a finite number or True, and the device; nothing else but
    ``omitted`` and ``notes``."""
    results = bench.run_suite("cpu", TINY)
    jax_keys = set(json.loads((REPO / "BENCH_SUITE.json").read_text()))
    omitted = set(results["omitted"])
    assert set(results) - {"omitted", "notes"} == jax_keys - omitted
    src = (REPO / "scripts" / "bench_suite.py").read_text()
    for key in omitted:  # the JAX suite's own cases
        assert f'("{key.removeprefix("ddpm1000_fused_b32768_")}", dict(' in src
    assert set(results["notes"]) <= set(results)
    for key, value in results.items():
        if key == "mmd_10k_pallas_equals_jnp":
            assert value is True
        elif key not in ("device", "omitted", "notes"):
            assert isinstance(value, float) and np.isfinite(value) and value > 0, key


def test_suite_mmd_holds_k4s_route_to_its_plain_version(monkeypatch):
    """``mmd_10k_pallas_equals_jnp`` compares the validator's MMD through
    K4's wrapper (its three kernel sums) with the same MMD on K4's plain
    version, and turns False when the two differ."""
    g = torch.Generator().manual_seed(11)
    real = torch.randn(10, D, generator=g)
    synth = torch.randn(30, D, generator=g) + 0.5
    routed, plain = [], []
    wrapper, reference = pallas_kernels.rbf_kernel_sum, bench.rbf_kernel_sum_plain

    def spy_wrapper(x, y, gamma, plan=None):
        routed.append((x.shape[0], y.shape[0]))
        return wrapper(x, y, gamma, plan)

    def spy_plain(x, y, gamma):
        plain.append((x.shape[0], y.shape[0]))
        return reference(x, y, gamma)

    monkeypatch.setattr(pallas_kernels, "rbf_kernel_sum", spy_wrapper)
    monkeypatch.setattr(bench, "rbf_kernel_sum_plain", spy_plain)
    seconds, equal = bench.mmd_case(real, synth, torch.device("cpu"))
    assert equal is True and seconds > 0
    assert set(routed) == set(plain) == {(10, 10), (30, 30), (10, 30)}
    monkeypatch.setattr(pallas_kernels, "rbf_kernel_sum",
                        lambda x, y, gamma, plan=None: 1.5 * wrapper(x, y, gamma, plan))
    assert bench.mmd_case(real, synth, torch.device("cpu"))[1] is False
