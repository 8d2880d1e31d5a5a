"""The plain reference against the port's plain path at tiny widths, and
the reference's imports."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import copula as ref_copula
from benchmark.reference import sampler as ref_sampler

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_philox_equals_the_ports_plain_generator():
    from osteosarcoma_diffusionmodel_torch.ops.sampler_kernels import philox_uniform_noise

    rows = torch.tensor([0, 3, 7])
    ours = ref_sampler.uniform_noise(12345, 7, rows, 37)
    theirs = philox_uniform_noise(12345, 7, 8, 37)[rows]
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("ddim_steps", [None, 4])
def test_schedule_tables_match_the_ports(ddim_steps):
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import coefficient_table
    from osteosarcoma_diffusionmodel_torch.ops.schedules import DiffusionSchedule

    sched = DiffusionSchedule.create("cosine", 20)
    n = len(ref_sampler.reverse_steps(20, ddim_steps))
    theirs = coefficient_table(sched, np.zeros(n), ddim_steps)[:, :3]
    ours = ref_sampler.transition_table("cosine", 20, ddim_steps)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ddim_steps", [None, 4])
def test_reverse_chain_agrees_with_the_ports_plain_sampler(ddim_steps):
    """The port's kernel sampler on the CPU runs its kernels' plain
    versions: the reference at the same inputs agrees to bf16 rounding."""
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.models.diffusion import ConditionalDiffusion
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler

    from benchmark.weights import seeded_weights

    cfg = Config()
    cfg.model.hidden_dims = [128, 256, 128]
    cfg.model.diffusion.num_steps = 12
    dims = cfg.freeze_dims(10, 40, 14, ["s", "e", "m"])
    model = ConditionalDiffusion.from_config(cfg, dims)
    weights = seeded_weights(model.denoiser, 5, "cpu")
    model.denoiser.load_state_dict(weights)
    sampler = FusedSampler(model, "cpu", ddim_steps=ddim_steps)
    cond = torch.randn(40, 3, generator=torch.Generator().manual_seed(1))
    out = sampler.sample(cond, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    x = torch.randn((40, 64), generator=gen)
    rows = torch.tensor([0, 5, 17, 39])
    den = ref_sampler.Denoiser(weights, [128, 256, 128], "cpu")
    ref = ref_sampler.reverse_chain(den, x[rows], cond[rows], rows, schedule="cosine",
                                    num_steps=12, ddim_steps=ddim_steps, clip=30.0,
                                    philox_seed=seed)
    rel = float((out[rows] - ref).norm() / ref.norm())
    assert rel < 5e-3


def test_joint_fit_is_the_ports():
    from osteosarcoma_diffusionmodel_torch.ops.copula import fit_joint_copula

    rng = np.random.default_rng(0)
    mut = (rng.random((30, 6)) < 0.3).astype(np.float32)
    cont = rng.normal(size=(30, 20)).astype(np.float32)
    freq, chol, tetra = ref_copula.fit_joint(mut, cont)
    f2, c2, t2, _ = fit_joint_copula(mut, cont)
    np.testing.assert_allclose(freq, f2)
    np.testing.assert_allclose(chol, c2, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tetra, t2, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [200, 20])
def test_calibration_agrees_with_the_ports_device_calibrator(n):
    """Both branches (re-sharpened bits from n > m + 1, whitening by the
    dual Gram below D rows) against ``DeviceCalibrator.joint`` on the CPU."""
    from osteosarcoma_diffusionmodel_torch.ops.copula import fit_joint_copula
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import DeviceCalibrator

    rng = np.random.default_rng(1)
    m = 6
    real = np.concatenate([(rng.random((30, m)) < 0.3), rng.normal(size=(30, 20))],
                          axis=1).astype(np.float32)
    raw = torch.from_numpy(rng.normal(size=(n, 26)).astype(np.float32))
    raw = raw.to(torch.bfloat16).float()  # ties, as a bf16 carry has them
    freq, chol, tetra, _ = fit_joint_copula(real[:, :m], real[:, m:])
    cal = DeviceCalibrator(m, np.sort(real, axis=0)[:, m:], freq=freq, joint_chol=chol,
                           tetra=tetra, device="cpu")
    bits, cont = cal.joint(raw, 77)
    rbits, rcont = ref_copula.calibrate_joint(raw, real, m, 77)
    assert float((torch.from_numpy(bits) != rbits).float().mean()) <= 2.0 / (n * m)
    np.testing.assert_allclose(rcont.numpy(), cont, rtol=1e-5, atol=1e-5)


def _loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {imports}; import json; "
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    loaded = _loaded_after("import benchmark.reference.sampler, benchmark.reference.copula, "
                           "benchmark.reference.cohort")
    assert not loaded & {"osteosarcoma_diffusionmodel_torch", "osteosarcoma_diffusionmodel_tpu",
                         "jax", "jaxlib", "flax"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a cell's run imports (the harness, each traffic kind, the
    trace reader, the metric readers) and the port's modules it drives."""
    loaded = _loaded_after(
        "from benchmark import harness, trace; "
        "import benchmark.traffic.cohort as k; "
        "[harness.metric_reader(m['name']) for m in harness.load_spec()['per_layer']]; "
        "k.counters(); from osteosarcoma_diffusionmodel_torch.generation import generator; "
        "from osteosarcoma_diffusionmodel_torch.data import dummy")
    assert "osteosarcoma_diffusionmodel_torch" in loaded
    assert not loaded & {"osteosarcoma_diffusionmodel_tpu", "jax", "jaxlib", "flax"}
