"""The comparison that decides ``correct`` fails where it must: under the
control (the program's own int8 path, the precision below the
configuration's bfloat16), and with the timed path broken underneath in
each way a cohort cell can break: a reverse step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. Each runs a cell's whole run but the look for a card, at tiny
widths on the CPU, against the cell's own limits."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import cpu, tiny_cell

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2**31 + 101


def _run(cell):
    numbers = {}
    result = harness.run_cell(cell, SEED, 0.2, False, 0.0, device=cpu(), numbers_out=numbers)
    return result, numbers


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, _ = _run(tiny_cell(name))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("quantize", ["all", "out"])
def test_control_int8_path_is_not_correct(name, quantize):
    """The program's int8 path, on every product or on the output product
    alone: the per-column bias of the gap catches the latter."""
    cell = tiny_cell(name)
    cell.config["config"]["generation"]["fused_quantize"] = quantize
    result, numbers = _run(cell)
    assert not result["correct"], result["checks"]
    assert numbers["sampler_col_bias"] > cell.limits["sampler_col_bias"]


@pytest.mark.parametrize("name", CELLS)
def test_fault_prior_drawn_uniform(name, monkeypatch):
    """x_T drawn uniform on [0, 1) instead of standard normal: the chain
    rerun from it agrees, the prior's moments do not."""
    from osteosarcoma_diffusionmodel_torch.ops import fused_sampler

    monkeypatch.setattr(fused_sampler, "x_prior", lambda batch, d, m, gen: torch.rand(
        (batch, d), generator=gen, device=gen.device))
    result, numbers = _run(tiny_cell(name))
    assert not result["correct"] and numbers["prior_z"] > 100
    assert numbers["sampler_rel_rms"] < 0.02


@pytest.mark.parametrize("name", CELLS)
def test_fault_step_returns_its_state_unchanged(name, monkeypatch):
    from osteosarcoma_diffusionmodel_torch.ops import fused_sampler

    monkeypatch.setattr(fused_sampler, "gemm_bf16_posterior", lambda *a, **k: None)
    result, numbers = _run(tiny_cell(name))
    assert not result["correct"] and numbers["sampler_rel_rms"] > 0.1


@pytest.mark.parametrize("name", CELLS)
def test_fault_half_the_batch_left_out(name, monkeypatch):
    """The sampler computes the first half of the rows and returns them in
    the second half's place too."""
    from osteosarcoma_diffusionmodel_torch.ops.fused_sampler import FusedSampler

    inner = FusedSampler.sample

    def half(self, conditions, generator, **kw):
        out = inner(self, conditions, generator, **kw)
        h = (out.shape[0] + 1) // 2
        out[h:] = out[: out.shape[0] - h]
        return out

    monkeypatch.setattr(FusedSampler, "sample", half)
    result, _ = _run(tiny_cell(name))
    assert not result["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_fault_answer_altered_where_produced(name, monkeypatch):
    """One patient's calibrated profile is shifted by the calibrator."""
    from osteosarcoma_diffusionmodel_torch.ops.copula_device import DeviceCalibrator

    inner = DeviceCalibrator.joint

    def altered(self, raw, seed):
        bits, cont = inner(self, raw, seed)
        cont = np.array(cont)
        cont[7] += 0.5 * np.abs(cont).mean()
        return bits, cont

    monkeypatch.setattr(DeviceCalibrator, "joint", altered)
    result, _ = _run(tiny_cell(name))
    assert not result["correct"]


def test_control_calibration_tf32_differs_only_on_a_card():
    """TF32 exists on the card alone: on the CPU the control reads 0."""
    from benchmark.reference.copula import calibrate_joint

    rng = np.random.default_rng(0)
    real = np.concatenate([(rng.random((30, 4)) < 0.3), rng.normal(size=(30, 12))],
                          axis=1).astype(np.float32)
    raw = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    a = calibrate_joint(raw, real, 4, 1, tf32=False)
    b = calibrate_joint(raw, real, 4, 1, tf32=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
