"""The port's profiling utilities: ``StepTimer`` as the JAX test checks it,
``profile_trace`` on the CPU (a Chrome trace written, none when disabled),
``--profile`` on a one-epoch CPU train (the same history and weights as
without it) and ``device_memory_stats`` without a card."""

import json
import time

import numpy as np
import pytest
import torch
import yaml

from osteosarcoma_diffusionmodel_torch import cli
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import make_dummy_cohort, write_processed
from osteosarcoma_diffusionmodel_torch.training import checkpoint as ckpt
from osteosarcoma_diffusionmodel_torch.utils.profiling import (
    StepTimer,
    device_memory_stats,
    profile_trace,
)


def test_step_timer_rates():
    timer = StepTimer("train")
    for _ in range(3):
        with timer:
            time.sleep(0.01)
    assert timer.count == 3
    assert timer.total >= 0.03
    summary = timer.summary()
    assert summary["count"] == 3
    assert summary["per_sec"] > 0
    assert timer.rate(items_per_step=100) > timer.rate()


def test_step_timer_empty():
    assert StepTimer().summary() == {"count": 0}
    assert StepTimer().rate() == 0.0


def _traces(log_dir):
    return sorted(log_dir.glob("*.pt.trace.json")) if log_dir.exists() else []


def test_profile_trace_writes_on_cpu(tmp_path):
    with profile_trace(tmp_path / "trace", device="cpu"):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    (trace,) = _traces(tmp_path / "trace")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_profile_trace_disabled(tmp_path):
    with profile_trace(tmp_path / "trace", enabled=False, device="cpu"):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert not (tmp_path / "trace").exists()


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert device_memory_stats() == {}


@pytest.fixture(scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _train(root, profile: bool):
    make = root / "processed"
    if not make.exists():
        write_processed(make_dummy_cohort(24, 6, 20, 6), make)
    raw = {
        "data": {"processed_dir": str(make)},
        "model": {"hidden_dims": [64, 128, 64], "latent_dim": 16,
                  "diffusion": {"num_steps": 8}},
        "training": {"save_dir": str(root / f"ckpt_{profile}"), "num_epochs": 1},
        "output": {"results_dir": str(root / f"results_{profile}")},
    }
    path = root / f"config_{profile}.yaml"
    path.write_text(yaml.safe_dump(raw))
    torch.manual_seed(0)  # the denoiser's dropout draws from the global generator
    return cli.train_model(Config.from_yaml(path), device="cpu", profile=profile)


def test_profile_changes_neither_history_nor_weights(tmp_path, one_thread):
    plain, profiled = _train(tmp_path, False), _train(tmp_path, True)
    assert profiled.train_loss == plain.train_loss and profiled.val_loss == plain.val_loss
    a, b = ckpt.load_weights(tmp_path / "ckpt_False"), ckpt.load_weights(tmp_path / "ckpt_True")
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert _traces(tmp_path / "results_True" / "profile")
    assert not (tmp_path / "results_False" / "profile").exists()
    assert np.isfinite(plain.train_loss).all()
