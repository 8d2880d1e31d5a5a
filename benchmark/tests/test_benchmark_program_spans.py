"""The readers of the program's spans and counters (``x_prior_ms.cohort``,
``steps_ms.cohort``, ``step_enqueue_us.cohort``, ``eigh_ms.cohort``,
``d2h_gbps.cohort``) on hand-made records: the right number, nothing
without records, and the records of requests begun before the window
left out."""

from collections import deque

import pytest

from benchmark import harness
from osteosarcoma_diffusionmodel_torch.utils import profiling

READERS = ("x_prior_ms.cohort", "steps_ms.cohort", "step_enqueue_us.cohort",
           "eigh_ms.cohort", "d2h_gbps.cohort")
WINDOW_T0 = 100.0


class _Event:
    """A completed CUDA event at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.t - self.t


def _request(root: int, t0: float, prior_s: float, steps_s: float, steps_ms: float,
             n_steps: int, whiten_ms: float, down_ms: float, nbytes: int):
    """One request's records, as the program's spans leave them."""
    def rec(name, i, parent, start, end, counts=None, device_ms=None):
        events = None if device_ms is None else (_Event(0.0), _Event(device_ms))
        return {"name": name, "id": root + i, "parent": parent, "root": root, "t0": start,
                "t1": end, "counts": counts or {}, "events": events}

    return [
        rec("sampler.prior", 2, root + 1, t0, t0 + prior_s),
        rec("sampler.steps", 3, root + 1, t0 + prior_s, t0 + prior_s + steps_s,
            {"sampler.steps": n_steps}, steps_ms),
        rec("sample_raw", 1, root, t0, t0 + prior_s + steps_s + 0.01),
        rec("calibrate.whiten", 5, root + 4, t0 + 2.0, t0 + 2.1, None, whiten_ms),
        rec("calibrate.download", 6, root + 4, t0 + 2.2, t0 + 2.3,
            {"copy.d2h_bytes": nbytes}, down_ms),
        rec("calibrate", 4, root, t0 + 2.0, t0 + 2.4, {"copy.d2h_bytes": nbytes}),
        rec("generate", 0, None, t0, t0 + 2.5, {"sampler.steps": n_steps,
                                                 "copy.d2h_bytes": nbytes}),
    ]


@pytest.fixture
def records(monkeypatch):
    buf = deque()
    monkeypatch.setattr(profiling, "_RECORDS", buf)
    return buf


def _read(name, requests):
    return harness.metric_reader(name)({"requests": requests, "spans": [], "counters": {}})


def test_readers_on_hand_made_records(records):
    # Before the window: a request whose numbers would move every reader.
    records.extend(_request(1, WINDOW_T0 - 5.0, 9.0, 9.0, 9000.0, 1, 9000.0, 9000.0, 10**9))
    records.extend(_request(10, WINDOW_T0 + 0.001, 0.5, 1.0, 1100.0, 1000, 150.0, 100.0,
                            300_000_000))
    records.extend(_request(20, WINDOW_T0 + 3.0, 0.7, 1.2, 1300.0, 1000, 250.0, 140.0,
                            300_000_000))
    requests = [{"i": 0, "t0": WINDOW_T0, "t1": WINDOW_T0 + 2.6},
                {"i": 1, "t0": WINDOW_T0 + 2.9, "t1": WINDOW_T0 + 5.6}]
    got = {name: _read(name, requests) for name in READERS}
    assert got["x_prior_ms.cohort"] == pytest.approx(600.0)
    assert got["steps_ms.cohort"] == pytest.approx(1200.0)
    assert got["step_enqueue_us.cohort"] == pytest.approx(1e6 * 2.2 / 2000)
    assert got["eigh_ms.cohort"] == pytest.approx(200.0)
    assert got["d2h_gbps.cohort"] == pytest.approx(600_000_000 / 0.240 / 1e9)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_without_records(records, name):
    requests = [{"i": 0, "t0": WINDOW_T0, "t1": WINDOW_T0 + 1.0}]
    assert _read(name, requests) is None
    assert _read(name, []) is None
    records.extend(_request(1, WINDOW_T0 - 5.0, 0.5, 1.0, 1100.0, 1000, 150.0, 100.0, 10**8))
    assert _read(name, requests) is None  # only a request begun before the window


@pytest.mark.parametrize("name", ["steps_ms.cohort", "eigh_ms.cohort", "d2h_gbps.cohort"])
def test_device_readers_return_nothing_without_device_times(records, name):
    """Spans on the CPU carry no CUDA events: the device readers read
    nothing there."""
    for r in _request(10, WINDOW_T0 + 0.5, 0.5, 1.0, 1100.0, 1000, 150.0, 100.0, 10**8):
        records.append(dict(r, events=None))
    assert _read(name, [{"i": 0, "t0": WINDOW_T0, "t1": WINDOW_T0 + 3.0}]) is None
