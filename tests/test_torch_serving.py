"""The port's serving API (serving/server.py) against the JAX package's.

The checkpoint is the port's own layout (``best_model.npz``,
``metadata.json``, ``data_stats.npz``) holding the JAX params converted by
``tests/torch_parity.py``, with the data statistics of a dummy cohort.
The service's cohort is held to the JAX generator's ``generate`` on the
same weights, bucket and scenario: equal keys, shapes, dtypes and
conditions, equal per-gene bit counts, and sorted continuous columns
within 1e-4 (calibration maps both onto the real cohort's quantile grid).
The HTTP surface is driven on 127.0.0.1 with an ephemeral port, on the
CPU (``device="cpu"``).
"""

import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_torch.serving import server as srv
from osteosarcoma_diffusionmodel_torch.serving.server import (
    GenerationService,
    _bucket,
    make_handler,
    serve,
)

M = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _write_checkpoint(path, head: bool, stats, jdims):
    """A port checkpoint of torch_parity's pair (JAX params converted);
    returns (JAX model, params, JAX config)."""
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_torch.config import Config
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import (
        save_data_stats,
        save_metadata,
        save_weights,
    )
    from torch_parity import _configure, make_pair

    jmodel, params, pmodel = make_pair(discrete=head)
    pc = _configure(Config(), 6, "bfloat16", discrete=head)
    pdims = pc.freeze_dims(jdims.mutation_dim, jdims.expression_dim, jdims.pathway_dim,
                           jdims.condition_names, jdims.survival_mean, jdims.survival_std)
    save_weights(path, pmodel.denoiser.state_dict())
    save_metadata(path, pc, pdims)
    save_data_stats(path, stats)
    return jmodel, params, _configure(JaxConfig(), 6, "bfloat16", discrete=head)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
    from osteosarcoma_diffusionmodel_tpu.data.dataset import make_dummy_data, prepare_arrays
    from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays
    from torch_parity import _configure

    root = tmp_path_factory.mktemp("serve")
    make_dummy_data(root / "processed", n_samples=40, n_mutation_genes=M, n_expression_genes=40,
                    n_pathways=14)
    jc = _configure(JaxConfig(), 6, "bfloat16")
    jc.data.processed_dir = str(root / "processed")
    arrays, jdims = prepare_arrays(jc)
    stats = data_stats_from_arrays(arrays.data, arrays.conditions, M)
    out = {"jdims": jdims, "stats": stats}
    for head in (False, True):
        path = root / ("ckpt_d3pm" if head else "ckpt")
        out[head] = (path, *_write_checkpoint(path, head, stats, jdims))
    return out


@pytest.fixture(scope="module")
def ckpt(checkpoints):
    return checkpoints[False][0]


def _service(ckpt, **kw):
    return GenerationService(ckpt, device="cpu", **kw)


@pytest.fixture
def running(ckpt):
    """A started server on 127.0.0.1 (CPU); yields a connection factory."""
    servers = []

    def start(**kw):
        server = serve(ckpt, host="127.0.0.1", port=0, warmup=False, device="cpu", **kw)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return lambda: http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                                  timeout=120)

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


def _request(conn, method, path, body=None, headers=None):
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers=headers or {})
    resp = conn.getresponse()
    return resp, resp.read()


def test_bucket_matches_jax():
    from osteosarcoma_diffusionmodel_tpu.serving import server as jax_srv

    for n in list(range(1, 70)) + [1000, 1024, 1025, 16383, 16384, 16385, 40000]:
        assert _bucket(n) == jax_srv._bucket(n), n
    assert (srv.MAX_BATCH, srv.MAX_JSON_SAMPLES, srv.MAX_REQUEST_BYTES) == (
        jax_srv.MAX_BATCH, jax_srv.MAX_JSON_SAMPLES, jax_srv.MAX_REQUEST_BYTES)


@pytest.mark.parametrize("head,sampler,backend", [
    (False, "ddpm", "auto"), (False, "ddim", "auto"), (False, "ddpm", "device"),
    (True, "ddpm", "device"),
])
def test_service_matches_jax_generator(checkpoints, head, sampler, backend):
    """One request at a full bucket of 16 rows (the tetrachoric stage runs:
    16 > m + 1) against the JAX generator's ``generate``, which calibrates
    on the host. The port calibrates on the host ("auto" on the CPU) or on
    its DeviceCalibrator ("device"). With the D3PM head the bits are each
    sampler's own draw: binary, not count-matched."""
    from osteosarcoma_diffusionmodel_tpu.generation.generator import (
        SyntheticPatientGenerator as JaxGenerator,
    )
    from osteosarcoma_diffusionmodel_torch.generation import generator as pg

    path, jmodel, params, jcfg = checkpoints[head]
    scenario = {"survival_time": 300, "event_occurred": 1, "metastasis_at_diagnosis": 1}
    jcfg.generation.sampler = sampler
    ref = JaxGenerator(jmodel, params, jcfg, checkpoints["jdims"],
                       data_stats=checkpoints["stats"]).generate(16, scenario,
                                                                 rng=jax.random.PRNGKey(3))
    service = _service(path)
    service.config.generation.calibration_backend = backend
    before = dict(pg.CALIBRATIONS)
    got = service.generate(16, scenario, sampler=sampler)
    took = "device" if backend == "device" else "host"
    assert pg.CALIBRATIONS[took] == before.get(took, 0) + 1
    assert set(got) == set(ref)
    for key in got:
        want = np.asarray(ref[key])
        assert got[key].shape == want.shape and got[key].dtype == want.dtype, key
    np.testing.assert_array_equal(got["conditions"], np.asarray(ref["conditions"]))
    assert set(np.unique(got["mutations"])) <= {0.0, 1.0}
    if not head:  # the D3PM head's bits are the model's own draw, not calibrated
        np.testing.assert_array_equal(got["mutations"].sum(0),
                                      np.asarray(ref["mutations"]).sum(0))
    for key in ("expression", "pathways"):
        np.testing.assert_allclose(np.sort(got[key], axis=0), np.sort(np.asarray(ref[key]), axis=0),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_http_json_npz_caps_and_errors(running):
    conn = running()()
    resp, body = _request(conn, "GET", "/health")
    health = json.loads(body)
    assert resp.status == 200 and health["status"] == "ok" and health["devices"] == ["cpu"]
    assert health["data_dim"] == 64

    resp, body = _request(conn, "POST", "/generate", {
        "num_samples": 3, "scenario": {"survival_time": 300, "event_occurred": 1}})
    out = json.loads(body)
    assert resp.status == 200 and out["num_samples"] == 3
    assert np.asarray(out["mutations"]).shape == (3, M)
    assert np.asarray(out["expression"]).shape == (3, 40)
    assert np.asarray(out["pathways"]).shape == (3, 14)
    assert all(v in (0.0, 1.0) for row in out["mutations"] for v in row)

    resp, body = _request(conn, "POST", "/generate", {
        "num_samples": 5, "format": "npz", "scenario": {"survival_time": 400}})
    assert resp.status == 200 and resp.getheader("Content-Type") == "application/octet-stream"
    with np.load(io.BytesIO(body)) as f:
        assert set(f.files) == {"mutations", "expression", "pathways", "conditions"}
        assert f["expression"].shape == (5, 40) and f["expression"].dtype == np.float32

    resp, body = _request(conn, "POST", "/generate", {"num_samples": srv.MAX_JSON_SAMPLES + 1})
    assert resp.status == 413 and "npz" in json.loads(body)["error"]
    resp, _ = _request(conn, "POST", "/generate", {"num_samples": 1, "format": "parquet"})
    assert resp.status == 400
    resp, _ = _request(conn, "POST", "/generate", {"num_samples": -5})
    assert resp.status == 400
    resp, _ = _request(conn, "POST", "/generate", {"num_samples": srv.MAX_BATCH + 1,
                                                   "format": "npz"})
    assert resp.status == 400
    resp, _ = _request(conn, "GET", "/nowhere")
    assert resp.status == 404
    resp, _ = _request(conn, "POST", "/health", {})
    assert resp.status == 404

    # Oversized body: a 413 before the body is read (or a broken pipe
    # mid-write: either way it was not processed).
    conn2 = http.client.HTTPConnection("127.0.0.1", conn.port, timeout=120)
    try:
        conn2.request("POST", "/generate", body=b"x" * (srv.MAX_REQUEST_BYTES + 1))
        assert conn2.getresponse().status == 413
    except (BrokenPipeError, ConnectionResetError):
        pass
    finally:
        conn2.close()

    resp, body = _request(conn, "GET", "/metrics")
    metrics = json.loads(body)
    assert resp.status == 200 and metrics["requests"] == 2 and metrics["patients"] == 8
    assert "drift_score" in metrics and metrics["p50_seconds"] > 0
    resp, body = _request(conn, "GET", "/dashboard")
    html = body.decode()
    assert resp.status == 200 and "Osteosarcoma Model Monitoring" in html and "Data drift" in html


def test_bearer_auth(running):
    conn = running(auth_token="s3cret")()
    assert _request(conn, "GET", "/health")[0].status == 200
    assert _request(conn, "GET", "/health?ready=1")[0].status == 200
    assert _request(conn, "GET", "/metrics")[0].status == 401
    assert _request(conn, "GET", "/dashboard")[0].status == 401
    assert _request(conn, "GET", "/metrics", headers={"Authorization": "Bearer wrong"})[0].status == 401
    assert _request(conn, "GET", "/metrics",
                    headers={"Authorization": "Bearer s3cr\xe9t"})[0].status == 401
    assert _request(conn, "POST", "/generate", {"num_samples": 1})[0].status == 401
    ok = {"Authorization": "Bearer s3cret"}
    resp, body = _request(conn, "POST", "/generate", {"num_samples": 1}, ok)
    assert resp.status == 200 and json.loads(body)["num_samples"] == 1
    assert _request(conn, "GET", "/metrics?verbose=1", headers=ok)[0].status == 200


def test_sampler_override_does_not_leak(ckpt):
    service = _service(ckpt)
    default = service.config.generation.sampler
    service.generate(2, sampler="ddim")
    assert service.config.generation.sampler == default
    service.warmup((2,), samplers=("ddpm", "ddim"))
    assert service.config.generation.sampler == default
    assert service.metrics["requests"] == 1 and service.metrics["warmups"] == 2
    # A failing request restores the default too.
    def fail(*args, **kwargs):
        raise RuntimeError("sampler failed")

    service.generator.generate = fail
    with pytest.raises(RuntimeError, match="sampler failed"):
        service.generate(2, sampler="ddim")
    assert service.config.generation.sampler == default


def test_warmup_does_not_pollute_metrics_drift_or_log(ckpt, tmp_path):
    service = _service(ckpt, request_log_path=str(tmp_path / "req.log"))
    service.warmup((3, 4, 64), samplers=("ddpm", "ddim"))
    assert service.metrics["warmups"] == 4  # buckets {4, 64} x 2 samplers
    assert service.metrics["requests"] == 0 and service.metrics["max_seconds"] == 0.0
    assert service.metrics["warmup_seconds"] > 0.0
    assert "p50_seconds" not in service.metrics_summary()
    assert service.drift.count == 0 and service.drift.score() == 0.0
    assert (tmp_path / "req.log").read_text() == ""
    service.generate(2, {"survival_time": 500, "patient_id": "XYZ"})
    assert service.drift.count == 2
    text = (tmp_path / "req.log").read_text()
    assert "survival_time" in text and "XYZ" not in text


def test_profile_cache_hits_stay_audited(ckpt, tmp_path):
    service = _service(ckpt, profile_cache_size=2, request_log_path=str(tmp_path / "req.log"))
    a = service.generate(3, {"survival_time": 501})
    b = service.generate(3, {"survival_time": 499})  # rounds to the same profile
    np.testing.assert_array_equal(a["expression"], b["expression"])
    assert service.metrics["cache_hits"] == 1 and service.drift.count == 6
    lines = (tmp_path / "req.log").read_text().strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[-1].split("generation ", 1)[1])["cached"] is True
    c = service.generate(3, {"survival_time": 900})
    assert service.metrics["cache_hits"] == 1
    assert not np.array_equal(a["expression"], c["expression"])
    # Off by default: each request draws its own stream.
    off = _service(ckpt)
    x, y = off.generate(3, {"survival_time": 501}), off.generate(3, {"survival_time": 501})
    assert not np.array_equal(x["expression"], y["expression"])


def test_latency_percentiles(ckpt):
    service = _service(ckpt)
    for i in range(5):
        service.generate(3, {"survival_time": 400 + i})
    m = service.metrics_summary()
    assert 0.0 < m["p50_seconds"] <= m["p95_seconds"] <= m["p99_seconds"] <= m["max_seconds"]
    assert len(service._latencies) == 5 and m["mean_seconds"] > 0


def test_tls_requires_both_cert_and_key(ckpt):
    with pytest.raises(ValueError, match="TLS"):
        serve(ckpt, port=0, warmup=False, device="cpu", tls_cert="only_cert.pem")
    with pytest.raises(ValueError, match="TLS"):
        serve(ckpt, port=0, warmup=False, device="cpu", tls_key="only_key.pem")


def test_main_parses_flags(monkeypatch):
    captured = {}

    def fake_serve(ckpt, host, port, warmup, **kwargs):
        captured.update(ckpt=ckpt, host=host, port=port, warmup=warmup, **kwargs)

        class _Server:
            def serve_forever(self):
                pass

        return _Server()

    monkeypatch.setattr(srv, "serve", fake_serve)
    srv.main(["--checkpoint-dir", "ck", "--port", "0", "--warmup-buckets", "64,1024",
              "--warmup-samplers", "ddpm,ddim", "--device", "cpu", "--profile-cache", "4",
              "--request-log", "r.log", "--auth-token", "t"])
    assert captured["warmup"] == [64, 1024] and captured["ckpt"] == "ck"
    assert captured["warmup_samplers"] == ["ddpm", "ddim"] and captured["device"] == "cpu"
    assert captured["profile_cache_size"] == 4 and captured["request_log_path"] == "r.log"
    assert captured["auth_token"] == "t"
    srv.main(["--warmup-buckets", ""])
    assert captured["warmup"] is False and captured["device"] == "cuda"
    assert captured["warmup_samplers"] == ["ddpm"]


def test_without_a_card_it_raises_unless_asked_for_the_cpu(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        GenerationService(ckpt)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve(ckpt, port=0, warmup=False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        srv.main(["--checkpoint-dir", str(ckpt), "--port", "0", "--warmup-buckets", ""])
    assert _service(ckpt).devices() == ["cpu"]


def test_d3pm_checkpoint_serves(checkpoints):
    """A D3PM-head checkpoint: the bits come out of the sampler binary and
    pass calibration unchanged, under both samplers, through the handler."""
    service = _service(checkpoints[True][0])
    assert service.generator.model.discrete_head
    for sampler in ("ddpm", "ddim"):
        out = service.generate(4, {"survival_time": 700}, sampler=sampler)
        assert out["mutations"].shape == (4, M) and set(np.unique(out["mutations"])) <= {0.0, 1.0}
    server = __import__("http.server", fromlist=["ThreadingHTTPServer"]).ThreadingHTTPServer(
        ("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        resp, body = _request(conn, "POST", "/generate", {"num_samples": 3, "sampler": "ddim"})
        assert resp.status == 200
        assert set(np.unique(json.loads(body)["mutations"])) <= {0.0, 1.0}
    finally:
        server.shutdown()
        server.server_close()
