"""Serving API of the PyTorch port: synthetic patients over HTTP.

    python -m osteosarcoma_diffusionmodel_torch.serving.server \
        --checkpoint-dir <port checkpoint dir> --port 8080 --warmup-buckets 64,1024

Counterpart of osteosarcoma_diffusionmodel_tpu/serving/server.py, on the
standard library's HTTP server:

    POST /generate   {"num_samples": N, "scenario": {...},
                      "sampler": "ddpm"|"ddim", "format": "json"|"npz"}
    GET  /health     -> {"status": "ok", "devices": [...], ...}
    GET  /metrics    -> request counts, latency p50/p95/p99, drift score
    GET  /dashboard  -> the monitoring page (HTML)

A request runs ``SyntheticPatientGenerator.generate`` on its batch bucket
(the next power of two): conditions (widened by the latent prior's draws
for a latent-factor checkpoint), the kernel sampler (the scan sampler for
the variants that the JAX package samples without its kernel), then the
calibration, on the card for buckets of 256 rows or more under the
shipped "auto" backend, and the AR head's draw of the mutation bits for
an AR checkpoint. The service runs on the CUDA card; the CPU serves
only when asked (``--device cpu``): without a card and without that flag
the service raises. The kernels are built in :func:`serve`, before the
socket opens, so no request runs nvcc. One lock serializes every
request's device work: the kernels' split-K workspace is one per device
and assumes launches ordered on one stream.
"""

from __future__ import annotations

import hmac
import io
import json
import logging
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..generation.generator import SyntheticPatientGenerator, load_trained_model, seeded_generator
from ..ops import _build
from ..training.checkpoint import load_data_stats
from .monitoring import DriftMonitor, SecureRequestLog, render_dashboard

logger = logging.getLogger(__name__)

MAX_BATCH = 16384
# A JSON body of 16384 x 5142 floats is multi-GB; above this cohort size
# the client must request {"format": "npz"} (compressed binary) or page
# the request.
MAX_JSON_SAMPLES = 1024
MAX_REQUEST_BYTES = 1_000_000


def _bucket(n: int) -> int:
    """Round up to the next power of two, at most MAX_BATCH."""
    b = 1
    while b < n:
        b *= 2
    return min(b, MAX_BATCH)


class GenerationService:
    """A loaded checkpoint and its generator on ``device``, thread-safe."""

    def __init__(self, checkpoint_dir: str | Path, config: Optional[Config] = None,
                 request_log_path: Optional[str] = None, profile_cache_size: int = 0,
                 device="cuda"):
        """``profile_cache_size`` > 0 turns on the common-profile cache:
        identical (rounded scenario, bucket, sampler) requests return the
        same cohort, a deliberate change from fresh sampling per request.
        Request i draws from ``seeded_generator(training.random_seed, i)``."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu (device='cpu') "
                               "to serve the PyTorch port on the CPU")
        model, config, dims = load_trained_model(checkpoint_dir, config)
        self.config = config
        self.dims = dims
        data_stats = load_data_stats(checkpoint_dir)
        self.generator = SyntheticPatientGenerator(model, config, dims, data_stats=data_stats,
                                                   device=device)
        self.drift: Optional[DriftMonitor] = None
        if data_stats is not None and "condition_mean" in data_stats:
            self.drift = DriftMonitor(data_stats["condition_mean"], data_stats["condition_std"],
                                      dims.condition_names)
        self.request_log: Optional[SecureRequestLog] = (
            SecureRequestLog(request_log_path) if request_log_path else None)
        self._lock = threading.Lock()
        self._seed = 0  # requests drawn so far: each one's stream index
        self._profile_cache_size = profile_cache_size
        self._profile_cache: Dict = {}  # insertion-ordered (LRU evict)
        self.metrics: Dict[str, float] = {
            "requests": 0, "patients": 0, "total_seconds": 0.0, "max_seconds": 0.0,
            "cache_hits": 0, "warmups": 0, "warmup_seconds": 0.0,
        }
        # Latencies of served requests (not warmups, not cache hits) for
        # the p50/p95/p99 in /metrics.
        self._latencies: deque = deque(maxlen=1024)

    def devices(self) -> List[str]:
        """The generator's device, with the card's name on CUDA."""
        dev = self.generator.device
        if dev.type == "cuda":
            return [f"{dev}: {torch.cuda.get_device_name(dev)}"]
        return [str(dev)]

    @staticmethod
    def _profile_key(scenario: Optional[Dict], bucket: int, sampler: str):
        """Cache key with rounded conditions: survival to the nearest 100
        days, other numbers to 2 decimals; None for a freeform scenario."""
        rounded = []
        for k in sorted(scenario or {}):
            v = (scenario or {})[k]
            if not isinstance(v, (int, float, bool)):
                return None
            if k == "survival_time":
                v = round(float(v) / 100.0) * 100.0
            else:
                v = round(float(v), 2)
            rounded.append((k, v))
        return (tuple(rounded), bucket, sampler)

    def warmup(self, batches=(64,), samplers=("ddpm",)) -> None:
        """Run each (bucket, sampler) pair once, largest bucket first, so
        the first request of a pair pays no set-up (the sampler's tables,
        its weights on the card, the calibrator's constants)."""
        if isinstance(batches, int):
            batches = (batches,)
        if isinstance(samplers, str):
            samplers = (samplers,)
        for s in samplers:
            for b in sorted({_bucket(int(b)) for b in batches}, reverse=True):
                self.generate(b, scenario={"survival_time": 800}, sampler=s, internal=True)

    def generate(self, num_samples: int, scenario: Optional[Dict] = None,
                 sampler: Optional[str] = None, internal: bool = False) -> Dict[str, np.ndarray]:
        """One request. ``internal`` marks warmup traffic: it stays out of
        the latency metrics, the drift monitor and the request log, and its
        wall time is counted as warmup_seconds."""
        if not 1 <= num_samples <= MAX_BATCH:
            raise ValueError(f"num_samples must be in [1, {MAX_BATCH}]")
        bucket = _bucket(num_samples)
        cache_key = None
        if self._profile_cache_size > 0 and not internal:
            cache_key = self._profile_key(scenario, bucket,
                                          sampler or self.config.generation.sampler)
            if cache_key is not None:
                with self._lock:
                    cached = self._profile_cache.get(cache_key)
                    if cached is not None:
                        self._profile_cache.pop(cache_key)  # refresh the LRU position
                        self._profile_cache[cache_key] = cached
                        self.metrics["requests"] += 1
                        self.metrics["patients"] += num_samples
                        self.metrics["cache_hits"] += 1
                # A cached cohort is still a served request: drift and the
                # audit log see it (marked cached=True).
                if cached is not None:
                    if self.drift is not None:
                        self.drift.update(cached["conditions"][:num_samples])
                    if self.request_log is not None:
                        self.request_log.log_generation(
                            scenario, num_samples, sampler or self.config.generation.sampler,
                            0.0, cached=True)
                    return {k: v[:num_samples] for k, v in cached.items()}
        t0 = time.perf_counter()
        # The whole generate runs under the lock: the device work is one
        # stream's, and the per-request sampler override must not race
        # another request's read of the shared config.
        with self._lock:
            self._seed += 1
            default_sampler = self.config.generation.sampler
            if sampler:
                self.config.generation.sampler = sampler
            try:
                out = self.generator.generate(bucket, scenario, generator=seeded_generator(
                    self.config.training.random_seed, self._seed))
            finally:
                self.config.generation.sampler = default_sampler
            dt = time.perf_counter() - t0
            if internal:
                self.metrics["warmups"] += 1
                self.metrics["warmup_seconds"] += dt
            else:
                self.metrics["requests"] += 1
                self.metrics["patients"] += num_samples
                self.metrics["total_seconds"] += dt
                self.metrics["max_seconds"] = max(self.metrics["max_seconds"], dt)
                self._latencies.append(dt)
        if not internal:
            if self.drift is not None:
                self.drift.update(out["conditions"][:num_samples])
            if self.request_log is not None:
                self.request_log.log_generation(
                    scenario, num_samples, sampler or self.config.generation.sampler, dt)
        if cache_key is not None:
            with self._lock:
                self._profile_cache[cache_key] = out
                while len(self._profile_cache) > self._profile_cache_size:
                    self._profile_cache.pop(next(iter(self._profile_cache)))
        return {k: v[:num_samples] for k, v in out.items()}

    def metrics_summary(self) -> Dict[str, float]:
        """The metrics with derived fields: mean and p50/p95/p99 latency,
        drift score."""
        m = dict(self.metrics)
        if m["requests"]:
            m["mean_seconds"] = m["total_seconds"] / m["requests"]
        if self._latencies:
            lat = np.sort(np.asarray(self._latencies))
            for q, name in ((50, "p50"), (95, "p95"), (99, "p99")):
                m[f"{name}_seconds"] = float(np.percentile(lat, q))
        if self.drift is not None:
            m["drift_score"] = self.drift.score()
        return m


def make_handler(service: GenerationService, auth_token: Optional[str] = None):
    """The request handler. With ``auth_token`` set, every endpoint but
    GET /health (left open for load-balancer checks) needs
    ``Authorization: Bearer <token>``, compared in constant time; a
    missing or wrong token is a 401."""

    class Handler(BaseHTTPRequestHandler):
        timeout = 120  # a stalled client cannot hold a handler thread forever

        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        @property
        def route(self) -> str:
            return self.path.split("?", 1)[0]

        def _authorized(self) -> bool:
            if auth_token is None or self.route == "/health":
                return True
            header = self.headers.get("Authorization", "")
            # Bytes: compare_digest raises on non-ASCII str, and a malformed
            # header must give a 401, not a 500.
            return hmac.compare_digest(header.encode("utf-8", "surrogateescape"),
                                       f"Bearer {auth_token}".encode("utf-8", "surrogateescape"))

        def _send_bytes(self, code: int, body: bytes, content_type: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send(self, code: int, payload: Dict):
            self._send_bytes(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            if not self._authorized():
                self._send(401, {"error": "missing or invalid bearer token"})
                return
            if self.route == "/health":
                self._send(200, {
                    "status": "ok",
                    "architecture": service.config.model.architecture,
                    "data_dim": service.dims.data_dim,
                    "devices": service.devices(),
                })
            elif self.route == "/metrics":
                self._send(200, service.metrics_summary())
            elif self.route == "/dashboard":
                body = render_dashboard(service.metrics_summary(), service.drift, {
                    "architecture": service.config.model.architecture,
                    "data_dim": service.dims.data_dim,
                    "conditions": ", ".join(service.dims.condition_names),
                    "devices": ", ".join(service.devices()),
                })
                self._send_bytes(200, body.encode(), "text/html; charset=utf-8")
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if not self._authorized():
                self._send(401, {"error": "missing or invalid bearer token"})
                return
            if self.route != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_REQUEST_BYTES:
                    self._send(413, {"error": f"request body exceeds {MAX_REQUEST_BYTES} bytes"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                num_samples = int(req.get("num_samples", 1))
                fmt = str(req.get("format", "json")).lower()
                if fmt not in ("json", "npz"):
                    self._send(400, {"error": f"unknown format {fmt!r}"})
                    return
                if fmt == "json" and num_samples > MAX_JSON_SAMPLES:
                    self._send(413, {"error": (
                        f"JSON responses are capped at {MAX_JSON_SAMPLES} samples; request "
                        f"{{'format': 'npz'}} for large cohorts or page the request")})
                    return
                out = service.generate(num_samples, req.get("scenario"), req.get("sampler"))
                if fmt == "npz":
                    buf = io.BytesIO()
                    np.savez_compressed(buf, **out)
                    self._send_bytes(200, buf.getvalue(), "application/octet-stream", [
                        ("Content-Disposition", "attachment; filename=synthetic_patients.npz")])
                    return
                self._send(200, {
                    "num_samples": len(out["mutations"]),
                    "mutations": out["mutations"].tolist(),
                    "expression": out["expression"].tolist(),
                    "pathways": out["pathways"].tolist(),
                    "conditions": out["conditions"].tolist(),
                })
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})

    return Handler


def serve(checkpoint_dir: str | Path, host: str = "127.0.0.1", port: int = 8080,
          config: Optional[Config] = None, warmup: bool | tuple | list = True,
          auth_token: Optional[str] = None, tls_cert: Optional[str] = None,
          tls_key: Optional[str] = None, warmup_samplers: tuple | list = ("ddpm",),
          request_log_path: Optional[str] = None, profile_cache_size: int = 0,
          device="cuda") -> ThreadingHTTPServer:
    """Start the service; returns the server (call ``serve_forever()``).

    On the card the kernels are built (or loaded) first, then ``warmup``
    runs (a list of batch buckets; True means the 64 bucket), all before
    the socket opens, so a health check never routes traffic to a server
    that would stall. ``auth_token`` turns on bearer auth (every endpoint
    but /health); ``tls_cert`` with ``tls_key`` (PEM paths) wraps the
    socket in TLS."""
    if (tls_cert or tls_key) and not (tls_cert and tls_key):
        raise ValueError("TLS requires both tls_cert and tls_key")
    service = GenerationService(checkpoint_dir, config, request_log_path=request_log_path,
                                profile_cache_size=profile_cache_size, device=device)
    if service.generator.device.type == "cuda":
        t0 = time.perf_counter()
        _build.LIBRARY.get()
        logger.info("Kernels ready in %.1f s", time.perf_counter() - t0)
    if warmup:
        service.warmup((64,) if warmup is True else warmup, samplers=warmup_samplers)
    server = ThreadingHTTPServer((host, port), make_handler(service, auth_token))
    if tls_cert:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile=tls_cert, keyfile=tls_key)
        # Handshake in the connection's handler thread, not in the accept
        # loop, where one stalled client would block every other.
        server.socket = ctx.wrap_socket(server.socket, server_side=True,
                                        do_handshake_on_connect=False)
    server.service = service
    logger.info("Serving on %s://%s:%d%s", "https" if tls_cert else "http", host,
                server.server_address[1], " (bearer auth)" if auth_token else "")
    return server


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Synthetic patient API server (PyTorch port)")
    parser.add_argument("--checkpoint-dir", default="./results/checkpoints")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--warmup-buckets", default="64",
                        help="comma-separated batch buckets to run once at startup "
                        "(e.g. '64,1024,16384'); empty string skips warmup")
    parser.add_argument("--auth-token", default=os.environ.get("OSDM_AUTH_TOKEN"),
                        help="require 'Authorization: Bearer <token>' on all endpoints but "
                        "/health (default: $OSDM_AUTH_TOKEN; unset = open)")
    parser.add_argument("--tls-cert", help="PEM certificate path (enables TLS)")
    parser.add_argument("--tls-key", help="PEM private-key path")
    parser.add_argument("--warmup-samplers", default="ddpm",
                        help="comma-separated samplers to warm per bucket (e.g. 'ddpm,ddim')")
    parser.add_argument("--request-log",
                        help="path for the PHI-safe rotating request log (allowlisted "
                        "scenario fields only; off when unset)")
    parser.add_argument("--profile-cache", type=int, default=0,
                        help="cache cohorts for up to N common (rounded-scenario, bucket, "
                        "sampler) profiles: identical requests return the SAME cohort "
                        "(0 = off, fresh sampling per request)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' serves on the CPU)")
    args = parser.parse_args(argv)
    buckets = [int(b) for b in args.warmup_buckets.split(",") if b.strip()]
    samplers = [s for s in args.warmup_samplers.split(",") if s.strip()]
    server = serve(
        args.checkpoint_dir, args.host, args.port,
        warmup=buckets or False,
        auth_token=args.auth_token,
        tls_cert=args.tls_cert,
        tls_key=args.tls_key,
        warmup_samplers=samplers or ("ddpm",),
        request_log_path=args.request_log,
        profile_cache_size=args.profile_cache,
        device=args.device,
    )
    server.serve_forever()


if __name__ == "__main__":
    main()
