"""The RL trainer's metrics server, heartbeat and token export on the CPU:
the ``/metrics`` body and the export file byte for byte against the JAX
package's (``prometheus_client`` there, the standard library here), the
health and unknown-path answers, and a trainer run with all three on (and
int8 compute), which scrapes its own gauges, counts the heartbeat's GETs,
finds the export and leaves no thread behind. One SFT step with int8 compute.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from prime_rl_tpu.trainer.rl.token_export import TokenExporter as JTokenExporter
from prime_rl_tpu.utils.metrics_server import MetricsServer as JMetricsServer
from prime_rl_tpu_torch.configs import SFTConfig, TrainerConfig
from prime_rl_tpu_torch.ops import _build
from prime_rl_tpu_torch.ops import int8_linear as tint8
from prime_rl_tpu_torch.trainer.rl import train as train_mod
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.rl.token_export import TokenExporter
from prime_rl_tpu_torch.utils import logger as tlogger
from prime_rl_tpu_torch.utils.metrics_server import MetricsServer, float_to_go_string

torch.set_num_threads(1)

RECORDS = [
    {"loss": 0.25, "grad_norm": 3, "mismatch_kl": None, "entropy": float("inf"),
     "lr": float("-inf"), "tokens_per_sec": float("nan"), "mfu": 1e-7, "peak": 1e21,
     "run_id": "run_0", "flag": True, "perf/step@p50^2": 12345678.9, "a\\b\nc": -0.0,
     "text_number": "2.5"},
    {"loss": 0.125, "grad_norm": 2.0, "new_key": 1234567.0, "mfu": 123456.0, "entropy": 0},
]


def _get(port: int, path: str) -> tuple[int, bytes, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def test_metrics_body_health_and_404_match_jax():
    """The same records into both servers: the ``/metrics`` answers equal
    byte for byte (floats, ints, bools, None and strings skipped or parsed,
    +Inf, -Inf, NaN, 1e-7, 1e21, Go's exponent form, the name sanitizing,
    the HELP escaping, gauges in the order of their first update), the
    content type; ``/health`` 200 then 503 after ``set_healthy(False)``; an
    unknown path 404."""
    ours, theirs = MetricsServer("127.0.0.1", 0).start(), JMetricsServer("127.0.0.1", 0).start()
    try:
        for rec in RECORDS:
            ours.update(rec)
            theirs.update(rec)
            got, want = _get(ours.port, "/metrics"), _get(theirs.port, "/metrics")
            assert got == want and got[0] == 200
        assert b"prime_rl_perf_step_at_p50_hat_2 1.23456789e+07\n" in got[1]
        assert b"prime_rl_text_number 2.5" in got[1] and b"run_id" not in got[1]
        for path in ("/health", "/healthz", "/nope", "/"):
            assert _get(ours.port, path)[:2] == _get(theirs.port, path)[:2]
        assert _get(ours.port, "/health")[:2] == (200, b"ok")
        assert _get(ours.port, "/nope")[0] == 404
        ours.set_healthy(False)
        theirs.set_healthy(False)
        assert _get(ours.port, "/health")[:2] == _get(theirs.port, "/health")[:2] == (
            503, b"unhealthy")
    finally:
        ours.stop()
        theirs.stop()


@pytest.mark.parametrize("value", [0.0, -1.5, 1e-300, 1234567.0, 999999.5, 1e16, 5e-324,
                                   float("inf"), float("-inf"), float("nan"), 7])
def test_float_format_is_prometheus_client_s(value):
    from prometheus_client.utils import floatToGoString

    assert float_to_go_string(value) == floatToGoString(value)


def test_token_export_bytes_match_jax(tmp_path):
    """A fake host batch with one row's loss mask cleared: both exporters'
    ``step_N.jsonl`` equal byte for byte, under a row limit that cuts the
    batch and one that does not, and both leave the ``.STABLE`` marker."""
    batch, _ = FakeDataLoader(512, 64, 3, 2, seed=4).next_batch()
    batch.loss_mask[0, 1] = False
    rng = np.random.default_rng(0)
    batch.advantages[:] = rng.standard_normal(batch.advantages.shape).astype(np.float32)
    for rows in (2, 64):
        got = TokenExporter(tmp_path / f"t{rows}", rows).export(3, batch)
        want = JTokenExporter(tmp_path / f"j{rows}", rows).export(3, batch)
        assert got.name == want.name == "step_3.jsonl"
        assert got.read_bytes() == want.read_bytes()
        assert got.with_suffix(".STABLE").exists()
        lines = got.read_text().splitlines()
        assert len(lines) == min(rows, 5)  # 6 rows, one fully masked
        assert all(json.loads(line)["token_ids"] for line in lines)


class _Pings:
    """A local stub of the heartbeat's endpoint: counts GETs."""

    def __init__(self):
        self.count = 0
        pings = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                pings.count += 1
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


class _ScrapingSink:
    """A weight sink that publishes nothing and, at version 2, scrapes the
    trainer's metrics server (which then holds step 1's record)."""

    def __init__(self, servers: list):
        self.servers = servers
        self.scraped = None

    def publish(self, params, version: int) -> None:
        if version == 2:
            self.scraped = _get(self.servers[0].port, "/metrics")


def test_trainer_serves_metrics_pings_exports_and_stops_its_threads(tmp_path, monkeypatch):
    """Two CPU steps of the debug model (int8 MLP products, Muon) with the
    metrics server on port 0, the heartbeat at a local stub every 0.1 s and
    token export: the server answers with ``prime_rl_loss`` equal to step 1's
    loss, the stub counts at least one GET, ``token_export/step_1.jsonl`` and
    its ``.STABLE`` exist, the int8 products ran, and once ``train`` returns
    no thread it started is alive. A step that raises stops them too."""
    pings = _Pings()
    servers = []
    real = train_mod.maybe_start_metrics_server

    def capture(cfg):
        servers.append(real(cfg))
        return servers[-1]

    monkeypatch.setattr(train_mod, "maybe_start_metrics_server", capture)

    def config(out):
        return TrainerConfig(
            device="cpu", max_steps=2, output_dir=str(out),
            model={"name": "debug", "attn": {"impl": "xla"}, "lm_head_chunk_size": 48,
                   "quantized_compute": "int8"},
            optimizer={"type": "muon"},
            data={"type": "fake", "seq_len": 64, "micro_batch_size": 2, "num_micro_batches": 2},
            batch={"seq_len": 64, "micro_batch_size": 2, "num_micro_batches": 2},
            metrics_server={"enable": True, "host": "127.0.0.1", "port": 0},
            heartbeat_url=f"http://127.0.0.1:{pings.httpd.server_port}/ping",
            heartbeat_interval=0.1, token_export_rows=3)

    before = set(threading.enumerate())
    sink = _ScrapingSink(servers)
    _build.reset_launches()
    try:
        result = train_mod.train(config(tmp_path / "run"), weight_sink=sink)
    finally:
        tlogger.reset_logger()
    try:
        assert len(result.records) == 2 and all(np.isfinite(r["loss"]) for r in result.records)
        assert _build.launches[tint8.COUNT] > 0
        status, body, ctype = sink.scraped
        assert status == 200 and ctype == "text/plain; version=0.0.4"
        lines = body.decode().splitlines()
        assert f"prime_rl_loss {float_to_go_string(result.records[0]['loss'])}" in lines
        assert "prime_rl_step 1.0" in lines
        assert pings.count >= 1
        export = tmp_path / "run" / "token_export"
        assert (export / "step_1.jsonl").read_text() and (export / "step_1.STABLE").exists()
        assert len((export / "step_0.jsonl").read_text().splitlines()) == 3
        alive = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        assert not alive, alive

        # a step that raises: the server and the heartbeat stop all the same
        def boom(*a, **k):
            raise RuntimeError("step failed")

        monkeypatch.setattr(train_mod, "make_train_step", lambda *a, **k: boom)
        with pytest.raises(RuntimeError, match="step failed"):
            train_mod.train(config(tmp_path / "raise"), weight_sink=_ScrapingSink(servers))
        tlogger.reset_logger()
        alive = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        assert not alive, alive
        with pytest.raises(OSError):
            _get(servers[-1].port, "/health")
    finally:
        pings.close()


def test_sft_step_with_int8_compute(tmp_path):
    """One SFT step on the debug model with ``quantized_compute = "int8"``:
    a finite loss, through the int8 products (``trainer/step.py`` hands the
    setting to the forward for SFT as for RL)."""
    from prime_rl_tpu_torch.trainer.sft.train import train as sft_train

    _build.reset_launches()
    try:
        result = sft_train(SFTConfig(output_dir=str(tmp_path), device="cpu", max_steps=1,
                                     model={"name": "debug", "quantized_compute": "int8",
                                            "attn": {"impl": "xla"}, "lm_head_chunk_size": 48},
                                     data={"type": "fake", "seq_len": 64, "batch_size": 4,
                                           "micro_batch_size": 2}))
    finally:
        tlogger.reset_logger()
    assert len(result.records) == 1 and np.isfinite(result.records[0]["loss"])
    assert _build.launches[tint8.COUNT] > 0
