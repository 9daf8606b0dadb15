"""Runtime settings and logging of the port against the reference.

- ``dynamo_tpu_torch.utils.config``: every case of the reference's
  ``tests/test_utils_config.py`` (defaults, the TOML layer under env,
  ``DYN_CONFIG_PATH``, ``RuntimeSettings`` from env), each run through
  both packages with the results equal field for field, plus seeded
  layerings of env, TOML and ``DYN_CONFIG_PATH`` that give equal
  ``RuntimeSettings`` in both.
- The logging cases of that file on the port's ``utils/logging.py``
  (filters, JSONL records), the stage attribution of the reference's
  ``stage_summary`` against the port's ``span_breakdown`` (the port keeps
  one), and ``Context.add_stage``.
- The front's drain: each package's ``in=http`` front, SIGTERMed with one
  stream in flight under ``DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT=0.5``. The
  port's exits within ``DRAIN_EXIT_S``, seconds before its stream would
  end (it waited a fixed 30 s before); the reference's outlives its
  setting until the stream ends (aiohttp's own 60 s shutdown grace, a
  fault the port does not copy).

Tolerance: exact equality, but the drain's exit time (within
``DRAIN_EXIT_S`` of the SIGTERM).
"""

import dataclasses
import io
import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dynamo_tpu.utils import config as ref_config
from dynamo_tpu.utils import logging as ref_logging
from dynamo_tpu_torch.utils import config as port_config
from dynamo_tpu_torch.utils import logging as port_logging

REPO = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class _Cfg:
    workers: int = 4
    rate: float = 1.5
    debug: bool = False
    name: str = "default"


def _both(*args, **kw):
    """``from_settings`` of each package on the same inputs, as dicts."""
    return [dataclasses.asdict(mod.from_settings(*args, **kw))
            for mod in (ref_config, port_config)]


def test_defaults_when_nothing_set():
    ref, port = _both(_Cfg, "TEST_X_", config_files=())
    assert ref == port == dataclasses.asdict(_Cfg())


def test_toml_layer_then_env_wins(tmp_path, monkeypatch):
    toml = tmp_path / "conf.toml"
    toml.write_text('workers = 8\nname = "from-toml"\nunknown_key = 1\n')
    ref, port = _both(_Cfg, "TEST_X_", config_files=(str(toml),))
    assert ref == port and port["workers"] == 8 and port["name"] == "from-toml"

    monkeypatch.setenv("TEST_X_WORKERS", "16")
    monkeypatch.setenv("TEST_X_DEBUG", "true")
    monkeypatch.setenv("TEST_X_RATE", "2.25")
    monkeypatch.setenv("TEST_X_NAME", "")  # empty == unset (reference semantics)
    ref, port = _both(_Cfg, "TEST_X_", config_files=(str(toml),))
    assert ref == port == dict(workers=16, rate=2.25, debug=True,
                               name="from-toml")


def test_dyn_config_path_env(tmp_path, monkeypatch):
    toml = tmp_path / "site.toml"
    toml.write_text("workers = 32\n")
    monkeypatch.setenv("DYN_CONFIG_PATH", str(toml))
    ref, port = _both(_Cfg, "TEST_X_", config_files=())
    assert ref == port and port["workers"] == 32


def test_runtime_settings_env(monkeypatch):
    monkeypatch.setenv("DYN_RUNTIME_NUM_WORKER_THREADS", "3")
    monkeypatch.setenv("DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT", "7.5")
    ref = ref_config.RuntimeSettings.from_settings()
    port = port_config.RuntimeSettings.from_settings()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert port.num_worker_threads == 3
    assert port.graceful_shutdown_timeout == 7.5


def test_bad_env_value_raises_in_both(monkeypatch):
    monkeypatch.setenv("TEST_X_WORKERS", "many")
    for mod in (ref_config, port_config):
        with pytest.raises(ValueError):
            mod.from_settings(_Cfg, "TEST_X_", config_files=())


@pytest.mark.parametrize("seed", range(8))
def test_runtime_settings_layers_match_the_reference(seed, tmp_path,
                                                     monkeypatch):
    """A seeded mix of ``[runtime]`` sections in TOML files (the
    reference's ``section``; a missing file skipped), a ``DYN_CONFIG_PATH``
    file over them, and ``DYN_RUNTIME_*`` / ``DYN_WORKER_*`` env (some
    empty) gives equal ``RuntimeSettings`` in both packages, through
    ``RuntimeSettings.from_settings`` and ``from_settings`` alike."""
    rng = np.random.default_rng(seed)
    for var in ("DYN_RUNTIME_NUM_WORKER_THREADS",
                "DYN_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT",
                "DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT", "DYN_CONFIG_PATH"):
        monkeypatch.delenv(var, raising=False)

    def section(path):
        keys = {"num_worker_threads": int(rng.integers(1, 64)),
                "graceful_shutdown_timeout": float(rng.integers(1, 120)) / 4,
                "unknown": 1}
        lines = [f"{k} = {v}" for k, v in keys.items() if rng.random() < 0.6]
        path.write_text("[runtime]\n" + "\n".join(lines) + "\n"
                        + ("[other]\nnum_worker_threads = 99\n"
                           if rng.random() < 0.5 else ""))
        return str(path)

    files = (section(tmp_path / "defaults.toml"),
             str(tmp_path / "missing.toml"))
    if rng.random() < 0.7:
        monkeypatch.setenv("DYN_CONFIG_PATH", section(tmp_path / "site.toml"))
    if rng.random() < 0.5:
        monkeypatch.setenv("DYN_RUNTIME_NUM_WORKER_THREADS",
                           str(int(rng.integers(1, 64))) if rng.random() < 0.8
                           else "")
    if rng.random() < 0.5:
        monkeypatch.setenv("DYN_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT",
                           str(float(rng.integers(1, 40)) / 2))
    if rng.random() < 0.5:
        monkeypatch.setenv("DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT",
                           str(float(rng.integers(1, 40)) / 8)
                           if rng.random() < 0.8 else "")

    settings = [dataclasses.asdict(mod.RuntimeSettings.from_settings())
                for mod in (ref_config, port_config)]
    assert settings[0] == settings[1]
    layered = _both(port_config.RuntimeSettings, "DYN_RUNTIME_",
                    config_files=files, section="runtime")
    assert layered[0] == layered[1]


# ---------------------------------------------------------------- logging


def test_parse_filter_spec():
    spec = "warn,dynamo_tpu.engine=debug,aiohttp=error"
    root, per = port_logging.parse_filter(spec)
    assert (root, per) == ref_logging.parse_filter(spec)
    assert root == logging.WARNING
    assert per == {"dynamo_tpu.engine": logging.DEBUG, "aiohttp": logging.ERROR}


def _jsonl_line(mod, monkeypatch):
    monkeypatch.setenv("DYN_LOGGING_JSONL", "1")
    monkeypatch.setenv("DYN_LOG", "info,quiet.mod=error")
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    buf = io.StringIO()
    mod.setup_logging(stream=buf)
    try:
        logging.getLogger("test.target").info(
            "hello %s", "world", extra={"request_id": "r1"}
        )
        logging.getLogger("quiet.mod").info("suppressed")
        return [json.loads(line) for line in buf.getvalue().splitlines() if line]
    finally:
        root.handlers[:], _ = saved
        root.setLevel(saved[1])
        logging.getLogger("quiet.mod").setLevel(logging.NOTSET)


def test_setup_logging_jsonl(monkeypatch):
    (ref,) = _jsonl_line(ref_logging, monkeypatch)
    (port,) = _jsonl_line(port_logging, monkeypatch)
    for rec in (ref, port):
        assert rec["level"] == "INFO"
        assert rec["target"] == "test.target"
        assert rec["message"] == "hello world"
        assert rec["request_id"] == "r1"
        assert "time" in rec
    assert set(ref) == set(port)


def test_stage_summary():
    """The reference's ``stage_summary`` and the port's ``span_breakdown``
    attribute each gap to the mark that closes it (marks record phase
    completions); the tail to now is ``egress``."""
    from dynamo_tpu_torch.telemetry.tracing import span_breakdown

    stages = [("http", 1.0), ("preprocess", 1.010), ("generate", 1.025)]
    s = ref_logging.stage_summary(stages)
    assert s.startswith("preprocess=10.0ms generate=15.0ms egress=")
    spans = span_breakdown(stages, end=1.5)
    assert [(x["name"], f"{x['duration_s'] * 1e3:.1f}") for x in spans[:2]] == [
        tuple(part.removesuffix("ms").split("=")) for part in s.split()[:2]]
    assert spans[2]["name"] == "egress"
    assert ref_logging.stage_summary([]) == "" and span_breakdown([]) == []


def test_context_add_stage():
    from dynamo_tpu.runtime.engine import Context as RefContext
    from dynamo_tpu_torch.runtime.engine import Context

    got = []
    for cls in (RefContext, Context):
        ctx = cls({"x": 1})
        ctx.add_stage("http")
        mapped = ctx.map({"y": 2})
        mapped.add_stage("preprocess")
        # stages survive map(): shared baggage
        got.append([s for s, _ in ctx.stages])
    assert got[0] == got[1] == ["http", "preprocess"]


# ------------------------------------------------------------ the front's drain

DRAIN_TIMEOUT_S = 0.5
DRAIN_EXIT_S = 6.0        # SIGTERM to exit, the drain's 0.5 s included
STREAM_WORDS = 240        # × 50 ms a token: a 12 s stream
CLI_START_S = 120


def _front_drain(module):
    """Start ``module``'s ``in=http out=echo_full`` front, open one slow
    stream, SIGTERM the front once the stream's first chunk is in, and
    return (seconds from SIGTERM to exit, whether the stream ended, rc)."""
    env = dict(os.environ, DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT=str(DRAIN_TIMEOUT_S),
               DYN_TOKEN_ECHO_DELAY_MS="50", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "in=http", "out=echo_full",
         "--http-host", "127.0.0.1", "--http-port", "0"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = None
        deadline = time.monotonic() + CLI_START_S
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, f"{module} did not start: {proc.stderr.read()[-2000:]}"

        first, done = threading.Event(), []

        def stream():
            body = {"model": "echo", "stream": True, "max_tokens": 2000,
                    "messages": [{"role": "user",
                                  "content": "word " * STREAM_WORDS}]}
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    for raw in resp:
                        if raw.startswith(b"data: "):
                            first.set()
                        if raw.strip() == b"data: [DONE]":
                            done.append(True)
            except OSError:
                pass  # the front went away mid-stream
            finally:
                first.set()

        t = threading.Thread(target=stream, daemon=True)
        t.start()
        assert first.wait(60)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        exit_s = time.monotonic() - t0
        t.join(timeout=30)
        return exit_s, bool(done), rc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_front_drain_follows_the_runtime_settings():
    """Under ``DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT=0.5`` the port's front
    stops taking requests on SIGTERM, waits the half second for the stream
    in flight and exits while it still streams (a 12 s stream: the port's
    old fixed 30 s drain let it finish). The reference's front keeps a
    fault here: past its own 0.5 s wait, ``HttpService.stop`` runs aiohttp's
    ``AppRunner.cleanup``, whose 60 s shutdown grace waits for the stream's
    handler, so it exits only when the stream ends."""
    ref_s, ref_done, ref_rc = _front_drain("dynamo_tpu.cli.run")
    port_s, port_done, port_rc = _front_drain("dynamo_tpu_torch.cli.run")
    assert ref_rc == port_rc == 0
    assert not port_done
    assert DRAIN_TIMEOUT_S <= port_s < DRAIN_EXIT_S, port_s
    assert ref_done and ref_s >= DRAIN_EXIT_S, (ref_s, ref_done)
