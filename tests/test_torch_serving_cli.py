"""The port's serving launcher (``python -m zoo_tpu_torch.serving.run``)
boots the whole pipeline (embedded RESP server + serving job + HTTP
front end) from a model file with ``--device cpu``, and clients
round-trip through both protocols: copies of ``tests/test_serving_cli.py``
on the port (plain, encrypted, a plain model beside a stray secret),
plus the HA mode (``--tcp-replicas``: replica processes on
``--device``) and the refusals the port adds: ``--encrypted`` with
``--tcp-replicas`` (the replicas would load the file themselves, so the
flag would be ignored), and a model directory (the TF loader, A.16).
The SIGTERM drain exits 0.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.layers import Dense
from zoo_tpu_torch.pipeline.inference import save_encrypted
from zoo_tpu_torch.serving import run as port_run
from zoo_tpu_torch.serving.client import InputQueue, OutputQueue

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_ports(n):
    """Distinct ports: hold all sockets open until every port is drawn."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _launch_cli(args, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("ZOO_MODEL_SECRET", "ZOO_MODEL_SALT", "ZOO_MODEL_ENC_MODE"):
        env.pop(k, None)
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "zoo_tpu_torch.serving.run", "--device",
         "cpu", *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait_for_port(proc, port, timeout=90):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            assert proc.poll() is None, proc.stdout.read()[-2000:]
            time.sleep(0.2)
    raise TimeoutError("serving CLI never opened the HTTP port")


def _http_predict(port, x):
    body = json.dumps({"instances": [{"t": x.tolist()}]}).encode()
    resp = json.loads(urllib.request.urlopen(
        urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=body,
            headers={"Content-Type": "application/json"}),
        timeout=60).read())
    val = json.loads(json.loads(resp["predictions"][0])["value"])
    return np.asarray(val["data"], np.float32).reshape(-1)


def _drain(proc):
    """SIGTERM, then the drained process's exit code and output."""
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return proc.returncode, out


def _model(name, units, inputs, softmax=False):
    m = Sequential(name=name)
    if softmax:
        m.add(Dense(8, activation="relu", input_shape=(inputs,)))
        m.add(Dense(units, activation="softmax"))
    else:
        m.add(Dense(units, input_shape=(inputs,)))
    m.compile("adam", "mse")
    m.build(device="cpu")
    return m


@pytest.mark.timeout(150)
def test_serving_cli_roundtrip(tmp_path):
    m = _model("cli_served", 3, 4, softmax=True)
    model_path = m.save(str(tmp_path / "m.zoo"))
    x = np.random.RandomState(0).randn(4).astype(np.float32)
    ref = m.predict(x[None], batch_size=1, device="cpu")[0]

    redis_port, http_port = _free_ports(2)
    proc = _launch_cli(["--model", model_path, "--redis-mode", "embedded",
                        "--redis-port", str(redis_port),
                        "--http-port", str(http_port),
                        "--batch-size", "4"])
    try:
        _wait_for_port(proc, http_port)
        iq = InputQueue(host="127.0.0.1", port=redis_port)
        iq.enqueue("req1", t=x)
        oq = OutputQueue(host="127.0.0.1", port=redis_port)
        got = "[]"
        for _ in range(300):
            got = oq.query("req1")
            if not isinstance(got, str):
                break
            time.sleep(0.1)
        assert not isinstance(got, str), got
        np.testing.assert_allclose(np.asarray(got).reshape(-1), ref,
                                   atol=1e-5)
        np.testing.assert_allclose(_http_predict(http_port, x), ref,
                                   atol=1e-4)
        metrics = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{http_port}/metrics", timeout=30).read())
        assert metrics["records_out"] >= 2 and metrics["nan_records"] == 0
    finally:
        rc, out = _drain(proc)
    assert rc == 0, out[-2000:]
    assert "device cpu" in out and "drained, 2 records answered" in out


@pytest.mark.timeout(150)
def test_serving_cli_encrypted_model(tmp_path):
    """The CLI serves a model encrypted at rest with the key from the
    environment (the explicit ``--encrypted`` opt-in)."""
    m = _model("enc_served", 4, 2)
    enc = save_encrypted(m, str(tmp_path / "m.enc"), "kms-secret",
                         "kms-salt", mode="gcm")
    x = np.random.RandomState(0).randn(2).astype(np.float32)
    ref = m.predict(x[None], batch_size=1, device="cpu")[0]

    redis_port, http_port = _free_ports(2)
    proc = _launch_cli(
        ["--model", enc, "--encrypted", "--redis-mode", "embedded",
         "--redis-port", str(redis_port), "--http-port", str(http_port)],
        extra_env={"ZOO_MODEL_SECRET": "kms-secret",
                   "ZOO_MODEL_SALT": "kms-salt",
                   "ZOO_MODEL_ENC_MODE": "gcm"})
    try:
        _wait_for_port(proc, http_port)
        np.testing.assert_allclose(_http_predict(http_port, x), ref,
                                   atol=1e-4)
    finally:
        rc, out = _drain(proc)
    assert rc == 0, out[-2000:]


@pytest.mark.timeout(150)
def test_plaintext_model_ignores_stray_secret_env(tmp_path):
    """A stray ZOO_MODEL_SECRET in the environment must not reroute a
    plaintext model through decryption."""
    m = _model("plain_served", 2, 2)
    path = m.save(str(tmp_path / "m.zoo"))
    x = np.random.RandomState(1).randn(2).astype(np.float32)
    ref = m.predict(x[None], batch_size=1, device="cpu")[0]

    redis_port, http_port = _free_ports(2)
    proc = _launch_cli(
        ["--model", path, "--redis-mode", "embedded",
         "--redis-port", str(redis_port), "--http-port", str(http_port)],
        extra_env={"ZOO_MODEL_SECRET": "leftover-from-other-deploy"})
    try:
        _wait_for_port(proc, http_port)
        np.testing.assert_allclose(_http_predict(http_port, x), ref,
                                   atol=1e-4)
    finally:
        rc, out = _drain(proc)
    assert rc == 0, out[-2000:]


@pytest.mark.timeout(120)
def test_serving_cli_ha_mode_serves_over_replicas(tmp_path):
    """``--tcp-replicas``: the CLI supervises a ``ReplicaGroup`` of
    replica processes on ``--device`` and serves over the TCP door; a
    SIGTERM stops the group and exits 0."""
    from zoo_tpu_torch.serving.tcp_client import _Connection

    proc = _launch_cli(["--model", "synthetic:double", "--tcp-replicas",
                        "1", "--batch-size", "4"])
    try:
        line = ""
        deadline = time.time() + 90
        while "serving-ha: endpoints" not in line:
            assert time.time() < deadline and proc.poll() is None, line
            line = proc.stdout.readline()
        host, port = line.split()[-1].split(",")[0].rsplit(":", 1)
        conn = _Connection(host, int(port))
        try:
            resp = conn.rpc({"op": "predict", "uri": "u",
                             "data": np.ones((1, 3), np.float32)})
        finally:
            conn.close()
        np.testing.assert_array_equal(np.asarray(resp["result"]),
                                      np.full((1, 3), 2.0, np.float32))
    finally:
        rc, out = _drain(proc)
    assert rc == 0, out[-2000:]


@pytest.mark.parametrize("args,message", [
    (["--model", "m.enc", "--encrypted", "--tcp-replicas", "1"],
     "--encrypted is not served with --tcp-replicas"),
    (["--model", "m.enc", "--model-secret", "k", "--tcp-replicas", "2"],
     "--encrypted is not served with --tcp-replicas"),
    (["--registry", "/nowhere"], "--registry needs the HA TCP mode"),
    ([], "--model"),
], ids=["encrypted", "secret", "registry", "no-model"])
def test_the_cli_refuses_what_it_would_ignore(args, message, capsys):
    with pytest.raises(SystemExit) as e:
        port_run.main(["--device", "cpu", *args])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_a_model_directory_is_refused_naming_a16(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_run._load_model(port_run._parser(), port_run._parser(
            ).parse_args(["--device", "cpu", "--model", str(tmp_path)]))
    assert e.value.code == 2
    assert "A.16" in capsys.readouterr().err


def test_the_config_file_sets_model_and_batch(tmp_path):
    cfg = tmp_path / "config.yaml"
    cfg.write_text("model:\n  modelPath: /models/m.zoo  # the model\n"
                   "params:\n  batchSize: 16\nredis:\n  redisPort: '7000'\n")
    got = port_run._load_config(str(cfg))
    assert got == {"modelPath": "/models/m.zoo", "batchSize": "16",
                   "redisPort": "7000"}
