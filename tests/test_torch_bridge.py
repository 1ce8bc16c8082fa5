"""The port's PcaBackend bridge against the JAX package's.

The cases of the JAX package's ``tests/test_bridge.py`` on the port's
``TorchPcaBackend`` (on the CPU) and ``PcaBridgeServer``: the in-process
backend and the bridge over a real socket give coordinates within 1e-4 of
the f64 golden and of the JAX backend's, in every pairing of the two
packages' clients and servers; the error replies are the JAX server's
bytes; the repo's external-driver example, its C++ client and (where a JDK
exists) its Java client work against the port's server unchanged.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_examples_tpu.bridge import (
    PcaBridgeClient as JaxClient,
    PcaBridgeServer as JaxServer,
    TpuPcaBackend,
)
from spark_examples_tpu.bridge.backend import (
    iter_call_batches as jax_iter_call_batches,
)
from spark_examples_tpu_torch.bridge import (
    PcaBridgeClient,
    PcaBridgeServer,
    TorchPcaBackend,
    iter_call_batches,
)
from spark_examples_tpu_torch.ops.pcoa import (
    mllib_principal_components_reference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_calls(n, v, seed=0):
    rng = np.random.default_rng(seed)
    return [
        list(rng.choice(n, size=rng.integers(1, n), replace=False))
        for _ in range(v)
    ]


def _golden(calls, n, k):
    x = np.zeros((n, len(calls)))
    for col, idx in enumerate(calls):
        x[idx, col] = 1
    return mllib_principal_components_reference(x @ x.T, k)[0]


def _backend(**kw):
    return TorchPcaBackend(device="cpu", **kw)


@pytest.fixture()
def port_server():
    server = PcaBridgeServer(_backend(block_variants=16)).start()
    yield server
    server.stop()


@pytest.fixture()
def jax_server():
    server = JaxServer(TpuPcaBackend(block_variants=16)).start()
    yield server
    server.stop()


def test_inprocess_backend_matches_golden():
    calls = _random_calls(17, 120)
    coords, eigvals = _backend(block_variants=32).compute(iter(calls), 17, 2)
    np.testing.assert_allclose(coords, _golden(calls, 17, 2),
                               atol=COORD_TOL)
    assert eigvals.shape == (2,)
    jax_coords, jax_eigvals = TpuPcaBackend(block_variants=32).compute(
        iter(calls), 17, 2)
    np.testing.assert_allclose(coords, jax_coords, atol=COORD_TOL)
    np.testing.assert_allclose(eigvals, jax_eigvals, rtol=1e-5)


def test_the_default_backend_is_the_card():
    backend = TorchPcaBackend()
    assert backend.device == "cuda" and backend.block_variants == 8192
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            backend.compute(iter([[0]]), 2, 1)


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_socket_bridge_round_trip(
        client_pkg, server_pkg, port_server, jax_server):
    calls = _random_calls(11, 60, seed=2)
    server = port_server if server_pkg == "port" else jax_server
    client = (PcaBridgeClient if client_pkg == "port" else JaxClient)(
        port=server.port)
    try:
        coords, eigvals = client.compute(calls, 11, 2, batch_size=7)
    finally:
        client.close()
    np.testing.assert_allclose(coords, _golden(calls, 11, 2),
                               atol=COORD_TOL)
    jax_coords, _ = TpuPcaBackend(block_variants=16).compute(
        iter(calls), 11, 2)
    np.testing.assert_allclose(coords, jax_coords, atol=COORD_TOL)
    assert eigvals.shape == (2,)


def _raw_reply(port, lines):
    with socket.create_connection(("127.0.0.1", port)) as sock:
        f = sock.makefile("rwb")
        for line in lines:
            f.write(line + b"\n")
        f.flush()
        return f.readline()


@pytest.mark.parametrize(
    "lines",
    [
        [b'{"cmd": "finish"}'],
        [b'{"cmd": "bogus"}'],
        [b'{"cmd": "init", "n_samples": 3, "num_pc": 0}',
         b'{"cmd": "calls", "batch": [[0]]}', b'{"cmd": "finish"}'],
    ],
    ids=["finish-before-init", "unknown-cmd", "bad-num-pc"],
)
def test_error_replies_are_the_jax_servers_bytes(
        lines, port_server, jax_server):
    port_reply = _raw_reply(port_server.port, lines)
    assert "error" in json.loads(port_reply)
    assert port_reply == _raw_reply(jax_server.port, lines)


def test_bridge_invalid_num_pc_reported(port_server):
    client = PcaBridgeClient(port=port_server.port)
    try:
        with pytest.raises(RuntimeError, match="num_pc"):
            client.compute([[0]], 3, 0)
    finally:
        client.close()


@pytest.mark.parametrize("n", [0, 5, 7, 14])
def test_batches_are_the_jax_clients(n):
    calls = _random_calls(9, n, seed=n)
    assert list(iter_call_batches(calls, 7)) == list(
        jax_iter_call_batches(calls, 7))


def test_external_driver_example_script(tmp_path):
    """The repo's example driver (the JAX package's client) runs end to
    end against the port's server."""
    server = PcaBridgeServer(_backend(block_variants=64)).start()
    try:
        out = subprocess.run(
            [
                sys.executable,
                os.path.join(ROOT, "examples", "external_driver_pca.py"),
                "--port", str(server.port),
                "--samples", "8",
                "--variants", "40",
            ],
            env={**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"},
            capture_output=True,
            timeout=120,
            text=True,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        lines = [l for l in out.stdout.strip().split("\n") if "\t" in l]
        assert len(lines) == 8  # one coordinate row per sample
    finally:
        server.stop()


def test_bridge_from_cpp_client(tmp_path):
    """A C++ TCP client (the repo's example, unchanged) speaks the
    newline-JSON protocol against the port's server."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    binary = tmp_path / "pca_bridge_client"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-o", str(binary),
         os.path.join(ROOT, "examples", "pca_bridge_client.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    server = PcaBridgeServer(_backend(block_variants=16)).start()
    try:
        out = subprocess.run([str(binary), str(server.port)],
                             capture_output=True, timeout=120, text=True)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "bridge ok" in out.stdout
    finally:
        server.stop()


def test_bridge_from_jvm_client(tmp_path):
    """The repo's dependency-free Java client against the port's server;
    compiles and runs only where a JDK exists."""
    javac, java = shutil.which("javac"), shutil.which("java")
    if javac is None or java is None:
        pytest.skip("no JDK on this host (javac/java not found)")
    subprocess.run(
        [javac, "-d", str(tmp_path),
         os.path.join(ROOT, "examples", "PcaBridgeClient.java")],
        check=True, capture_output=True, timeout=120,
    )
    server = PcaBridgeServer(_backend(block_variants=16)).start()
    try:
        out = subprocess.run(
            [java, "-cp", str(tmp_path), "PcaBridgeClient",
             str(server.port)],
            capture_output=True, timeout=120, text=True,
        )
        assert out.returncode == 0, out.stdout + out.stderr
        assert "bridge ok (jvm)" in out.stdout
    finally:
        server.stop()
