"""The port's credential resolution against the JAX package's.

``get_access_token`` must resolve the same token from the same secrets
files on both paths (``--client-secrets`` with its confirmation, and the
application-default variable), refuse the same malformed or headless cases,
and run the OAuth refresh-token exchange against a stub token endpoint on
127.0.0.1 with the same results and the same error text.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs

import pytest
import torch

from spark_examples_tpu.genomics import auth as jax_auth
from spark_examples_tpu.genomics import oauth as jax_oauth
from spark_examples_tpu.resilience import RetryPolicy as JaxRetryPolicy
from spark_examples_tpu_torch.genomics import auth, oauth
from spark_examples_tpu_torch.resilience import RetryPolicy

FAST = dict(max_attempts=3, base_delay=0.0, jitter=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _TokenEndpoint:
    """A refresh-token grant endpoint: one registered credential; a
    queue of statuses to answer first (transient failures)."""

    def __init__(self):
        ep = self
        self.requests = []
        self.fail_first = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                form = {k: v[0] for k, v in parse_qs(
                    self.rfile.read(n).decode()).items()}
                ep.requests.append(form)
                if ep.fail_first:
                    self._reply(ep.fail_first.pop(0),
                                {"error": "temporarily_unavailable"})
                elif form.get("refresh_token") != "rtok":
                    self._reply(400, {"error": "invalid_grant",
                                      "error_description": "revoked"})
                elif (form.get("client_id"), form.get("client_secret")) != (
                        "cid", "csec"):
                    self._reply(401, {"error": "invalid_client"})
                else:
                    self._reply(200, {"access_token": "minted",
                                      "token_type": "Bearer"})

            def _reply(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.uri = f"http://127.0.0.1:{self.server.server_address[1]}/token"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def endpoint():
    ep = _TokenEndpoint()
    yield ep
    ep.stop()


def _write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    return str(path)


def _both(call):
    """``call(module)`` for each package → (outcome, outcome), where an
    AuthError outcome is its message."""
    out = []
    for mod in (auth, jax_auth):
        try:
            out.append(call(mod))
        except mod.AuthError as e:
            out.append(f"AuthError: {e}")
    return out


def _refresh(uri, **over):
    return {"client_id": "cid", "client_secret": "csec",
            "refresh_token": "rtok", "token_uri": uri, **over}


def test_the_adc_variable_resolves_the_same_token(tmp_path, monkeypatch,
                                                   endpoint):
    for doc in ({"token": "pre"}, {"installed": {"token": "nested"}},
                _refresh(endpoint.uri),
                {"installed": _refresh(endpoint.uri)}):
        monkeypatch.setenv(auth.ADC_ENV, _write(tmp_path, "adc.json", doc))
        got, want = _both(lambda m: m.get_access_token())
        assert (got.token, got.source) == (want.token, want.source)
        assert got.token in ("pre", "nested", "minted")


def test_client_secrets_confirmed_and_declined(tmp_path, endpoint):
    path = _write(tmp_path, "cs.json", _refresh(endpoint.uri))
    got, want = _both(lambda m: m.get_access_token(
        path, interactive=True, _input=lambda prompt: "y"))
    assert (got.token, got.source) == (want.token, want.source) == (
        "minted", "client-secrets")
    got, want = _both(lambda m: m.get_access_token(
        path, interactive=True, _input=lambda prompt: "n"))
    assert got == want == "AuthError: user declined client-secrets credential"


@pytest.mark.parametrize(
    "doc,interactive",
    [
        ({"token": "t"}, False),  # headless: fails closed
        ({"client_id": "only-public"}, True),  # not a secret
        ("{broken", True),  # unreadable JSON
        ({"installed": "not-an-object"}, True),
    ],
    ids=["headless", "client-id-only", "bad-json", "bad-installed"],
)
def test_the_same_refusals(tmp_path, doc, interactive):
    path = _write(tmp_path, "cs.json", doc)
    got, want = _both(lambda m: m.get_access_token(
        path, interactive=interactive, _input=lambda prompt: "y"))
    assert got.startswith("AuthError") and got == want


def test_anonymous_without_any_credential(monkeypatch):
    monkeypatch.delenv(auth.ADC_ENV, raising=False)
    got, want = _both(lambda m: m.get_access_token())
    assert (got.token, got.source) == (want.token, want.source) == (
        "", "anonymous")


@pytest.mark.parametrize(
    "over,fail_first",
    [
        ({}, []),
        ({}, [503, 500]),  # transient: retried to success
        ({"refresh_token": "revoked"}, []),  # 400 invalid_grant
        ({"client_secret": "wrong"}, []),  # 401 invalid_client
        ({}, [503, 503, 503]),  # retries exhausted
    ],
    ids=["ok", "transient", "invalid-grant", "invalid-client", "exhausted"],
)
def test_refresh_exchange_against_a_local_endpoint(endpoint, over,
                                                   fail_first):
    cred = _refresh(endpoint.uri, **over)
    args = (cred["client_id"], cred["client_secret"], cred["refresh_token"])
    results, attempts = [], []
    for mod, policy, err in (
        (oauth, RetryPolicy(**FAST), auth.AuthError),
        (jax_oauth, JaxRetryPolicy(**FAST), jax_auth.AuthError),
    ):
        endpoint.requests.clear()
        endpoint.fail_first = list(fail_first)
        try:
            results.append(mod.exchange_refresh_token(
                *args, token_uri=endpoint.uri, timeout=10,
                retry_policy=policy))
        except err as e:
            results.append(f"AuthError: {e}")
        attempts.append(len(endpoint.requests))
    assert results[0] == results[1]
    assert attempts[0] == attempts[1]
    assert endpoint.requests[0]["grant_type"] == "refresh_token"


def test_unreachable_endpoint_is_an_auth_error():
    # A port nothing listens on: connection refused, retried, then raised.
    server = HTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler)
    uri = f"http://127.0.0.1:{server.server_address[1]}/token"
    server.server_close()
    with pytest.raises(auth.AuthError, match="cannot reach token endpoint"):
        oauth.exchange_refresh_token(
            "cid", "csec", "rtok", token_uri=uri, timeout=5,
            retry_policy=RetryPolicy(**FAST))
