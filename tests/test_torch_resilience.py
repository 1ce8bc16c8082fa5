"""The port's resilience core against the JAX package's.

Retry policies, circuit breakers and the fault plane are pure Python in
both packages; the port's copies must take the same decisions on the same
inputs: the same retries and backoff delays under a seeded ``random`` and an
injected ``sleep``, the same breaker transitions under a fake clock, the same
``classify_http``/``classify_oauth`` verdicts, and a ``FaultPlan`` from the
same spec firing at the same calls.
"""

import email.message
import json
import random
from urllib.error import HTTPError, URLError

import pytest
import torch

from spark_examples_tpu import obs as jax_obs
from spark_examples_tpu import resilience as jax_res
from spark_examples_tpu.genomics import service as jax_service
from spark_examples_tpu.resilience import faults as jax_faults
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch import resilience as res
from spark_examples_tpu_torch.genomics import service
from spark_examples_tpu_torch.resilience import faults


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _served(pkg_service, code, retry_after=None):
    """The IOError the HTTP tier raises for a served status."""
    try:
        raise IOError(f"/x: HTTP {code}") from pkg_service._ServedHttpError(
            code, "reason", retry_after
        )
    except IOError as e:
        return e


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _retry_trace(pkg, seed, failures, policy_kw, error_of, budget_s=None):
    """Run one call_with_retry over a function failing ``failures`` times;
    → (outcome, attempts, slept delays)."""
    resilience, pkg_service, _ = pkg
    clock = _Clock()
    slept = []

    def sleep(d):
        slept.append(round(d, 12))
        clock.t += d

    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise error_of(pkg_service, len(calls))
        return "ok"

    budget = (
        resilience.Budget(budget_s, clock=clock) if budget_s else None
    )
    try:
        outcome = resilience.call_with_retry(
            fn,
            resilience.RetryPolicy(**policy_kw),
            resilience.classify_http,
            budget=budget,
            sleep=sleep,
            rng=random.Random(seed),
        )
    except IOError as e:
        outcome = f"raised {e}"
    return outcome, len(calls), slept


ERRORS = {
    "transport": lambda s, i: IOError(f"reset {i}"),
    "503": lambda s, i: _served(s, 503),
    "503-retry-after": lambda s, i: _served(s, 503, retry_after=0.5 * i),
    "404": lambda s, i: _served(s, 404),
}
POLICIES = {
    "default": {},
    "no-jitter": {"jitter": 0.0, "base_delay": 0.1},
    "cap": {"max_delay": 0.07, "max_attempts": 6},
    "one-attempt": {"max_attempts": 1},
    "ignore-hints": {"honor_retry_after": False},
}


@pytest.mark.parametrize("failures", [0, 2, 3, 7])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("error", sorted(ERRORS))
def test_retry_decisions_and_backoff_match(error, policy, failures):
    args = (11, failures, POLICIES[policy], ERRORS[error])
    got = _retry_trace((res, service, obs), *args)
    want = _retry_trace((jax_res, jax_service, jax_obs), *args)
    assert got == want


@pytest.mark.parametrize("budget_s", [0.05, 0.2, 1.0])
def test_deadline_budget_draws_down_the_same(budget_s):
    args = (3, 9, {"max_attempts": 10}, ERRORS["transport"], budget_s)
    assert _retry_trace((res, service, obs), *args) == _retry_trace(
        (jax_res, jax_service, jax_obs), *args
    )


def test_backoff_delays_are_the_same_numbers():
    for seed in range(5):
        a, b = random.Random(seed), random.Random(seed)
        port, ref = res.RetryPolicy(), jax_res.RetryPolicy()
        assert [port.backoff_delay(f, a) for f in range(1, 12)] == [
            ref.backoff_delay(f, b) for f in range(1, 12)
        ]


@pytest.mark.parametrize("code", [200, 301, 400, 401, 403, 404, 408, 425,
                                  429, 500, 501, 502, 503, 504])
def test_classify_http_verdict_per_status(code):
    got = res.classify_http(_served(service, code, retry_after=2.0))
    want = jax_res.classify_http(_served(jax_service, code, retry_after=2.0))
    assert (got.retryable, got.reason, got.delay_hint) == (
        want.retryable,
        want.reason,
        want.delay_hint,
    )


def test_classify_http_transport_and_open_circuit():
    for exc_port, exc_jax in (
        (IOError("reset"), IOError("reset")),
        (res.CircuitOpenError("/x", 1.0), jax_res.CircuitOpenError("/x", 1.0)),
    ):
        got, want = res.classify_http(exc_port), jax_res.classify_http(exc_jax)
        assert (got.retryable, got.reason) == (want.retryable, want.reason)


def _http_error(code, retry_after=None):
    headers = email.message.Message()
    if retry_after is not None:
        headers["Retry-After"] = retry_after
    return HTTPError("http://t/token", code, "x", headers, None)


@pytest.mark.parametrize(
    "exc",
    [
        lambda: _http_error(400),
        lambda: _http_error(401),
        lambda: _http_error(429, "3"),
        lambda: _http_error(500),
        lambda: _http_error(503, "7"),
        lambda: URLError("down"),
        lambda: OSError("reset"),
        lambda: ValueError("bad"),
    ],
    ids=["400", "401", "429", "500", "503", "urlerror", "oserror", "value"],
)
def test_classify_oauth_and_ingest_match(exc):
    for fn_port, fn_jax in (
        (res.classify_oauth, jax_res.classify_oauth),
        (res.classify_ingest, jax_res.classify_ingest),
    ):
        got, want = fn_port(exc()), fn_jax(exc())
        assert (got.retryable, got.reason, got.delay_hint) == (
            want.retryable,
            want.reason,
            want.delay_hint,
        )


@pytest.mark.parametrize("value", [None, "", "5", " 2.5 ", "-3", "soon",
                                   "Wed, 21 Oct 2015 07:28:00 GMT"])
def test_parse_retry_after_matches(value):
    assert res.parse_retry_after(value) == jax_res.policy.parse_retry_after(
        value
    )


# Breaker script: (operation, clock advance before it).
BREAKER_SCRIPT = [
    ("failure", 0), ("success", 0), ("failure", 0), ("failure", 0),
    ("call", 0), ("failure", 0), ("call", 0), ("call", 1.0),
    ("call", 5.0), ("failure", 0), ("call", 0), ("call", 6.0),
    ("call", 0), ("release", 0), ("call", 0), ("success", 0),
    ("call", 0), ("failure", 0), ("failure", 0), ("failure", 0),
    ("call", 0), ("call", 6.0), ("success", 0), ("call", 0),
]


def _breaker_trace(pkg_res):
    clock = _Clock()
    b = pkg_res.CircuitBreaker(
        "ep", failure_threshold=3, cooldown_s=5.0, clock=clock
    )
    trace = []
    for op, advance in BREAKER_SCRIPT:
        clock.t += advance
        if op == "call":
            try:
                b.before_call()
                trace.append((op, "admitted", b.state))
            except pkg_res.CircuitOpenError as e:
                trace.append((op, f"shed {e.retry_in:.3f}", b.state))
        else:
            getattr(b, {"failure": "record_failure",
                        "success": "record_success",
                        "release": "release_probe"}[op])()
            trace.append((op, "", b.state))
    return trace


def test_breaker_transitions_match():
    assert _breaker_trace(res) == _breaker_trace(jax_res)


def test_breaker_set_and_transitions_are_observed_the_same():
    got, want = [], []
    for pkg_res, pkg_obs, out in ((res, obs, got), (jax_res, jax_obs, want)):
        with pkg_obs.telemetry_session() as session:
            _breaker_trace(pkg_res)
            bs = pkg_res.BreakerSet("http:h:", failure_threshold=1)
            bs.get("/a").record_failure()
            out.append(bs.states())
            snap = session.registry.snapshot()["counters"]
            out.append(sorted(
                (k, v) for k, v in snap.items() if "breaker" in k
            ))
            out.append([
                (e["name"], e.get("args"))
                for e in session.tracer.to_chrome()["traceEvents"]
                if e["name"].startswith("breaker")
            ])
    assert got == want


SPEC = {
    "seed": 7,
    "rules": [
        {"site": "transport.http.request", "match": "/variants-csr",
         "times": 2, "after": 1},
        {"site": "transport.*", "kind": "stall", "probability": 0.5,
         "times": None, "stall_s": 0.0},
        {"site": "transport.http.frames", "kind": "truncate", "at_line": 1},
    ],
}
HITS = [
    ("transport.http.request", "/callsets"),
    ("transport.http.request", "/variants-csr"),
    ("transport.http.request", "/variants-csr"),
    ("transport.http.frames", "/variants-csr"),
    ("transport.http.request", "/variants-csr"),
    ("transport.http.request", "/variants-csr"),
    ("transport.oauth.request", "http://t"),
    ("transport.http.stream", "/variants"),
] * 3


def test_fault_plan_from_spec_fires_at_the_same_calls():
    plans = (
        faults.FaultPlan.from_spec(json.dumps(SPEC)),
        jax_faults.FaultPlan.from_spec(json.dumps(SPEC)),
    )
    decisions = [
        [
            None if (r := plan.decide(site, key)) is None else r.kind
            for site, key in HITS
        ]
        for plan in plans
    ]
    assert decisions[0] == decisions[1]
    assert plans[0].to_dict() == plans[1].to_dict()
    assert plans[0].fired_total == plans[1].fired_total > 0
    assert plans[0].fired_by_site() == plans[1].fired_by_site()


def test_fault_plan_from_a_file_and_bad_specs(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(SPEC))
    assert faults.FaultPlan.from_spec(str(path)).to_dict() == (
        jax_faults.FaultPlan.from_spec(str(path)).to_dict()
    )
    listed = tmp_path / "list.json"
    listed.write_text("[1, 2]")
    for bad in ("{not json", str(listed)):
        for mod in (faults, jax_faults):
            with pytest.raises(ValueError):
                mod.FaultPlan.from_spec(bad)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultRule(site="x", kind="explode")


@pytest.mark.parametrize("kind", ["truncate", "corrupt", "error", "stall"])
def test_wrap_lines_acts_the_same(kind):
    lines = [b"d line%d" % i for i in range(5)]
    out = []
    for mod in (faults, jax_faults):
        plan = mod.FaultPlan(rules=[mod.FaultRule(
            site="transport.http.stream", kind=kind, at_line=2,
            stall_s=0.0)])
        got = []
        try:
            for line in mod.wrap_lines(
                "transport.http.stream", iter(lines), plan=plan
            ):
                got.append(line)
        except IOError as e:
            got.append(f"raised {type(e).__name__}: {e}")
        out.append(got)
    assert out[0] == out[1]


def test_inject_raises_an_io_error_and_scopes_restore():
    rule = dict(site="transport.http.request", match="/v", times=1)
    for mod in (faults, jax_faults):
        plan = mod.FaultPlan(rules=[mod.FaultRule(**rule)])
        assert mod.current_plan() is None
        with mod.active_plan(plan):
            mod.inject("transport.http.request", key="/callsets")
            with pytest.raises(IOError, match="injected error fault"):
                mod.inject("transport.http.request", key="/v")
            mod.inject("transport.http.request", key="/v")  # exhausted
        assert mod.current_plan() is None
        assert plan.fired_total == 1


def test_the_port_reads_no_fault_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv(jax_faults.FAULT_PLAN_ENV, json.dumps(SPEC))
    assert not hasattr(faults, "plan_from_env")
    assert faults.current_plan() is None
    faults.inject("transport.http.request", key="/variants-csr")
