"""The port's crash flight recorder, watchdog flush hooks and lock check.

``TestFlightRecorder`` holds ``obs/flightrec.py`` to the JAX package's
cases (``tests/test_obs.py::TestFlightRecorder``): the per-thread rings,
the reasoned JSONL dumps and the span, instant and metric hooks of the
port's ``obs/tracer.py`` and ``obs/metrics.py``. The JAX package's
recorder sees the same transitions for the same calls. The watchdog's
flush-hook registry (which the job journal uses) and the lock check
(``set_lock_check``; the port reads no environment variable for it) are
tested below.
"""

import json
import os
import threading

import pytest

from spark_examples_tpu.obs import flightrec as jax_flightrec
from spark_examples_tpu.utils import lockcheck as jax_lockcheck
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.resilience import FaultPlan, FaultRule, faults
from spark_examples_tpu_torch.utils import lockcheck, watchdog


class TestFlightRecorder:
    """The crash black box: per-thread overwrite rings, reasoned JSONL
    dumps, hook/handler chaining — always on once installed, cheap
    enough for production (one global read when off)."""

    @pytest.fixture(autouse=True)
    def _clean(self):
        from spark_examples_tpu_torch.obs import flightrec

        flightrec.uninstall()
        yield
        flightrec.uninstall()

    def test_ring_overwrites_keeping_the_last_k(self):
        from spark_examples_tpu_torch.obs import flightrec

        rec = flightrec.FlightRecorder(capacity_per_thread=8)
        for i in range(30):
            rec.note("instant", f"ev{i}", {"i": i})
        snap = rec.snapshot()
        assert len(snap) == 8
        # Exactly the last 8 survive; snapshot order is by timestamp,
        # which can tie at clock resolution — compare as a set.
        assert sorted(r["fields"]["i"] for r in snap) == list(range(22, 30))

    def test_threads_write_locklessly_and_merge_sorted(self):
        from spark_examples_tpu_torch.obs import flightrec

        rec = flightrec.FlightRecorder(capacity_per_thread=64)

        def work(tag):
            for i in range(50):
                rec.note("metric", tag, {"i": i})

        threads = [
            threading.Thread(target=work, args=(f"t{k}",), name=f"w{k}")
            for k in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = rec.snapshot()
        assert len(snap) == 200
        assert {r["thread"] for r in snap} == {f"w{k}" for k in range(4)}
        tss = [r["ts_unix"] for r in snap]
        assert tss == sorted(tss)

    def test_dump_schema_and_atomicity(self, tmp_path):
        from spark_examples_tpu_torch.obs import flightrec

        rec = flightrec.FlightRecorder()
        rec.note("span_begin", "job.run", {"job_id": "j-1"})
        rec.note("metric", "serving_jobs_total", {"delta": 1.0})
        rec.note("instant", "bad", {"obj": object()})  # unserializable
        path = str(tmp_path / "d" / "flightrec-test.jsonl")
        rec.dump(path, "test")
        lines = [json.loads(l) for l in open(path)]
        header, records = lines[0], lines[1:]
        assert header["schema"] == flightrec.SCHEMA
        assert header["reason"] == "test"
        assert header["pid"] == os.getpid()
        assert [r["name"] for r in records] == [
            "job.run",
            "serving_jobs_total",
            "bad",
        ]
        assert records[2]["unserializable_fields"] is True
        assert not os.path.exists(path + ".tmp")  # tmp+rename, no ruins

    def test_ambient_helpers_tap_the_recorder_without_a_session(
        self, tmp_path
    ):
        """The black box works with tracing OFF — that is its reason to
        exist: span/instant transitions and metric deltas land in the
        rings even when no telemetry session is active."""
        from spark_examples_tpu_torch.obs import flightrec

        assert not obs.collection_active()
        flightrec.install(str(tmp_path), handle_signals=False)
        with obs.span("job.run", job_id="j-9"):
            obs.instant("job_transition", scope="p", to="running")
        reg = obs.get_registry()
        reg.counter("serving_jobs_total").labels(outcome="done").inc()
        snap = flightrec.get_recorder().snapshot()
        kinds = {(r["kind"], r["name"]) for r in snap}
        assert ("span_begin", "job.run") in kinds
        assert ("span_end", "job.run") in kinds
        assert ("instant", "job_transition") in kinds
        assert ("metric", "serving_jobs_total") in kinds
        path = flightrec.dump_now("watchdog")
        assert path and path.endswith("flightrec-watchdog.jsonl")
        assert os.path.exists(path)

    def test_install_is_idempotent_and_uninstall_restores(self, tmp_path):
        import sys

        from spark_examples_tpu_torch.obs import flightrec

        prev_hook = sys.excepthook
        rec1 = flightrec.install(str(tmp_path), handle_signals=False)
        rec2 = flightrec.install(str(tmp_path / "other"), handle_signals=False)
        assert rec1 is rec2
        assert sys.excepthook is not prev_hook
        flightrec.uninstall()
        assert sys.excepthook is prev_hook
        assert flightrec.get_recorder() is None
        flightrec.note("instant", "after", None)  # no-op, no crash

    def test_excepthook_dumps_then_chains(self, tmp_path, capsys):
        import sys

        from spark_examples_tpu_torch.obs import flightrec

        seen = []
        prev_hook = sys.excepthook
        sys.excepthook = lambda *a: seen.append(a)
        try:
            flightrec.install(str(tmp_path), handle_signals=False)
            flightrec.note("instant", "before_crash", None)
            try:
                raise RuntimeError("boom")
            except RuntimeError:
                sys.excepthook(*sys.exc_info())
            dump = os.path.join(str(tmp_path), "flightrec-exception.jsonl")
            assert os.path.exists(dump)
            lines = [json.loads(l) for l in open(dump)]
            assert lines[0]["reason"] == "exception"
            names = [r["name"] for r in lines[1:]]
            assert "before_crash" in names
            assert "unhandled_exception" in names
            assert len(seen) == 1  # the previous hook still ran
        finally:
            flightrec.uninstall()
            sys.excepthook = prev_hook

    def test_periodic_flusher_writes_last_snapshot(self, tmp_path):
        import time as time_mod

        from spark_examples_tpu_torch.obs import flightrec

        flightrec.install(
            str(tmp_path), flush_interval_s=0.05, handle_signals=False
        )
        flightrec.note("instant", "tick", None)
        last = os.path.join(str(tmp_path), "flightrec-last.jsonl")
        deadline = time_mod.time() + 5
        while time_mod.time() < deadline and not os.path.exists(last):
            time_mod.sleep(0.02)
        assert os.path.exists(last), "periodic flusher never wrote"
        lines = [json.loads(l) for l in open(last)]
        assert lines[0]["reason"] == "periodic"


class TestFlightRecorderHooks:
    @pytest.fixture(autouse=True)
    def _clean(self):
        from spark_examples_tpu_torch.obs import flightrec

        flightrec.uninstall()
        yield
        flightrec.uninstall()

    def test_gauge_writes_are_recorded(self, tmp_path):
        from spark_examples_tpu_torch.obs import flightrec

        flightrec.install(str(tmp_path), handle_signals=False)
        gauge = obs.get_registry().gauge("serving_queue_depth", "depth")
        gauge.set(3.0)
        gauge.inc(2.0)
        obs.counter("serving_in_flight", running=1.0)
        snap = flightrec.get_recorder().snapshot()
        fields = [
            r.get("fields") for r in snap
            if r["name"] == "serving_queue_depth"
        ]
        assert fields == [{"value": 3.0}, {"delta": 2.0}]
        assert ("counter", "serving_in_flight") in {
            (r["kind"], r["name"]) for r in snap
        }

    def test_hooks_record_what_the_jax_recorder_records(self, tmp_path):
        """The same ambient calls leave the same (kind, name, fields)
        sequence in either package's rings."""
        from spark_examples_tpu import obs as jax_obs
        from spark_examples_tpu_torch.obs import flightrec

        def drive(o):
            with o.span("job.run", job_id="j-1"):
                o.instant("job_transition", scope="p", to="running")
            o.get_registry().counter("serving_jobs_total").labels(
                outcome="done"
            ).inc()
            o.counter("serving_in_flight", running=0.0)

        def seq(rec):
            return [
                (r["kind"], r["name"], r.get("fields"))
                for r in rec.snapshot()
            ]

        jax_flightrec.uninstall()
        try:
            port = flightrec.install(
                str(tmp_path / "port"), handle_signals=False
            )
            ref = jax_flightrec.install(
                str(tmp_path / "jax"), handle_signals=False
            )
            drive(obs)
            got = seq(port)
            drive(jax_obs)
            want = seq(ref)
        finally:
            jax_flightrec.uninstall()
        # Each recorder saw only its own package's calls.
        assert got == want
        assert ("span_begin", "job.run", {"job_id": "j-1"}) in got

    def test_torn_dump_keeps_the_previous_dump(self, tmp_path):
        from spark_examples_tpu_torch.obs import flightrec

        rec = flightrec.FlightRecorder()
        rec.note("instant", "first", None)
        path = str(tmp_path / "flightrec-x.jsonl")
        rec.dump(path, "one")
        before = open(path).read()
        rec.note("instant", "second", None)
        plan = FaultPlan(
            seed=1, rules=[FaultRule(site="flightrec.write", kind="torn")]
        )
        with faults.active_plan(plan):
            with pytest.raises(faults.InjectedFault):
                rec.dump(path, "two")
        assert open(path).read() == before


class TestWatchdogFlushHooks:
    def test_register_run_replace_unregister(self):
        seen = []
        watchdog.register_flush_hook("t", lambda: seen.append(1))
        watchdog.register_flush_hook("t", lambda: seen.append(2))
        try:
            watchdog.run_flush_hooks(deadline_s=5.0)
            assert seen == [2]  # the latest registration under a name
        finally:
            watchdog.unregister_flush_hook("t")
        watchdog.run_flush_hooks(deadline_s=5.0)
        assert seen == [2]

    def test_a_failing_hook_never_stops_the_others(self, capsys):
        seen = []

        def bad():
            raise OSError("disk gone")

        watchdog.register_flush_hook("a-bad", bad)
        watchdog.register_flush_hook("b-good", lambda: seen.append("ok"))
        try:
            watchdog.run_flush_hooks(deadline_s=5.0)
        finally:
            watchdog.unregister_flush_hook("a-bad")
            watchdog.unregister_flush_hook("b-good")
        assert seen == ["ok"]
        assert "pre-exit flush hook 'a-bad' failed" in capsys.readouterr().err

    def test_unarmed_watchdog_is_a_no_op(self):
        with watchdog.CollectiveWatchdog(None).armed("phase"):
            pass
        with watchdog.CollectiveWatchdog(30.0).armed("phase"):
            pass  # the timer is cancelled on exit
        assert watchdog.EXIT_COLLECTIVE_TIMEOUT == 77


class TestLockCheck:
    def test_asserts_only_when_turned_on(self):
        lock = threading.Lock()
        prev = lockcheck.set_lock_check(False)
        try:
            lockcheck.assert_lock_held(lock, "f")  # off: no-op
            lockcheck.set_lock_check(True)
            assert lockcheck.lock_check_enabled()
            with pytest.raises(AssertionError, match="_locked convention"):
                lockcheck.assert_lock_held(lock, "f")
            with lock:
                lockcheck.assert_lock_held(lock, "f")
            rlock = threading.RLock()
            with pytest.raises(AssertionError):
                lockcheck.assert_lock_held(rlock, "g")
            with rlock:
                lockcheck.assert_lock_held(rlock, "g")
        finally:
            lockcheck.set_lock_check(prev)

    def test_reads_no_environment_variable(self, monkeypatch):
        monkeypatch.setenv(jax_lockcheck.LOCK_CHECK_ENV, "1")
        prev = lockcheck.set_lock_check(False)
        try:
            assert jax_lockcheck.lock_check_enabled()
            assert not lockcheck.lock_check_enabled()
            lockcheck.assert_lock_held(threading.Lock(), "f")
        finally:
            lockcheck.set_lock_check(prev)
        source = open(lockcheck.__file__).read()
        assert "os.environ" not in source and "getenv" not in source
        assert "import os" not in source
