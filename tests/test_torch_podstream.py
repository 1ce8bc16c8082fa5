"""The port's pod exchange and slot pipeline, at two and four gloo ranks.

The ranks are spawned as ``tests/test_torch_multihost.py`` spawns them (a
free port, hard timeouts of at most 120 s). Over the socket mesh that
``PodWindowExchange.open`` bootstraps through the process group:

- headers, confirms, collective-check digests and payloads round-trip,
  every rank's row in rank order, over several back-to-back streams;
- a frame whose (stream, step, kind) is not the expected one raises the
  JAX package's desync text;
- a producer error re-raises at its slot, in the pipeline alone (depths
  0, 2 and 8) and across the pod (every rank raises at the same step);
- peer death: kill -9 the last rank mid-exchange, and every survivor
  raises at the kill step having completed the steps before it
  (``tests/test_multihost.py:1124``), within its own short exchange
  deadline. The teardown sends this rank's queued frames before it closes
  the sockets, so no survivor loses a frame of an earlier phase.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from spark_examples_tpu_torch.parallel.podstream import (
    POD_EXCHANGE_TIMEOUT_S,
    PodSlot,
    PodWindowExchange,
    SlotPipeline,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KILL_STEP = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(script_path, argv, n=2, timeout=120, expected_rcs=None):
    """Spawn ``n`` ranks of one gloo group; every rank is killed at the
    timeout, never leaked. Returns the logs."""
    env = {
        **os.environ,
        "PYTHONPATH": ROOT,
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(_free_port()),
        "WORLD_SIZE": str(n),
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(script_path)] + [str(a) for a in argv],
            env={**env, "RANK": str(i), "LOCAL_RANK": str(i)},
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(n)
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log, rc in zip(procs, logs, expected_rcs or [0] * n):
        assert p.returncode == rc, log[-3000:]
    return logs


_ROUND_TRIP_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from spark_examples_tpu_torch.parallel import distributed
    from spark_examples_tpu_torch.parallel.podstream import (
        PodSlot, PodWindowExchange, SlotPipeline)

    assert distributed.initialize_from_env("cpu")
    pid, world = distributed.process_index(), distributed.process_count()
    out = {"headers": [], "confirms": [], "checks": [], "payloads": [],
           "streams": []}
    for s in range(3):  # back-to-back streams on one socket mesh
        ex = PodWindowExchange.open(timeout_s=60.0)
        out["streams"].append(ex.stream)
        for step in range(4):
            ex.post_header(step, np.array(
                [pid, step, s, 100 * pid + step, -1, 7, 0], np.int64))
            out["headers"].append(ex.gather_headers(step, 7).tolist())
            ok = not (pid == world - 1 and step == 2)
            ex.post_confirm(step, ok)
            out["confirms"].append(ex.gather_confirms(step).tolist())
            ex.post_check(step, 1000 * s + 10 * step + pid)
            out["checks"].append(ex.gather_checks(step).tolist())
            mat = np.full((step + 1, 3), 10 * pid + step, np.int32)
            ex.post_payload(step, mat)
            got = {}
            for p in range(world):
                if p != pid:
                    got[p] = ex.get_payload(step, p, (step + 1, 3)).tolist()
            out["payloads"].append(got)
        ex.close()

    # A producer error at one rank's slot raises on every rank there.
    ex = PodWindowExchange.open()
    state = {"step": 0}

    def produce():
        step = state["step"]
        state["step"] += 1
        bad = pid == world - 1 and step == 3
        ex.post_header(step, np.array([-2 if bad else 0] * 7, np.int64))
        rows = ex.gather_headers(step, 7)
        failed = [i for i, r in enumerate(rows) if int(r[0]) == -2]
        if failed:
            raise RuntimeError(f"peers failed: {failed} at step {step}")
        if step == 6:
            return None
        return PodSlot(step=step, route="scatter", gathered=None,
                       local=None, nnz=0, variants=0, windows=1)

    done, err = [], None
    try:
        for slot in SlotPipeline(produce, depth=2):
            done.append(slot.step)
    except RuntimeError as e:
        err = str(e)
    out["pipeline"] = {"done": done, "err": err}

    # Last: a desync. Rank 0 posts a confirm where its peers expect a
    # header; they raise (the body stays unread, so nothing follows).
    ex = PodWindowExchange.open()
    out["desync_stream"] = ex.stream
    if pid == 0:
        ex.post_confirm(0, True)
        out["desync"] = None
    else:
        ex.post_header(0, np.zeros(7, np.int64))
        try:
            ex.gather_headers(0, 7)
            out["desync"] = None
        except RuntimeError as e:
            out["desync"] = str(e)
    with open(os.path.join(sys.argv[1], f"rank{pid}.json"), "w") as f:
        json.dump(out, f)
    # Rank 0 stays up until its peers have read its frame.
    torch.distributed.barrier()
    os._exit(0)  # the desync left frames unread: skip the group's teardown
    """
)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def round_trip(request, tmp_path_factory):
    world = request.param
    work = tmp_path_factory.mktemp(f"exchange{world}")
    script = work / "worker.py"
    script.write_text(_ROUND_TRIP_WORKER)
    _run_workers(script, [work], n=world)
    return world, [json.loads((work / f"rank{r}.json").read_text())
                   for r in range(world)]


def test_headers_round_trip(round_trip):
    world, reports = round_trip
    for pid, rep in enumerate(reports):
        assert len(rep["headers"]) == 12
        for k, rows in enumerate(rep["headers"]):
            s, step = divmod(k, 4)
            assert rows == [[p, step, s, 100 * p + step, -1, 7, 0]
                            for p in range(world)]
    # Streams open in the same program order everywhere: the same ids.
    assert len({tuple(r["streams"]) for r in reports}) == 1


def test_confirms_round_trip(round_trip):
    world, reports = round_trip
    for rep in reports:
        for k, vals in enumerate(rep["confirms"]):
            bad = k % 4 == 2
            assert vals == [0] * (world - 1) + [-2 if bad else 0]


def test_checks_and_payloads_round_trip(round_trip):
    world, reports = round_trip
    for pid, rep in enumerate(reports):
        for k, vals in enumerate(rep["checks"]):
            s, step = divmod(k, 4)
            assert vals == [1000 * s + 10 * step + p for p in range(world)]
        for k, got in enumerate(rep["payloads"]):
            step = k % 4
            assert sorted(int(p) for p in got) == [
                p for p in range(world) if p != pid]
            for p, mat in got.items():
                assert mat == [[10 * int(p) + step] * 3] * (step + 1)


def test_a_producer_error_raises_everywhere_at_its_slot(round_trip):
    world, reports = round_trip
    for rep in reports:
        assert rep["pipeline"]["done"] == [0, 1, 2]
        assert rep["pipeline"]["err"] == (
            f"peers failed: [{world - 1}] at step 3")


def test_a_frame_out_of_order_raises_the_desync_text(round_trip):
    world, reports = round_trip
    assert reports[0]["desync"] is None
    stream = reports[0]["desync_stream"]
    for rep in reports[1:]:
        assert rep["desync"] == (
            "pod exchange protocol desync with peer 0: expected "
            f"(stream={stream}, step=0, kind=0), got (stream={stream}, "
            "step=0, kind=1) — version-skewed pod or out-of-order stream "
            "construction"
        )


_PEER_DEATH_WORKER = textwrap.dedent(
    """
    import json, os, signal, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from spark_examples_tpu_torch.parallel import distributed
    from spark_examples_tpu_torch.parallel.podstream import (
        PodSlot, PodWindowExchange, SlotPipeline)

    assert distributed.initialize_from_env("cpu")
    pid, world = distributed.process_index(), distributed.process_count()
    KILL_STEP = int(sys.argv[2])
    victim = world - 1  # never rank 0
    # A short deadline: a survivor hanging out its receive instead of
    # converting the death fails here, well inside the harness timeout.
    ex = PodWindowExchange.open(timeout_s=20.0)
    state = {"step": 0}

    def produce():
        step = state["step"]
        state["step"] += 1
        header = np.array([0, 0, 0, 0, 0, step, 0], np.int64)
        if pid == victim and step == KILL_STEP:
            # Die MID-exchange: the steps before it on the wire, the
            # header posted, the confirm never. (A frame still queued in
            # the victim's sender threads when it dies may reach one
            # survivor and not another.)
            ex.flush()
            ex.post_header(step, header)
            os.kill(os.getpid(), signal.SIGKILL)
        ex.post_header(step, header)
        rows = ex.gather_headers(step, 7)
        failed = [i for i, r in enumerate(rows) if int(r[0]) == -2]
        if failed:
            raise RuntimeError(f"peers failed: {failed} at step {step}")
        ex.post_confirm(step, True)
        bad = [i for i, v in enumerate(ex.gather_confirms(step))
               if int(v) == -2]
        if bad:
            raise RuntimeError(f"peers failed: {bad} at step {step}")
        return PodSlot(step=step, route="scatter", gathered=None,
                       local=None, nnz=0, variants=0, windows=1)

    completed, err = [], None
    try:
        for slot in SlotPipeline(produce, depth=2):
            completed.append(slot.step)
    except RuntimeError as e:
        err = str(e)
    ok = (err is not None and f"at step {KILL_STEP}" in err
          and str(victim) in err and completed == list(range(KILL_STEP)))
    with open(os.path.join(sys.argv[1], f"rank{pid}.json"), "w") as f:
        json.dump({"ok": ok, "err": err, "completed": completed}, f)
    # No group teardown: it would wait on the dead peer.
    os._exit(0 if ok else 3)
    """
)


@pytest.mark.parametrize("world", [2, 4])
def test_peer_death_fails_every_survivor_at_the_same_slot(tmp_path, world):
    script = tmp_path / "worker.py"
    script.write_text(_PEER_DEATH_WORKER)
    logs = _run_workers(script, [tmp_path, KILL_STEP], n=world,
                        timeout=90, expected_rcs=[0] * (world - 1) + [-9])
    for pid in range(world - 1):
        result = json.loads((tmp_path / f"rank{pid}.json").read_text())
        assert result["ok"], (result, logs[pid][-1500:])
        assert result["completed"] == list(range(KILL_STEP))


def _slots(n):
    return [PodSlot(step=s, route="scatter", gathered=None, local=None,
                    nnz=0, variants=0, windows=1) for s in range(n)]


@pytest.mark.parametrize("depth", [0, 2, 8])
def test_the_pipeline_reraises_at_the_slot(depth):
    slots = iter(_slots(3))

    def produce():
        slot = next(slots, None)
        if slot is None:
            raise OSError("producer failed at slot 3")
        return slot

    got = []
    with pytest.raises(OSError, match="at slot 3"):
        for slot in SlotPipeline(produce, depth):
            got.append(slot.step)
    assert got == [0, 1, 2]


@pytest.mark.parametrize("depth", [0, 2, 8])
def test_the_pipeline_yields_in_order_and_ends(depth):
    slots = iter(_slots(20))
    steps = [s.step for s in SlotPipeline(lambda: next(slots, None), depth)]
    assert steps == list(range(20))


def test_the_pipeline_refuses_a_negative_depth():
    with pytest.raises(ValueError, match="pipeline depth must be >= 0"):
        SlotPipeline(lambda: None, -1)


def test_one_process_has_no_exchange():
    assert PodWindowExchange.open() is None
    assert POD_EXCHANGE_TIMEOUT_S == 1800.0
