"""Soft-cancel run deadlines of the port (``utils/softcancel.py``).

The cases of the JAX package's ``tests/test_softcancel.py`` that test the
module and the driver (its run-wrapper cases test a TPU shell script),
on the port's own variable ``SPARK_EXAMPLES_TPU_TORCH_SOFT_DEADLINE``:

- a past deadline exits with code 75 at each of the driver's four seams —
  the block boundary of the dense route, the window boundary of the
  sparse route (the scatter kernel's path) and of the sketch engine, and
  the group boundary of checkpointed ingest — with the JAX package's
  ``where`` strings and stderr line;
- the JAX package's variable, ``SPARK_EXAMPLES_TPU_SOFT_DEADLINE``, does
  nothing to a port run, in process and through the CLI;
- a checkpointed CLI run cancelled after its first snapshot exits 75 with
  its telemetry flushed, and a rerun resumes to the uncancelled G.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from spark_examples_tpu.utils import softcancel as jax_softcancel
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.utils import checkpoint, softcancel
from spark_examples_tpu_torch.utils.config import PcaConfig

REFS = "17:41196311:41277499"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VAR = jax_softcancel.SOFT_DEADLINE_ENV


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class TestSoftCancelCheck:
    def test_the_ports_own_variable(self):
        assert softcancel.SOFT_DEADLINE_ENV == (
            "SPARK_EXAMPLES_TPU_TORCH_SOFT_DEADLINE"
        )
        assert softcancel.SOFT_DEADLINE_ENV != JAX_VAR

    def test_noop_without_env(self):
        softcancel.check("anywhere", environ={})

    def test_future_deadline_is_noop(self):
        env = {softcancel.SOFT_DEADLINE_ENV: str(time.time() + 3600)}
        softcancel.check("anywhere", environ=env)
        assert softcancel.remaining(environ=env) > 3500

    def test_past_deadline_raises_clean_exit_75(self, capsys):
        env = {softcancel.SOFT_DEADLINE_ENV: str(time.time() - 5)}
        with pytest.raises(SystemExit) as exc:
            softcancel.check("block boundary", environ=env)
        assert exc.value.code == softcancel.SOFT_CANCEL_EXIT == 75
        assert exc.value.where == "block boundary"
        assert exc.value.late_s >= 5
        assert "block boundary" in capsys.readouterr().err

    def test_the_stderr_line_is_the_jax_packages(self, capsys):
        past = str(time.time() - 1000)
        with pytest.raises(SystemExit):
            softcancel.check(
                "x", environ={softcancel.SOFT_DEADLINE_ENV: past})
        port_line = capsys.readouterr().err
        with pytest.raises(SystemExit):
            jax_softcancel.check("x", environ={JAX_VAR: past})
        jax_line = capsys.readouterr().err
        strip = lambda s: s.split("(", 1)[0] + s.split("s past)", 1)[1]
        assert strip(port_line) == strip(jax_line)

    def test_unparseable_deadline_is_loud(self):
        env = {softcancel.SOFT_DEADLINE_ENV: "tomorrow"}
        with pytest.raises(ValueError, match="unix timestamp"):
            softcancel.check("anywhere", environ=env)

    def test_the_jax_packages_variable_is_ignored(self):
        env = {JAX_VAR: str(time.time() - 5)}
        softcancel.check("anywhere", environ=env)
        assert softcancel.deadline(environ=env) is None
        with pytest.raises(SystemExit):
            jax_softcancel.check("anywhere", environ=env)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort") / "c")
    synthetic_cohort(12, 60, seed=3).dump(root)
    return root


def _driver(root, **kw):
    conf = PcaConfig(
        references=REFS,
        variant_set_ids=[DEFAULT_VARIANT_SET_ID],
        bases_per_partition=20_000,
        device="cpu",
        **kw,
    )
    return VariantsPcaDriver(conf, JsonlSource(root))


def _past(monkeypatch):
    monkeypatch.setenv(softcancel.SOFT_DEADLINE_ENV, str(time.time() - 1))


class TestDriverSeams:
    @pytest.mark.parametrize(
        "kw,call,where",
        [
            ({}, lambda d: d.get_similarity_matrix_csr(d.get_csr_fused()),
             "gramian block boundary"),
            ({"pca_mode": "sparse"}, lambda d: d.ingest_gramian(),
             "sparse gramian window boundary"),
            ({"pca_mode": "sketch"}, lambda d: d.ingest_gramian(),
             "sketch panel window boundary"),
            ({"checkpoint_dir": "CK"}, lambda d: d.ingest_gramian(),
             "checkpoint group boundary"),
        ],
        ids=["block", "sparse-window", "sketch-window", "group"],
    )
    def test_a_past_deadline_exits_75_at_the_seam(
            self, cohort, tmp_path, monkeypatch, capsys, kw, call, where):
        if kw.get("checkpoint_dir"):
            kw = {**kw, "checkpoint_dir": str(tmp_path / "ck")}
        drv = _driver(cohort, **kw)
        _past(monkeypatch)
        with pytest.raises(SystemExit) as exc:
            call(drv)
        assert exc.value.code == 75
        assert exc.value.where == where
        assert f"at {where}; exiting cleanly with code 75" in (
            capsys.readouterr().err
        )

    def test_run_completes_without_deadline(self, cohort, monkeypatch):
        monkeypatch.delenv(softcancel.SOFT_DEADLINE_ENV, raising=False)
        drv = _driver(cohort)
        g = drv.get_similarity_matrix_csr(drv.get_csr_fused())
        assert g.shape == (12, 12)

    @pytest.mark.parametrize("mode", ["auto", "sparse", "sketch"])
    def test_the_jax_packages_deadline_does_not_cancel_a_port_run(
            self, cohort, monkeypatch, mode):
        monkeypatch.delenv(softcancel.SOFT_DEADLINE_ENV, raising=False)
        monkeypatch.setenv(JAX_VAR, str(time.time() - 1))
        result = _driver(cohort, pca_mode=mode).run()
        assert len(result) == 12

    def test_a_future_deadline_changes_nothing(self, cohort, monkeypatch):
        monkeypatch.delenv(softcancel.SOFT_DEADLINE_ENV, raising=False)
        want = _driver(cohort, pca_mode="sparse").ingest_gramian()
        monkeypatch.setenv(
            softcancel.SOFT_DEADLINE_ENV, str(time.time() + 3600))
        got = _driver(cohort, pca_mode="sparse").ingest_gramian()
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    def test_cancel_after_a_snapshot_then_resume(
            self, cohort, tmp_path, monkeypatch, capsys):
        """The deadline passes while group 2 is pending: the run exits 75
        at the group boundary with group 1's snapshot on disk, and a rerun
        without the deadline resumes to the uncancelled G."""
        monkeypatch.delenv(softcancel.SOFT_DEADLINE_ENV, raising=False)
        want = _driver(cohort).ingest_gramian().numpy()
        ckdir = str(tmp_path / "ck")
        real = checkpoint.save_snapshot

        def save_then_expire(*args, **kwargs):
            real(*args, **kwargs)
            _past(monkeypatch)

        monkeypatch.setattr(checkpoint, "save_snapshot", save_then_expire)
        with pytest.raises(SystemExit) as exc:
            _driver(cohort, checkpoint_dir=ckdir,
                    checkpoint_every=2).ingest_gramian()
        assert exc.value.code == 75
        assert exc.value.where == "checkpoint group boundary"
        monkeypatch.setattr(checkpoint, "save_snapshot", real)
        monkeypatch.delenv(softcancel.SOFT_DEADLINE_ENV)
        capsys.readouterr()
        src = JsonlSource(cohort)
        drv = VariantsPcaDriver(
            _driver(cohort, checkpoint_dir=ckdir, checkpoint_every=2).conf,
            src,
        )
        got = drv.ingest_gramian().numpy()
        assert "Resuming from snapshot: 2/5 shards done." in (
            capsys.readouterr().out
        )
        assert src.stats.partitions == 3
        np.testing.assert_array_equal(got, want)


class TestCli:
    def _argv(self, root, *extra):
        return ["pca", "--input-path", root, "--references", REFS,
                "--bases-per-partition", "20000", "--device", "cpu", *extra]

    def test_exit_75_flushes_the_telemetry(
            self, cohort, tmp_path, monkeypatch):
        _past(monkeypatch)
        trace = str(tmp_path / "t.json")
        metrics = str(tmp_path / "m.prom")
        with pytest.raises(SystemExit) as exc:
            cli.main(self._argv(cohort, "--trace-out", trace,
                                "--metrics-out", metrics))
        assert exc.value.code == 75
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = {e["name"] for e in events}
        assert {"soft_cancel", "run_failed"} <= names
        assert os.path.exists(metrics)

    def _subprocess(self, root, env_var, *extra):
        env = {k: v for k, v in os.environ.items()
               if k not in (JAX_VAR, softcancel.SOFT_DEADLINE_ENV)}
        env[env_var] = str(time.time() - 1)
        return subprocess.run(
            [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
             *self._argv(root, *extra)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )

    def test_the_cli_exits_75(self, cohort, tmp_path):
        out = self._subprocess(cohort, softcancel.SOFT_DEADLINE_ENV,
                               "--checkpoint-dir", str(tmp_path / "ck"))
        assert out.returncode == 75, out.stderr[-2000:]
        assert "Soft-cancel: run deadline reached" in out.stderr
        assert "checkpoint group boundary" in out.stderr

    def test_the_cli_ignores_the_jax_packages_variable(self, cohort):
        out = self._subprocess(cohort, JAX_VAR)
        assert out.returncode == 0, out.stderr[-2000:]
        assert sum(line.count("\t") == 3
                   for line in out.stdout.splitlines()) == 12
