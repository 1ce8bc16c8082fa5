"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

Set-up draws the cohort from the seed, writes it under ``TMPDIR``, and runs
every distinct job of the rotation once (the first one twice), so the
sidecar is built, the kernels are built and loaded and every shape is
warm before the window opens. The window runs jobs back to back, one
client in a closed loop, until ``--seconds`` have passed; the last job
finishes and counts. Each job is the port's ``pca`` command, built as
``cli/main.py``'s ``_cmd_pca`` builds it: ``pca_config_from_args(
build_parser().parse_args(argv))`` and ``VariantsPcaDriver(conf,
JsonlSource(dir)).run()``, its standard output sent to a file under
``TMPDIR``. (``_cmd_pca`` also joins a process group when a launcher's
variables are set; a run of this benchmark is one process on one card.)

Once the window has closed and the card's peak is read, the emitted rows
of up to ``KEPT_ROWS`` of the window's jobs, and the Gramian or sketch
panel of up to ``KEPT_OUTPUTS`` of those, drawn from the seed (the first
job always), are compared with the reference. A job that raises counts as
failed, and the run is then not correct.

Every run also prints, on earlier lines of standard error, the process's
CPU seconds (``host.py``) over the window and, for a job that took
``SLOW_FACTOR`` times the median or more, over that job alone; and a job
still running after ``stall_s`` seconds has every thread's stack dumped
there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark import cohort as cohort_mod
from benchmark import jobs as jobs_mod
from benchmark import check as check_mod
from benchmark import host as host_mod
from benchmark.trace import JOB, WINDOW, Trace, profiler

__all__ = ["JobRecord", "Run", "run_cell"]

# Jobs of one window whose emitted rows are kept for the comparison, at
# most, and of those, jobs whose Gramian or sketch panel is kept too.
KEPT_ROWS = 8
KEPT_OUTPUTS = 4
# A window job this many times the window's median is reported alone; one
# still running after this many times the warm-up median (and at least
# STALL_FLOOR_S) has its threads' stacks dumped.
SLOW_FACTOR = 5.0
STALL_FACTOR = 20.0
STALL_FLOOR_S = 5.0


@dataclasses.dataclass
class JobRecord:
    key: int  # the distinct job it ran
    start: float
    end: float
    construct_s: float
    stages: Dict[str, float]
    n: int
    sites: int
    carriers: int
    pairs: int
    rows: Optional[list] = None  # the emitted (callset id, pc1, pc2) rows,
    # kept for a sample of the window's jobs
    kept: Optional[object] = None  # G on the host, or the sketch panel
    error: Optional[str] = None
    sketch: bool = False
    cpu_s: float = 0.0  # the process's CPU seconds over the job

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads."""

    jobs: List[JobRecord]
    trace: Optional[Trace]


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _counters():
    """The port's route counts: scatter kernel launches, pinned copies,
    and windows by route of the sparse and sketch engines."""
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.arrays import feed
    from spark_examples_tpu_torch.ops import scatter_kernel

    counters = obs.get_registry().snapshot()["counters"]
    out = {
        "scatter_launches": scatter_kernel.SCATTER_KERNEL_LAUNCHES,
        "pinned_copies": feed.PINNED_COPIES,
    }
    for key, value in counters.items():
        if key.startswith(("sparse_gramian_windows_total",
                           "sketch_windows_total")):
            out[key] = value
    return out


def _job_sizes(cohort, job):
    k = cohort.counts()[job.lo:job.hi].astype(np.int64)
    return dict(n=cohort.n, sites=job.hi - job.lo, carriers=int(k.sum()),
                pairs=int((k * k).sum()))


def _run_job(job, out_path, sizes, keep_rows: bool, keep_output: bool):
    import torch
    from torch.profiler import record_function

    from spark_examples_tpu_torch.cli.main import build_parser
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops.sketch import SketchPanel
    from spark_examples_tpu_torch.utils.config import pca_config_from_args

    cpu0 = host_mod.cpu_s()
    start = time.perf_counter()
    rec = JobRecord(key=job.key, start=start, end=start, construct_s=0.0,
                    stages={}, **sizes)
    try:
        with record_function(JOB), open(out_path, "w") as out, \
                contextlib.redirect_stdout(out):
            args = build_parser().parse_args(job.argv)
            conf = pca_config_from_args(args)
            t0 = time.perf_counter()
            with record_function("bench.construct"):
                driver = VariantsPcaDriver(conf, JsonlSource(args.input_path))
            rec.construct_s = time.perf_counter() - t0
            rows = driver.run()
        rec.stages = dict(driver.timer.seconds)
        rec.sketch = isinstance(driver.g, SketchPanel)
        if keep_rows:
            rec.rows = rows
        if keep_output:
            rec.kept = (driver.g if rec.sketch
                        else driver.g.to("cpu").to(torch.float64))
    except Exception as e:  # a job that fails counts as failed, not fatal
        rec.error = f"{type(e).__name__}: {e}"
    rec.end = time.perf_counter()
    rec.cpu_s = host_mod.cpu_s() - cpu0
    return rec


def _fresh_heap() -> None:
    """Collect what the last job left, then move what stays alive (the
    kept rows and outputs, the port's module caches) to the collector's
    permanent generation: each job starts from the same collector state,
    with nothing to scan from earlier jobs, as a fresh ``pca`` process
    would, and not from a heap that grows over the window."""
    gc.collect()
    gc.freeze()


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(name)
    readers = spec.readers(cell) if trace else {}
    work = tempfile.mkdtemp(prefix="benchmark-")
    try:
        cohort = cohort_mod.draw(cell.config, cell.mix, seed)
        root = os.path.join(work, "cohort")
        written = cohort_mod.write_jsonl(cohort, root, seed)
        jobs = jobs_mod.plan(cell.config, cell.mix, cohort, root, seed, device)
        sizes = {j.key: _job_sizes(cohort, j) for j in jobs}
        out_path = os.path.join(work, "job.out")
        _log(f"cohort: {cohort.n} samples, {cohort.sites} sites, "
             f"{cohort.carriers.size} carriers, {written} bytes; "
             f"{len(jobs)} distinct jobs")

        # Warm-up: every distinct job once, the first one twice.
        warm = []
        for job in [jobs[0]] + jobs:
            rec = _run_job(job, out_path, sizes[job.key], False, False)
            if rec.error:
                raise RuntimeError(f"warm-up job failed: {rec.error}")
            warm.append(rec.seconds)
        per_job = float(np.median(warm[1:]))
        keep_rng = np.random.default_rng([seed, 4])
        expected = max(1.0, seconds / per_job)
        p_rows = min(1.0, KEPT_ROWS / expected)
        p_output = min(1.0, KEPT_OUTPUTS / expected)
        before = _counters()
        # The cohort and its sidecar reach the disk before the window, so
        # their write-back does not run inside it.
        os.sync()
        _fresh_heap()

        _sync(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        prof = profiler() if trace else contextlib.nullcontext()
        records: List[JobRecord] = []
        kept_rows = kept_outputs = 0
        stall_s = max(STALL_FLOOR_S, STALL_FACTOR * per_job)
        cpu_w0 = host_mod.cpu_s()
        with prof:
            from torch.profiler import record_function

            with record_function(WINDOW):
                t_w0 = time.perf_counter()
                while True:
                    job = jobs[len(records) % len(jobs)]
                    u = keep_rng.random() if records else 0.0
                    rows = kept_rows < KEPT_ROWS and u < p_rows
                    output = kept_outputs < KEPT_OUTPUTS and u < p_output
                    faulthandler.dump_traceback_later(stall_s)
                    rec = _run_job(job, out_path, sizes[job.key], rows,
                                   output)
                    faulthandler.cancel_dump_traceback_later()
                    kept_rows += rec.rows is not None
                    kept_outputs += rec.kept is not None
                    records.append(rec)
                    _fresh_heap()
                    if time.perf_counter() - t_w0 >= seconds:
                        break
                _sync(device)
                t_w1 = time.perf_counter()
        cpu_w = host_mod.cpu_s() - cpu_w0
        gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        after = _counters()
        routes = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        routes["sketch_jobs"] = sum(r.sketch for r in records)
        _log("routes over the window: " + ", ".join(
            f"{k}={v:g}" for k, v in sorted(routes.items())))
        durations = [r.seconds for r in records]
        _log("job seconds: " + ", ".join(
            f"{q}={np.percentile(durations, q):.6f}"
            for q in (0, 25, 50, 75, 95, 100)))
        parts = {"construct": [r.construct_s for r in records]}
        for stage in ("ingest+gramian", "pca", "emit"):
            parts[stage] = [r.stages.get(stage, 0.0) for r in records]
        _log("stage seconds (mean, min, max): " + "; ".join(
            f"{k} {np.mean(v):.4f} {np.min(v):.4f} {np.max(v):.4f}"
            for k, v in parts.items()))
        _log("host over the window: " + host_mod.describe(
            cpu_w, t_w1 - t_w0, len(records)))
        median = float(np.median(durations))
        for i, r in enumerate(records):
            if r.seconds >= SLOW_FACTOR * median:
                _log(f"slow job {i} (distinct job {r.key}): "
                     f"{r.seconds:.6f} s against a median {median:.6f} s; "
                     f"construct {r.construct_s:.6f} s, stages "
                     + ", ".join(f"{k} {v:.6f}" for k, v in r.stages.items())
                     + "; host " + host_mod.describe(r.cpu_s, r.seconds, 1))
        digest = None
        if trace:
            digest = Trace.from_profile(prof, watched=("gramian.accumulate",))
            del prof
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        checks = check_mod.compare(cell, cohort, jobs, records, routes,
                                   seed, device)
        failed = sum(r.error is not None for r in records)
        for r in records:
            if r.error:
                _log(f"job {r.key} failed: {r.error}")
        correct = failed == 0 and all(
            c["value"] <= c["limit"] for c in checks.values())

        metrics = {}
        if trace:
            run = Run(jobs=records, trace=digest)
            units = {m["name"]: m["unit"] for m in cell.per_layer}
            for metric, read in readers.items():
                value = read(run)
                if value is not None:
                    metrics[metric] = {"value": value, "unit": units[metric]}
        else:
            values = {
                "job_s": (t_w1 - t_w0) / len(records),
                "job_p95_s": float(np.percentile(durations, 95)),
                "peak_card_mib": peak / 2**20,
                "setup_s": t_w0 - t_start,
            }
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        result = {
            "correct": bool(correct),
            "attempted": len(records),
            "failed": failed,
            "metrics": metrics,
            "device": _device(device, peak),
        }
        if trace:
            result["device"]["busy_s"] = digest.busy_us() / 1e6
            result["device"]["window_s"] = digest.window_us / 1e6
            result["breakdown"] = {"device_ops": digest.device_ops(),
                                   "idle_gaps": digest.idle_gaps()}
        result["checks"] = checks
        for key, c in checks.items():
            _log(f"check {key}: {c['value']!r} (limit {c['limit']!r})")
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _device(device: str, peak: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
