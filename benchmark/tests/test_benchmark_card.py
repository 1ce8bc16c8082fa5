"""On a CUDA card: a cell runs through the benchmark's command, comes
out correct, and the control fails at the cell's own size. Skips without
a card (decided inside each test).

    python3 -m pytest benchmark/tests -m card
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_chrom_cell_runs_correct_on_the_card(trace):
    _need_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kg1000.chrom",
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", trace],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
def test_control_fails_at_the_cell_size():
    _need_card()
    from benchmark import control, spec

    for seed in (1, 2, 3):
        out = control.control_numbers(spec.load(), "kg1000.chrom", seed,
                                      "cuda")
        assert not out["control_passed"], out


def test_run_exits_without_a_result_where_no_card_is_seen():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kg1000.chrom",
         "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
