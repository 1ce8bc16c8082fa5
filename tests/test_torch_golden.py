"""The port held to the committed golden outputs (``tests/golden/*.tsv``).

The inputs of the JAX package's ``tests/test_golden.py``: the full driver
on ``synthetic_cohort(64, 500, seed=0)`` with ``--precise`` (the host
float64 finish) and 64-variant blocks, in ``auto``, ``stream`` and
``sparse`` and checkpointed; and the two-set identity join of
``synthetic_cohort(32, 300, seed=4)`` as ``setA``/``setB``. Every TSV must
have the golden's keys and dataset labels, and coordinates within 1e-6 of
it.
"""

import os

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import FixtureSource
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.utils.config import PcaConfig

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "brca1_cohort64_seed0-pca.tsv")
JOIN_GOLDEN = os.path.join(GOLDEN_DIR, "join_cohort32_seed4-pca.tsv")
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load(path):
    rows = {}
    with open(path) as f:
        for line in f:
            name, pc1, pc2, dataset = line.rstrip("\n").split("\t")
            rows[(name, dataset)] = (float(pc1), float(pc2))
    return rows


def _assert_matches(got_path, golden_path):
    got, want = _load(got_path), _load(golden_path)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(
            got[key], want[key], atol=TOL, err_msg=str(key)
        )
    return got


@pytest.mark.parametrize(
    "kw",
    [
        {"pca_mode": "auto"},
        {"pca_mode": "stream"},
        {"pca_mode": "sparse"},
        {"pca_mode": "auto", "checkpoint_every": 1,
         "bases_per_partition": 20_000},
    ],
    ids=["auto", "stream", "sparse", "checkpointed"],
)
def test_pipeline_matches_committed_golden(tmp_path, kw):
    if "checkpoint_every" in kw:
        kw = {**kw, "checkpoint_dir": str(tmp_path / "ck")}
    conf = PcaConfig(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID],
        output_path=str(tmp_path / "out"),
        precise=True,
        block_variants=64,
        device="cpu",
        **kw,
    )
    VariantsPcaDriver(conf, synthetic_cohort(64, 500, seed=0)).run()
    got = _assert_matches(str(tmp_path / "out-pca.tsv"), GOLDEN)
    assert len(got) == 64
    if "checkpoint_dir" in kw:
        assert os.path.exists(tmp_path / "ck" / "gramian_snapshot.npz")


def test_two_dataset_join_matches_committed_golden(tmp_path):
    """The multi-dataset identity join: two identical 32-sample cohorts
    under different variant-set ids joined through the full driver, and
    each sample's setA/setB twins at the same coordinates."""
    a = synthetic_cohort(32, 300, variant_set_id="setA", seed=4)
    b = synthetic_cohort(32, 300, variant_set_id="setB", seed=4)
    merged = FixtureSource(
        variants=a._variants + b._variants,
        callsets=a._callsets + b._callsets,
    )
    conf = PcaConfig(
        variant_set_ids=["setA", "setB"],
        precise=True,
        block_variants=64,
        output_path=str(tmp_path / "join"),
        device="cpu",
    )
    VariantsPcaDriver(conf, merged).run()
    got = _assert_matches(str(tmp_path / "join-pca.tsv"), JOIN_GOLDEN)
    assert {dataset for _, dataset in got} == {"setA", "setB"}
    for (name, dataset), (pc1, pc2) in got.items():
        np.testing.assert_allclose(
            (pc1, pc2), got[(name, "setA")], atol=1e-9, err_msg=name
        )
