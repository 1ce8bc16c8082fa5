"""The spans of a tile grid's eigensolve: a ``pca`` job on a 2×2 mesh of
CPU devices, above the dense-eigh limit, opens ``pcoa.tiles.sums`` once
(G's row sums, read once a job and shared by the non-zero-rows report and
the centring) and ``pcoa.tiles.product`` once for each centred product of
the randomized iteration, as many as ``sharded_centered_products_total``
counts: 31 for the fixed 30 sweeps and the Ritz product, and whatever the
adaptive iteration used under ``eig_tol``. A span opens once a job or a
product, never once a row."""

import collections
import contextlib
import io

import pytest

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.parallel import ShardedGramian, make_mesh
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.tracing import (
    PCOA_TILES_PRODUCT,
    PCOA_TILES_SUMS,
)

PRODUCTS = "sharded_centered_products_total"


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    synthetic_cohort(61, 400, seed=3, population_structure=2).dump(root)
    return root


def _products():
    return obs.get_registry().snapshot()["counters"].get(PRODUCTS, 0)


@pytest.mark.parametrize("eig_tol", [None, 1e-4], ids=["fixed", "adaptive"])
def test_one_sums_span_a_job_and_one_product_span_a_product(cohort_dir,
                                                           eig_tol):
    from torch.profiler import ProfilerActivity, profile

    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                  bases_per_partition=20000, pca_mode="sparse",
                  dense_eigh_limit=16, eig_tol=eig_tol),
        JsonlSource(cohort_dir),
        mesh=make_mesh("data:2,model:2", device="cpu"),
    )
    before = _products()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            contextlib.redirect_stdout(io.StringIO()):
        driver.run()
    products = _products() - before
    assert isinstance(driver.g, ShardedGramian)
    names = collections.Counter(e.name for e in prof.events())
    assert names[PCOA_TILES_SUMS] == 1
    assert names[PCOA_TILES_PRODUCT] == products
    if eig_tol is None:
        assert products == 31
    else:
        assert 0 < products <= 36
