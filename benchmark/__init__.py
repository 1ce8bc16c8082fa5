"""The benchmark of the PyTorch and CUDA port (``spark_examples_tpu_torch``).

One command runs one cell once::

    python3 benchmark/run.py --workload kg1000.chrom --seed 7 --seconds 30 --trace 0

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: the cohort's published shape and
the cuts), a traffic mix (``traffic/<mix>.json``: which jobs run back to
back) and, in a traced run, per-layer metrics (``metrics/<metric>.py``: one
reader each). All three are found by name, so a later cell, configuration,
mix or metric is new files only.

Nothing here imports ``jax`` or the JAX package: the port is driven the way
its own ``pca`` command drives it, and its outputs are judged against a
plain reference (``reference.py``) that imports nothing of the port.
"""
