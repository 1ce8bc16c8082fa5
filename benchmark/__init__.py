"""The benchmark of the PyTorch and CUDA port (``spark_examples_tpu_torch``).

One command runs one cell once::

    python3 benchmark/run.py --workload kg1000.chrom --seed 7 --seconds 30 --trace 0

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: the cohort's published shape and
the cuts), a traffic mix (``traffic/<mix>.json``: which jobs run back to
back) and, in a traced run, per-layer metrics (``metrics/<metric>.py``: one
reader each). All three are found by name, so a later cell, configuration,
mix or metric is new files only.

A run is one process over the cards of its cell: one card, or a mesh of
this process's cards where the mix passes ``--mesh-shape`` (the workload's
``chips`` says how many; ``run.py`` refuses a cell on more cards than it
sees). The pod regime, one process a card under ``torchrun`` with the
``podstream`` exchange, is left out: the harness starts one process, and
its window, peak, trace and check would have to be split over processes.

Nothing here imports ``jax`` or the JAX package: the port is driven the way
its own ``pca`` command drives it, and its outputs are judged against a
plain reference (``reference.py``) that imports nothing of the port.
"""
