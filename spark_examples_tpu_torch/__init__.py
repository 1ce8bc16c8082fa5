"""PyTorch/CUDA port of ``spark_examples_tpu`` for NVIDIA Hopper.

Same sub-package and module layout as the JAX package, so each module's
counterpart is found by name. The port imports ``torch`` and ``numpy`` and
never ``jax`` or the JAX package; it keeps its own copies of what it needs.
Entry points compute on ``cuda`` unless the caller passes ``device="cpu"``.
It serves meshless ``pca`` in every ``--pca-mode``; ROADMAP.md lists the
rest in porting order.
"""
