"""Device resolution: the card by default, the CPU only when asked.

Every entry point of the port (``VariantsPcaDriver``,
``sparse_gramian_blockwise``, ``fused_finish``, the CLI) takes a ``device``
argument that defaults to ``"cuda"`` and resolves it here. Without CUDA,
and unless the caller passed ``"cpu"``, resolution raises: a run never
carries on silently on the CPU. ``"cpu"`` is the port's counterpart of the
JAX package's ``JAX_PLATFORMS=cpu``; the tests use it.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``.

    A CUDA device requires ``torch.cuda.is_available()``; resolving one
    also turns TF32 off for float32 matrix products and convolutions. The
    fused finish's subspace iteration needs full f32 products: the JAX
    package measured reduced-precision panel matmuls stalling eigenvector
    refinement at ~1e-4 instead of converging (its ``ops/fused.py``, the
    ``default_matmul_precision("float32")`` block).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (CLI: "
                "--device cpu) to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
