"""Run manifest: one machine-readable JSON artifact per run.

The JAX package's ``obs/manifest.py`` on PyTorch. A manifest carries the
per-stage decomposition (from the span tracer), the parity accumulators plus
every registry counter, and histogram summaries (RPC latency) — enough to
diff two runs stage by stage.

Schema (``spark_examples_tpu_torch.run_manifest/v1``):

- ``schema``/``created_unix``/``argv``/``command`` — provenance;
- ``config`` — the resolved flag surface (JSON-serializable values only);
- ``environment`` — python/platform, and the torch version, its CUDA
  version and the CUDA devices (count and names) when CUDA is available;
- ``stages`` — ``{name: {"seconds": s, "count": n}}`` from the tracer;
- ``counters``/``gauges``/``histograms`` — the registry snapshot.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["MANIFEST_SCHEMA", "build_manifest", "write_manifest"]

MANIFEST_SCHEMA = "spark_examples_tpu_torch.run_manifest/v1"


def _jsonable(value: Any) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False


def _environment() -> Dict[str, Any]:
    import platform

    env: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "hostname": platform.node(),
        "pid": os.getpid(),
    }
    doc: Dict[str, Any] = {
        "version": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": 0,
        "device_names": [],
    }
    if doc["cuda_available"]:
        count = torch.cuda.device_count()
        doc["device_count"] = count
        doc["device_names"] = [
            torch.cuda.get_device_name(i) for i in range(count)
        ]
    env["torch"] = doc
    return env


def build_manifest(
    config: Optional[Dict[str, Any]] = None,
    tracer=None,
    registry=None,
    command: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the manifest dict from the session's tracer + registry."""
    if tracer is None:
        from spark_examples_tpu_torch.obs.tracer import get_tracer

        tracer = get_tracer()
    if registry is None:
        from spark_examples_tpu_torch.obs.metrics import get_registry

        registry = get_registry()
    seconds = tracer.stage_seconds()
    counts = tracer.stage_counts()
    snap = registry.snapshot()
    manifest: Dict[str, Any] = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": time.time(),
        "command": command,
        "argv": list(sys.argv),
        "config": {
            k: v for k, v in (config or {}).items() if _jsonable(v)
        },
        "environment": _environment(),
        "stages": {
            name: {"seconds": secs, "count": counts.get(name, 0)}
            for name, secs in sorted(seconds.items())
        },
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
    }
    if extra:
        manifest.update(
            {k: v for k, v in extra.items() if _jsonable(v)}
        )
    return manifest


def write_manifest(path: str, manifest: Dict[str, Any]) -> None:
    """Write atomically (tmp + rename) with stable indentation."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
