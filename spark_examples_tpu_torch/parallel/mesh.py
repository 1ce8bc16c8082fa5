"""Device-mesh construction — the topology half of ``--mesh-shape``.

The CLI spec grammar is the JAX package's, ``"axis:size[,axis:size...]"``
(e.g. ``"data:4"``, ``"data:4,model:2"``): name how devices factor over the
variant ("data") and sample ("model") axes, in place of the reference's
``--spark-master`` / ``--num-reduce-partitions`` knobs
(GenomicsConf.scala:42-45,52-53).

A :class:`Mesh` is one process's grid of ``torch.device``s — the JAX
package's single-controller mesh: one process drives every device of the
grid. On the card it takes ``cuda:0 … cuda:n-1`` (in a multi-process run,
this process's own ``cuda:LOCAL_RANK``); on the CPU, which has one device,
it repeats that device as many times as the spec names, the counterpart
of the JAX tests' ``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "mesh_spans_processes",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device``s whose axes are named by ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} axes given {len(axis_names)} "
                f"names {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (JAX ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ",".join(f"{k}:{v}" for k, v in self.shape.items())
        return f"Mesh({axes}; {self.devices.flat[0]})"


def mesh_spans_processes(mesh: Mesh) -> bool:
    """Does this mesh cross a process boundary (the pod regime)?

    The one topology predicate the accumulator routing keys on. A port
    mesh is always one process's own devices, so this is False: the pod
    regime (process-spanning meshes, the per-step synced streams) is
    ROADMAP.md step C2.
    """
    return False


def _default_devices(device, want: int):
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(want, 1)
    if dev.index is not None:
        return [dev]
    from spark_examples_tpu_torch.parallel import distributed

    if distributed.process_count() > 1:
        # One card per rank: a rank's mesh is its own device.
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    spec: Optional[str] = None,
    devices: Optional[Sequence] = None,
    device=DEFAULT_DEVICE,
) -> Mesh:
    """Build a Mesh from a spec string; default = every device on "data".

    ``devices`` is an explicit device list; without it the mesh takes the
    devices of ``device`` (the card unless the caller asks for ``"cpu"``,
    whose one device repeats as often as the spec names).
    """
    names, sizes = [], []
    for part in spec.split(",") if spec else ():
        try:
            name, size = part.strip().split(":")
            sizes.append(int(size))
        except ValueError:
            raise ValueError(
                f"bad mesh spec segment {part!r} in {spec!r}: expected "
                "'axis:size[,axis:size...]', e.g. 'data:4,model:2'"
            ) from None
        if sizes[-1] < 1:
            raise ValueError(
                f"mesh axis {name!r} has non-positive size {sizes[-1]} "
                f"in {spec!r}"
            )
        names.append(name)
    want = int(np.prod(sizes)) if sizes else 0
    if devices is None:
        devices = _default_devices(device, want)
    devices = [torch.device(d) for d in devices]
    if not spec:
        return Mesh(_object_array(devices), (DATA_AXIS,))
    if want > len(devices):
        raise ValueError(
            f"mesh spec {spec!r} needs {want} devices, have {len(devices)}"
        )
    return Mesh(_object_array(devices[:want]).reshape(sizes), tuple(names))


def _object_array(devices) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr
