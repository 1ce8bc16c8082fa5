"""Device-mesh construction — the topology half of ``--mesh-shape``.

The CLI spec grammar is the JAX package's, ``"axis:size[,axis:size...]"``
(e.g. ``"data:4"``, ``"data:4,model:2"``): name how devices factor over the
variant ("data") and sample ("model") axes, in place of the reference's
``--spark-master`` / ``--num-reduce-partitions`` knobs
(GenomicsConf.scala:42-45,52-53).

A :class:`Mesh` is a grid of ``torch.device``s with, beside it, the grid
of the process (the ``torch.distributed`` rank) that owns each device.
Without a process group every device is this process's: the JAX
package's single-controller mesh, one process driving ``cuda:0 …
cuda:n-1``. In a process group :func:`make_mesh` takes the group's
**global** device list, rank by rank, as ``jax.devices()`` does, so a spec
of more devices than one rank holds spans processes — the pod regime
(:func:`mesh_spans_processes`). On the card each rank contributes its own
``cuda:LOCAL_RANK``; on the CPU, which has one device, each rank
contributes ``want // world`` copies of it (the counterpart of the JAX
tests' ``--xla_force_host_platform_device_count``). An explicit
``devices`` list is always this process's own: a host-local mesh.
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


def _rank() -> int:
    from spark_examples_tpu_torch.parallel import distributed

    return distributed.process_index()


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device``s whose axes are named by ``axis_names``;
    ``processes`` is the int grid of the rank that owns each device (this
    process's rank everywhere when omitted). A device of another rank is
    named only: this process never touches it."""

    def __init__(
        self,
        devices: np.ndarray,
        axis_names: Sequence[str],
        processes: Optional[np.ndarray] = None,
    ):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} axes given {len(axis_names)} "
                f"names {tuple(axis_names)}"
            )
        if processes is None:
            processes = np.full(devices.shape, _rank(), dtype=np.int64)
        processes = np.asarray(processes, dtype=np.int64)
        if processes.shape != devices.shape:
            raise ValueError(
                f"process grid {processes.shape} does not match the "
                f"device grid {devices.shape}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = processes

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (JAX ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self, index) -> bool:
        """Is the device at grid ``index`` this process's?"""
        return int(self.processes[index]) == _rank()

    def local_devices(self):
        """This process's devices, in grid order."""
        return list(self.devices[self.processes == _rank()])

    def __repr__(self) -> str:
        axes = ",".join(f"{k}:{v}" for k, v in self.shape.items())
        procs = sorted({int(p) for p in self.processes.flat})
        where = f"; processes {procs}" if len(procs) > 1 else ""
        return f"Mesh({axes}; {self.devices.flat[0]}{where})"


def mesh_spans_processes(mesh: Mesh) -> bool:
    """Does this mesh cross a process boundary (the pod regime)?

    The one topology predicate the accumulator routing keys on (JAX
    ``parallel/mesh.py:24-34``): a process-spanning mesh makes every
    accumulation step a collective (the per-step synced streams of
    :mod:`~spark_examples_tpu_torch.parallel.sharded`), while a
    host-local mesh feeds its devices independently.
    """
    return len({int(p) for p in mesh.processes.flat}) > 1


def _global_devices(device, want: int):
    """The device list :func:`make_mesh` takes without an explicit one,
    and the rank owning each: every rank's devices, rank by rank."""
    from spark_examples_tpu_torch.parallel import distributed

    dev = resolve_device(device)
    world, rank = distributed.process_count(), distributed.process_index()
    if dev.type == "cpu":
        per = max(want // world, 1)
        return [dev] * (per * world), [r for r in range(world) for _ in
                                       range(per)]
    if world > 1:
        # One card a rank (NCCL takes one rank per card). Another rank's
        # card is named by its index on a host of one card per rank; the
        # process grid, not this name, says who owns it.
        count = max(torch.cuda.device_count(), 1)
        own = torch.device("cuda", torch.cuda.current_device())
        cards = [own if r == rank else torch.device("cuda", r % count)
                 for r in range(world)]
        return cards, list(range(world))
    if dev.index is not None:
        return [dev], [rank]
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(count)], [rank] * count


def make_mesh(
    spec: Optional[str] = None,
    devices: Optional[Sequence] = None,
    device=DEFAULT_DEVICE,
) -> Mesh:
    """Build a Mesh from a spec string; default = every device on "data".

    ``devices`` is an explicit list of this process's devices (a
    host-local mesh); without it the mesh takes the global device list of
    ``device`` (the card unless the caller asks for ``"cpu"``), every
    rank's in rank order when a process group is up.
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
        devices, owners = _global_devices(device, want)
    else:
        devices = [torch.device(d) for d in devices]
        owners = [_rank()] * len(devices)
    devices = _object_array(devices)
    owners = np.asarray(owners, dtype=np.int64)
    if not spec:
        return Mesh(devices, (DATA_AXIS,), owners)
    if want > len(devices):
        raise ValueError(
            f"mesh spec {spec!r} needs {want} devices, have {len(devices)}"
        )
    return Mesh(
        devices[:want].reshape(sizes),
        tuple(names),
        owners[:want].reshape(sizes),
    )


def _object_array(devices) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr
