"""The port's mesh against the JAX package's ``make_mesh``.

Specs, bad specs and oversized specs on an explicit device list give the
JAX package's shapes, axis names and error texts; the CPU's one device
repeats as often as a spec names (the counterpart of the JAX tests'
virtual devices); a mesh never spans processes in this slice.
"""

import jax
import numpy as np
import pytest
import torch

from spark_examples_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_examples_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    mesh_spans_processes,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize(
    "spec",
    ["data:1", "data:4", "data:4,model:2", "data:2,model:2", "model:2,data:4",
     "x:2,y:2,z:2"],
)
def test_specs_give_the_jax_shapes(spec):
    devices = [torch.device("cpu")] * 8
    mesh = make_mesh(spec, devices=devices)
    ref = jax_make_mesh(spec, devices=jax.devices()[:8])
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.devices.shape == ref.devices.shape
    assert not mesh_spans_processes(mesh)


def test_default_mesh_puts_every_device_on_data():
    devices = [torch.device("cpu")] * 3
    mesh = make_mesh(devices=devices)
    ref = jax_make_mesh(devices=jax.devices()[:3])
    assert mesh.axis_names == (DATA_AXIS,) == tuple(ref.axis_names)
    assert mesh.shape == {DATA_AXIS: 3} == dict(ref.shape)


@pytest.mark.parametrize(
    "spec", ["data", "data:x", "data:4,model", "data:2:2", ":", "data:0",
             "data:4,model:-1"],
)
def test_bad_specs_raise_the_jax_texts(spec):
    devices = [torch.device("cpu")] * 8
    with pytest.raises(ValueError) as ours:
        make_mesh(spec, devices=devices)
    with pytest.raises(ValueError) as theirs:
        jax_make_mesh(spec, devices=jax.devices()[:8])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec", ["data:16", "data:4,model:4", "data:9"])
def test_oversized_specs_raise_the_jax_text(spec):
    devices = [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="needs") as ours:
        make_mesh(spec, devices=devices)
    with pytest.raises(ValueError) as theirs:
        jax_make_mesh(spec, devices=jax.devices()[:8])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize(
    "spec,shape",
    [("data:8", {"data": 8}), ("data:4,model:2", {"data": 4, "model": 2}),
     (None, {"data": 1})],
)
def test_the_cpu_device_repeats(spec, shape):
    mesh = make_mesh(spec, device="cpu")
    assert mesh.shape == shape
    assert all(d == CPU for d in mesh.devices.flat)
    assert mesh.size == int(np.prod(list(shape.values())))


def test_the_card_is_the_default_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh("data:1")


def test_mesh_checks_its_names():
    with pytest.raises(ValueError, match="2 axes given 1 names"):
        Mesh(np.empty((2, 2), dtype=object), (DATA_AXIS,))
    mesh = make_mesh(f"{DATA_AXIS}:2,{MODEL_AXIS}:1", device="cpu")
    assert "data:2,model:1" in repr(mesh)
