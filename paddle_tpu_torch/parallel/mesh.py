"""Device mesh construction for the dp/tp/pp/sp axes (the port of
``paddle_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over ``jax.devices()`` and
one program runs SPMD over it.  The port keeps its single-controller
model: one process drives a :class:`Mesh` whose entries are
``torch.device`` objects, and the ops that read the mesh (the ring of
``parallel/ring_attention.py``, the GPipe schedule of
``ops/pipeline_ops.py``) place each shard on its entry and move data
between entries where the JAX package ppermutes.  Entries may repeat:
``[torch.device("cpu")] * 8`` in the tests, ``cuda:0`` sixteen times on a
one-card machine, where every move between entries is a device-local
no-op.  One process per card under ``torch.distributed`` is a later
slice (ROADMAP queue 1, the multi-process mesh).
"""

import numpy as np
import torch


class MeshAxes:
    DATA = "data"
    MODEL = "model"
    PIPELINE = "pipe"
    SEQUENCE = "seq"
    EXPERT = "expert"


class Mesh:
    """An ndarray of ``torch.device`` with one name per axis.
    ``shape[axis]`` is the axis's size (as ``jax.sharding.Mesh.shape``)
    and ``devices`` the array itself."""

    def __init__(self, devices, axis_names):
        arr = devices if isinstance(devices, np.ndarray) \
            else _object_array(list(devices))
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def device(self, **coords):
        """The entry at the given axis coordinates; an axis left out
        takes index 0."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise KeyError(f"mesh has no axis {sorted(unknown)}; axes "
                           f"{self.axis_names}")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def _object_array(devices):
    # np.array would try to read a torch.device as a sequence element
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr


def cuda_devices():
    """Every visible CUDA device (what ``jax.devices()`` is to the JAX
    package); empty without one."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes, axis_names=None, devices=None):
    """Build a Mesh from {axis: size} or a list of sizes, over `devices`
    (default: every visible CUDA device)."""
    if isinstance(axis_sizes, dict):
        names = tuple(axis_sizes.keys())
        sizes = tuple(axis_sizes.values())
    else:
        sizes = tuple(axis_sizes)
        names = tuple(axis_names or
                      [MeshAxes.DATA, MeshAxes.MODEL, MeshAxes.PIPELINE,
                       MeshAxes.SEQUENCE][:len(sizes)])
    devices = list(devices) if devices is not None else cuda_devices()
    n = 1
    for s in sizes:
        n *= s
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(_object_array(devices[:n]).reshape(sizes), names)


def data_parallel_mesh(num_devices=None):
    devices = cuda_devices()
    n = num_devices or len(devices)
    if n > len(devices) or n < 1:
        raise ValueError(f"a data-parallel mesh of {n} devices needs "
                         f"that many; have {len(devices)}")
    return Mesh(_object_array(devices[:n]), (MeshAxes.DATA,))


def elastic_factorization(num_hosts, local_devices=None):
    """The mesh factorization for an elastic host set: the data axis
    absorbs hosts x per-host devices (the model and pipeline axes
    survive a re-mesh through a checkpoint reshard-load, so only the
    data extent is recomputed)."""
    n = int(local_devices) if local_devices is not None \
        else len(cuda_devices())
    return {MeshAxes.DATA: int(num_hosts) * n}


_default_mesh = None


def get_default_mesh():
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = data_parallel_mesh()
    return _default_mesh


def set_default_mesh(mesh):
    global _default_mesh
    _default_mesh = mesh
