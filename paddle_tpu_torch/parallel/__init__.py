"""Parallelism utilities — the device mesh, the multi-host env contract
and ring attention (the port of ``paddle_tpu/parallel``).

The JAX package maps the reference's NCCL context maps onto a
``jax.sharding.Mesh`` and XLA collectives.  The port is single-controller:
one process drives a mesh of ``torch.device`` entries (``mesh.py``), and
the ops that need the mesh move shards between its entries themselves.
"""

from .mesh import (make_mesh, data_parallel_mesh,  # noqa: F401
                   elastic_factorization, get_default_mesh,
                   set_default_mesh, Mesh, MeshAxes)
from . import env  # noqa: F401
from .env import (get_trainer_id, get_trainer_endpoints,  # noqa: F401
                  get_num_trainers)
