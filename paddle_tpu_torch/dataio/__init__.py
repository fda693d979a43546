"""paddle_tpu_torch.dataio — the input pipeline behind ``PyReader`` (the
part of ``paddle_tpu.dataio`` that ``fluid.layers.py_reader`` needs).

- **pipeline**: ``DataPipeline`` — one thread converts a batched
  reader's items into a bounded queue: backpressure, reader order,
  clean EOF/reset, crash propagation (``WorkerCrashed``).
- **device**: ``DeviceStager``/``FeedHandle`` — double-buffered device
  staging: batch N+1 is copied from pinned host memory on a side CUDA
  stream while batch N computes, and a step's stream waits on the
  copy's event before it reads the batch.

Sharded feeding, length bucketing, resumable iteration and the elastic
rebalance are ROADMAP queue 1 item 12.
"""

from .pipeline import (DataPipeline, DataioConfig,  # noqa: F401
                       PipelineError, WorkerCrashed)
from .device import DeviceStager, FeedHandle  # noqa: F401
