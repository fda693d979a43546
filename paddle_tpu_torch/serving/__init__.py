"""paddle_tpu_torch.serving — dynamic-batching inference over the
Predictor (port of ``paddle_tpu.serving``'s engine core).

    engine = serving.ServingEngine(
        fluid.create_paddle_predictor(fluid.AnalysisConfig(model_dir)),
        serving.ServingConfig(max_batch_size=8, max_wait_ms=5))
    req = engine.submit({"src_ids": ids, ...})   # -> Request future
    (probs,) = req.result(timeout=10)
    print(engine.stats())                        # latencies, occupancy
    engine.stop()                                # graceful drain
"""

from .batcher import (ServingError, ServerOverloaded,  # noqa: F401
                      DeadlineExceeded, RequestCancelled, EngineStopped,
                      Request, ResolvableFuture, MicroBatcher)
from .buckets import (ExecutableCache, choose_bucket,  # noqa: F401
                      default_batch_buckets, pad_rows, unpad_rows,
                      pad_seq, unpad_seq, signature)
from .engine import ServingEngine, ServingConfig  # noqa: F401
from .metrics import Histogram, ServingMetrics  # noqa: F401
from . import fleet  # noqa: F401  (continuous-batching decode over the
#                      paged KV pool, the multi-replica router — see
#                      fleet/, kv/)
from . import disagg  # noqa: F401  (disaggregated prefill/decode over
#                      kv_stream — see disagg/)
from . import sampling  # noqa: F401  (per-request decode control:
#                      SamplingConfig, constraint steppers — see
#                      sampling/)

__all__ = [
    "ServingEngine", "ServingConfig", "Request", "ResolvableFuture",
    "MicroBatcher",
    "ServingError", "ServerOverloaded", "DeadlineExceeded",
    "RequestCancelled", "EngineStopped", "ExecutableCache",
    "ServingMetrics", "Histogram", "choose_bucket",
    "default_batch_buckets", "pad_rows", "unpad_rows", "pad_seq",
    "unpad_seq", "signature", "disagg", "fleet", "sampling",
]
