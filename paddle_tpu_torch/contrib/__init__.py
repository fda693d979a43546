"""contrib namespace (reference: ``python/paddle/fluid/contrib/``; the
port of ``paddle_tpu/contrib``).  ``mixed_precision`` and ``decoder`` are
ported; the rest of the JAX package's ``contrib/`` (quantize, slim,
int8_inference, reader, utils) is not yet."""

from . import mixed_precision  # noqa: F401
from . import decoder          # noqa: F401
from .decoder import (InitState, StateCell, TrainingDecoder,  # noqa: F401
                      BeamSearchDecoder)
