"""contrib namespace (reference: ``python/paddle/fluid/contrib/``; the
port of ``paddle_tpu/contrib``).  Only ``mixed_precision`` is ported; the
rest of the JAX package's ``contrib/`` (quantize, slim, int8_inference,
decoder, reader, utils) is not yet."""

from . import mixed_precision  # noqa: F401
