"""paddle_tpu_torch.serving.kv — paged KV decode memory (port of
``paddle_tpu.serving.kv``, a numpy copy).

The block-table pool that converts decode context memory from
O(slots · max_len) to O(tokens actually live) (``pool.KVBlockPool``,
the PagedAttention model under a fixed-shape discipline — Kwon et al.,
SOSP 2023, PAPERS.md), plus the speculative-decode draft/verify arm
(``speculative``, Leviathan et al., arXiv:2211.17192).
``ContinuousBatchingEngine`` consumes both via
``ContinuousConfig(kv=PagedKVConfig(...))`` and
``speculative=SpeculativeConfig(...)``.  The pool's value planes
(``value_spec``, ``kv_value_spec`` with its int8 arena mode) are the
K/V arenas a paged-attention kernel gathers through the block table:
``ops/paged_kernels.paged_attention`` (K4) and its int8 arm
``ops/quant_kernels.paged_attention_quant`` (K5).  As in the JAX
package, the decode step does not call them: it recomputes over
``token_view()``.
"""

from .pool import (KVBlockPool, PagedKVConfig,  # noqa: F401
                   PoolExhausted)
from .speculative import (SpeculativeConfig,  # noqa: F401
                          accept_drafts, accept_drafts_sampled)

__all__ = ["KVBlockPool", "PagedKVConfig", "PoolExhausted",
           "SpeculativeConfig", "accept_drafts", "accept_drafts_sampled"]
