"""Attention ops (port of ``paddle_tpu/ops/attention_ops.py``).

``fused_attention``: scaled-dot-product attention over [B, H, T, D] with
an additive bias — the core of ``multi_head_attention``
(models/transformer.py).  It always goes through the port's
flash-attention forward (``ops/attention_kernels.py``): the hand-written
CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor.
The reference's measured dispatch (``ops/kernel_select.py``) is not
ported yet.
"""

from . import attention_kernels
from .registry import register, first, current


@register("fused_attention")
def fused_attention(ins, attrs):
    q = first(ins, "Q")                   # [B, H, Tq, D]
    k = first(ins, "K")
    v = first(ins, "V")
    bias = first(ins, "Bias")
    scale = attrs.get("scale", 0.0) or 1.0 / (q.shape[-1] ** 0.5)
    training = not (attrs.get("is_test", False) or current().is_test)
    if attrs.get("dropout_prob", 0.0) and training:
        raise NotImplementedError(
            "fused_attention with attention-weight dropout in training "
            "mode runs in the training slice of the port, which has not "
            "landed yet")
    # the kernel reads dense [B, H, T, D]; split-heads hands over a
    # transposed view, which is made dense here (XLA relayouts it too)
    out = attention_kernels.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), bias=bias,
        causal=attrs.get("causal", False), scale=scale)
    return {"Out": [out]}
