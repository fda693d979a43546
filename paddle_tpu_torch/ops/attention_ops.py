"""Attention ops (port of ``paddle_tpu/ops/attention_ops.py``).

``fused_attention``: scaled-dot-product attention over [B, H, T, D] with
an additive bias and, in training, dropout on the softmax weights — the
core of ``multi_head_attention`` (models/transformer.py).  It always goes
through the port's flash attention (``ops/attention_kernels.py``): the
hand-written CUDA kernels on a CUDA tensor (forward K1; under the generic
grad's recompute, K1 with its lse, then the backward K2a and K2b), their
plain PyTorch versions on a CPU tensor.

The reference dispatches by measurement (``ops/kernel_select.py``, not
ported yet) and takes its in-kernel dropout only on a TPU and only for
Tq·Tk > 512² (``pallas_kernels.py:235-242``), so at BERT's T=128 it
composes.  The port has no measured dispatch yet: on a CUDA tensor it
runs the kernels at every T, dropout or not.  Its dropout mask is keyed
by the reference's per-op seed recipe (``registry.op_seed``) and drawn
by Philox from each element's coordinates, the same bits on the CPU and
the card.
"""

from . import attention_kernels
from .registry import register, first, current, op_seed


@register("fused_attention")
def fused_attention(ins, attrs):
    q = first(ins, "Q")                   # [B, H, Tq, D]
    k = first(ins, "K")
    v = first(ins, "V")
    bias = first(ins, "Bias")
    scale = attrs.get("scale", 0.0) or 1.0 / (q.shape[-1] ** 0.5)
    training = not (attrs.get("is_test", False) or current().is_test)
    p = attrs.get("dropout_prob", 0.0) if training else 0.0
    # the kernels read dense [B, H, T, D]; split-heads hands over a
    # transposed view, which is made dense here (XLA relayouts it too)
    out = attention_kernels.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), bias=bias,
        causal=attrs.get("causal", False), scale=scale, dropout_p=p,
        seed=op_seed(attrs) if p else 0)
    return {"Out": [out]}
