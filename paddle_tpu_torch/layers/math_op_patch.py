"""Variable operator sugar (fluid's math_op_patch.py)."""

from ..core.framework import Variable
from ..layer_helper import LayerHelper


def binary_op(x, other, op_type, reverse=False):
    helper = LayerHelper(op_type)
    if not isinstance(other, Variable):
        # scalar: use scale/fill path
        val = float(other)
        if op_type == "elementwise_add":
            return _scale(x, 1.0, val, helper)
        if op_type == "elementwise_sub" and not reverse:
            return _scale(x, 1.0, -val, helper)
        if op_type == "elementwise_sub" and reverse:
            return _scale(x, -1.0, val, helper)
        if op_type == "elementwise_mul":
            return _scale(x, val, 0.0, helper)
        if op_type == "elementwise_div" and not reverse:
            return _scale(x, 1.0 / val, 0.0, helper)
        # fall back: materialize a constant tensor
        from . import tensor as tensor_layers
        other = tensor_layers.fill_constant(shape=[1], dtype=x.dtype,
                                            value=val)
    a, b = (other, x) if reverse else (x, other)
    out = helper.create_variable_for_type_inference(dtype=a.dtype)
    out.shape = a.shape if a.shape is not None else b.shape
    helper.append_op(type=op_type, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def _scale(x, scale, bias, helper):
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": True})
    return out
