"""Auto-generated-style unary op layers (fluid layers/ops.py via
layer_function_generator.py — here a simple factory)."""

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "sqrt", "rsqrt", "abs", "ceil",
    "floor", "cos", "sin", "round", "reciprocal", "square", "softplus",
    "softsign", "relu", "gelu", "erf", "log",
]


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out
    layer.__name__ = op_type
    return layer


_g = globals()
for _op in _UNARY_OPS:
    _g[_op] = _make_unary(_op)


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="leaky_relu", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"alpha": alpha})
    return out


def elu(x, alpha=1.0, name=None):
    helper = LayerHelper("elu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="elu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha})
    return out


def relu6(x, threshold=6.0, name=None):
    helper = LayerHelper("relu6", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="relu6", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"threshold": threshold})
    return out


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    return out


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    helper = LayerHelper("hard_sigmoid", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="hard_sigmoid", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"slope": slope, "offset": offset})
    return out


def swish(x, beta=1.0, name=None):
    helper = LayerHelper("swish", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="swish", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"beta": beta})
    return out
