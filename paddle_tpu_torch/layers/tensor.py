"""Tensor creation/manipulation layers (fluid layers/tensor.py)."""

from ..core.framework import Variable, convert_dtype
from ..layer_helper import LayerHelper


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_program.current_block().create_var(
        name=name, dtype=dtype, persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(persistable=persistable, dtype=dtype,
                                        shape=shape, name=name)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype,
                                                        stop_gradient=True)
    out.shape = tuple(shape)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": convert_dtype(dtype),
                            "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    out.shape = tuple(shape)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = x.shape
    out.stop_gradient = x.stop_gradient
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    shapes = [v.shape for v in input]
    if all(s is not None for s in shapes):
        sh = list(shapes[0])
        ax = axis if axis >= 0 else len(sh) + axis
        if all(s[ax] is not None and s[ax] >= 0 for s in shapes):
            sh[ax] = sum(s[ax] for s in shapes)
        else:
            sh[ax] = -1
        out.shape = tuple(sh)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
        out.shape = input[0].shape
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    from .sequence import propagate_lod
    return propagate_lod(helper, input[0], out)


def assign(input, output=None):
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(dtype=input.dtype)
        output.shape = input.shape
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out.shape = x.shape
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("fill_any_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out.shape = x.shape
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 1.0, "dtype": -1})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def range(start, end, step, dtype="float32"):
    helper = LayerHelper("range")
    svars = []
    for v, nm in ((start, "start"), (end, "end"), (step, "step")):
        if not isinstance(v, Variable):
            v = fill_constant([1], dtype, v)
        svars.append(v)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(type="range",
                     inputs={"Start": [svars[0]], "End": [svars[1]],
                             "Step": [svars[2]]},
                     outputs={"Out": [out]})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    if isinstance(axis, int):
        axis = [axis]
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out
