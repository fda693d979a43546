"""LayerHelper — shared machinery for layers/ op-builders.

Reference: ``python/paddle/fluid/layer_helper.py`` — create_parameter emits
the initializer op into the *startup* program and registers the Parameter in
both programs (``layer_helper.py:292``); append_op targets the main program's
current block (``layer_helper.py:58``); append_activation / append_bias_op
sugar.
"""

from .core import framework, unique_name
from .core.framework import default_main_program, default_startup_program
from .param_attr import ParamAttr
from .initializer import ConstantInitializer


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        attr = self.kwargs.get("bias_attr")
        if attr is False:
            return False
        return ParamAttr._to_attr(attr)

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def startup_op(self, *args, **kwargs):
        return self.startup_program.global_block().append_op(*args, **kwargs)

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None, suffix=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        suffix = suffix or ("b" if is_bias else "w")
        if attr.name is None:
            # copy before naming: the same ParamAttr object may be reused
            # for several parameters (e.g. fc over a list of inputs), and
            # mutating it would silently alias them to one weight
            import copy as _copy
            attr = _copy.copy(attr)
            attr.name = unique_name.generate(f"{self.name}.{suffix}_0")
        init = attr.initializer or default_initializer or \
            attr._default_initializer(is_bias)
        shape = [int(s) for s in shape]
        common = dict(shape=shape, dtype=dtype, trainable=attr.trainable,
                      regularizer=attr.regularizer,
                      optimize_attrs={"learning_rate": attr.learning_rate})
        # Param registered in startup program + init op appended there...
        sp = self.startup_program.global_block().create_parameter(
            name=attr.name, **common)
        init(sp, self.startup_program.global_block())
        # ...and in main program (no init op), exactly like the reference.
        mp = self.main_program.global_block().create_parameter(
            name=attr.name, **common)
        mp.gradient_clip_attr = attr.gradient_clip
        mp.sharding = getattr(attr, "sharding", None)
        sp.sharding = mp.sharding
        return mp

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"), dtype=dtype,
            stop_gradient=stop_gradient)

    # alias used by some fluid layer code
    create_tmp_variable = create_variable_for_type_inference

    def create_global_variable(self, persistable=True, dtype="float32",
                               shape=None, name=None):
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            dtype=dtype, shape=shape, persistable=persistable,
            stop_gradient=True)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True, stop_gradient=True)
        initializer(sv, sb)
        return sv

    def input_dtype(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name)
        if isinstance(inputs, (list, tuple)):
            return inputs[0].dtype
        return inputs.dtype

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        out.shape = input_var.shape
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]},
                       attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype)
        out.shape = input_var.shape
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out
