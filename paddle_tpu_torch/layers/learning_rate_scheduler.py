"""Learning-rate schedules as ops over a global step counter (port of
``paddle_tpu/layers/learning_rate_scheduler.py``).

Reference: ``python/paddle/fluid/layers/learning_rate_scheduler.py`` —
eight schedules built from ops over ``@LR_DECAY_COUNTER@``, a persistable
float counter that an ``increment`` prepended to the main program raises
once a run.  The counter and the learning rate derived from it are
variables of the program, so the optimizer reads a rate that the step's
own ops computed on the device (``optimizer.py`` takes a Variable
learning rate).
"""

import math

from ..core.framework import default_main_program, default_startup_program
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import nn, tensor
from .control_flow import less_than

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The step counter: made once per program, with an ``increment``
    prepended to the main program and the startup program setting it to
    ``begin - 1``, so the first run reads ``begin``."""
    main_block = default_main_program().global_block()
    if LR_COUNTER_NAME in main_block.vars:
        return main_block.vars[LR_COUNTER_NAME]
    counter = main_block.create_var(
        name=LR_COUNTER_NAME, shape=(1,), dtype="float32",
        persistable=True, stop_gradient=True)
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=LR_COUNTER_NAME, shape=(1,), dtype="float32",
                       persistable=True, stop_gradient=True)
    ConstantInitializer(float(begin - 1))(sv, sb)
    main_block.prepend_op(type="increment", inputs={"X": [counter]},
                          outputs={"Out": [counter]}, attrs={"step": 1.0})
    return counter


def noam_decay(d_model, warmup_steps):
    step = _decay_step_counter(1)
    a = step ** -0.5
    b = step * float(warmup_steps ** -1.5)
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _unary("floor", div)
    # rate ** div == exp(div * ln(rate)): a chain of ops on the device
    return learning_rate * _unary("exp", div * math.log(decay_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _unary("floor", div)
    return learning_rate * _unary("exp", -1.0 * float(decay_rate) * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _unary("floor", div)
    denom = div * float(decay_rate) + 1.0
    return nn.elementwise_div(
        tensor.fill_constant([1], "float32", learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        ratio = _unary("ceil", step / float(decay_steps))
        ratio = nn.elementwise_max(
            ratio, tensor.fill_constant([1], "float32", 1.0))
        decay_var = ratio * float(decay_steps)
    else:
        decay_var = tensor.fill_constant([1], "float32", float(decay_steps))
        step = nn.elementwise_min(step, decay_var)
    frac = 1.0 - step / decay_var
    return (learning_rate - end_learning_rate) * \
        _unary("pow", frac, factor=float(power)) + end_learning_rate


def _where(cond, x, y, name):
    helper = LayerHelper(name)
    out = helper.create_variable_for_type_inference("float32")
    out.shape = (1,)
    helper.append_op(type="where",
                     inputs={"Condition": [cond], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in [boundaries[i-1], boundaries[i])."""
    assert len(values) == len(boundaries) + 1
    step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", values[-1])
    for b, v in reversed(list(zip(boundaries, values[:-1]))):
        cond = less_than(step, tensor.fill_constant([1], "float32",
                                                    float(b)))
        lr = _where(cond, tensor.fill_constant([1], "float32", float(v)), lr,
                    "piecewise_decay")
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch = _unary("floor", step / float(step_each_epoch))
    return learning_rate * 0.5 * (
        _unary("cos", epoch * math.pi / float(epochs)) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _decay_step_counter()
    linear = start_lr + (end_lr - start_lr) * (step / float(warmup_steps))
    if not hasattr(learning_rate, "name"):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    cond = less_than(step, tensor.fill_constant([1], "float32",
                                                float(warmup_steps)))
    return _where(cond, linear, learning_rate, "lr_warmup")


def _unary(op_type, v, **attrs):
    """One op of `op_type` over `v` (X -> Out, v's dtype and shape)."""
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(v.dtype)
    out.shape = v.shape
    helper.append_op(type=op_type, inputs={"X": [v]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out
