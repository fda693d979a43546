"""Recurrent layer builders: dynamic_lstm/lstmp/gru, gru_unit, lstm_unit
(a copy of ``paddle_tpu/layers/rnn.py``; ``StaticRNN`` waits for a later
slice of the port).

Reference: ``python/paddle/fluid/layers/nn.py`` dynamic_lstm/dynamic_gru
builders.  The ops run in ``ops/rnn_ops.py``.
"""

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .sequence import _len_var, _make_lod_out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over a lod input of shape [B, T, 4D] (pre-projected by an fc),
    size = 4*D.  Returns (hidden, cell), both lod [B, T, D]."""
    helper = LayerHelper("lstm", name=name, param_attr=param_attr,
                         bias_attr=bias_attr)
    d = size // 4
    w = helper.create_parameter(helper.param_attr, shape=[d, 4 * d],
                                dtype=dtype)
    bias_size = 7 * d if use_peepholes else 4 * d
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[1, bias_size], dtype=dtype,
                                is_bias=True)
    hidden, h_len = _make_lod_out(helper, input, dtype=dtype)
    cell, c_len = _make_lod_out(helper, input, dtype=dtype)
    if input.shape:
        hidden.shape = tuple(input.shape[:2]) + (d,)
        cell.shape = hidden.shape
    ins = {"Input": [input], "Weight": [w], "Bias": [b],
           "SeqLen": [_len_var(input)]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    helper.append_op(type="lstm", inputs=ins,
                     outputs={"Hidden": [hidden], "Cell": [cell],
                              "OutLen": [h_len]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    helper.append_op(type="assign", inputs={"X": [h_len]},
                     outputs={"Out": [c_len]})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    helper = LayerHelper("lstmp", name=name, param_attr=param_attr,
                         bias_attr=bias_attr)
    d = size // 4
    w = helper.create_parameter(helper.param_attr, shape=[proj_size, 4 * d],
                                dtype=dtype)
    proj = helper.create_parameter(helper.param_attr, shape=[d, proj_size],
                                   dtype=dtype, suffix="proj")
    bias_size = 7 * d if use_peepholes else 4 * d
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[1, bias_size], dtype=dtype,
                                is_bias=True)
    projection, p_len = _make_lod_out(helper, input, dtype=dtype)
    cell, c_len = _make_lod_out(helper, input, dtype=dtype)
    if input.shape:
        projection.shape = tuple(input.shape[:2]) + (proj_size,)
        cell.shape = tuple(input.shape[:2]) + (d,)
    helper.append_op(type="lstmp",
                     inputs={"Input": [input], "Weight": [w],
                             "ProjWeight": [proj], "Bias": [b],
                             "SeqLen": [_len_var(input)]},
                     outputs={"Projection": [projection], "Cell": [cell],
                              "OutLen": [p_len]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    helper.append_op(type="assign", inputs={"X": [p_len]},
                     outputs={"Out": [c_len]})
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                name=None):
    """GRU over lod input [B, T, 3D], size = D.  Returns hidden [B, T, D]."""
    helper = LayerHelper("gru", name=name, param_attr=param_attr,
                         bias_attr=bias_attr)
    d = size
    dtype = input.dtype
    w = helper.create_parameter(helper.param_attr, shape=[d, 3 * d],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[1, 3 * d], dtype=dtype, is_bias=True)
    hidden, h_len = _make_lod_out(helper, input, dtype=dtype)
    if input.shape:
        hidden.shape = tuple(input.shape[:2]) + (d,)
    ins = {"Input": [input], "Weight": [w], "Bias": [b],
           "SeqLen": [_len_var(input)]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    helper.append_op(type="gru", inputs=ins,
                     outputs={"Hidden": [hidden], "OutLen": [h_len]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation,
                            "origin_mode": origin_mode})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step; input [B, 3D] pre-projected, size = 3*D (fluid API)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    d = size // 3
    dtype = input.dtype
    w = helper.create_parameter(helper.param_attr, shape=[d, 3 * d],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[1, 3 * d], dtype=dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset = helper.create_variable_for_type_inference(dtype)
    new_hidden = helper.create_variable_for_type_inference(dtype)
    n = input.shape[0] if input.shape else -1
    gate.shape = (n, 3 * d)
    reset.shape = (n, d)
    new_hidden.shape = (n, d)
    helper.append_op(type="gru_unit",
                     inputs={"Input": [input], "HiddenPrev": [hidden],
                             "Weight": [w], "Bias": [b]},
                     outputs={"Gate": [gate], "ResetHiddenPrev": [reset],
                              "Hidden": [new_hidden]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation,
                            "origin_mode": origin_mode})
    return new_hidden, reset, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step (layers/nn.py lstm_unit): fc over [x, h] then the
    lstm_unit op.  Returns (hidden, cell)."""
    from . import nn
    d = cell_t_prev.shape[-1]
    fc_out = nn.fc(input=[x_t, hidden_t_prev], size=4 * d,
                   param_attr=param_attr, bias_attr=bias_attr)
    helper = LayerHelper("lstm_unit", name=name)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c.shape = cell_t_prev.shape
    h.shape = cell_t_prev.shape
    helper.append_op(type="lstm_unit",
                     inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c
