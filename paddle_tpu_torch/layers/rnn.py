"""Recurrent layer builders: dynamic_lstm/lstmp/gru, gru_unit, lstm_unit,
StaticRNN (a copy of ``paddle_tpu/layers/rnn.py``).

Reference: ``python/paddle/fluid/layers/nn.py`` dynamic_lstm/dynamic_gru
builders and ``layers/control_flow.py:278`` StaticRNN.  The ops run in
``ops/rnn_ops.py``.  StaticRNN unrolls its step block T times directly
into the main block, as the JAX package does; the reference runs a
sub-block executor per step, and unrolling gives the same dataflow.
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


class StaticRNN:
    """Unrolled RNN builder (control_flow.py:278 API).

    Ops appended inside ``with rnn.step()`` are recorded as the step
    template and replayed T-1 more times with per-step var renaming, in
    place of the reference's per-step sub-block executor.  T comes from
    the static time dim of the first step_input.
    """

    BEFORE, IN, AFTER = 0, 1, 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE
        self.seq_len = None           # static T
        self.inputs = []              # (step_var, source_var)
        self.memories = {}            # step_var name -> (mem_var, init, next)
        self.outputs = []             # (step out var, stacked out var)
        self._block = None
        self._op_start = None

    class _StepGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            rnn = self.rnn
            rnn.status = StaticRNN.IN
            rnn._block = rnn.helper.main_program.current_block()
            rnn._op_start = len(rnn._block.ops)
            return rnn

        def __exit__(self, exc_type, *a):
            if exc_type is None:
                self.rnn._complete()
            self.rnn.status = StaticRNN.AFTER

    def step(self):
        return StaticRNN._StepGuard(self)

    def _assert_in_block(self):
        if self.status != StaticRNN.IN:
            raise ValueError("StaticRNN method used outside rnn.step()")

    def step_input(self, x):
        """x: [B, T, D] lod/padded; returns the per-step [B, D] slice var."""
        self._assert_in_block()
        if self.seq_len is None:
            self.seq_len = x.shape[1]
            if self.seq_len in (None, -1):
                raise ValueError("StaticRNN needs a static time dim")
        block = self.helper.main_program.current_block()
        step_var = self.helper.create_variable_for_type_inference(x.dtype)
        step_var.shape = (x.shape[0],) + tuple(x.shape[2:])
        block.append_op(
            type="slice", inputs={"Input": [x]},
            outputs={"Out": [step_var]},
            attrs={"axes": [1], "starts": [0], "ends": [1],
                   "decrease_axis": [1]})
        self.inputs.append((step_var, x))
        return step_var

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               dtype="float32"):
        self._assert_in_block()
        block = self.helper.main_program.current_block()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            init = self.helper.create_variable_for_type_inference(dtype)
            init.shape = tuple(batch_ref.shape[:1]) + tuple(shape[1:])
            block.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [batch_ref]},
                outputs={"Out": [init]},
                attrs={"shape": [-1] + list(shape[1:]), "value": init_value,
                       "dtype": dtype, "input_dim_idx": 0,
                       "output_dim_idx": 0})
        mem = self.helper.create_variable_for_type_inference(init.dtype)
        mem.shape = init.shape
        block.append_op(type="assign", inputs={"X": [init]},
                        outputs={"Out": [mem]})
        self.memories[mem.name] = {"mem": mem, "init": init, "next": None}
        return mem

    def update_memory(self, mem, var):
        self._assert_in_block()
        self.memories[mem.name]["next"] = var

    def output(self, *outputs):
        self._assert_in_block()
        for o in outputs:
            stacked = self.helper.create_variable_for_type_inference(o.dtype)
            self.outputs.append((o, stacked))

    def __call__(self):
        outs = [s for _, s in self.outputs]
        return outs[0] if len(outs) == 1 else outs

    # -- unrolling ---------------------------------------------------------
    def _complete(self):
        from ..core import unique_name

        block = self._block
        template = block.ops[self._op_start:]
        t_total = self.seq_len

        step_outs = {name: [info["next"].name if info["next"] else name]
                     for name, info in self.memories.items()}
        per_step_outputs = {o.name: [o.name] for o, _ in self.outputs}

        for t in range(1, t_total):
            rename = {}
            # memories read the previous step's updated value
            for name, info in self.memories.items():
                rename[name] = step_outs[name][-1]
            for op in template:
                if op.type == "assign" and any(
                        o in self.memories for o in op.output_arg_names):
                    continue  # boundary init assign runs only at t=0
                new_outputs = {}
                for slot, names in op.outputs.items():
                    new_names = []
                    for n in names:
                        nn_ = unique_name.generate(n + f"@t{t}")
                        v = block.vars[n]
                        block.create_var(name=nn_, shape=v.shape,
                                         dtype=v.dtype,
                                         stop_gradient=v.stop_gradient)
                        rename[n] = nn_
                        new_names.append(nn_)
                    new_outputs[slot] = new_names
                new_inputs = {slot: [rename.get(n, n) for n in names]
                              for slot, names in op.inputs.items()}
                attrs = dict(op.attrs)
                if op.type == "slice" and attrs.get("axes") == [1]:
                    # step_input slice advances along time
                    is_step_slice = any(
                        src.name in op.input_arg_names
                        for _, src in self.inputs)
                    if is_step_slice:
                        attrs["starts"] = [t]
                        attrs["ends"] = [t + 1]
                        new_inputs = {slot: list(names)
                                      for slot, names in op.inputs.items()}
                no = block.append_op(type=op.type, inputs=new_inputs,
                                     outputs=new_outputs, attrs=attrs)
                del no  # appended in place
            for name, info in self.memories.items():
                if info["next"] is not None:
                    step_outs[name].append(rename.get(info["next"].name,
                                                      info["next"].name))
            for o, _ in self.outputs:
                per_step_outputs[o.name].append(rename.get(o.name, o.name))

        # stack per-step outputs into [B, T, D]
        for o, stacked in self.outputs:
            names = per_step_outputs[o.name]
            stacked.shape = (o.shape[0], t_total) + tuple(o.shape[1:])
            block.append_op(type="stack", inputs={"X": names},
                            outputs={"Y": [stacked]}, attrs={"axis": 1})
