"""Control flow layers: ``While``, ``increment`` and the comparison and
logical layers, ``DynamicRNN``, ``PipelineStack``, ``cond_block``,
``Switch``, the tensor arrays, ``IfElse`` and the rank-table family, with
the ``BlockGuard`` they record their sub-blocks with (a copy of
``paddle_tpu/layers/control_flow.py``).

Reference: ``python/paddle/fluid/layers/control_flow.py`` — ``While``:504
builds a while op holding a sub-block (run by a nested Executor,
``controlflow/while_op.cc:50``); ``Switch``:1138; ``IfElse``:1264;
``DynamicRNN``:1394.

Lowering, as in the JAX package: the Executor runs a ``while`` op's
sub-block on the host while its condition holds (``core/executor.py``),
the tensor arrays are dense preallocated buffers (``ops/array_ops.py``),
``Switch`` and ``IfElse`` are ``where`` selects over the full batch, and
a DynamicRNN's step block becomes ONE ``dynamic_rnn`` op
(``ops/rnn_ops.py``) run over the padded time dim.
"""

import contextlib

from ..core import unique_name
from ..core.lod import seq_len_name
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers


class BlockGuard:
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.block = self.program.create_block()
        return self.block

    def __exit__(self, *a):
        self.program.rollback()
        return False


class While:
    """with While(cond).block(): ... — cond must be updated in the block."""

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        if cond.dtype != "bool":
            raise TypeError("While condition must be a bool Variable")

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        guard = BlockGuard(program)
        sub_block = guard.__enter__()
        try:
            yield
        finally:
            guard.__exit__()
        parent_block.append_op(
            type="while",
            inputs={"Condition": [self.cond_var]},
            outputs={},
            attrs={"sub_block": sub_block, "is_test": False})


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def _cmp_layer(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference(
                "bool", stop_gradient=True)
            cond.shape = x.shape
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        return cond
    layer.__name__ = op_type
    return layer


less_than = _cmp_layer("less_than")
less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")
equal = _cmp_layer("equal")
not_equal = _cmp_layer("not_equal")


class DynamicRNN:
    """DynamicRNN (reference ``layers/control_flow.py:1394``): a user-written
    per-timestep block over lod inputs.

    Reference lowering is lod_rank_table + lod_tensor_to_array + a host
    `while` over shrinking length-sorted batches (``math/sequence2batch.h``).
    Here, as in the JAX package, the step block is recorded into a
    sub-block and emitted as ONE ``dynamic_rnn`` op, run once per step of
    the padded time dim (``ops/rnn_ops.py``); finished sequences are masked
    (memories freeze, outputs zero), so no reordering is needed, and the
    generic grad re-runs the loop under torch autograd.
    """

    BEFORE_RNN, IN_RNN, AFTER_RNN = 0, 1, 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.step_inputs = []     # (outer lod var, sub-block step var)
        self.memories = []        # {"mem": var, "init": outer var, "next": var}
        self.outputs_ = []        # per-step output vars (sub-block)
        self.sub_block = None
        self._parent_block = None
        self._stacked = None

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be entered once")
        program = self.helper.main_program
        self._parent_block = program.current_block()
        self.status = DynamicRNN.IN_RNN
        guard = BlockGuard(program)
        self.sub_block = guard.__enter__()
        try:
            yield
        finally:
            guard.__exit__()
            self.status = DynamicRNN.AFTER_RNN
        self._complete()

    def _assert_in(self, what):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{what} must be called inside rnn.block()")

    def step_input(self, x, level=0):
        """x: lod [B, T, ...]; returns the per-step [B, ...] slice var."""
        self._assert_in("step_input")
        step = self.sub_block.create_var(
            name=unique_name.generate(x.name + "@STEP"), dtype=x.dtype,
            stop_gradient=x.stop_gradient)
        if x.shape and len(x.shape) >= 2:
            step.shape = (x.shape[0],) + tuple(x.shape[2:])
        self.step_inputs.append((x, step))
        return step

    def static_input(self, x):
        """Non-recurrent input visible every step; with the dense+lengths
        lowering there is no per-step batch reorder, so the var is simply
        read by the step block (and becomes an explicit Static input)."""
        self._assert_in("static_input")
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in("memory")
        if init is None:
            if shape is None or not self.step_inputs:
                raise ValueError(
                    "memory(shape=...) requires a prior step_input to take "
                    "the batch size from")
            ref = self.step_inputs[0][0]
            init = self._parent_block.create_var(
                name=unique_name.generate("drnn_mem_init"), dtype=dtype,
                stop_gradient=True)
            init.shape = (ref.shape[0] if ref.shape else -1,) + tuple(shape)
            self._parent_block.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [ref]}, outputs={"Out": [init]},
                attrs={"shape": [-1] + list(shape), "value": float(value),
                       "dtype": dtype, "input_dim_idx": 0,
                       "output_dim_idx": 0})
        mem = self.sub_block.create_var(
            name=unique_name.generate("drnn_mem"), dtype=init.dtype)
        mem.shape = init.shape
        self.memories.append({"mem": mem, "init": init, "next": None})
        return mem

    def update_memory(self, ex_mem, new_mem):
        self._assert_in("update_memory")
        for m in self.memories:
            if m["mem"] is ex_mem or m["mem"].name == ex_mem.name:
                m["next"] = new_mem
                return
        raise ValueError(f"{ex_mem.name} is not a DynamicRNN memory")

    def output(self, *outputs):
        self._assert_in("output")
        self.outputs_.extend(outputs)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN or self._stacked is None:
            raise ValueError("rnn() is only valid after rnn.block() closes")
        return self._stacked[0] if len(self._stacked) == 1 \
            else list(self._stacked)

    def _complete(self):
        from ..core.executor import _block_io
        from .sequence import _len_var

        if not self.step_inputs:
            raise ValueError("DynamicRNN needs at least one step_input")
        if not self.outputs_:
            raise ValueError("DynamicRNN needs at least one output")
        for m in self.memories:
            if m["next"] is None:
                raise ValueError(
                    f"memory {m['mem'].name} was never update_memory'd")

        parent = self._parent_block
        step_names = [s.name for _, s in self.step_inputs]
        mem_names = [m["mem"].name for m in self.memories]
        next_names = [m["next"].name for m in self.memories]
        out_names = [o.name for o in self.outputs_]
        reads, writes = _block_io(self.sub_block)
        skip = set(step_names) | set(mem_names)
        static_names = sorted(
            n for n in reads
            if n not in writes and n not in skip
            and parent._find_var_recursive(n) is not None)

        x0 = self.step_inputs[0][0]
        stacked, companions = [], []
        t_dim = x0.shape[1] if x0.shape and len(x0.shape) > 1 else -1
        for o in self.outputs_:
            s = parent.create_var(
                name=unique_name.generate(o.name + "@STACKED"),
                dtype=o.dtype, lod_level=1)
            if o.shape:
                s.shape = (o.shape[0], t_dim) + tuple(o.shape[1:])
            c = parent.create_var(name=seq_len_name(s.name),
                                  shape=(x0.shape[0] if x0.shape else -1,),
                                  dtype="int32", stop_gradient=True)
            stacked.append(s)
            companions.append(c)

        parent.append_op(
            type="dynamic_rnn",
            inputs={"X": [x.name for x, _ in self.step_inputs],
                    "SeqLen": [_len_var(x0).name],
                    "Init": [m["init"].name for m in self.memories],
                    "Static": static_names},
            outputs={"Out": [s.name for s in stacked],
                     "OutLen": [companions[0].name]},
            attrs={"sub_block": self.sub_block,
                   "step_names": step_names, "mem_names": mem_names,
                   "next_names": next_names, "out_names": out_names,
                   "static_names": static_names})
        for c in companions[1:]:
            parent.append_op(type="assign",
                             inputs={"X": [companions[0].name]},
                             outputs={"Out": [c.name]})
        self._stacked = stacked


class PipelineStack:
    """Pipeline parallelism over a homogeneous stage stack (SURVEY §2.4;
    GPipe schedule).  The stage template is recorded ONCE into a
    sub-block; every parameter it reads is hoisted to a stacked
    ``[num_stages, ...]`` parameter sharded over the mesh's "pipe" axis,
    and the ``gpipe`` op (``ops/pipeline_ops.py``) runs the GPipe schedule
    over the mesh's pipe devices.  Off-mesh the same op runs the stages
    in sequence, so pipeline-vs-serial equivalence holds.

    Usage::

        pipe = layers.PipelineStack(num_stages=4, num_microbatches=8)
        with pipe.block():
            h = pipe.stage_input(x)          # [B, D]
            h = layers.fc(h, size=D, act="relu")
            pipe.output(h)
        y = pipe()                           # [B, D] after 4 stages

    Stage input and output must have the same shape (the activation that
    rotates through the ring).
    """

    def __init__(self, num_stages, num_microbatches, name=None):
        self.helper = LayerHelper("pipeline", name=name)
        self.num_stages = int(num_stages)
        self.num_microbatches = int(num_microbatches)
        self.sub_block = None
        self._parent_block = None
        self._in_outer = None
        self._in_var = None
        self._out_var = None
        self._result = None

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        guard = BlockGuard(program)
        self.sub_block = guard.__enter__()
        try:
            yield
        finally:
            guard.__exit__()
        self._complete()

    def stage_input(self, x):
        if self._in_var is not None:
            raise ValueError("PipelineStack takes exactly one stage_input")
        v = self.sub_block.create_var(
            name=unique_name.generate(x.name + "@STAGE"), dtype=x.dtype)
        v.shape = x.shape
        self._in_outer, self._in_var = x, v
        return v

    def output(self, out):
        self._out_var = out

    def __call__(self):
        if self._result is None:
            raise ValueError("pipe() is only valid after pipe.block()")
        return self._result

    def _complete(self):
        from ..core.executor import _block_io
        from ..core.framework import Parameter, default_startup_program

        if self._in_var is None or self._out_var is None:
            raise ValueError(
                "PipelineStack needs one stage_input and one output")
        parent = self._parent_block
        main_global = self.helper.main_program.global_block()
        startup = default_startup_program().global_block()
        s = self.num_stages

        reads, writes = _block_io(self.sub_block)
        param_names, static_names = [], []
        for n in sorted(reads):
            if n in writes or n == self._in_var.name:
                continue
            v = parent._find_var_recursive(n)
            if v is None:
                continue
            if isinstance(v, Parameter):
                param_names.append(n)
            else:
                static_names.append(n)

        # hoist each template parameter to a stacked [S, ...] parameter
        # sharded over "pipe"; retarget its startup init (each stage gets
        # an independent random slice).  A param also read OUTSIDE the
        # stage block can't be hoisted (weight tying across the pipeline
        # boundary) — fail loudly instead of deleting it from under the
        # outer reader.
        def _collect_ops(blk, acc):
            for op in blk.ops:
                acc.add(id(op))
                for v in op.attrs.values():
                    if hasattr(v, "ops") and hasattr(v, "vars"):
                        _collect_ops(v, acc)
            return acc

        sub_ops = _collect_ops(self.sub_block, set())
        for blk in self.helper.main_program.blocks:
            if blk is self.sub_block:
                continue
            for op in blk.ops:
                if id(op) in sub_ops:
                    continue
                tied = set(op.input_arg_names) & set(param_names)
                if tied:
                    raise ValueError(
                        f"parameter(s) {sorted(tied)} are used both "
                        "inside a PipelineStack stage and outside it; "
                        "weight tying across the pipeline boundary is "
                        "not supported (the stage copy is hoisted to a "
                        "stacked per-stage parameter)")
        stacked_names = []
        for n in param_names:
            v = main_global.var(n)
            sname = n + "@STACKED"
            sv = main_global.create_parameter(
                name=sname, shape=(s,) + tuple(v.shape), dtype=v.dtype,
                trainable=getattr(v, "trainable", True))
            sv.sharding = ("pipe",) + (None,) * len(v.shape)
            for op in startup.ops:
                if n in op.output_arg_names:
                    op.outputs = {slot: [sname if x == n else x
                                         for x in names]
                                  for slot, names in op.outputs.items()}
                    if op.attrs.get("shape") is not None:
                        op.attrs = dict(op.attrs,
                                        shape=[s] + list(op.attrs["shape"]))
            if startup.has_var(n):
                stv = startup.var(n)
                startup.create_var(name=sname,
                                   shape=(s,) + tuple(stv.shape or ()),
                                   dtype=stv.dtype, persistable=True)
                startup.vars.pop(n, None)
            main_global.vars.pop(n, None)
            stacked_names.append(sname)

        out = parent.create_var(
            name=unique_name.generate("gpipe_out"),
            dtype=self._out_var.dtype)
        out.shape = self._in_outer.shape
        parent.append_op(
            type="gpipe",
            inputs={"X": [self._in_outer.name],
                    "StackedParam": stacked_names,
                    "Static": static_names},
            outputs={"Out": [out.name]},
            attrs={"sub_block": self.sub_block,
                   "in_name": self._in_var.name,
                   "out_name": self._out_var.name,
                   "param_inner_names": param_names,
                   "static_names": static_names,
                   "num_stages": s,
                   "num_microbatches": self.num_microbatches})
        self._result = out


def cond_block(pred, true_fn_outputs=None):
    raise NotImplementedError(
        "Use layers.Switch or ifelse-style select; a conditional_block op "
        "built into a program runs on the Executor")


class Switch:
    """Piecewise select, used by lr schedules (control_flow.py:1138).

    Lowering: each case writes to output vars via ``where`` ops chained
    over the cases, with no branch on the host.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.cases = []          # [(cond_var or None, [assign ops builder])]
        self.inside = False
        self._pending_assigns = []

    @contextlib.contextmanager
    def case(self, condition):
        self._pending_assigns = []
        self._recording = condition
        yield
        self.cases.append((condition, list(self._pending_assigns)))

    @contextlib.contextmanager
    def default(self):
        self._pending_assigns = []
        yield
        self.cases.append((None, list(self._pending_assigns)))

    def record_assign(self, target, value):
        self._pending_assigns.append((target, value))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        # materialize: out = where(cond1, v1, where(cond2, v2, ... default))
        targets = {}
        for cond, assigns in self.cases:
            for tgt, val in assigns:
                targets.setdefault(tgt.name, (tgt, []))[1].append((cond, val))
        for _, (tgt, branches) in targets.items():
            default_val = None
            cond_vals = []
            for cond, val in branches:
                if cond is None:
                    default_val = val
                else:
                    cond_vals.append((cond, val))
            if default_val is None:
                default_val = cond_vals[-1][1]
            result = default_val
            for cond, val in reversed(cond_vals):
                h = LayerHelper("select")
                out = h.create_variable_for_type_inference(tgt.dtype)
                out.shape = tgt.shape
                h.append_op(type="where",
                            inputs={"Condition": [cond], "X": [val],
                                    "Y": [result]},
                            outputs={"Out": [out]})
                result = out
            tensor_layers.assign(result, tgt)
        return False


# ---------------------------------------------------------------------------
# Tensor arrays (reference write_to_array/read_from_array/lod_array_length
# over a host std::vector<LoDTensor>): a dense preallocated (buffer, count)
# pair indexed on the device (ops/array_ops.py).
# ---------------------------------------------------------------------------

def create_array(dtype, capacity=64):
    """LOD_TENSOR_ARRAY var (control_flow.py:1042).  `capacity` bounds the
    dense buffer — the static analogue of the reference's growable vector
    (the While loop bound in every decode use is static anyway)."""
    helper = LayerHelper("create_array")
    out = helper.main_program.current_block().create_var(
        name=unique_name.generate("tensor_array"), dtype=dtype,
        stop_gradient=True)
    out._ta_capacity = int(capacity)
    helper.append_op(type="tensor_array_create", inputs={},
                     outputs={"Out": [out]}, attrs={"dtype": dtype})
    return out


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    if getattr(array, "_ta_elem_shape", None) is None:
        array._ta_elem_shape = x.shape      # IR-level element shape
    helper.append_op(
        type="write_to_array",
        inputs={"X": [x], "I": [i], "Array": [array]},
        outputs={"Out": [array]},
        attrs={"capacity": getattr(array, "_ta_capacity", 64)})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    out.shape = getattr(array, "_ta_elem_shape", None)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    out.shape = (1,)
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def _logical_layer(op_type, binary=True):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference(
                "bool", stop_gradient=True)
            out.shape = x.shape
        ins = {"X": [x]}
        if binary:
            ins["Y"] = [y]
        helper.append_op(type=op_type, inputs=ins, outputs={"Out": [out]})
        return out
    layer.__name__ = op_type
    return layer


logical_and = _logical_layer("logical_and")
logical_or = _logical_layer("logical_or")
logical_xor = _logical_layer("logical_xor")
logical_not = _logical_layer("logical_not", binary=False)


class IfElse:
    """Row-wise conditional (reference control_flow.py:1264): partitions the
    batch by a bool mask, runs each branch on its rows, merges.

    Lowering, as in the JAX package: both branches run on the FULL batch
    (no split_lod_tensor / gather of the true rows) and ``ie()`` merges the
    i-th outputs of each branch with a ``where`` select on the mask;
    backward is the select's vector-Jacobian product, so a differentiable
    conditional needs no special casing.
    """

    OUT_IF_ELSE_BLOCKS, IN_IF_ELSE_TRUE_BLOCKS, IN_IF_ELSE_FALSE_BLOCKS = \
        range(3)

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.outputs = {True: [], False: []}

    @contextlib.contextmanager
    def true_block(self):
        self.status = IfElse.IN_IF_ELSE_TRUE_BLOCKS
        yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    @contextlib.contextmanager
    def false_block(self):
        self.status = IfElse.IN_IF_ELSE_FALSE_BLOCKS
        yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    def input(self, x):
        """The reference gathers the branch's rows; with the full-batch
        select lowering the branch simply reads x."""
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("ie.input() outside a branch block")
        return x

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("ie.output() outside a branch block")
        branch = self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
        self.outputs[branch].extend(outs)

    def __call__(self):
        t_outs, f_outs = self.outputs[True], self.outputs[False]
        if len(t_outs) != len(f_outs):
            raise ValueError(
                f"IfElse branches returned {len(t_outs)} vs {len(f_outs)} "
                "outputs; they must pair up")
        merged = []
        for tv, fv in zip(t_outs, f_outs):
            h = LayerHelper("ifelse_merge")
            out = h.create_variable_for_type_inference(tv.dtype)
            out.shape = tv.shape
            h.append_op(type="where",
                        inputs={"Condition": [self.cond], "X": [tv],
                                "Y": [fv]},
                        outputs={"Out": [out]})
            merged.append(out)
        return merged


def lod_rank_table(x, level=0):
    """[index, length] table sorted by length desc
    (control_flow.py:1042)."""
    from .sequence import _len_var

    helper = LayerHelper("lod_rank_table")
    out = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    if x.shape:
        out.shape = (x.shape[0], 2)
    helper.append_op(type="lod_rank_table",
                     inputs={"X": [x], "SeqLen": [_len_var(x)]},
                     outputs={"Out": [out]})
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    out.shape = (1,)
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def lod_tensor_to_array(x, table=None):
    helper = LayerHelper("lod_tensor_to_array")
    arr = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_tensor_array"), dtype=x.dtype,
        stop_gradient=True)
    if x.shape and len(x.shape) >= 2:
        arr._ta_elem_shape = (x.shape[0],) + tuple(x.shape[2:])
        arr._ta_capacity = x.shape[1] if x.shape[1] not in (None, -1) \
            else 64
    helper.append_op(type="lod_tensor_to_array", inputs={"X": [x]},
                     outputs={"Out": [arr]})
    return arr


def array_to_lod_tensor(x, table=None, seq_lens=None):
    from .sequence import _make_lod_out

    helper = LayerHelper("array_to_lod_tensor")
    out, out_len = _make_lod_out(helper, x, dtype=x.dtype)
    ins = {"X": [x]}
    if seq_lens is not None:
        ins["SeqLen"] = [seq_lens]
    elif table is not None:
        # the canonical fluid call form: lengths come from the rank table
        ins["RankTable"] = [table]
    helper.append_op(type="array_to_lod_tensor", inputs=ins,
                     outputs={"Out": [out], "OutLen": [out_len]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    from .sequence import _make_lod_out

    helper = LayerHelper("reorder_lod_tensor_by_rank")
    if getattr(x, "lod_level", 0) > 0:
        out, out_len = _make_lod_out(helper, x, dtype=x.dtype)
        outs = {"Out": [out], "OutLen": [out_len]}
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
        outs = {"Out": [out]}
    out.shape = x.shape
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs=outs)
    return out
