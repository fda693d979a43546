"""Control flow layers: ``DynamicRNN``, ``PipelineStack`` and the
``BlockGuard`` they record their sub-blocks with (a copy of part of
``paddle_tpu/layers/control_flow.py``;
``While``, ``cond_block``, the tensor arrays and the rank-table layers wait
for a later slice of the port).

Reference: ``python/paddle/fluid/layers/control_flow.py`` — ``DynamicRNN``
at :1394.  The step block becomes ONE ``dynamic_rnn`` op
(``ops/rnn_ops.py``) run over the padded time dim.
"""

import contextlib

from ..core import unique_name
from ..core.lod import seq_len_name
from ..layer_helper import LayerHelper


class BlockGuard:
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.block = self.program.create_block()
        return self.block

    def __exit__(self, *a):
        self.program.rollback()
        return False


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
