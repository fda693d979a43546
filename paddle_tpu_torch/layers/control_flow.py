"""Control flow layers: ``DynamicRNN`` and the ``BlockGuard`` it records
its step block with (a copy of part of ``paddle_tpu/layers/control_flow.py``;
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
