"""contrib.decoder: StateCell / TrainingDecoder / BeamSearchDecoder
(reference ``contrib/decoder/beam_search_decoder.py``; a copy of
``paddle_tpu/contrib/decoder.py``).

The reference builds these on LoD ragged beams: TrainingDecoder wraps a
DynamicRNN, and BeamSearchDecoder builds a host `while` loop whose beams
grow/shrink as LoD tensors (`beam_search_decoder.py:523`).

Here, as in the JAX package, the same user API lowers to this framework's
control flow: TrainingDecoder drives the DynamicRNN (one ``dynamic_rnn``
op), and BeamSearchDecoder emits the static-width beam While graph (B*K
rows carried through tensor arrays, ``beam_search`` + ``beam_search_decode``
ops).  Static beams mean the `need_reorder`/LoD expansion knobs are
accepted for API parity but do nothing: the caller feeds
`init_ids`/`init_scores` with one row per (sentence, beam) exactly as the
book machine-translation chapter does.
"""

import contextlib

from .. import layers
from ..core import unique_name


class InitState:
    """Initial state of a StateCell (beam_search_decoder.py:43)."""

    def __init__(self, init=None, shape=None, value=0.0,
                 init_boot=None, need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError("init_boot must be provided for "
                             "default-initialized state")
        else:
            # shape is passed VERBATIM like the reference (the user
            # includes the -1 batch dim, beam_search_decoder.py:83)
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=list(shape),
                dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder     # static beams: no-op
        self._dtype = dtype

    @property
    def value(self):
        return self._init


class StateCell:
    """User-defined RNN cell: named inputs, named states, an updater
    registered with @state_cell.state_updater (beam_search_decoder.py:159).
    """

    def __init__(self, inputs, states, out_state, name=None):
        self._inputs = dict(inputs)         # name -> placeholder/None
        self._init_states = dict(states)    # name -> InitState
        self._state_names = list(states)
        self._out_state = out_state
        self._updater = None
        self._cur_states = {}
        self._cur_inputs = {}
        self._pending = {}                  # set_state values this step
        self._decoder = None
        if out_state not in self._init_states:
            raise ValueError(f"out_state {out_state!r} not in states")

    # -- decorator ---------------------------------------------------------
    def state_updater(self, fn):
        self._updater = fn
        return fn

    # -- step-scope accessors (called from inside the updater) -------------
    def get_input(self, name):
        if name not in self._cur_inputs:
            raise ValueError(f"input {name!r} not fed this step")
        return self._cur_inputs[name]

    def get_state(self, name):
        if name not in self._init_states:
            raise ValueError(f"unknown state {name!r} (declared: "
                             f"{self._state_names})")
        if name in self._pending:
            return self._pending[name]
        if name not in self._cur_states:
            self._materialize()
        return self._cur_states[name]

    def set_state(self, name, value):
        if name not in self._init_states:
            raise ValueError(f"unknown state {name!r}")
        self._pending[name] = value

    def out_state(self):
        return self.get_state(self._out_state)

    def compute_state(self, inputs):
        """Bind this step's inputs and run the updater
        (beam_search_decoder.py:330)."""
        if self._updater is None:
            raise ValueError("no @state_cell.state_updater registered")
        self._materialize()
        self._cur_inputs = dict(inputs)
        self._updater(self)

    def update_states(self):
        """Commit set_state values as the next step's states."""
        if self._decoder is not None:
            self._decoder._commit_states(self._pending)
        for n, v in self._pending.items():
            self._cur_states[n] = v
        self._pending = {}

    # -- decoder plumbing --------------------------------------------------
    def _enter(self, decoder, initial_states):
        self._decoder = decoder
        self._cur_states = dict(initial_states)
        self._pending = {}

    def _materialize(self):
        if not self._cur_states and self._decoder is not None:
            self._cur_states = dict(self._decoder._initial_states())


class TrainingDecoder:
    """Train-time decoder over a StateCell: lowers to DynamicRNN (one
    ``dynamic_rnn`` op) — beam_search_decoder.py:384 parity."""

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._drnn = layers.DynamicRNN(name=name)
        self._outputs = []

    @property
    def state_cell(self):
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        with self._drnn.block():
            mems = {}
            for n in self._state_cell._state_names:
                init = self._state_cell._init_states[n].value
                mems[n] = self._drnn.memory(init=init)
            self._mems = dict(mems)
            self._state_cell._enter(self, mems)
            yield
        self._state_cell._decoder = None

    def _initial_states(self):
        return self._mems

    def _commit_states(self, pending):
        for n, v in pending.items():
            self._drnn.update_memory(self._mems[n], v)

    def step_input(self, x, level=0):
        return self._drnn.step_input(x, level=level)

    def static_input(self, x):
        return self._drnn.static_input(x)

    def output(self, *outputs):
        self._drnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        return self._drnn(*args, **kwargs)


class BeamSearchDecoder:
    """Inference beam search over a StateCell
    (beam_search_decoder.py:523): emits the static-beam While graph
    (embedding -> user updater -> score fc -> topk -> beam_search ->
    gather-by-parents), backtracked by beam_search_decode.

    `decode()` uses the default structure; `translation_ids,
    translation_scores = decoder()` afterwards.  `input_var_dict` vars
    ride each step unchanged (static [B*K, ...] rows)."""

    def __init__(self, state_cell, init_ids, init_scores,
                 target_dict_dim, word_dim, input_var_dict=None,
                 topk_size=50, sparse_emb=True, max_len=100, beam_size=1,
                 end_id=1, name=None):
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._name = name or unique_name.generate("beam_search_decoder")
        self._outs = None
        self._pending_states = {}

    @property
    def state_cell(self):
        return self._state_cell

    def _initial_states(self):
        return dict(self._step_states)

    def _commit_states(self, pending):
        self._pending_states.update(pending)

    def decode(self):
        cell = self._state_cell
        counter = layers.zeros(shape=[1], dtype="int64")
        array_len = layers.fill_constant(shape=[1], dtype="int64",
                                         value=self._max_len)
        ids_array = layers.create_array("int64",
                                        capacity=self._max_len + 1)
        scores_array = layers.create_array("float32",
                                           capacity=self._max_len + 1)
        parents_array = layers.create_array("int64",
                                            capacity=self._max_len + 1)
        # states only ever need the PREVIOUS step (ids/scores/parents
        # need full history for the backtrack; states do not): a
        # capacity-1 slot read+rewritten each iteration keeps state
        # memory O(1) instead of O(max_len)
        zero_idx = layers.zeros(shape=[1], dtype="int64")
        state_arrays = {}
        for n in cell._state_names:
            init = cell._init_states[n].value
            arr = layers.create_array(init.dtype, capacity=1)
            layers.array_write(init, array=arr, i=zero_idx)
            state_arrays[n] = arr
        init_parents = layers.fill_constant_batch_size_like(
            input=self._init_ids, shape=[-1], dtype="int64", value=0)
        layers.array_write(self._init_ids, array=ids_array, i=counter)
        layers.array_write(self._init_scores, array=scores_array,
                           i=counter)
        layers.array_write(init_parents, array=parents_array, i=counter)

        cond = layers.less_than(x=counter, y=array_len)
        while_op = layers.While(cond=cond)
        with while_op.block():
            pre_ids = layers.array_read(array=ids_array, i=counter)
            pre_scores = layers.array_read(array=scores_array, i=counter)
            self._step_states = {
                n: layers.array_read(array=state_arrays[n], i=zero_idx)
                for n in cell._state_names}
            emb = layers.embedding(
                input=pre_ids,
                size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb,
                param_attr=layers.ParamAttr(name=self._name + "_emb"))

            feed = dict(self._input_var_dict)
            for input_name in cell._inputs:
                if input_name not in feed:
                    feed[input_name] = emb
            cell._enter(self, self._step_states)
            self._pending_states = {}
            cell.compute_state(inputs=feed)
            out_state = cell.get_state(cell._out_state)
            scores = layers.fc(
                input=out_state, size=self._target_dict_dim,
                act="softmax",
                param_attr=layers.ParamAttr(name=self._name + "_score_w"),
                bias_attr=layers.ParamAttr(name=self._name + "_score_b"))
            k = min(self._topk_size, self._beam_size)
            topk_scores, topk_indices = layers.topk(scores, k=k)
            accu_scores = layers.elementwise_add(
                x=layers.log(topk_scores), y=pre_scores, axis=0)
            selected_ids, selected_scores, parent_idx = \
                layers.beam_search(pre_ids, pre_scores, topk_indices,
                                   accu_scores, self._beam_size,
                                   end_id=self._end_id)
            cell.update_states()
            committed = dict(self._step_states)
            committed.update(self._pending_states)

            layers.increment(x=counter, value=1, in_place=True)
            for n in cell._state_names:
                # reorder states to the surviving beams' parents
                nxt = layers.gather(committed[n], parent_idx)
                layers.array_write(nxt, array=state_arrays[n],
                                   i=zero_idx)
            layers.array_write(selected_ids, array=ids_array, i=counter)
            layers.array_write(selected_scores, array=scores_array,
                               i=counter)
            layers.array_write(parent_idx, array=parents_array, i=counter)
            layers.less_than(x=counter, y=array_len, cond=cond)
        cell._decoder = None

        self._outs = layers.beam_search_decode(
            ids_array, scores_array, self._beam_size, self._end_id,
            parents=parents_array)
        return self._outs

    def __call__(self):
        if self._outs is None:
            raise ValueError("call decode() first")
        return self._outs
