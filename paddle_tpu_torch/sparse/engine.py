"""Program rewrite + host-op runtime of the sharded embedding engine
(the port of ``paddle_tpu/sparse/engine.py``).

:func:`shard_program` is the dispatch seam of the engine (the
``DistributeTranspiler._rewrite_trainer_dist_tables`` discipline,
rebuilt on the sparse registry): lookups on DECLARED tables become
``sharded_lookup_table`` host ops, their gradient ops become
``sharded_push_grad`` host ops, the table's optimizer ops move to the
owning shards (applied async, touched rows only), and the table var
leaves the trainer program entirely — the full table never
materializes on one device.  Small declared tables (below
``FLAGS_sparse_shard_min_rows``) keep the dense path, warned once.

The two op types execute as host ops of the Executor's interpreter
(``distributed/host_ops.py``) on its per-endpoint lanes: a lookup is
issued at its op and collected before the first op that reads its rows.
"""

import copy

import torch

from . import table as table_mod
from .client import SparseTableClient

SHARDED_LOOKUP_OP = "sharded_lookup_table"
SHARDED_PUSH_OP = "sharded_push_grad"

_LOOKUP_FWD = ("lookup_table", "lookup_table_v2", "lookup_sparse_table")


def _shardable_tables(program, tables):
    """``(used, shardable)`` — two ``{name: cfg}`` dicts: every
    declared table this program actually looks up, and the subset big
    enough to shard (small tables warned out once, kept dense)."""
    from ..flags import get_flag

    declared = tables if tables is not None else table_mod.tables()
    blk = program.global_block()
    used = {}
    for op in blk.ops:
        if op.type in _LOOKUP_FWD:
            w = op.input("W")[0]
            if w in declared:
                used[w] = declared[w]
    floor = get_flag("sparse_shard_min_rows")
    out = {}
    for name, cfg in used.items():
        if cfg.vocab < floor:
            table_mod.warn_once(
                ("small-table", name),
                f"declared sharded table {name!r} has only "
                f"{cfg.vocab} rows (< FLAGS_sparse_shard_min_rows="
                f"{floor}); keeping the dense path — sharding a small "
                f"table costs an RPC per batch for nothing")
            continue
        out[name] = cfg
    return used, out


def _lookup_attrs(cfg, fw_type, trainer_id):
    return {"table_name": cfg.name, "table_dim": cfg.dim,
            "vocab": cfg.vocab, "num_shards": cfg.num_shards,
            "endpoints": list(cfg.endpoints), "dtype": cfg.dtype,
            "padding_idx": cfg.padding_idx,
            "squeeze": fw_type != "lookup_table_v2",
            "trainer_id": trainer_id}


def _grad_fw_type(op):
    """The forward op type a grad op differentiates — only
    ``lookup_table`` has a custom grad; ``lookup_table_v2`` and
    ``lookup_sparse_table`` backward through ``generic_grad`` (attrs
    carry ``fw_type``), which must rewrite the same way or it would
    keep referencing the deleted table var."""
    if op.type == "generic_grad":
        return op.attrs.get("fw_type")
    if op.type.endswith("_grad"):
        return op.type[:-len("_grad")]
    return None


def shard_program(program, startup_program=None, tables=None,
                  trainer_id=0):
    """Rewrite a trained program onto the sharded engine.

    Returns ``(trainer_program, trainer_startup)`` — fresh deep copies;
    the originals are untouched.  Exception: when every declared table
    falls below ``FLAGS_sparse_shard_min_rows`` the dense path is the
    right engine and the INPUT objects are returned unchanged (the
    pass pipeline's identity no-op convention).  ``tables`` defaults to
    every table declared via :func:`table.declare_sharded_table` that
    the program looks up.  Raises when nothing qualifies (a silent
    no-op rewrite hides a typo'd table name), and when a surviving op
    still references the removed table or its gradient — a lookup
    inside a control-flow sub-block, or gradient clipping / weight
    decay mixing the table's grad with live vars — since emitting that
    program would only fail later as a dangling-input verifier error.
    """
    from ..passes.base import OPTIMIZER_OPS

    used, cfgs = _shardable_tables(program, tables)
    if not used:
        raise ValueError(
            "shard_program: no declared sharded table is looked up by "
            f"this program (declared: {sorted(table_mod.tables())})")
    if not cfgs:
        # every declared table fell below FLAGS_sparse_shard_min_rows:
        # the dense path is the right engine — identity, warned above
        return program, startup_program
    prog = copy.deepcopy(program)
    block = prog.global_block()
    new_ops = []
    dropped_grads = set()
    # every arg of a dropped table-optimizer op: its moment/beta-pow
    # accumulators are TABLE-SIZED trainer-resident vars (e.g.
    # wd_table_moment_0 [vocab, D]) — the owning shards keep the real
    # slots, so any candidate no surviving op references must leave the
    # trainer program too, or the headline "full table never
    # materializes on a trainer" invariant dies on the optimizer state
    slot_candidates = set()
    for op in block.ops:
        if op.type in _LOOKUP_FWD and op.input("W")[0] in cfgs:
            cfg = cfgs[op.input("W")[0]]
            no = copy.copy(op)
            no.type = SHARDED_LOOKUP_OP
            no.inputs = {"Ids": list(op.inputs["Ids"])}
            no.outputs = {"Out": list(op.outputs["Out"])}
            no.attrs = _lookup_attrs(cfg, op.type, trainer_id)
            new_ops.append(no)
            continue
        gfw = _grad_fw_type(op)
        if gfw in _LOOKUP_FWD and (op.inputs.get("W") or [None])[0] \
                in cfgs:
            cfg = cfgs[op.input("W")[0]]
            no = copy.copy(op)
            no.type = SHARDED_PUSH_OP
            no.inputs = {"Ids": list(op.inputs["Ids"]),
                         "OutGrad": list(op.inputs["Out@GRAD_OUT"])}
            no.outputs = {}
            no.attrs = _lookup_attrs(cfg, gfw, trainer_id)
            dropped_grads.update(op.output_arg_names)
            new_ops.append(no)
            continue
        if op.type in OPTIMIZER_OPS and op.inputs.get("Param") and \
                op.input("Param")[0] in cfgs:
            # the owning shard applies the update (async, touched rows)
            dropped_grads.update(op.output_arg_names)
            slot_candidates.update(op.input_arg_names)
            slot_candidates.update(op.output_arg_names)
            continue
        if dropped_grads and op.input_arg_names and all(
                n in dropped_grads for n in op.input_arg_names):
            # the sum op merging two lookups' partial grads of a shared
            # table: each partial is pushed SEPARATELY and the owning
            # shard applies each push as its own touched-rows update
            # (the reference's async-mode discipline) — identical math
            # to the dense program for linear optimizers (SGD); for
            # adagrad/adam the moments accumulate per push rather than
            # per merged step.  Either way the trainer-side merge has
            # no remaining consumer — cascade
            dropped_grads.update(op.output_arg_names)
            continue
        new_ops.append(op)
    block.ops = new_ops
    still_used = set()
    for blk in prog.blocks:
        for op in blk.ops:
            still_used.update(op.input_arg_names)
            still_used.update(op.output_arg_names)
    dead_slots = slot_candidates - still_used
    for name, cfg in cfgs.items():
        for blk in prog.blocks:
            blk.vars.pop(name, None)
            for gname in list(blk.vars):
                from ..core.framework import strip_grad_suffix

                if strip_grad_suffix(gname) == name:
                    blk.vars.pop(gname, None)
    for blk in prog.blocks:
        for name in dead_slots:
            blk.vars.pop(name, None)
    # fail LOUD on anything the rewrite could not absorb: a surviving
    # op reading the removed table (a lookup inside a control-flow
    # sub-block — host ops cannot run under traced control flow) or a
    # dropped grad no surviving op produces (gradient clipping's
    # global-norm sum / scale mul mix the table grad with live vars,
    # so the all-inputs-dropped cascade keeps them).  Emitting the
    # program would only fail later as a dangling-input verifier error
    # with no hint of the cause.
    produced = set()
    for blk in prog.blocks:
        for op in blk.ops:
            produced.update(op.output_arg_names)
    offenders = []
    for blk in prog.blocks:
        for op in blk.ops:
            for n in op.input_arg_names:
                if n in cfgs or (n in dropped_grads
                                 and n not in produced):
                    offenders.append(f"{op.type}({n})")
    if offenders:
        raise ValueError(
            "shard_program: surviving op(s) still reference a sharded "
            "table or its gradient after the rewrite: "
            f"{', '.join(sorted(set(offenders))[:5])}. The engine "
            "removes the table var and applies updates shard-side, so "
            "trainer-side consumers cannot be preserved — exclude the "
            "table's param from gradient clipping/weight decay, and "
            "keep lookups on sharded tables out of control-flow "
            "sub-blocks.")
    prog._sparse_tables = {n: c.meta() for n, c in cfgs.items()}

    startup = None
    if startup_program is not None:
        startup = copy.deepcopy(startup_program)
        sblk = startup.global_block()
        gone = set(cfgs) | dead_slots
        sblk.ops = [op for op in sblk.ops
                    if not any(o in gone for o in op.output_arg_names)]
        for name in gone:
            sblk.vars.pop(name, None)
    return prog, startup


# -- host-op runtime --------------------------------------------------------

_clients = {}


def _client_key(name, endpoints, vocab, dim, dtype, tid):
    """The ONE cache-key shape for installed/auto-built clients —
    shared by _client_for and install_client so the two sites cannot
    drift (a hand-duplicated key already caused one silently-ignored
    installed client)."""
    return (name, tuple(endpoints), vocab, dim, dtype, tid)


def _client_for(attrs, tid):
    """Cached SparseTableClient for a lookup/push op's attrs.  Prefers
    the registry declaration (carries optimizer/init config); a program
    deserialized into a fresh process reconstructs a lookup-capable
    config from the op attrs alone."""
    # geometry is part of the key: a table re-declared under the same
    # name/endpoints with a GROWN vocab (routine for CTR) must not keep
    # routing through a stale client's old RowPartition
    key = _client_key(attrs["table_name"], attrs["endpoints"],
                      attrs["vocab"], attrs["table_dim"],
                      attrs.get("dtype", "float32"), tid)
    c = _clients.get(key)
    if c is None:
        cfg = table_mod.get_table(attrs["table_name"])
        if cfg is None or list(cfg.endpoints) != list(
                attrs["endpoints"]):
            cfg = table_mod.ShardedTableConfig(
                attrs["table_name"], attrs["vocab"],
                attrs["table_dim"], attrs["endpoints"],
                dtype=attrs.get("dtype", "float32"),
                padding_idx=attrs.get("padding_idx", -1))
        c = _clients[key] = SparseTableClient(cfg, trainer_id=tid)
    return c


def clear_clients():
    _clients.clear()


def install_client(client, trainer_id=0):
    """Route a table's host-op dispatch through a caller-built
    :class:`SparseTableClient` (custom RPC deadlines/retry — e.g. the
    chaos runner's fast-fail client).  Keyed via the shared
    :func:`_client_key` so the op-attrs lookup hits it."""
    cfg = client.cfg
    key = _client_key(cfg.name, cfg.endpoints, cfg.vocab, cfg.dim,
                      cfg.dtype, trainer_id)
    _clients[key] = client
    return key


def _host(value):
    """A host numpy view of an env value (the executor holds tensors on
    its device, or their pinned copies, ``host_ops.HostCopy``; the
    engine's dedup and routing run on the host)."""
    from ..distributed.host_ops import host_array

    return host_array(value)


def issue_sharded_lookup(op, env, attrs, tid):
    """ISSUE phase of the engine lookup: dedup + per-shard RPCs fire now,
    ``collect()`` puts the rows [ids shape + (D,)] into env later, as a
    tensor on the running executor's device — the executor collects
    before the first op that reads them, so the wire time overlaps the
    device work dispatched in between."""
    from ..ops.nn_ops import squeeze_ids
    from ..ops.registry import current

    client = _client_for(attrs, tid)
    ids = _host(env[op.input("Ids")[0]])
    idx = squeeze_ids(ids) if attrs.get("squeeze", True) else ids
    flat = idx.reshape(-1)
    inner = client.issue_lookup(flat)
    out_name = op.output("Out")[0]
    device = current().device

    def collect():
        out = inner()
        env[out_name] = torch.from_numpy(
            out.reshape(idx.shape + (attrs["table_dim"],))).to(device)

    return collect


def run_sharded_push(op, env, attrs, tid):
    """SelectedRows grad push through the engine: merge duplicates,
    route per owning shard, fire-and-forget on the endpoint lanes (the
    owning shard's async optimizer applies on arrival)."""
    from ..ops.nn_ops import squeeze_ids

    client = _client_for(attrs, tid)
    ids = _host(env[op.input("Ids")[0]])
    og = _host(env[op.input("OutGrad")[0]])
    idx = squeeze_ids(ids) if attrs.get("squeeze", True) else ids
    rows = idx.reshape(-1)
    values = og.reshape(rows.shape[0], -1)
    client.push(rows, values)
