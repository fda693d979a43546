"""Checkpoint save/load + inference-model export (port of
``paddle_tpu/io.py``).

Reference: ``python/paddle/fluid/io.py`` — save_vars/save_params/
save_persistables (:92,213,441), load mirrors (:490,610,657),
save_inference_model prunes to the feed→fetch subgraph and writes the
program + params (:862), load_inference_model (:1014).

The on-disk format is the JAX package's, byte for byte: a JSON
``__model__`` plus one ``.npy`` per var, or one ``.npz`` when
``params_filename`` is given.  A model dir written by ``paddle_tpu`` loads
here and one written here loads in ``paddle_tpu``.  Loaded values become
tensors of their IR dtype on the executor's device (an int64 var the JAX
package stored narrowed to int32 is widened back).
"""

import json
import os

import numpy as np

from .core.framework import (CUDAPlace, Program, Parameter, Variable,
                             default_main_program)
from .core.executor import _to_numpy, device_of, global_scope
from .ops import registry


def _vars_to_save(main_program, predicate):
    return [v for v in main_program.list_vars() if predicate(v)]


def is_persistable(var):
    return var.persistable and not var.is_data


def is_parameter(var):
    return isinstance(var, Parameter)


def _combined_path(dirname, filename):
    """np.savez appends '.npz' when absent; normalize so save/load agree."""
    path = os.path.join(dirname, filename)
    return path if path.endswith(".npz") else path + ".npz"


def _host(val):
    return _to_numpy(val) if hasattr(val, "detach") else np.asarray(val)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = _vars_to_save(main_program, predicate or is_persistable)
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    if filename is not None:
        blob = {}
        for v in vars:
            val = scope.find_var(v.name)
            if val is not None:
                blob[v.name] = _host(val)
        np.savez(_combined_path(dirname, filename), **blob)
        return
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            continue
        np.save(os.path.join(dirname, v.name + ".npy"), _host(val))


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = _vars_to_save(main_program, predicate or is_persistable)
    scope = global_scope()
    if filename is not None:
        blob = np.load(_combined_path(dirname, filename))
        for v in vars:
            if v.name in blob:
                scope.set_var(v.name, registry.cast_feed(
                    blob[v.name], v.dtype, executor.device))
        return
    for v in vars:
        path = os.path.join(dirname, v.name + ".npy")
        if os.path.exists(path):
            scope.set_var(v.name, registry.cast_feed(
                np.load(path), v.dtype, executor.device))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


def state_from_numpy(arrays, scope=None, place=None, main_program=None):
    """Put host state {name: np.ndarray} — e.g. the JAX package's scope as
    ``models/zoo.py::snapshot_startup`` returns it — into the port's
    Scope as tensors on `place` (default ``CUDAPlace(0)``).  Each tensor
    gets the IR dtype `main_program` (default: the default main program)
    declares for its name; names the program does not declare keep their
    numpy dtype.  Returns the scope."""
    scope = scope if scope is not None else global_scope()
    device = device_of(place if place is not None else CUDAPlace(0))
    main_program = main_program or default_main_program()
    dtypes = {v.name: v.dtype for v in main_program.list_vars()}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        scope.set_var(name, registry.cast_feed(
            arr, dtypes.get(name, arr.dtype.name), device))
    return scope


# ---------------------------------------------------------------------------
# Program serialization (the reference serializes the ProgramDesc proto;
# the JAX package and the port share one JSON schema).
# ---------------------------------------------------------------------------

def program_to_dict(program):
    from .core import framework as fw

    blocks = []
    for blk in program.blocks:
        vars_d = {}
        for name, v in blk.vars.items():
            vars_d[name] = {
                "shape": list(v.shape) if v.shape is not None else None,
                "dtype": v.dtype,
                "lod_level": v.lod_level,
                "persistable": v.persistable,
                "stop_gradient": v.stop_gradient,
                "is_data": v.is_data,
                "is_parameter": isinstance(v, Parameter),
                "trainable": getattr(v, "trainable", False),
            }
        ops = []
        for op in blk.ops:
            attrs = {}
            for k, val in op.attrs.items():
                if isinstance(val, fw.Block):
                    attrs[k] = {"__block__": val.idx}
                elif isinstance(val, tuple):
                    attrs[k] = {"__tuple__": _jsonable(val)}
                else:
                    attrs[k] = _jsonable(val)
            ops.append({"type": op.type, "inputs": op.inputs,
                        "outputs": op.outputs, "attrs": attrs})
        blocks.append({"idx": blk.idx, "parent_idx": blk.parent_idx,
                       "vars": vars_d, "ops": ops})
    return {"blocks": blocks, "random_seed": program.random_seed,
            "version": 1}


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def program_from_dict(d):
    from .core import framework as fw
    p = Program()
    p.random_seed = d.get("random_seed", 0)
    for bd in d["blocks"][1:]:
        blk = fw.Block(p, bd["idx"], bd["parent_idx"])
        p.blocks.append(blk)
    for bd in d["blocks"]:
        blk = p.blocks[bd["idx"]]
        for name, vd in bd["vars"].items():
            kw = dict(name=name, shape=vd["shape"], dtype=vd["dtype"],
                      lod_level=vd["lod_level"],
                      persistable=vd["persistable"],
                      stop_gradient=vd["stop_gradient"])
            if vd.get("is_parameter"):
                v = fw.Parameter(blk, trainable=vd.get("trainable", True),
                                 **kw)
            else:
                v = fw.Variable(blk, is_data=vd.get("is_data", False), **kw)
            blk.vars[name] = v
        for od in bd["ops"]:
            attrs = {}
            for k, val in od["attrs"].items():
                if isinstance(val, dict) and "__block__" in val:
                    attrs[k] = p.blocks[val["__block__"]]
                elif isinstance(val, dict) and "__tuple__" in val:
                    attrs[k] = tuple(val["__tuple__"])
                else:
                    attrs[k] = val
            op = fw.Operator(blk, od["type"])
            op.inputs = {k: list(v) for k, v in od["inputs"].items()}
            op.outputs = {k: list(v) for k, v in od["outputs"].items()}
            op.attrs = attrs
            blk.ops.append(op)
    p.current_block_idx = 0
    return p


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    main_program = main_program or default_main_program()
    pruned = main_program._prune(target_vars)
    pruned = pruned.clone(for_test=True)
    # drop vars unreachable from the pruned feed->fetch subgraph
    # (reference io.py:862 saves only referenced vars)
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    referenced = set(feeded_var_names) | set(fetch_names)
    for blk in pruned.blocks:
        for op in blk.ops:
            referenced.update(op.input_arg_names)
            referenced.update(op.output_arg_names)
    for blk in pruned.blocks:
        blk.vars = {n: v for n, v in blk.vars.items() if n in referenced}
    os.makedirs(dirname, exist_ok=True)
    model_filename = model_filename or "__model__"
    meta = program_to_dict(pruned)
    meta["feed_names"] = list(feeded_var_names)
    meta["fetch_names"] = fetch_names
    with open(os.path.join(dirname, model_filename), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned,
                      filename=params_filename)
    return meta["fetch_names"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    model_filename = model_filename or "__model__"
    with open(os.path.join(dirname, model_filename)) as f:
        meta = json.load(f)
    program = program_from_dict(meta)
    load_persistables(executor, dirname, program, filename=params_filename)
    feed_names = meta["feed_names"]
    fetch_vars = [program.global_block().var(n)
                  for n in meta["fetch_names"]]
    return program, feed_names, fetch_vars
