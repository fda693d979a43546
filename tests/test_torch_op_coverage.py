"""Every op type the port's front end can emit has a kernel in the port's
registry, with no list of exceptions.

The front end is every module under ``layers/``, ``clip.py``,
``regularizer.py``, ``optimizer.py``, ``nets.py``, ``contrib/``, and the
modules they build ops through (``layer_helper.py``, ``initializer.py``
and the operator sugar of ``core/framework.py``).  Their sources are read
with ``ast``:

- an ``append_op`` (or ``prepend_op``, ``startup_op``) call whose
  ``type=`` is a string literal emits that type;
- a ``type=`` that is a parameter of an enclosing function (a helper
  such as ``_simple`` or a factory such as ``_reduce_layer``) takes the
  types of that argument at every call of the function, resolved the
  same way, recursively;
- a name bound by a ``for`` loop over a module-level list of literals
  (``layers/ops.py``'s ``_UNARY_OPS``) takes that list's types;
- ``LayerHelper.append_activation``'s type is the ``act=`` a layer is
  given: every literal ``act=`` in the front end's sources (a user's
  own ``act`` string is the user's choice of op);
- a call that only forwards ``*args, **kwargs`` (``LayerHelper``'s
  own ``append_op``) is read at its callers;
- ``type=op.type`` re-emits an op already in a program (``StaticRNN``'s
  unroll), which adds no type.

Any other ``type=`` fails the scan, so a new helper cannot hide a type.
A type is runnable when ``registry._KERNELS`` holds it, or when the
Executor runs it itself: the sub-block ops ``while`` and
``conditional_block`` (``executor._SUB_BLOCK_OPS``).
"""

import ast
import copy
import os

import pytest

from paddle_tpu_torch.core import executor
from paddle_tpu_torch.ops import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def front_end_files():
    files = ["clip.py", "regularizer.py", "optimizer.py", "nets.py",
             "layer_helper.py", "initializer.py",
             os.path.join("core", "framework.py")]
    for sub in ("layers", "contrib"):
        files += sorted(os.path.join(sub, f)
                        for f in os.listdir(os.path.join(PKG, sub))
                        if f.endswith(".py"))
    return files


# the Block and LayerHelper methods that add an op to a program
EMITTERS = ("append_op", "prepend_op", "startup_op")


class Unresolved(Exception):
    pass


def _literal_list(node):
    if isinstance(node, (ast.List, ast.Tuple)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return None


class FrontEnd:
    """The parsed sources, with each node's chain of enclosing functions
    and for-loops."""

    def __init__(self, files):
        self.trees = {f: ast.parse(open(os.path.join(PKG, f)).read(), f)
                      for f in files}
        self.lists = {}           # module-level name -> literal list
        self.parents = {}
        self.calls = []           # (file, Call node)
        for f, tree in self.trees.items():
            for node in ast.walk(tree):
                for child in ast.iter_child_nodes(node):
                    self.parents[child] = node
                if isinstance(node, ast.Call):
                    self.calls.append((f, node))
            for stmt in tree.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    vals = _literal_list(stmt.value)
                    if vals is not None:
                        self.lists[stmt.targets[0].id] = vals

    def enclosing(self, node):
        while node in self.parents:
            node = self.parents[node]
            yield node

    def resolve(self, f, expr, seen=()):
        """The op types `expr` (a ``type=`` or helper argument in file
        `f`) can take."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return {expr.value}
        if not isinstance(expr, ast.Name):
            raise Unresolved(f"{f}:{expr.lineno}: {ast.unparse(expr)}")
        name = expr.id
        for scope in self.enclosing(expr):
            if isinstance(scope, ast.For) and isinstance(scope.target,
                                                         ast.Name) \
                    and scope.target.id == name:
                it = scope.iter
                if isinstance(it, ast.Name) and it.id in self.lists:
                    return set(self.lists[it.id])
                vals = _literal_list(it)
                if vals is not None:
                    return set(vals)
                raise Unresolved(f"{f}:{expr.lineno}: loop over "
                                 f"{ast.unparse(it)}")
            if isinstance(scope, (ast.FunctionDef, ast.Lambda)):
                params = [a.arg for a in scope.args.args]
                if name in params:
                    if isinstance(scope, ast.Lambda):
                        raise Unresolved(f"{f}:{expr.lineno}: lambda {name}")
                    return self.call_args(scope.name, params.index(name),
                                          name, seen)
        raise Unresolved(f"{f}:{expr.lineno}: {name}")

    def call_args(self, fn, pos, kw, seen):
        """Types the argument at position `pos` (or keyword `kw`) of
        every call of function `fn` can take (a call reached again
        through a cycle adds none)."""
        if (fn, pos) in seen:
            return set()
        seen = seen + ((fn, pos),)
        out, n = set(), 0
        for f, call in self.calls:
            callee = call.func
            cname = callee.attr if isinstance(callee, ast.Attribute) \
                else getattr(callee, "id", None)
            if cname != fn:
                continue
            # a method call passes self implicitly
            p = pos - 1 if isinstance(callee, ast.Attribute) and \
                self._is_method(fn) else pos
            arg = next((k.value for k in call.keywords if k.arg == kw),
                       call.args[p] if p < len(call.args) else None)
            if arg is None:
                raise Unresolved(f"{f}:{call.lineno}: {fn}() without "
                                 f"{kw}")
            out |= self.resolve(f, arg, seen)
            n += 1
        if not n:
            # a helper called only from outside the front end: its
            # types cannot be read here
            raise Unresolved(f"{fn}() has no caller in the front end")
        return out

    def _is_method(self, fn):
        for tree in self.trees.values():
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(item, ast.FunctionDef) and \
                                item.name == fn:
                            return True
        return False

    def act_types(self):
        return {k.value.value for _, call in self.calls
                for k in call.keywords
                if k.arg == "act" and isinstance(k.value, ast.Constant)
                and isinstance(k.value.value, str)}

    def emitted(self):
        """{op type: [file:line, ...]} of every type the sources can
        emit; raises :class:`Unresolved` on a ``type=`` no rule reads."""
        types = {}
        for f, call in self.calls:
            callee = call.func
            if not (isinstance(callee, ast.Attribute)
                    and callee.attr in EMITTERS):
                continue
            if call.args and all(isinstance(a, ast.Starred)
                                 for a in call.args) and not any(
                    k.arg == "type" for k in call.keywords):
                continue     # a forwarder; its callers are scanned
            arg = next((k.value for k in call.keywords if k.arg == "type"),
                       call.args[0] if call.args else None)
            if arg is None:
                raise Unresolved(f"{f}:{call.lineno}: append_op without "
                                 f"a type")
            where = f"{f}:{call.lineno}"
            if isinstance(arg, ast.Attribute) and arg.attr == "type" and \
                    isinstance(arg.value, ast.Name) and arg.value.id == "op":
                continue                      # re-emits a program's op
            if isinstance(arg, ast.Name) and arg.id == "act_type" and \
                    any(isinstance(s, ast.FunctionDef)
                        and s.name == "append_activation"
                        for s in self.enclosing(call)):
                found = self.act_types()
            else:
                found = self.resolve(f, arg)
            for t in found:
                types.setdefault(t, []).append(where)
        return types


@pytest.fixture(scope="module")
def emitted():
    return FrontEnd(front_end_files()).emitted()


def missing(types, kernels):
    return sorted(t for t in types if t not in kernels
                  and t not in executor._SUB_BLOCK_OPS)


def test_every_emitted_op_type_has_a_kernel(emitted):
    gaps = missing(emitted, registry._KERNELS)
    assert not gaps, {t: emitted[t] for t in gaps}


def test_scan_reads_the_front_ends_helpers(emitted):
    """The scan reaches through each kind of site: a helper's literal
    argument (``_simple``), a factory (``_reduce_layer``), a helper
    called through another (``_interp`` through ``_simple``), the
    unary list, the operator sugar, the clip, regularizer and optimizer
    rewrites and an activation."""
    for t in ("log_loss", "reduce_prod", "bilinear_interp", "softsign",
              "elementwise_floordiv", "elementwise_pow", "clip_by_norm",
              "squared_l2_norm", "abs", "lars_momentum", "ftrl", "relu"):
        assert t in emitted, t


def test_check_names_a_planted_gap(emitted):
    kernels = copy.copy(registry._KERNELS)
    del kernels["squared_l2_norm"]
    assert missing(emitted, kernels) == ["squared_l2_norm"]


def test_unresolved_type_fails_the_scan():
    """A ``type=`` that no rule reads (here one computed by a call) makes
    the scan raise rather than skip the site."""
    fe = FrontEnd([])
    tree = ast.parse("def f(helper):\n"
                     "    helper.append_op(type=pick(), inputs={})\n")
    fe.trees["planted.py"] = tree
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            fe.parents[child] = node
        if isinstance(node, ast.Call):
            fe.calls.append(("planted.py", node))
    with pytest.raises(Unresolved):
        fe.emitted()


def test_registry_counts_the_ported_types():
    # 126 before this slice, the 77 the front end emitted without a
    # kernel, and the 8 ops of the optimizers
    assert len(registry._KERNELS) >= 211, len(registry._KERNELS)
