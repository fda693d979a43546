"""ProgramDesc static verifier: a rule registry over the analyses.

The checking half of the reference's ``BuildStrategy``/``ir::Pass``
layer (PAPER.md §L4): rules run over the pure dataflow / shape
analyses and report :class:`Finding`\\ s carrying ``block.idx`` / op
index / var names — so graph bugs surface at the compile seam as
named, located diagnostics instead of opaque trace-time JAX failures
(or silent wrong answers, like a donation-aliasing tear).

Severities: ``error`` findings fail ``FLAGS_validate_program=strict``
at the compile seams; ``warn`` findings are advisory in every mode.
Pure query: verifying a program never mutates it (jitcache hint
fingerprints are byte-identical before/after).
"""

import collections

from ..core.framework import is_grad_var_name, strip_grad_suffix
from . import dataflow as dataflow_mod
from . import shapes as shapes_mod

ERROR = "error"
WARN = "warn"


class Finding:
    """One verifier diagnostic, locatable in the IR."""

    __slots__ = ("rule", "severity", "message", "block_idx", "op_idx",
                 "var")

    def __init__(self, rule, severity, message, block_idx=None,
                 op_idx=None, var=None):
        self.rule = rule
        self.severity = severity
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.var = var

    def location(self):
        loc = []
        if self.block_idx is not None:
            loc.append(f"block {self.block_idx}")
        if self.op_idx is not None:
            loc.append(f"op {self.op_idx}")
        if self.var is not None:
            loc.append(f"var {self.var!r}")
        return " ".join(loc)

    def format(self):
        loc = self.location()
        return f"{self.severity.upper()} [{self.rule}]" + \
            (f" {loc}: " if loc else ": ") + self.message

    def to_dict(self):
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "block_idx": self.block_idx,
                "op_idx": self.op_idx, "var": self.var}

    def __repr__(self):
        return f"Finding({self.format()!r})"


class ProgramVerificationError(RuntimeError):
    """Raised at a compile seam under FLAGS_validate_program=strict."""

    def __init__(self, message, findings):
        super().__init__(message)
        self.findings = findings


# -- rule registry ----------------------------------------------------------

RULES = collections.OrderedDict()    # name -> (severity, fn)


def rule(name, severity):
    def deco(fn):
        RULES[name] = (severity, fn)
        return fn
    return deco


class VerifyContext:
    """Shared analysis state for one verify run (built once, queried by
    every rule)."""

    def __init__(self, program, feed_names=(), fetch_names=()):
        self.program = program
        self.feed_names = set(feed_names)
        self.fetch_names = list(fetch_names)
        self.df = dataflow_mod.build(program, feed_names=feed_names)
        self._shapes = None
        self._donation = None

    @property
    def shapes(self):
        if self._shapes is None:
            self._shapes = shapes_mod.infer(self.program)
        return self._shapes

    # blocks the executor walks with env-transparent semantics: block 0
    # plus while/conditional_block bodies (recursively); self-contained
    # sub-blocks (dynamic_rnn/gpipe) follow kernel-internal conventions
    # the env rules don't apply to.
    def analysis_blocks(self):
        out = []
        stack = [self.program.blocks[0]]
        seen = set()
        while stack:
            blk = stack.pop()
            if blk.idx in seen:
                continue
            seen.add(blk.idx)
            out.append(blk)
            for op in blk.ops:
                for sub in dataflow_mod.sub_blocks(op):
                    stack.append(sub)
        return sorted(out, key=lambda b: b.idx)

    def is_external(self, name, block_idx=0):
        return self.df.is_external(name, block_idx)

    @property
    def donation(self):
        """(state_in, state_out, donated) name sets — the static mirror
        of _CompiledBlock's donation analysis (core/executor.py):
        donated = persistable vars both read-before-written and
        written, whose HBM buffers the jitted step aliases in place."""
        if self._donation is None:
            df0 = self.df.blocks[0]
            blk = self.program.blocks[0]
            state_in, state_out = set(), set()
            for name in set(df0.defs) | set(df0.uses):
                if name in self.feed_names:
                    continue
                v = blk._find_var_recursive(name)
                persistable = v is not None and v.persistable
                first_use = df0.uses.get(name, [None])[0]
                first_def = df0.first_def(name)
                if first_use is not None and (first_def is None or
                                              first_use <= first_def):
                    state_in.add(name)
                if persistable and first_def is not None:
                    state_out.add(name)
            self._donation = (state_in, state_out,
                              sorted(state_in & state_out))
        return self._donation


# -- rules ------------------------------------------------------------------

@rule("dangling-input", ERROR)
def _dangling_input(ctx):
    """Op input name that resolves in no reachable scope: no Variable
    declaration on the parent-block chain, no producing op anywhere,
    and not a runtime feed — nothing can ever supply the value."""
    out = []
    for blk in ctx.analysis_blocks():
        for i, op in enumerate(blk.ops):
            for n in op.input_arg_names:
                if n in ctx.feed_names:
                    continue
                if ctx.df.resolves(n, blk.idx):
                    continue
                if ctx.df.def_sites.get(n):
                    continue       # produced at runtime, declaration-free
                out.append(Finding(
                    "dangling-input", ERROR,
                    f"op {op.type!r} reads {n!r}, which is declared in "
                    f"no reachable scope and produced by no op",
                    block_idx=blk.idx, op_idx=i, var=n))
    return out


@rule("read-before-write", ERROR)
def _read_before_write(ctx):
    """A declared, non-external var read before any visible write: the
    executor's env lookup would hand the kernel None (an opaque
    trace-time crash) or a scope miss."""
    out = []
    for blk in ctx.analysis_blocks():
        for i, op in enumerate(blk.ops):
            for n in op.input_arg_names:
                if ctx.is_external(n, blk.idx):
                    continue
                if not ctx.df.resolves(n, blk.idx) and \
                        not ctx.df.def_sites.get(n):
                    continue       # dangling-input reports this one
                site = dataflow_mod.Site(blk.idx, i)
                if ctx.df.defs_visible_before(n, site):
                    continue
                if ctx.df.def_sites.get(n):
                    msg = (f"op {op.type!r} reads {n!r} before its "
                           f"first write (defined later at "
                           f"{[tuple(s) for s in ctx.df.def_sites[n][:3]]})")
                else:
                    msg = (f"op {op.type!r} reads {n!r}, which is "
                           f"declared but never written, fed, or "
                           f"persistable")
                out.append(Finding("read-before-write", ERROR, msg,
                                   block_idx=blk.idx, op_idx=i, var=n))
    return out


@rule("duplicate-def", ERROR)
def _duplicate_def(ctx):
    """The same var name declared at conflicting shape/dtype in nested
    scopes: Block._find_var_recursive resolves to the innermost one,
    silently shadowing the other declaration."""
    out = []
    for blk in ctx.analysis_blocks():
        if blk.idx == 0:
            continue
        for name, v in blk.vars.items():
            outer = None
            b = blk.parent_block
            while b is not None:
                if name in b.vars:
                    outer = b
                    break
                b = b.parent_block
            if outer is None:
                continue
            ov = outer.vars[name]
            shape_conflict = not shapes_mod.compatible_shapes(
                v.shape, ov.shape)
            dtype_conflict = (v.dtype is not None and
                              ov.dtype is not None and
                              v.dtype != ov.dtype)
            if shape_conflict or dtype_conflict:
                out.append(Finding(
                    "duplicate-def", ERROR,
                    f"{name!r} declared as shape={v.shape} "
                    f"dtype={v.dtype} shadows block {outer.idx}'s "
                    f"declaration shape={ov.shape} dtype={ov.dtype}",
                    block_idx=blk.idx, var=name))
    return out


@rule("unreachable-fetch", ERROR)
def _unreachable_fetch(ctx):
    """A fetch target no reachable op produces and no external source
    (feed / persistable / is_data) supplies."""
    out = []
    for f in ctx.fetch_names:
        if f in ctx.feed_names or ctx.is_external(f):
            continue
        if ctx.df.def_sites.get(f):
            continue
        if ctx.df.resolves(f, 0):
            msg = (f"fetch target {f!r} is declared but computed by no "
                   f"reachable op (pruned out, or the producing op "
                   f"lives in an orphaned block)")
        else:
            msg = f"fetch target {f!r} resolves in no reachable scope"
        out.append(Finding("unreachable-fetch", ERROR, msg, var=f))
    return out


@rule("orphaned-sub-block", ERROR)
def _orphaned_sub_block(ctx):
    """A non-empty block unreachable from the global block through any
    op's Block attr: the executor can never run it, but its ops/vars
    still leak into every whole-program walk (save/size/fingerprint
    surfaces).  Program._prune empties exactly these."""
    out = []
    for blk in ctx.program.blocks:
        if blk.idx in ctx.df.reachable_blocks:
            continue
        if not blk.ops and not blk.vars:
            continue               # pruned husk: harmless by design
        out.append(Finding(
            "orphaned-sub-block", ERROR,
            f"block {blk.idx} (parent {blk.parent_idx}) is unreachable "
            f"from block 0 but still holds {len(blk.ops)} op(s) / "
            f"{len(blk.vars)} var(s) — prune it or re-attach it to an "
            f"op's sub_block attr",
            block_idx=blk.idx))
    return out


@rule("grad-without-forward", ERROR)
def _grad_without_forward(ctx):
    """A ``@GRAD``-suffixed var whose forward counterpart resolves
    nowhere — the backward.py naming discipline guarantees every grad
    var shadows a forward var, so a free-floating grad name is a
    desc-surgery bug (renamed forward var, half-pruned backward)."""
    out = []
    seen = set()
    for blk in ctx.analysis_blocks():
        names = set(blk.vars)
        for op in blk.ops:
            names.update(op.input_arg_names)
            names.update(op.output_arg_names)
        for n in sorted(names):
            if not is_grad_var_name(n) or n in seen:
                continue
            seen.add(n)
            base = strip_grad_suffix(n)
            if not base or ctx.df.resolves(base, blk.idx) or \
                    ctx.df.def_sites.get(base):
                continue
            out.append(Finding(
                "grad-without-forward", ERROR,
                f"gradient var {n!r} has no forward counterpart "
                f"{base!r} in any reachable scope",
                block_idx=blk.idx, var=n))
    return out


_SPARSE_OPS = ("sharded_lookup_table", "sharded_push_grad")
_SPARSE_REQUIRED_ATTRS = ("table_name", "table_dim", "vocab",
                          "num_shards", "endpoints")


@rule("sparse-undeclared-table", ERROR)
def _sparse_undeclared_table(ctx):
    """A sharded lookup/scatter-update op against a table the program
    never declares: ``sparse.shard_program`` stamps the rewritten
    program with its tables' metadata (``_sparse_tables``), and the
    ops themselves must carry the complete routing attrs — a lookup
    referencing a table outside that record (desc surgery, a
    hand-merged program, a stale deserialization) would RPC into
    whatever shard topology happens to be cached, or crash opaquely at
    the host interpreter.  Fail it here, named."""
    declared = getattr(ctx.program, "_sparse_tables", {}) or {}
    out = []
    for blk in ctx.analysis_blocks():
        for i, op in enumerate(blk.ops):
            if op.type not in _SPARSE_OPS:
                continue
            name = op.attrs.get("table_name")
            missing = [a for a in _SPARSE_REQUIRED_ATTRS
                       if not op.attrs.get(a)]
            if missing:
                out.append(Finding(
                    "sparse-undeclared-table", ERROR,
                    f"op {op.type!r} is missing sharding attrs "
                    f"{missing} — not produced by sparse."
                    f"shard_program?",
                    block_idx=blk.idx, op_idx=i, var=name))
                continue
            if name not in declared:
                out.append(Finding(
                    "sparse-undeclared-table", ERROR,
                    f"op {op.type!r} reads sharded table {name!r}, "
                    f"which this program never declares "
                    f"(declared: {sorted(declared)}) — rewrite with "
                    f"sparse.shard_program after "
                    f"declare_sharded_table",
                    block_idx=blk.idx, op_idx=i, var=name))
    return out


@rule("shape-mismatch", ERROR)
def _shape_mismatch(ctx):
    """Static shape inference definitely disagrees with a declaration
    (both sides known, conflicting): the trace would either crash with
    a kernel-level error or silently compute on the wrong geometry."""
    out = []
    for m in ctx.shapes.mismatches:
        if m.kind == "dtype":
            continue               # dtype-mismatch (warn) reports these
        out.append(Finding(
            "shape-mismatch", ERROR,
            f"inferred shape {m.inferred} conflicts with declared "
            f"shape {m.declared}",
            block_idx=m.block_idx, op_idx=m.op_idx, var=m.name))
    return out


@rule("dtype-mismatch", WARN)
def _dtype_mismatch(ctx):
    out = []
    for m in ctx.shapes.mismatches:
        if m.kind != "dtype":
            continue
        out.append(Finding(
            "dtype-mismatch", WARN,
            f"inferred dtype {m.inferred} disagrees with declared "
            f"dtype {m.declared}",
            block_idx=m.block_idx, op_idx=m.op_idx, var=m.name))
    return out


_LOW_FLOATS = {"bfloat16", "float16"}


@rule("amp-dtype-mix", WARN)
def _amp_dtype_mix(ctx):
    """An op consuming fp32 and bf16/fp16 operands at once: the gray
    AMP rule silently downcasts the fp32 side at trace time, which is
    usually fine for activations and usually WRONG for loss terms,
    statistics, and optimizer state.  Ops that manage their own
    precision are exempt."""
    from ..ops.registry import _AMP_EXEMPT, _NOT_DIFFERENTIABLE

    out = []
    for blk in ctx.analysis_blocks():
        for i, op in enumerate(blk.ops):
            if op.type == "cast" or op.type in _AMP_EXEMPT or \
                    op.type in _NOT_DIFFERENTIABLE:
                continue
            dts = {}
            for n in op.input_arg_names:
                dt = ctx.shapes.dtype_of(n)
                if dt is not None and (dt.startswith("float") or
                                       dt == "bfloat16"):
                    dts[dt] = n
            low = _LOW_FLOATS & set(dts)
            if "float32" in dts and low:
                lo = sorted(low)[0]
                out.append(Finding(
                    "amp-dtype-mix", WARN,
                    f"op {op.type!r} mixes float32 ({dts['float32']!r}) "
                    f"with {lo} ({dts[lo]!r}) operands — the gray AMP "
                    f"rule will downcast the float32 side at trace "
                    f"time; cast explicitly if that is not intended",
                    block_idx=blk.idx, op_idx=i))
    return out


@rule("donation-alias", WARN)
def _donation_alias(ctx):
    """The donation-tear class, caught statically: a var the compiled step
    DONATES (persistable, read-then-written in place — its pre-step
    buffer is dead the moment the next step launches) is also fetched,
    i.e. captured by a consumer that outlives the step.  The executor
    defends the fetch path by copying (``_fetches_to_numpy``), but any
    consumer holding a zero-copy view of this state (``np.asarray`` of
    a snapshot, an async checkpoint capture) reads torn step-N+1 bytes
    — the donation-aliasing bug, found statically."""
    if getattr(ctx.program, "_stepguard", None) is not None:
        # guard mode trades donation for skippability (_CompiledBlock:
        # donate=() when a StepGuard is attached) — no buffer is ever
        # aliased, so there is nothing to tear
        return []
    _, _, donated = ctx.donation
    donated = set(donated)
    out = []
    for f in ctx.fetch_names:
        if f in donated:
            out.append(Finding(
                "donation-alias", WARN,
                f"fetch of donated state {f!r}: the step donates this "
                f"buffer (in-place update), so a zero-copy view of the "
                f"fetched value tears when the next step runs — "
                f"consumers must copy (checkpoint.sharded._host_copy "
                f"semantics)",
                var=f))
    return out


# -- entry points -----------------------------------------------------------

def verify_program(program, feed_names=(), fetch_names=(), rules=None,
                   return_context=False):
    """Run the rule registry; returns findings, errors first, each
    carrying block.idx / op index / var name.  Pure query.

    ``return_context=True`` additionally returns the
    :class:`VerifyContext`, so callers that also want the underlying
    analyses (shape result, dataflow, donation sets) read the run that
    already happened instead of re-running inference."""
    ctx = VerifyContext(program, feed_names=feed_names,
                        fetch_names=fetch_names)
    findings = []
    selected = RULES if rules is None else {
        r: RULES[r] for r in rules}
    for name, (severity, fn) in selected.items():
        findings.extend(fn(ctx))
    findings.sort(key=lambda f: (f.severity != ERROR,
                                 f.block_idx if f.block_idx is not None
                                 else -1,
                                 f.op_idx if f.op_idx is not None
                                 else -1))
    if return_context:
        return findings, ctx
    return findings


def errors(findings):
    return [f for f in findings if f.severity == ERROR]


_MAX_PRINTED = 20


def validate_at_seam(program, feed_names=(), fetch_names=(),
                     where="compile"):
    """FLAGS_validate_program hook for the Executor / CompiledProgram /
    Predictor compile seams.  Modes: ``off`` (no-op), ``warn``
    (default: findings go to stderr once per program version),
    ``strict`` (error findings raise :class:`ProgramVerificationError`
    before anything is traced or compiled).

    Runs at most once per (program version, feed set, fetch set); the
    memo lives in a plain attribute, so fingerprints and clones are
    untouched.
    """
    from ..flags import get_flag

    mode = get_flag("validate_program")
    if mode in ("off", "0", "false", False, None):
        return []
    if mode not in ("warn", "strict"):
        mode = "warn"
    key = (program._version, tuple(sorted(feed_names)),
           tuple(fetch_names))
    memo = getattr(program, "_validate_memo", None)
    if memo is None:
        memo = program.__dict__.setdefault("_validate_memo", set())
    if key in memo:
        return []
    import sys

    try:
        findings = verify_program(program, feed_names=feed_names,
                                  fetch_names=fetch_names)
    except Exception as e:     # noqa: BLE001 — the verifier must never
        # take down the runtime it guards; report once and stand aside
        memo.add(key)
        print(f"[paddle_tpu_torch.analysis] {where}: verifier crashed "
              f"({type(e).__name__}: {e}) — skipping validation for "
              f"this program version", file=sys.stderr)
        return []
    errs = errors(findings)
    if mode == "strict" and errs:
        # deliberately NOT memoized: a caller that catches the error
        # and retries must hit the same wall, not slip past a
        # verified-done marker into compiling the broken program
        lines = [f.format() for f in errs[:_MAX_PRINTED]]
        if len(errs) > _MAX_PRINTED:
            lines.append(f"... {len(errs) - _MAX_PRINTED} more")
        raise ProgramVerificationError(
            f"FLAGS_validate_program=strict: program verification "
            f"failed at the {where} seam with {len(errs)} error(s):\n  "
            + "\n  ".join(lines) +
            "\nInspect with analysis.verify_program; set "
            "FLAGS_validate_program=warn (default) or off to bypass.",
            findings)
    memo.add(key)
    if not findings:
        return findings
    print(f"[paddle_tpu_torch.analysis] {where}: "
          f"{len(errs)} error(s), {len(findings) - len(errs)} "
          f"warning(s) for program@v{program._version}:",
          file=sys.stderr)
    for f in findings[:_MAX_PRINTED]:
        print(f"  {f.format()}", file=sys.stderr)
    if len(findings) > _MAX_PRINTED:
        print(f"  ... {len(findings) - _MAX_PRINTED} more",
              file=sys.stderr)
    return findings
