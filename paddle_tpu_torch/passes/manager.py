"""PassManager: ordered, configurable, verifier-gated pipeline runner (a
copy of ``paddle_tpu/passes/manager.py``).  The memory-planning passes
(``remat``, ``eager_deletion``, ``plan_donation``: the "memory" preset,
and "all") need ``memplan/``, which is not ported: a spec naming them
raises NotImplementedError.  The port's seams are ``Executor.run``,
``CompiledProgram`` and the Predictor, as in the reference.

``FLAGS_pass_pipeline`` is the user surface (flags.py contract —
``FLAGS_pass_pipeline=default,-cse python train.py``):

* a comma list whose tokens are preset names (expanded in place),
  pass names (appended), or ``-pass`` opt-outs (removed);
* ``off`` / ``none`` / ``0`` disables the pipeline entirely (the
  pre-pipeline behavior, byte-identical fingerprints);
* unknown tokens raise immediately — a typo must not silently run a
  different pipeline than the one the flag author believed they chose.

``apply_at_seam`` is the single entry point a seam calls — it memoizes
the transformed program per (program version, feeds, fetches, pipeline
spec) so a repeated call pays a dict probe.  A pipeline with nothing to
do returns the input object itself.

Invariant gate: after every pass that changed the program, the
verifier must report no NEW error-severity finding (baseline = the
findings the input program already had), else PassVerificationError —
regardless of FLAGS_validate_program, because a pass-introduced error
is a framework bug, not a user one.  (The JAX package's
FLAGS_pass_verify=0, which skips the gate for an A/B of its cost, is not
ported: the gate always runs.)
"""

import collections
import threading
import time

from .base import (PASSES, PassContext, PassVerificationError,
                   op_counts)

PRESETS = {
    "default": ("cse", "dce", "isolate_updates", "isolate_epilogues",
                "amp_propagate", "quantize_weights", "auto_shard"),
    "cleanup": ("cse", "dce"),
    "off": (),
    "none": (),
}

# pass names and presets of the JAX package that need memplan/
_UNPORTED = ("remat", "eager_deletion", "plan_donation", "memory", "all")

PassRecord = collections.namedtuple(
    "PassRecord", ["name", "changed", "ms", "op_delta", "var_delta"])


class PipelineReport:
    """What one pipeline run did — per-pass records + totals."""

    def __init__(self, where="pipeline"):
        self.where = where
        self.records = []

    def add(self, rec):
        self.records.append(rec)

    @property
    def changed(self):
        return any(r.changed for r in self.records)

    def record_for(self, name):
        for r in self.records:
            if r.name == name:
                return r
        return None

    def total_ms(self):
        return sum(r.ms for r in self.records)

    def to_dict(self):
        return {"where": self.where,
                "changed": self.changed,
                "total_ms": round(self.total_ms(), 3),
                "passes": [r._asdict() for r in self.records]}


class _PassMetrics:
    """Process-wide per-pass counters (bench/tests read these the way
    jitcache.METRICS is read)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._d = collections.defaultdict(
            lambda: collections.defaultdict(float))

    def note(self, rec):
        with self._lock:
            e = self._d[rec.name]
            e["runs"] += 1
            e["changed"] += 1 if rec.changed else 0
            e["ms"] += rec.ms
            e["ops_removed"] += max(-rec.op_delta, 0)
            e["vars_removed"] += max(-rec.var_delta, 0)

    def snapshot(self):
        with self._lock:
            return {name: {k: (round(v, 3) if k == "ms" else int(v))
                           for k, v in e.items()}
                    for name, e in self._d.items()}

    def reset(self):
        with self._lock:
            self._d.clear()


METRICS = _PassMetrics()


def resolve_pipeline(spec):
    """Flag value -> ordered pass-name list.  See module docstring."""
    if spec is None or spec is False:
        return []
    s = str(spec).strip()
    if s.lower() in ("", "0", "false", "off", "none"):
        return []
    out = []
    opt_outs = set()
    for tok in (t.strip() for t in s.split(",")):
        if not tok:
            continue
        if tok.lstrip("-") in _UNPORTED:
            raise NotImplementedError(
                f"FLAGS_pass_pipeline: {tok!r} names the memory-planning "
                f"passes, which need memplan/ (not ported yet: ROADMAP "
                f"queue 1 item 7)")
        if tok.startswith("-"):
            name = tok[1:]
            if name not in PASSES:
                raise ValueError(
                    f"FLAGS_pass_pipeline: unknown pass {name!r} in "
                    f"opt-out {tok!r}; known: {sorted(PASSES)}")
            # applied AFTER all presets expand: "-cse,default" must
            # prune cse exactly like "default,-cse" does, not be
            # silently re-added by a later preset token
            opt_outs.add(name)
        elif tok in PRESETS:
            for n in PRESETS[tok]:
                if n not in out:
                    out.append(n)
        elif tok in PASSES:
            if tok not in out:
                out.append(tok)
        else:
            raise ValueError(
                f"FLAGS_pass_pipeline: unknown token {tok!r}; known "
                f"presets {sorted(PRESETS)}, passes "
                f"{sorted(PASSES)}")
    return [n for n in out if n not in opt_outs]


def _error_keys(findings):
    from ..analysis.verifier import ERROR

    return {(f.rule, f.var) for f in findings if f.severity == ERROR}


class PassManager:
    """Run an ordered pass list over one program."""

    def __init__(self, passes=None):
        if passes is None:
            passes = PRESETS["default"]
        self.passes = [p if callable(p) else PASSES[p] for p in passes]

    def run(self, program, ctx=None):
        """-> (program, PipelineReport).  Returns the INPUT program
        object when no pass changes anything."""
        from ..profiler import record_event

        ctx = ctx or PassContext()
        report = PipelineReport(where=ctx.where)
        baseline = None
        with record_event("passes/pipeline"):
            for fn in self.passes:
                name = getattr(fn, "pass_name", fn.__name__)
                before = op_counts(program)
                t0 = time.perf_counter()
                with record_event(f"passes/{name}"):
                    out = fn(program, ctx)
                ms = (time.perf_counter() - t0) * 1e3
                changed = out is not program
                if changed:
                    if baseline is None:
                        baseline = self._verify_baseline(program, ctx)
                    self._gate(name, out, ctx, baseline)
                    after = op_counts(out)
                else:
                    after = before
                rec = PassRecord(name, changed, ms,
                                 after[0] - before[0],
                                 after[1] - before[1])
                report.add(rec)
                METRICS.note(rec)
                program = out
        return program, report

    def _verify_baseline(self, program, ctx):
        from ..analysis.verifier import verify_program

        return _error_keys(verify_program(
            program, feed_names=ctx.feed_names,
            fetch_names=ctx.fetch_names))

    def _gate(self, name, program, ctx, baseline):
        from ..analysis.verifier import verify_program
        from ..profiler import record_event

        with record_event("passes/verify"):
            findings = verify_program(program,
                                      feed_names=ctx.feed_names,
                                      fetch_names=ctx.fetch_names)
        fresh = [f for f in findings if f.severity == "error" and
                 (f.rule, f.var) not in baseline]
        if fresh:
            lines = "\n  ".join(f.format() for f in fresh[:20])
            raise PassVerificationError(
                f"pass {name!r} broke the program: "
                f"{len(fresh)} new verifier error(s) at the "
                f"{ctx.where} seam:\n  {lines}\n"
                f"This is a pass bug — opt out with "
                f"FLAGS_pass_pipeline=default,-{name} and report it.",
                fresh)


# -- the compile-seam entry point -------------------------------------------

def apply_at_seam(program, feed_names=(), fetch_names=(),
                  where="compile", mesh=None):
    """Transform `program` through the FLAGS_pass_pipeline pipeline,
    memoized per (version, feeds, fetches, spec, mesh axes).  Returns
    the program to run — the input object itself whenever the pipeline
    is off or has nothing to do.  `mesh` (``CompiledProgram``'s) lets
    auto_shard see the model axis.  (The JAX package's `feed_shapes`
    argument feeds the memory passes, which the port does not have.)"""
    from ..flags import get_flag

    spec = get_flag("pass_pipeline")
    names = resolve_pipeline(spec)    # bad flag tokens raise HERE, at
    #                                   the seam, before anything runs
    if not names:
        return program
    ctx = PassContext(feed_names=feed_names, fetch_names=fetch_names,
                      mesh=mesh, where=where)
    key = (program._version, tuple(names)) + ctx.memo_key()
    memo = program.__dict__.setdefault("_pass_memo", {})
    hit = memo.get(key)
    if hit is not None:
        return hit[0]
    # a version bump (StepGuard attach/detach, desc surgery) obsoletes
    # every older entry — drop them or each one pins a full transformed
    # clone for the program's lifetime (the Executor._cache unbounded-
    # pin class)
    stale = [k for k in memo if k[0] != program._version]
    for k in stale:
        del memo[k]
    out, report = PassManager(names).run(program, ctx)
    if out is not program:
        out.__dict__["_pass_report"] = report
        # the transformed program IS its own fixpoint for this seam —
        # running it back through the seam (e.g. a CompiledProgram
        # wrapping an already-pipelined program) must be the identity
        out.__dict__.setdefault("_pass_memo", {})[key] = (out, report)
    memo[key] = (out, report)
    return out


def report_for(program):
    """PipelineReport attached at the seam (None = untransformed)."""
    return getattr(program, "_pass_report", None)
