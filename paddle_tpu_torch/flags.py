"""Flag system: FLAGS_* environment variables as the user interface.

Reference: gflags DEFINE_* at use sites, re-parsed from env via
``core.init_gflags(["--tryfromenv=..."])`` (python __init__.py:97-166) —
env vars are the supported way users toggle runtime behavior.  Same
contract here: ``FLAGS_trace_sample_rate=1 python serve.py``.

Only the flags that some module of this package reads are defined.  A
name that is not defined raises, so a knob of the JAX package that has
no consumer here yet fails loudly instead of doing nothing.
"""

import os

_DEFAULTS = {
    # Ragged-feed padding policy (SURVEY hard-part #1): pad each lod>0
    # feed's time dim to a bucket so distinct max-lengths share one
    # signature.  "pow2" = next power of two >= seq_len_min_bucket;
    # "none" = pad to the batch max.
    "seq_len_bucket": "pow2",
    "seq_len_min_bucket": 16,
    # distributed request tracing (observability.trace): head-sampling
    # probability for request roots.  0 (default) disables tracing
    # entirely — the hot path is one memoized float compare with zero
    # allocations; 1 traces everything (tests, chaos drills).
    "trace_sample_rate": 0.0,
    # SLA classes that are ALWAYS sampled while trace_sample_rate is
    # nonzero (comma list) — high-SLA postmortems must never miss
    # their trace to the sampling dice
    "trace_force_sla": "high",
    # trace-store bounds: newest trace_max_traces traces kept, each
    # capped at trace_max_spans spans
    "trace_max_traces": 64,
    "trace_max_spans": 512,
    # static program verification (analysis/verifier.py) at the
    # Predictor seam, once per program version: "warn" prints findings
    # to stderr, "strict" raises on error findings, "off" skips
    "validate_program": "warn",
    # IR pass pipeline (passes/) run at the Predictor seam: comma list of
    # presets/pass names with -pass opt-outs ("default,-cse"), or
    # "off"/"none"; unknown tokens raise at the seam
    "pass_pipeline": "default",
    # quantized-inference weight dtype (passes/quantize.py): "int8" only;
    # "fp8" raises until it is ported
    "quant_dtype": "int8",
    # sharded embedding engine (sparse/): declared tables below this many
    # rows keep the dense path (sharding a tiny table costs an RPC per
    # batch for nothing); sparse.shard_program warns once per table
    "sparse_shard_min_rows": 512,
}

_overrides = {}


def _name(key):
    name = key[6:] if key.startswith("FLAGS_") else key
    if name not in _DEFAULTS:
        raise KeyError(f"unknown flag {key!r}: paddle_tpu_torch defines "
                       f"{sorted(_DEFAULTS)}")
    return name


def _parse(name, raw):
    default = _DEFAULTS[name]
    if isinstance(default, bool):
        return raw not in ("0", "false", "False", "")
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, int):
        return int(raw)
    return raw


def get_flag(name):
    name = _name(name)
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(f"FLAGS_{name}")
    if raw is not None:
        return _parse(name, raw)
    return _DEFAULTS[name]


def set_flags(flags):
    """fluid.set_flags parity: {'FLAGS_trace_sample_rate': 1.0} or bare
    names.  Raises KeyError on a flag this package does not define."""
    import sys

    names = {_name(k): v for k, v in flags.items()}
    _overrides.update(names)
    tr = sys.modules.get("paddle_tpu_torch.observability.trace")
    if tr is not None:
        # the tracer memoizes trace_sample_rate/trace_force_sla so its
        # fast path never calls get_flag — the memo must follow a
        # runtime flip
        tr.TRACER._refresh_flags()


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{_name(n)}": get_flag(n) for n in names}
