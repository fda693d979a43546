"""SamplingConfig — per-request decode knobs, validated at submit.

The engine's context-dtype discipline applied to sampling: every field is
checked the moment a request enters the system, and a bad value raises
``SamplingConfigError`` (a ``ServingError``) NAMING THE FIELD — not an
opaque NaN/shape failure halfway through a decode step that takes every
slot-mate down with it.
"""

import math
import numbers

from ..batcher import ServingError


class SamplingConfigError(ServingError):
    """Invalid SamplingConfig field — raised at construction (= at submit)."""


class SamplingConfig:
    """Per-request sampling/constraint configuration.

    Fields (all have safe defaults; the default config IS greedy):

    - ``temperature`` — float >= 0.  0 (default) is greedy decode: the
      degenerate row of the shared sampler, not a separate executable.
    - ``top_k`` — int >= 0 tokens kept by rank.  0 (default) disables.
    - ``top_p`` — nucleus mass in (0, 1].  1.0 (default) disables.
    - ``seed`` — int; the per-request PRNG stream root (folded to uint32).
      Two submits with the same seed (and same model/config) generate the
      same tokens, including across preemption-and-recompute.
    - ``logit_bias`` — {token_id: bias} added to the logits row before
      the draw; ``-inf`` hard-forbids a token.
    - ``constraint`` — a mask-stepper object with ``start()``,
      ``allowed(state, vocab)`` and ``advance(state, token)``
      (see constrain.TokenDFA, the reference implementation).  Its mask
      joins the bias plane at every token boundary.
    """

    __slots__ = ("temperature", "top_k", "top_p", "seed", "logit_bias",
                 "constraint")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=0,
                 logit_bias=None, constraint=None):
        if (isinstance(temperature, bool)
                or not isinstance(temperature, numbers.Real)
                or not math.isfinite(float(temperature))
                or float(temperature) < 0.0):
            raise SamplingConfigError(
                f"temperature must be a finite float >= 0 (0 = greedy); "
                f"got {temperature!r}")
        if (isinstance(top_k, bool) or not isinstance(top_k, numbers.Integral)
                or int(top_k) < 0):
            raise SamplingConfigError(
                f"top_k must be an int >= 0 (0 = disabled); got {top_k!r}")
        if (isinstance(top_p, bool) or not isinstance(top_p, numbers.Real)
                or math.isnan(float(top_p))
                or not 0.0 < float(top_p) <= 1.0):
            raise SamplingConfigError(
                f"top_p must be in (0, 1] (1.0 = disabled); got {top_p!r}")
        if isinstance(seed, bool) or not isinstance(seed, numbers.Integral):
            raise SamplingConfigError(
                f"seed must be an int; got {seed!r}")
        if logit_bias is not None:
            if not isinstance(logit_bias, dict):
                raise SamplingConfigError(
                    f"logit_bias must be a dict token_id -> bias; "
                    f"got {type(logit_bias).__name__}")
            for tok, b in logit_bias.items():
                if (isinstance(tok, bool)
                        or not isinstance(tok, numbers.Integral)
                        or int(tok) < 0):
                    raise SamplingConfigError(
                        f"logit_bias keys must be token ids (int >= 0); "
                        f"got {tok!r}")
                if (not isinstance(b, numbers.Real)
                        or math.isnan(float(b))):
                    raise SamplingConfigError(
                        f"logit_bias[{tok}] must be a non-NaN float "
                        f"(-inf forbids the token); got {b!r}")
            logit_bias = {int(t): float(b) for t, b in logit_bias.items()}
        if constraint is not None:
            for meth in ("start", "allowed", "advance"):
                if not callable(getattr(constraint, meth, None)):
                    raise SamplingConfigError(
                        f"constraint must implement start()/allowed()/"
                        f"advance(); {type(constraint).__name__} lacks "
                        f"{meth!r}")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed) & 0xFFFFFFFF      # the uint32 seed row
        self.logit_bias = logit_bias
        self.constraint = constraint

    @classmethod
    def coerce(cls, obj):
        """None -> GREEDY; dict -> SamplingConfig(**dict); pass through a
        SamplingConfig.  Anything else is a named submit-time error."""
        if obj is None:
            return GREEDY
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            try:
                return cls(**obj)
            except TypeError as e:          # unknown kwarg
                raise SamplingConfigError(f"bad sampling dict: {e}") from None
        raise SamplingConfigError(
            f"sampling must be a SamplingConfig, dict, or None; "
            f"got {type(obj).__name__}")

    def plain_greedy(self):
        """True when this config needs NO sampler work at all — greedy
        with no bias and no constraint — so an all-plain batch keeps the
        engine's original host argmax fast path."""
        return (self.temperature == 0.0 and self.logit_bias is None
                and self.constraint is None)

    def __repr__(self):
        parts = [f"temperature={self.temperature}"]
        if self.top_k:
            parts.append(f"top_k={self.top_k}")
        if self.top_p < 1.0:
            parts.append(f"top_p={self.top_p}")
        if self.seed:
            parts.append(f"seed={self.seed}")
        if self.logit_bias:
            parts.append(f"logit_bias=<{len(self.logit_bias)} tokens>")
        if self.constraint is not None:
            parts.append(f"constraint={type(self.constraint).__name__}")
        return f"SamplingConfig({', '.join(parts)})"


# The shared default: greedy, unbiased, unconstrained.  Immutable by
# convention (SamplingConfig has no mutators), so one instance serves
# every default-config request.
GREEDY = SamplingConfig()
