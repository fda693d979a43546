"""Deterministic, config-driven fault injection (a copy of
``paddle_tpu/resilience/faults.py``: host Python, no device code).

A :class:`FaultPlan` is a seeded list of rules that can

- **delay / drop / error** RPC frames at the transport
  ``send_frame``/``recv_frame``/server-dispatch seam
  (``transport.set_fault_hook``),
- **kill** the process with SIGKILL at training step N
  (``plan.maybe_kill(step)`` in worker loops) or at the Nth matching
  RPC (a server dying mid-call, deterministically),
- **corrupt** one checkpoint shard (seed-chosen) for restore-fallback
  tests, and
- mark a step for **NaN injection** (``plan.nan_at_step(step)`` —
  readers/tests poison that batch to exercise the StepGuard).

Determinism contract: all randomness comes from ``random.Random(seed)``
and per-seam call counters — the same plan against the same call
sequence fires the same faults, so chaos tests are reproducible and
enumerable (no wall-clock randomness).  Plans round-trip through JSON
(``to_spec``/``from_spec``) and through the ``PADDLE_TPU_FAULTS``
environment variable so subprocess workers inherit them.

Seam keys are ``"<where>:<what>"``:

- ``send:<method>`` / ``recv:<method>`` — client-side frame I/O
  (``recv`` fires before the read, so the method is ``*``),
- ``serve:<method>`` — server-side dispatch, after decode,
- any caller-chosen key via ``plan.wrap_callable(fn, key)`` (the
  serving engine's compute seam in chaos tests).

Matching is ``fnmatch`` style (``serve:*``, ``send:get``).

The reference commits a flight-recorder dump before a kill; the port has
no flight recorder (ROADMAP queue 1 item 12), so a kill is the SIGKILL
alone.
"""

import fnmatch
import json
import os
import random
import signal

_ENV_VAR = "PADDLE_TPU_FAULTS"

_KINDS = ("delay", "drop", "error", "kill", "nan", "corrupt")


class FaultRule:
    """One injection rule.

    kind   — delay | drop | error | kill | nan | corrupt
    match  — seam key pattern (fnmatch); None for step-keyed kinds
    at     — explicit 0-based matching-call indices to fire on
    after  — fire on EVERY matching call from this 0-based index on
             (a replica that goes dark at its Nth dispatch and stays
             dark until the `times` budget runs out — the fleet-chaos
             shape `at` can't express without enumerating indices)
    prob   — per-call fire probability (seeded), alternative to `at`
    times  — total fire budget (None = unlimited)
    ms     — delay duration (kind=delay)
    step   — training step (kind=kill/nan)
    message— error text (kind=error)
    index  — shard index (kind=corrupt)
    """

    __slots__ = ("kind", "match", "at", "after", "prob", "times", "ms",
                 "step", "message", "index")

    def __init__(self, kind, match=None, at=None, after=None, prob=None,
                 times=None, ms=0.0, step=None, message=None, index=0):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.kind = kind
        self.match = match
        self.at = sorted(int(a) for a in at) if at is not None else None
        self.after = int(after) if after is not None else None
        self.prob = float(prob) if prob is not None else None
        self.times = int(times) if times is not None else None
        self.ms = float(ms)
        self.step = int(step) if step is not None else None
        self.message = message
        self.index = int(index)

    def to_spec(self):
        d = {"kind": self.kind}
        for k in ("match", "at", "after", "prob", "times", "step",
                  "message"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.ms:
            d["ms"] = self.ms
        if self.index:
            d["index"] = self.index
        return d

    @classmethod
    def from_spec(cls, d):
        return cls(**d)

    def __repr__(self):
        return f"FaultRule({self.to_spec()})"


class FaultPlan:
    def __init__(self, seed=0, rules=()):
        self.seed = int(seed)
        self.rules = [r if isinstance(r, FaultRule)
                      else FaultRule.from_spec(r) for r in rules]
        self._rng = random.Random(self.seed)
        import threading

        # _fire mutates counters; server-seam hooks run on concurrent
        # dispatch threads (FrameServer), and an unlocked read-inc race
        # would make call indices — the determinism contract — unstable
        self._fire_lock = threading.Lock()
        self._counts = {}            # seam key -> calls seen
        self._fired = {}             # id(rule) -> times fired
        self.log = []                # (key, kind, call_index) fired

    # -- construction sugar --------------------------------------------------

    def _add(self, rule):
        self.rules.append(rule)
        return self

    def delay(self, match, ms, at=None, prob=None, times=None):
        return self._add(FaultRule("delay", match, at=at, prob=prob,
                                   times=times, ms=ms))

    def drop(self, match, at=None, prob=None, times=None):
        return self._add(FaultRule("drop", match, at=at, prob=prob,
                                   times=times))

    def error(self, match, at=None, after=None, prob=None, times=None,
              message=None):
        return self._add(FaultRule("error", match, at=at, after=after,
                                   prob=prob, times=times,
                                   message=message))

    def kill_at_step(self, step):
        return self._add(FaultRule("kill", step=step))

    def kill_at_call(self, match, at):
        return self._add(FaultRule("kill", match,
                                   at=[at] if isinstance(at, int) else at))

    def nan_at_step(self, step):
        return self._add(FaultRule("nan", step=step))

    def corrupt_shard(self, index=0):
        return self._add(FaultRule("corrupt", index=index))

    # -- (de)serialization ---------------------------------------------------

    def to_spec(self):
        return {"seed": self.seed,
                "rules": [r.to_spec() for r in self.rules]}

    @classmethod
    def from_spec(cls, spec):
        return cls(seed=spec.get("seed", 0), rules=spec.get("rules", ()))

    def to_env(self, env=None):
        """Serialize into `env` (default os.environ) for subprocesses."""
        env = os.environ if env is None else env
        env[_ENV_VAR] = json.dumps(self.to_spec())
        return env

    @classmethod
    def from_env(cls, install=False):
        """Plan from PADDLE_TPU_FAULTS, or None when unset."""
        raw = os.environ.get(_ENV_VAR)
        if not raw:
            return None
        plan = cls.from_spec(json.loads(raw))
        if install:
            plan.install()
        return plan

    # -- the injection engine ------------------------------------------------

    def _fire(self, key):
        """Which rule (if any) fires for this call of seam `key`.
        Advances the per-key call counter exactly once (thread-safe:
        server-seam hooks run on concurrent dispatch threads)."""
        with self._fire_lock:
            return self._fire_locked(key)

    def _fire_locked(self, key):
        i = self._counts.get(key, 0)
        self._counts[key] = i + 1
        for r in self.rules:
            if r.match is None or not fnmatch.fnmatch(key, r.match):
                continue
            if r.kind in ("nan", "corrupt"):
                continue
            fired = self._fired.get(id(r), 0)
            if r.times is not None and fired >= r.times:
                continue
            if r.at is not None:
                hit = i in r.at
            elif r.after is not None:
                hit = i >= r.after
            elif r.prob is not None:
                hit = self._rng.random() < r.prob
            else:
                hit = True
            if hit:
                self._fired[id(r)] = fired + 1
                self.log.append((key, r.kind, i))
                return r
        return None

    def hook(self, where, msg):
        """The transport fault hook (``set_fault_hook`` signature):
        returns "drop" to swallow the frame, raises to error it, sleeps
        to delay it."""
        method = (msg or {}).get("method", "*")
        r = self._fire(f"{where}:{method}")
        if r is None:
            return None
        if r.kind == "delay":
            import time

            time.sleep(r.ms / 1000.0)
            return None
        if r.kind == "drop":
            return "drop"
        if r.kind == "error":
            raise ConnectionError(
                r.message or f"injected fault: {where}:{method}")
        if r.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        return None

    def install(self):
        """Install as the process-wide transport fault hook."""
        from ..distributed import transport

        transport.set_fault_hook(self.hook)
        return self

    def uninstall(self):
        from ..distributed import transport

        if transport.get_fault_hook() == self.hook:
            transport.set_fault_hook(None)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def wrap_callable(self, fn, key):
        """Route any callable through the plan (delay/error/drop-as-None
        before the real call) under seam `key` — e.g. a serving
        engine's compute function in a slow-compute chaos test."""
        def wrapped(*a, **kw):
            if self.hook(key.split(":")[0] if ":" in key else "call",
                         {"method": key.split(":", 1)[-1]}) == "drop":
                return None
            return fn(*a, **kw)

        return wrapped

    # -- step-keyed faults ---------------------------------------------------

    def maybe_kill(self, step):
        """SIGKILL this process if a kill rule targets `step` (worker
        loops call this each step — the subprocess analogue of the
        parent killing at an observed output line, but deterministic)."""
        for r in self.rules:
            if r.kind == "kill" and r.step is not None and \
                    int(step) == r.step:
                os.kill(os.getpid(), signal.SIGKILL)

    def is_nan_step(self, step):
        """Whether a NaN-injection rule targets `step` (readers poison
        that batch to exercise the StepGuard)."""
        return any(r.kind == "nan" and r.step == int(step)
                   for r in self.rules)

    # -- checkpoint corruption ----------------------------------------------

    def corrupt_one_shard(self, step_dir):
        """Flip bytes in the middle of one (seed-chosen) shard file of a
        committed checkpoint — the restore-fallback scenario.  Returns
        the corrupted filename.  Deterministic: the pick depends only on
        (seed, sorted shard list) and any corrupt-rule ``index``."""
        shards = sorted(f for f in os.listdir(step_dir)
                        if f.endswith(".npy"))
        if not shards:
            raise FileNotFoundError(f"no shard files under {step_dir}")
        index = next((r.index for r in self.rules
                      if r.kind == "corrupt"), 0)
        pick = shards[(random.Random(self.seed).randrange(len(shards))
                       + index) % len(shards)]
        path = os.path.join(step_dir, pick)
        with open(path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(size // 2)
            chunk = f.read(8)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        return pick
