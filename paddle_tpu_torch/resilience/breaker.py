"""Per-endpoint circuit breaker (a copy of
``paddle_tpu/resilience/breaker.py``): the RPC client and the sparse
table client fail fast through it.

Classic three-state machine:

- **closed**: calls flow; consecutive failures are counted.
- **open**: after ``fail_threshold`` consecutive failures the breaker
  trips — ``allow()`` is False and callers fail fast (shed / raise)
  instead of stacking timeouts against a dead peer.
- **half-open**: ``reset_after_s`` after the trip, exactly ONE probe
  call is let through; its success closes the breaker, its failure
  re-opens it (and restarts the timer).

Thread-safe; time is injectable for deterministic tests.
"""

import threading
import time


class CircuitOpenError(ConnectionError):
    """Raised by callers that translate a tripped breaker into an error
    (the RPC client does; the serving engine sheds instead)."""


class CircuitBreaker:
    def __init__(self, fail_threshold=5, reset_after_s=30.0,
                 clock=time.monotonic, metrics=None, name=""):
        self.fail_threshold = max(int(fail_threshold), 1)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at = None       # None = closed
        self._probing = False        # half-open probe in flight
        self._probe_at = 0.0         # when the probe was admitted
        self._trips = 0
        self._metrics = metrics
        self.name = name

    # -- state queries ------------------------------------------------------

    @property
    def failures(self):
        with self._lock:
            return self._failures

    @property
    def trips(self):
        with self._lock:
            return self._trips

    def _state_locked(self):
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.reset_after_s:
            return "half-open"
        return "open"

    @property
    def state(self):
        with self._lock:
            return self._state_locked()

    def export(self):
        """Atomic state snapshot for stats/export paths: one lock
        acquisition, so state/failures/trips describe the same instant
        (reading the three properties separately can interleave with a
        trip and export e.g. state="closed" next to its trip count)."""
        with self._lock:
            return {"state": self._state_locked(),
                    "failures": self._failures,
                    "trips": self._trips}

    def remaining_s(self):
        """Seconds until the next half-open probe (0 when not open)."""
        with self._lock:
            if self._opened_at is None:
                return 0.0
            return max(0.0, self.reset_after_s
                       - (self._clock() - self._opened_at))

    # -- call protocol ------------------------------------------------------

    def allow(self):
        """Whether a call may proceed.  In half-open state only the
        FIRST caller gets True (the probe); concurrent callers keep
        failing fast until the probe resolves.  A probe whose outcome
        is never recorded (the caller died between allow() and the
        call — shed, invalid feed, expired in queue) EXPIRES after
        another reset window, so an undisciplined caller can never
        wedge the breaker open forever."""
        with self._lock:
            if self._opened_at is None:
                return True
            now = self._clock()
            if now - self._opened_at < self.reset_after_s:
                return False
            if self._probing and \
                    now - self._probe_at < self.reset_after_s:
                return False
            self._probing = True
            self._probe_at = now
            return True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._opened_at is not None:
                if self._probing:
                    # failed half-open probe: re-open, restart the timer
                    self._probing = False
                    self._opened_at = self._clock()
                # non-probe failures while open (already-admitted
                # backlog draining against the sick peer) must NOT
                # restart the window — they would push the next probe
                # out to reset_after_s after the LAST backlog item
                return
            if self._failures >= self.fail_threshold:
                self._opened_at = self._clock()
                self._trips += 1
                if self._metrics is not None:
                    self._metrics.inc("breaker_trips")

    def reset(self):
        self.record_success()
