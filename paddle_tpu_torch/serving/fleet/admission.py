"""SLA classes + the fleet admission policy.

An :class:`SlaClass` names one service tier and carries everything the
router and the continuous-batching scheduler need to treat it
differently under load:

- ``priority`` — the admission-queue rank.  Maps 1:1 onto the
  ``MicroBatcher``/slot-pool priority semantics: higher jumps lower in
  the queue, and a full queue sheds its newest lowest-priority entry to
  admit a higher-priority arrival.  Low classes absorb overload FIRST.
- ``share`` — the fraction of the fleet's in-flight budget this class
  may consume.  The top class runs at 1.0 (it may use everything);
  lower classes run below it, so when traffic saturates the fleet the
  ``batch`` tier starts shedding at admission while ``high`` still has
  reserved headroom.  This is Clipper's deadline-aware admission
  inverted into a budget: instead of estimating per-request slack we
  bound how deep each tier may fill the pipe.
- ``timeout_ms`` — the default per-request deadline when a submit
  passes none (per-class deadlines; expiry is a typed
  ``DeadlineExceeded``).

The registry is just a dict ``name -> SlaClass``; :data:`DEFAULT_CLASSES`
provides the canonical two-tier ``high``/``batch`` split the acceptance
replay uses.  Per-class latency/outcome accounting lives in
``fleet.metrics.FleetMetrics``.
"""


class SlaClass:
    """One service tier; immutable value object."""

    __slots__ = ("name", "priority", "share", "timeout_ms")

    def __init__(self, name, priority=0, share=1.0, timeout_ms=None):
        if not (0.0 < share <= 1.0):
            raise ValueError(
                f"SLA class {name!r}: share must be in (0, 1], "
                f"got {share}")
        self.name = name
        self.priority = int(priority)
        self.share = float(share)
        self.timeout_ms = timeout_ms

    def __repr__(self):
        return (f"SlaClass({self.name!r}, priority={self.priority}, "
                f"share={self.share}, timeout_ms={self.timeout_ms})")


def default_classes():
    """The canonical two-tier split: `high` (interactive — full budget,
    tight default deadline, queue-jumps) and `batch` (throughput — 75%
    of the budget, loose deadline, shed first)."""
    return {
        "high": SlaClass("high", priority=10, share=1.0,
                         timeout_ms=5000.0),
        "batch": SlaClass("batch", priority=0, share=0.75,
                          timeout_ms=60000.0),
    }


DEFAULT_CLASSES = default_classes()


class AdmissionPolicy:
    """Budgeted admission over a class registry.

    ``admit(cls, in_flight, budget)`` answers whether a request of
    `cls` may enter when `in_flight` requests are already held against
    a total `budget` — the class is admitted while it leaves its share
    of the budget un-exceeded.  Pure function of its arguments (no
    internal state): the router calls it with its live outstanding
    count, the continuous engine with queue depth + active slots.
    """

    def __init__(self, classes=None):
        self.classes = dict(classes or default_classes())
        if not self.classes:
            raise ValueError("at least one SLA class is required")

    def resolve(self, sla):
        """The SlaClass for `sla` (a name or an SlaClass); typed
        KeyError naming the known tiers on an unknown class — a typo'd
        class must not silently get default treatment."""
        if isinstance(sla, SlaClass):
            return sla
        try:
            return self.classes[sla]
        except KeyError:
            raise KeyError(
                f"unknown SLA class {sla!r}; known: "
                f"{sorted(self.classes)}") from None

    def admit(self, cls, in_flight, budget):
        """Whether one more `cls` request fits: True while the request
        would keep in_flight within cls.share of the budget."""
        return in_flight < budget * cls.share

    def names_by_priority(self):
        """Class names, most important first."""
        return [c.name for c in sorted(self.classes.values(),
                                       key=lambda c: -c.priority)]
