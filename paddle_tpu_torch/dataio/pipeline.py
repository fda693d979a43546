"""DataPipeline: background conversion of a batched reader's items (the
part of ``paddle_tpu/dataio/pipeline.py`` that ``PyReader`` needs).

One thread drains the reader generator, converts each batch to a host
feed dict (``feed_fn``) and parks it in a bounded queue; the consumer
pops feeds in reader order.

- **Backpressure**: the queue holds at most ``capacity`` feeds; the
  thread blocks when the consumer falls behind, so a fast reader never
  balloons host memory.
- **EOF/reset**: the reader's end flows through as a ``None`` from
  ``next_feed()``; ``reset()`` stops the thread (bounded wait) and the
  pipeline can be ``start()``ed again for the next epoch.
- **Crash propagation**: a reader or conversion failure raises
  ``WorkerCrashed`` on the consumer's thread, so input bugs surface on
  the training thread instead of as a silently truncated epoch.
"""

import queue
import threading
import time

from ..profiler import record_span

_EOF = object()


class PipelineError(Exception):
    """Base for dataio pipeline failures."""


class WorkerCrashed(PipelineError):
    """The reader or the conversion died producing a batch; ``__cause__``
    carries the original exception."""


class _Err:
    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


class DataioConfig:
    """Input-pipeline policy of a ``DataPipeline``: ``capacity`` bounds
    its queue of converted feeds."""

    def __init__(self, capacity=8):
        self.capacity = max(int(capacity), 1)


class DataPipeline:
    """Background conversion over a batched reader factory.

        pipe = DataPipeline(reader, feed_fn=feeder.feed)
        pipe.start()
        while (feed := pipe.next_feed()) is not None:
            exe.run(main_prog, feed=feed, ...)
        pipe.reset()

    `reader` is a zero-arg callable returning a fresh generator of raw
    batches (the fluid reader convention); `feed_fn` converts one raw
    batch to a host feed dict on the pipeline's thread (None: batches
    pass through as-is).
    """

    def __init__(self, reader, feed_fn=None, config=None):
        self.reader = reader
        self.feed_fn = feed_fn
        self.config = config or DataioConfig()
        self._out = None
        self._thread = None
        self._stop = threading.Event()
        self._exhausted = False

    def start(self):
        """Spawn the conversion thread for one epoch."""
        if self._thread is not None and not self._exhausted:
            raise RuntimeError(
                "DataPipeline.start() called while the previous epoch "
                "is still active; call reset() first")
        if self._thread is not None:
            self.reset()        # EOF'd epoch: reap the thread first
        self._stop = threading.Event()
        self._exhausted = False
        self._out = queue.Queue(maxsize=self.config.capacity)
        stop, out = self._stop, self._out

        def bounded_put(item):
            """Stop-aware put into the bounded queue."""
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for raw in self.reader():
                    if stop.is_set():
                        return
                    feed = self.feed_fn(raw) if self.feed_fn is not None \
                        else raw
                    if not bounded_put(feed):
                        return
            except Exception as e:
                bounded_put(_Err(e))
            finally:
                bounded_put(_EOF)

        self._thread = threading.Thread(target=produce, name="dataio",
                                        daemon=True)
        self._thread.start()

    def next_feed(self):
        """Next feed dict in reader order, or None when the epoch is
        exhausted (or reset() ended it).  Raises WorkerCrashed if
        production failed."""
        out = self._out
        if out is None:
            raise RuntimeError("DataPipeline.start() not called")
        if self._exhausted:
            return None
        t0 = time.perf_counter()
        item = out.get()
        record_span("dataio/wait", t0, time.perf_counter())
        if item is _EOF:
            self._exhausted = True
            return None
        if isinstance(item, _Err):
            self._exhausted = True
            raise WorkerCrashed(
                f"dataio pipeline failed: {type(item.error).__name__}: "
                f"{item.error}") from item.error
        return item

    def reset(self):
        """Stop the thread (bounded wait) and drop queued feeds; the
        pipeline can be start()ed again afterwards."""
        self._stop.set()
        out, thread = self._out, self._thread
        deadline = time.monotonic() + 10.0
        while thread is not None and thread.is_alive() and \
                time.monotonic() < deadline:
            try:
                while True:
                    out.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
        if out is not None:
            # wake a consumer blocked in out.get() concurrently with
            # this reset (e.g. the DeviceStager thread)
            try:
                out.put_nowait(_EOF)
            except queue.Full:
                pass
        self._thread = None
        self._out = None
        self._exhausted = False
