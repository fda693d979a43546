"""Double-buffered device staging: the copy of batch N+1 overlaps batch N
(port of ``paddle_tpu/dataio/device.py``).

The reference's ``reader/buffered_reader.cc`` hides PCIe behind a pinned
-memory double buffer, and so does this module: a single staging thread
pulls host feed dicts from its source (usually ``DataPipeline.
next_feed``), puts each array into pinned host memory and copies it to the device asynchronously on a
side CUDA stream, records an event after the copies, and parks the
result in a bounded queue of ``depth`` (2 is the classic double buffer).
While the training thread computes batch N, the stager is already
copying batch N+1.

A :class:`FeedHandle` carries the event: :meth:`FeedHandle.ready` makes
the consumer's current stream wait on it (and tells the caching
allocator that stream uses the tensors), so a step never reads a batch
before its copy has landed.  The stager copies to the device it was
given, which is the device of the run that consumes the batches; on a
CPU device the arrays become CPU tensors with no stream or pinning.
"""

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from ..profiler import record_span

_EOF = object()


class _Err:
    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


class FeedHandle:
    """One step's feed, copied to the device or on its way there: `event`,
    when not None, completes on CUDA `device` when the copies have
    landed."""

    __slots__ = ("arrays", "event", "device")

    def __init__(self, arrays, event=None, device=None):
        self.arrays = dict(arrays)
        self.event = event
        self.device = device

    def ready(self):
        """The arrays, once the current CUDA stream waits for their
        copies; each tensor is marked as used on that stream, so the
        allocator does not hand its memory to the staging stream while
        the step may still read it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.arrays.values():
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(stream)
        return self.arrays

    def __repr__(self):
        return f"FeedHandle({sorted(self.arrays)})"


class DeviceStager:
    """Background device-staging stage.

        stager = DeviceStager(torch.device("cuda", 0))
        stager.start(pipe.next_feed)
        while (h := stager.next_handle()) is not None:
            exe.run(main_prog, feed=h.ready(), fetch_list=[loss])
        stager.stop()

    device: where the batches go (the consuming run's device); the
    feeds come normalized (ragged slots padded, as PyReader's pipeline
    does).  put_fn(name, arr): per-array staging override (the
    PyReader's budgeted device cache), called inside the staging
    stream.  depth: staging queue bound (2 = double buffer).
    """

    def __init__(self, device, depth=2, put_fn=None):
        self.device = torch.device(device)
        self.depth = max(int(depth), 1)
        self.put_fn = put_fn
        self._stream = None
        self._q = None
        self._thread = None
        self._stop = threading.Event()
        self._exhausted = False

    def put(self, a):
        """One host array (or tensor) onto the device: through pinned host
        memory with an asynchronous copy on the current (staging)
        stream for a CUDA device; a tensor already there passes."""
        t = a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(a))
        if t.device == self.device:
            return t
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def stage(self, feed):
        """Stage one host feed dict into a FeedHandle (the staging
        thread's body; also usable inline)."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        staged, event = {}, None
        with torch.cuda.stream(self._stream) if cuda else \
                contextlib.nullcontext():
            for n, a in feed.items():
                if isinstance(a, list):
                    # deep-lod nested lists stay host-side: the executor's
                    # normalization owns their multi-level padding
                    staged[n] = a
                elif self.put_fn is not None:
                    staged[n] = self.put_fn(n, a)
                else:
                    staged[n] = self.put(a)
            if cuda:
                event = torch.cuda.Event()
                event.record(self._stream)
        record_span("dataio/stage", t0, time.perf_counter())
        return FeedHandle(staged, event, self.device)

    def start(self, source):
        """Spawn the staging thread.  ``source`` is a callable returning
        the next host feed dict, or None at EOF (i.e.
        ``DataPipeline.next_feed``).  Source exceptions (WorkerCrashed
        etc.) re-raise from ``next_handle``."""
        if self._thread is not None:
            raise RuntimeError(
                "DeviceStager already started; stop() first")
        self._stop = threading.Event()
        self._exhausted = False
        stop = self._stop
        self._q = q = queue.Queue(maxsize=self.depth)

        def bounded_put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def worker():
            try:
                while not stop.is_set():
                    feed = source()
                    if feed is None:
                        break
                    bounded_put(self.stage(feed))
            except Exception as e:      # propagate to the consumer
                bounded_put(_Err(e))
            finally:
                bounded_put(_EOF)

        self._thread = threading.Thread(target=worker,
                                        name="dataio-stager", daemon=True)
        self._thread.start()
        return self

    def next_handle(self):
        """Next staged FeedHandle, or None when the source is
        exhausted (latched: further calls keep returning None instead
        of blocking on a queue no thread feeds anymore).  Re-raises
        staging/source errors."""
        if self._q is None:
            raise RuntimeError("DeviceStager.start() not called")
        if self._exhausted:
            return None
        item = self._q.get()
        if item is _EOF:
            self._exhausted = True
            return None
        if isinstance(item, _Err):
            self._exhausted = True
            raise item.error
        return item

    def stop(self):
        """Stop the staging thread (bounded wait) and drop staged
        batches.  Reset the upstream pipeline FIRST so a source()
        blocked on its queue wakes up."""
        self._stop.set()
        if self._stream is not None:
            # a cached device copy may be handed out again on another
            # stager's stream: let this stream's copies land first
            self._stream.synchronize()
        deadline = time.monotonic() + 10.0
        while self._thread is not None and self._thread.is_alive() and \
                time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        self._thread = None
        self._q = None
        self._exhausted = False
