"""PyReader: background host -> device staging of a program's feeds (port
of ``paddle_tpu/pyreader.py``).

Reference: ``layers/io.py:636`` py_reader + ``reader/buffered_reader.cc``
(a double-buffered asynchronous copy to the device).  A thin facade over
``dataio``: a ``DataPipeline`` converts the reader's batches to host feed
dicts on its thread (DataFeeder rows, ready dicts, or tuples with
level-1 lod slots padded to dense + lengths), and a ``DeviceStager``
copies them from pinned memory to the device on a side CUDA stream, so
the copy of batch t+1 overlaps the compute of batch t.  The Executor
takes one staged batch per run with no feed (``next_feed``) and raises
:class:`EOFException` at the end of the epoch.

The batches go to the device of the run that consumes them: the stager
starts at the first ``next_feed(device)``, and a later run on another
device raises.

Epoch lifecycle (the fluid contract): ``start()`` while an epoch is
still active raises — call ``reset()`` (or drain to EOF) first;
``reset()`` after partial consumption stops the pipeline's threads and a
following ``start()`` yields a complete fresh epoch.  A reader or
conversion crash raises ``dataio.WorkerCrashed`` from the training
thread instead of masquerading as a clean EOF.
"""

import numpy as np
import torch


class PyReader:
    def __init__(self, feed_list, capacity=4, return_list=False,
                 cache_on_device=False, cache_budget_bytes=2 << 30):
        """feed_list: data Variables (order matches reader tuples).

        cache_on_device: keep each distinct batch's device copy (keyed by
        the numpy array's id) and skip re-staging when the reader yields
        it again — a device-resident dataset cache for epoch-style
        training whose working set fits on the card (the analogue of the
        reference's recordio + buffered_reader amortization).  Bounded by
        cache_budget_bytes (FIFO eviction), so a reader that allocates
        fresh arrays per batch cannot grow host and device use without
        limit.
        """
        self.feed_vars = list(feed_list)
        self.capacity = max(int(capacity), 1)
        self.cache_on_device = cache_on_device
        self.cache_budget_bytes = cache_budget_bytes
        self._dev_cache = {}
        self._cache_bytes = 0
        self._reader = None
        self._feeder = None
        self._pipe = None
        self._stager = None
        self._exhausted = False

    def _evict_to_budget(self, incoming_bytes):
        """FIFO-evict cache entries until incoming_bytes fits the budget.
        Called from the single DeviceStager thread only."""
        self._cache_bytes += incoming_bytes
        while self._cache_bytes > self.cache_budget_bytes and \
                self._dev_cache:
            key, (_a, _buf, nbytes) = next(iter(self._dev_cache.items()))
            del self._dev_cache[key]
            self._cache_bytes -= nbytes

    # fluid API parity -------------------------------------------------------
    def decorate_paddle_reader(self, reader, places=None):
        self._reader = reader
        from .data_feeder import DataFeeder
        self._feeder = DataFeeder(feed_list=self.feed_vars, place=None)

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_batch_generator(self, reader, places=None):
        """reader yields ready feed dicts (name -> array) or tuples of
        arrays in feed_list order."""
        self._reader = reader
        self._feeder = None

    # pipeline stages --------------------------------------------------------
    def _convert(self, item):
        """Raw reader item -> host feed dict.  Runs on the DataPipeline's
        thread, overlapped with compute: ragged (lod) level-1
        slots pad to the dense + lengths form HERE, so the executor
        receives shape-stable arrays that pass through its
        normalization untouched.  Deeper-lod lists stay host-side for
        the executor's nested padding."""
        if self._feeder is not None:
            return self._feeder.feed(item)
        if isinstance(item, dict):
            return item
        from .core import lod as lod_mod

        feed = {}
        for v, a in zip(self.feed_vars, item):
            if isinstance(a, list) and getattr(v, "lod_level", 0) == 1:
                padded, lens = lod_mod.to_padded(a)
                feed[v.name] = padded
                feed[lod_mod.seq_len_name(v.name)] = lens
            elif isinstance(a, list):
                feed[v.name] = a
            else:
                feed[v.name] = np.asarray(a)
        return feed

    def _stage_array(self, name, a):
        """Device staging (the single DeviceStager thread): the budgeted
        id-keyed device cache.  The entry holds the host array, which
        keeps its id() from being recycled by a later batch; the
        identity check guards the cache anyway."""
        key = (name, id(a))
        hit = self._dev_cache.get(key)
        if hit is None or hit[0] is not a:
            buf = self._stager.put(a)
            nbytes = buf.numel() * buf.element_size()
            hit = (a, buf, nbytes)
            self._evict_to_budget(nbytes)
            self._dev_cache[key] = hit
        return hit[1]

    # lifecycle --------------------------------------------------------------
    def start(self):
        from .dataio.pipeline import DataPipeline, DataioConfig

        if self._reader is None:
            raise RuntimeError(
                "PyReader: decorate_*_reader/generator not called")
        if self._pipe is not None and not self._exhausted:
            raise RuntimeError(
                "PyReader.start() called while the previous epoch is "
                "still active; call reset() (or drain to EOF) first")
        if self._pipe is not None:
            self.reset()        # EOF'd epoch: reap threads, then restart
        self._exhausted = False
        # the stager is a second stage, started by the first run that
        # reads
        self._pipe = DataPipeline(
            self._reader, feed_fn=self._convert,
            config=DataioConfig(capacity=self.capacity))
        self._pipe.start()

    def reset(self):
        """Stop the pipeline threads (bounded wait — a reader stuck in
        its own IO orphans the daemon threads instead of hanging
        training) and drop staged batches."""
        pipe, stager = self._pipe, self._stager
        self._pipe = None
        self._stager = None
        if pipe is not None:
            pipe.reset()        # first: unblocks a stager mid-next_feed
        if stager is not None:
            stager.stop()
        self._exhausted = False

    # Executor hook ----------------------------------------------------------
    def next_feed(self, device):
        """The next batch as tensors on `device` (the consuming run's),
        ready for the current stream to read, or None when the epoch is
        exhausted."""
        from .dataio.device import DeviceStager

        if self._pipe is None:
            raise RuntimeError("PyReader.start() not called")
        device = torch.device(device)
        if self._stager is None:
            self._stager = DeviceStager(
                device, depth=2,
                put_fn=self._stage_array if self.cache_on_device else None)
            self._stager.start(self._pipe.next_feed)
        elif self._stager.device != device:
            raise RuntimeError(
                f"PyReader stages this epoch onto {self._stager.device}; "
                f"a run on {device} cannot read it (reset() and start() "
                "a new epoch for that device)")
        handle = self._stager.next_handle()
        if handle is None:
            self._exhausted = True
            return None
        return handle.ready()


class EOFException(Exception):
    """Raised by Executor.run when a PyReader epoch ends (fluid parity)."""
