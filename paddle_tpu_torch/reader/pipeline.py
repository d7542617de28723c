"""Host->device prefetch pipeline.

The counterpart of the JAX package's ``DeviceLoader`` (a worker thread
that ``device_put``s batch N+1 while the step runs batch N) and of the
reference's reader-op stack (``py_reader`` pushing into a C++ blocking
queue plus the double-buffered device prefetch; reference:
operators/reader/create_py_reader_op.cc, buffered_reader.cc).

On the card the worker stages each batch through a ring of ``depth + 1``
pinned host buffers per feed, reused in turn (a ``pin_memory()`` per
batch would pay a page-locked allocation for every feed of every step),
and copies it to the card with ``non_blocking=True`` on a side stream of
its own, recording one CUDA event a batch. Three rules keep that right:

- every CUDA call of the worker (the event wait, a pinned or device
  allocation, the copy, the event record) holds the capture gate shared
  (core/lowering.py ``GATE``): the executor captures its first graph on
  the consumer's thread while the worker is copying the next batch, and
  a CUDA call beside a capture invalidates it;
- a pinned slot is written again only once the event of the copy that
  last read it has completed;
- before a batch is handed out, the consumer's current stream waits for
  the batch's event and every device tensor is ``record_stream``-ed on
  that stream, so the caching allocator does not hand a tensor's memory
  to a later batch while a replay may still read it. The executor's
  captured step copies device feeds into its static buffers on the
  current stream (``StepRunner._load_feeds``), after that wait.

A consumer on another thread than the one that captures (a Trainer's
consumer is the capturing thread itself) reads a batch's values back
under ``GATE.shared()``, as every CUDA call beside a capture must. On
the CPU the worker hands out CPU tensors (copies of the reader's
arrays), with no stream and no gate.

Lifecycle, as in the JAX package: every iteration owns a stop event. A
consumer that stops early (a trainer exception, a ``break``) closes the
generator; ``GeneratorExit`` or ``close()`` sets the stop event, the
worker's put loop sees it within one poll interval and exits, and the
queue is drained so no batch stays on the card. A reader error reaches
the consumer after the batches before it; an out-of-memory error in the
worker gets the monitor's forensics, attributed to the prefetch phase.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch.core.lowering import GATE
from paddle_tpu_torch.framework import resolve_device

# chaos hook (faults.py): armed plans can fail or delay the prefetch
# worker's per-batch staging — raise(RESOURCE_EXHAUSTED ...) = infeed
# OOM drill (surfaces in the consumer with forensics), delay = a slow
# host pipeline driving the input_bound verdict
_F_PREFETCH = _faults.site("pipeline.prefetch")


class _PinnedSlot:
    """One ring slot: a pinned host buffer per feed and the event of the
    copy that last read them."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs: Dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def buffer(self, name: str, a: np.ndarray) -> torch.Tensor:
        """The slot's pinned buffer for ``name``, shaped like ``a``
        (allocated anew when the shape or dtype changes)."""
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        buf = self.bufs.get(name)
        if buf is None or tuple(buf.shape) != a.shape or buf.dtype != dtype:
            buf = self.bufs[name] = torch.empty(a.shape, dtype=dtype,
                                                pin_memory=True)
        return buf


class DeviceLoader:
    """Iterate batches with ``depth``-deep prefetch onto ``place``'s
    device (``CUDAPlace(0)`` when None; pass ``CPUPlace()`` for the
    CPU). ``reader`` yields feed dicts or sequences aligned with
    ``feed_names``. ``stats`` counts the batches staged and the batches
    whose copy waited for a capture to end (``gate_waits``)."""

    def __init__(self, reader: Callable[[], Iterator], feed_names: Sequence[str],
                 depth: int = 2, sharding=None, place=None):
        if sharding is not None:
            raise NotImplementedError(
                "DeviceLoader(sharding=...) places batches over a device "
                "mesh; the port has one card and no mesh yet (ROADMAP.md "
                "Queue 1, item 9)")
        self._reader = reader
        self._names = list(feed_names)
        self._depth = depth
        self.device = resolve_device(place)
        # latest iteration's (stop event, queue, worker thread) — close()
        # targets it; a new iteration stops the previous one first, so
        # re-iterating never leaks the old worker
        self._active: Optional[tuple] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.stats = {"batches": 0, "gate_waits": 0}

    def close(self):
        """Stop the active iteration's worker (idempotent): sets the
        stop event and drains the queue so no staged batch stays on the
        card behind an abandoned consumer."""
        active, self._active = self._active, None
        if active is None:
            return
        stop, q, _thread = active
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass

    def _stage(self, arrays, ring: List[_PinnedSlot], n: int):
        """Batch ``n`` as ({name: tensor on the device}, copy event or
        None)."""
        arrays = [(k, np.asarray(v)) for k, v in arrays]
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.array(a)) for k, a in arrays}, None
        slot = ring[n % len(ring)]
        me = threading.get_ident()
        ended = GATE.wait_ended(me)
        with GATE.shared():
            if GATE.wait_ended(me) != ended:
                self.stats["gate_waits"] += 1  # a capture held us back
            if slot.event is not None:
                slot.event.synchronize()  # its last copy has read it
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            feed = {}
            with torch.cuda.stream(self._stream):
                for k, a in arrays:
                    host = slot.buffer(k, a)
                    host.numpy()[...] = a
                    feed[k] = host.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            slot.event = event
        return feed, event

    def _hand_out(self, feed, event):
        """Make the consumer's current stream wait for the batch's copy
        and keep the tensors' memory until that stream's work on them is
        done."""
        if event is None:
            return feed
        with GATE.shared():
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in feed.values():
                t.record_stream(cur)
        return feed

    def __iter__(self):
        self.close()  # re-iteration must not leak the previous worker
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        END = object()
        failure = []
        _monitor.prefetch_depth(self._depth)
        ring = [_PinnedSlot() for _ in range(max(self._depth, 0) + 1)]

        def worker():
            try:
                for n, sample in enumerate(self._reader()):
                    if stop.is_set():
                        return
                    _F_PREFETCH.hit()
                    arrays = (sample.items() if isinstance(sample, dict)
                              else zip(self._names, sample))
                    item = self._stage(arrays, ring, n)
                    self.stats["batches"] += 1
                    if not _monitor.timed_put_stoppable(
                            q, item, stop, "device_loader"):
                        return
            except BaseException as e:  # surface in the consumer, not the
                failure.append(e)       # daemon thread's stderr
            finally:
                _monitor.timed_put_stoppable(q, END, stop,
                                             "device_loader")

        thread = threading.Thread(target=worker, daemon=True,
                                  name="pt-device-loader")
        self._active = (stop, q, thread)
        thread.start()

        def gen():
            try:
                while True:
                    # the consumer wait is THE input-bound signal: an
                    # empty prefetch queue means the step loop outran the
                    # host pipeline, and this wait weighs into the
                    # boundedness verdict
                    item = _monitor.timed_get(q, "device_loader")
                    if item is END:
                        if failure:
                            exc = failure[0]
                            # an OOM in the prefetch worker (a batch's
                            # copy to the card) gets the same forensics
                            # as an executor-side OOM, attributed to the
                            # prefetch phase
                            _monitor.maybe_record_oom(exc,
                                                      phase="prefetch")
                            raise RuntimeError(
                                "DeviceLoader reader thread failed: "
                                f"{type(exc).__name__}: {exc}") from exc
                        return
                    yield self._hand_out(*item)
            finally:
                # GeneratorExit (abandoned consumer) and normal
                # exhaustion both release the worker and its batches
                if self._active is not None and self._active[0] is stop:
                    self.close()
                else:
                    stop.set()

        return gen()


class PyReader:
    """API-compatible stand-in for the reference PyReader
    (reference: python/paddle/fluid/reader.py:42): decorate with a sample or
    batch reader, iterate feed dicts staged on ``places`` (the card when
    None; the first place of a list)."""

    def __init__(self, feed_list=None, capacity: int = 2, use_double_buffer=True,
                 iterable: bool = True):
        self._feed_vars = list(feed_list or [])
        self._capacity = capacity
        self._batch_reader = None
        self._places = None
        self._loader: Optional[DeviceLoader] = None

    def decorate_sample_list_generator(self, reader, places=None):
        self._batch_reader = reader
        self._places = places

    def decorate_batch_generator(self, reader, places=None):
        self._batch_reader = reader
        self._places = places

    def __iter__(self):
        from paddle_tpu_torch.data_feeder import DataFeeder

        # a previous iteration's worker must not leak: stop it before
        # starting the next (DeviceLoader.__iter__ also closes its own
        # prior iteration, but self._loader may be a different instance)
        self.reset()
        feeder = DataFeeder(self._feed_vars, place=self._places)
        place = self._places
        if isinstance(place, (list, tuple)):
            place = place[0] if place else None
        self._loader = DeviceLoader(
            # assembly runs in the prefetch worker, OFF the verdict's
            # critical path — overlapped batch building must not count
            # into the input score (the consumer's queue wait does)
            lambda: (feeder.feed(b, critical_path=False)
                     for b in self._batch_reader()),
            [v.name for v in self._feed_vars],
            depth=self._capacity, place=place,
        )
        return iter(self._loader)

    def start(self):
        """The reference's explicit queue start: iteration starts the
        worker lazily here, so this only validates state."""
        if self._batch_reader is None:
            raise RuntimeError(
                "PyReader.start() before decorate_sample_list_generator/"
                "decorate_batch_generator — no reader to start")

    def reset(self):
        """Stop the active iteration's prefetch worker (the reference's
        queue reset). Safe to call with no iteration active."""
        loader, self._loader = self._loader, None
        if loader is not None:
            loader.close()
