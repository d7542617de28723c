"""Reader decorators (reference: python/paddle/reader/decorator.py:82-360).

The JAX package's decorators, host-only: a seeded ``shuffle`` draws from
Python's ``random`` as the JAX copy does, so it gives the same order in
both packages. A reader is a zero-arg callable returning an iterator of
samples. Decorators
compose: shuffle, buffered (background-thread prefetch), batch, chain,
compose, map_readers, xmap (multi-thread transform), cache, firstn.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
import time
from typing import List

from paddle_tpu_torch import monitor as _monitor


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size: int):
    """(reference: decorator.py:82)"""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment: bool = True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        iterator = zip(*rs) if check_alignment else itertools.zip_longest(*rs)
        for outputs in iterator:
            yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size: int):
    """Background-thread prefetch (reference: decorator.py buffered) — the
    host half of double-buffering; device prefetch is reader/pipeline.py.

    A producer exception is captured and re-raised in the consumer (the
    ``finally: put(_End)`` still unblocks it first, so propagation is
    bounded by one queue drain, never a hang). With telemetry on, queue
    depth and producer/consumer waits feed the input-pipeline
    instruments (``pt_reader_queue_depth{site="buffered"}``,
    ``pt_reader_wait_seconds``) and the boundedness verdict."""

    class _End:
        pass

    def data_reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        failure: List[BaseException] = []

        def worker():
            try:
                for d in reader():
                    _monitor.timed_put(q, d, "buffered")
            except BaseException as e:  # re-raised by the consumer —
                failure.append(e)       # never a silently short epoch
            finally:
                q.put(_End)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            e = _monitor.timed_get(q, "buffered")
            if e is _End:
                if failure:
                    raise failure[0]
                break
            yield e

    return data_reader


def firstn(reader, n: int):
    def data_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return data_reader


def cache(reader):
    all_data: List = []
    filled = [False]

    def data_reader():
        if not filled[0]:
            all_data.extend(reader())
            filled[0] = True
        yield from all_data

    return data_reader


def xmap_readers(mapper, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """Multi-thread sample transform (reference: decorator.py xmap_readers).
    ``order=True`` preserves input order via sequence numbers.

    A raising ``mapper`` (or source reader) posts an error sentinel
    before its end marker, and the consumer re-raises on the NEXT get —
    bounded-time propagation in both modes. Without it, a dead worker
    never posts ``_End`` so the consumer blocks forever, and ordered
    mode additionally hangs on the sequence gap the lost sample leaves.
    Telemetry feeds ``pt_reader_queue_depth{site="xmap_in"/"xmap_out"}``
    and the producer/consumer wait histograms."""

    class _End:
        pass

    class _Err:
        def __init__(self, exc: BaseException):
            self.exc = exc

    def data_reader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feeder():
            try:
                for i, s in enumerate(reader()):
                    _monitor.timed_put(in_q, (i, s), "xmap_in")
            except BaseException as e:  # source reader failed: surface
                out_q.put(_Err(e))      # it in the consumer
            finally:
                for _ in range(process_num):
                    in_q.put(_End)

        def worker():
            while True:
                item = in_q.get()
                if item is _End:
                    out_q.put(_End)
                    break
                i, s = item
                try:
                    mapped = mapper(s)
                except BaseException as e:
                    # error BEFORE the end marker: the consumer raises
                    # on its next get instead of waiting out a sequence
                    # gap / missing _End forever
                    out_q.put(_Err(e))
                    out_q.put(_End)
                    break
                _monitor.timed_put(out_q, (i, mapped), "xmap_out")

        threading.Thread(target=feeder, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=worker, daemon=True).start()

        def _next():
            item = _monitor.timed_get(out_q, "xmap_out")
            if isinstance(item, _Err):
                raise item.exc
            return item

        ended = 0
        if not order:
            while ended < process_num:
                item = _next()
                if item is _End:
                    ended += 1
                    continue
                yield item[1]
            return
        pending = {}
        next_idx = 0
        while ended < process_num or pending:
            if next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1
                continue
            if ended == process_num:
                # every worker ended yet the next sequence number never
                # arrived: a sample was lost without an error sentinel
                raise RuntimeError(
                    f"xmap_readers(order=True): sequence gap at sample "
                    f"{next_idx} ({len(pending)} later samples buffered)")
            item = _next()
            if item is _End:
                ended += 1
                continue
            i, mapped = item
            pending[i] = mapped

    return data_reader


def multiprocess_reader(readers, use_pipe: bool = True,
                        queue_size: int = 1000):
    """Run each reader in its own OS process, interleaving their samples
    (reference: decorator.py multiprocess_reader — fork + pipe/queue).

    Worker processes only iterate their reader and enqueue samples, so
    they never touch CUDA (a forked child must not: plain data readers
    are safe). They are forked, as in the JAX package, because a reader
    is usually a closure, which a spawned process could not receive.
    Samples must be picklable. ``use_pipe`` is accepted for API parity; both modes use a
    multiprocessing queue here.

    Messages are tagged tuples so any sample payload works; a worker
    exception is re-raised in the consumer (truncated silent epochs are
    the reference's failure mode too — it forwards an error sentinel);
    a worker killed without cleanup (OOM/SIGKILL) is detected by a
    liveness poll instead of hanging the training loop.
    """
    if not isinstance(readers, (list, tuple)) or not readers:
        raise ValueError("multiprocess_reader needs a non-empty reader list")

    def data_reader():
        import multiprocessing as mp
        import queue as _queue

        ctx = mp.get_context("fork")
        q = ctx.Queue(queue_size)

        def worker(r):
            try:
                for sample in r():
                    q.put(("data", sample))
                q.put(("end", None))
            except BaseException as e:  # propagated to the consumer
                q.put(("error", repr(e)))

        procs = [
            ctx.Process(target=worker, args=(r,), daemon=True)
            for r in readers
        ]
        for p in procs:
            p.start()
        ended = 0
        try:
            while ended < len(readers):
                # gate snapshotted across the wait: a runtime telemetry
                # flip mid-get must not record perf_counter() - 0.0
                obs = _monitor.enabled()
                t_wait0 = time.perf_counter() if obs else 0.0
                while True:
                    try:
                        tag, payload = q.get(timeout=5.0)
                        break
                    except _queue.Empty:
                        if not any(p.is_alive() for p in procs):
                            raise RuntimeError(
                                "multiprocess_reader: worker process died "
                                "without an end/error message (killed?)"
                            )
                if obs:
                    # the total blocked time, Empty-timeout polls included
                    _monitor.reader_wait("multiprocess", "consumer",
                                         time.perf_counter() - t_wait0)
                    try:
                        _monitor.reader_depth("multiprocess", q.qsize())
                    except NotImplementedError:  # qsize unsupported on
                        pass                     # some platforms (macOS)
                if tag == "end":
                    ended += 1
                elif tag == "error":
                    raise RuntimeError(
                        f"multiprocess_reader worker failed: {payload}"
                    )
                else:
                    yield payload
        finally:
            # early exit leaves workers blocked in q.put on the bounded
            # queue; terminate first so join doesn't stall per worker
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)

    return data_reader

