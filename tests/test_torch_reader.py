"""The port's reader stack against the JAX package's, on the CPU: the
reader decorators and ``batch``, the ten synthetic datasets, the
``DataFeeder``, the dataset containers (``dataset_api``), the streaming
metrics, and the ``DeviceLoader`` / ``PyReader`` lifecycle (the cases of
tests/test_async_pipeline.py on the port, with CPU tensors).

Tolerance: none. Readers, datasets, feeders and seeded shuffles are host
numpy and Python ``random`` in both packages, so every sample, batch and
order is equal; the metrics are host numpy over the same inputs, equal to
rtol 1e-12 (float64 sums in the same order).
"""

import os
import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu import dataset as pdataset
from paddle_tpu import dataset_api as pdapi
from paddle_tpu import faults as pfaults
from paddle_tpu import layers as players
from paddle_tpu import metrics as pmetrics
from paddle_tpu import reader as preader
from paddle_tpu.data_feeder import DataFeeder as PFeeder

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import dataset_api as tdapi
from paddle_tpu_torch import faults as tfaults
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import metrics as tmetrics
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder
from paddle_tpu_torch.reader.pipeline import DeviceLoader, PyReader


@pytest.fixture(autouse=True)
def _clean():
    tfaults.disarm()
    yield
    tfaults.disarm()
    pfaults.disarm()


def _same(a, b):
    """Equal nested samples (tuples / lists / dicts of arrays and
    scalars)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _take(reader, n=8):
    out = []
    for s in reader():
        out.append(s)
        if len(out) == n:
            break
    return out


# --- datasets ---------------------------------------------------------------

_READERS = [
    ("cifar", "train10", ()), ("cifar", "test10", ()),
    ("cifar", "train100", ()), ("conll05", "test", ()),
    ("flowers", "train", ()), ("imdb", "train", ()), ("imdb", "test", ()),
    ("mnist", "train", ()), ("mnist", "test", ()),
    ("movielens", "train", ()), ("movielens", "test", ()),
    ("sentiment", "train", ()), ("uci_housing", "train", ()),
    ("uci_housing", "test", ()), ("wmt14", "train", (1000,)),
    ("wmt16", "train", (10000, 10000)), ("wmt16", "test", (10000, 10000)),
    ("imagenet", "train", ()),
]


@pytest.mark.parametrize("mod,fn,args", _READERS,
                         ids=[f"{m}.{f}" for m, f, _ in _READERS])
def test_dataset_first_samples_equal_jax(mod, fn, args):
    want = _take(getattr(getattr(pdataset, mod), fn)(*args))
    got = _take(getattr(getattr(tdataset, mod), fn)(*args))
    assert len(got) == len(want) == 8
    _same(got, want)


def test_every_jax_dataset_is_ported():
    for name in ("cifar", "conll05", "flowers", "imagenet", "imdb", "mnist",
                 "movielens", "sentiment", "uci_housing", "wmt14", "wmt16"):
        assert hasattr(tdataset, name), name


def test_dataset_helpers_equal_jax():
    _same(tdataset.conll05.get_dict(), pdataset.conll05.get_dict())
    _same(tdataset.imdb.word_dict(), pdataset.imdb.word_dict())
    np.testing.assert_array_equal(tdataset.conll05.get_embedding(),
                                  pdataset.conll05.get_embedding())


# --- decorators -------------------------------------------------------------


def _counter(n=20, start=0):
    def r():
        for i in range(start, start + n):
            yield (np.int64(i), np.full(3, i, np.float32))

    return r


def _both(make):
    return make(preader), make(treader)


_DECORATORS = {
    "map_readers": lambda m: m.map_readers(
        lambda a, b: (a[0] + b[0], a[1] * 2), _counter(), _counter(start=5)),
    "chain": lambda m: m.chain(_counter(5), _counter(4, start=50)),
    "compose": lambda m: m.compose(_counter(6), _counter(6, start=9)),
    "buffered": lambda m: m.buffered(_counter(), 4),
    "firstn": lambda m: m.firstn(_counter(), 7),
    "cache": lambda m: m.cache(_counter(9)),
    "xmap_readers": lambda m: m.xmap_readers(
        lambda s: (s[0] * 3, s[1]), _counter(), 3, 4, order=True),
    "batch": lambda m: m.batch(_counter(10), 3, drop_last=False),
    "batch_drop_last": lambda m: m.batch(_counter(10), 3),
}


@pytest.mark.parametrize("name", sorted(_DECORATORS))
def test_decorator_equals_jax(name):
    pr, tr = _both(_DECORATORS[name])
    _same(list(tr()), list(pr()))


def test_seeded_shuffle_gives_the_jax_order():
    pr, tr = _both(lambda m: m.shuffle(_counter(50), 16))
    random.seed(7)
    want = list(pr())
    random.seed(7)
    got = list(tr())
    _same(got, want)
    assert [int(s[0]) for s in got] != list(range(50))


def test_multiprocess_reader_yields_every_sample():
    r = treader.multiprocess_reader([_counter(6), _counter(5, start=100)],
                                    queue_size=4)
    got = sorted(int(s[0]) for s in r())
    assert got == list(range(6)) + list(range(100, 105))


# --- DataFeeder -------------------------------------------------------------


def _feed_vars(fluid, layers):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[3], dtype="float32")
        ids = layers.data("ids", shape=[-1], dtype="int64")
        y = layers.data("label", shape=[1], dtype="int64")
    return [x, ids, y]


def test_data_feeder_equals_jax():
    r = np.random.RandomState(0)
    batch = [(r.randn(3), r.randint(0, 9, r.randint(2, 7)), r.randint(4))
             for _ in range(5)]
    want = PFeeder(_feed_vars(pfluid, players),
                   pad_to={"ids": 6}).feed(batch)
    got = TFeeder(_feed_vars(tfluid, tlayers), pad_to={"ids": 6}).feed(batch)
    _same(got, want)
    assert got["label"].shape == (5, 1) and got["ids_len"].dtype == np.int64
    with pytest.raises(ValueError, match="ragged"):
        TFeeder(_feed_vars(tfluid, tlayers)).feed(batch)


# --- dataset_api ------------------------------------------------------------


def _files(tmp_path, n=3, rows=7):
    r = np.random.RandomState(1)
    out = []
    for i in range(n):
        p = tmp_path / f"part-{i}.txt"
        p.write_text("".join(
            " ".join(f"{v:.5f}" for v in r.randn(4)) + f" {r.randint(3)}\n"
            for _ in range(rows)))
        out.append(str(p))
    return out


def _parse(line):
    v = line.split()
    return (np.array(v[:4], np.float32), np.array(v[4:], np.int64))


@pytest.mark.parametrize("kind", ["InMemoryDataset", "QueueDataset"])
def test_datasets_batch_as_jax(tmp_path, kind):
    files = _files(tmp_path)
    batches = []
    for api in (pdapi, tdapi):
        ds = api.DatasetFactory().create_dataset(kind)
        ds.set_filelist(files)
        ds.set_batch_size(4)
        ds.set_use_var(["x", "y"])
        ds.set_parse_fn(_parse)
        if kind == "InMemoryDataset":
            ds.load_into_memory()
            ds.set_shuffle_seed(3)
            ds.local_shuffle()
        batches.append(list(ds.batch_reader()()))
    _same(batches[1], batches[0])
    assert len(batches[1]) == 6  # 21 rows in batches of 4


def test_global_shuffle_over_one_worker_is_local_and_more_wait():
    class Fleet:
        def __init__(self, n):
            self.n = n

        def worker_num(self):
            return self.n

    ds = tdapi.InMemoryDataset()
    ds._samples = list(range(10))
    ds.set_shuffle_seed(4)
    ds.global_shuffle(Fleet(1))
    want = list(range(10))
    random.Random(4).shuffle(want)
    assert ds._samples == want
    with pytest.raises(NotImplementedError, match="item 9"):
        ds.global_shuffle(Fleet(2))


# --- metrics ----------------------------------------------------------------


def _metric_rounds(metrics):
    r = np.random.RandomState(0)
    out = {}
    acc = metrics.Accuracy()
    for _ in range(3):
        acc.update(r.rand(), r.randint(1, 9))
    out["acc"] = acc.eval()
    ch = metrics.ChunkEvaluator()
    for _ in range(3):
        n = r.randint(5, 9)
        ch.update(n, n + r.randint(3), r.randint(1, n))
    out["chunk"] = ch.eval()
    ed = metrics.EditDistance("ed")
    ed.update(r.randint(0, 4, (6, 1)).astype(np.float32), 6)
    out["ed"] = ed.eval()
    auc = metrics.Auc("auc")
    preds = r.rand(32, 2)
    auc.update(preds, r.randint(0, 2, (32, 1)))
    out["auc"] = auc.eval()
    p, rc = metrics.Precision(), metrics.Recall()
    pr, lb = r.rand(20) > 0.5, r.rand(20) > 0.4
    p.update(pr.astype(np.float32), lb.astype(np.int64))
    rc.update(pr.astype(np.float32), lb.astype(np.int64))
    out["precision"], out["recall"] = p.eval(), rc.eval()
    comp = metrics.CompositeMetric()
    comp.add_metric(metrics.Precision())
    comp.add_metric(metrics.Recall())
    comp.update(pr.astype(np.float32), lb.astype(np.int64))
    out["composite"] = comp.eval()
    return out


def test_metrics_equal_jax():
    want, got = _metric_rounds(pmetrics), _metric_rounds(tmetrics)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-12, err_msg=k)


def test_detection_map_waits_for_its_op():
    with pytest.raises(NotImplementedError, match="detection_map"):
        tmetrics.DetectionMAP(None, None, None, class_num=3)


# --- DeviceLoader / PyReader lifecycle --------------------------------------


def _no_loader_threads(timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if not any(t.name == "pt-device-loader" and t.is_alive()
                   for t in threading.enumerate()):
            return True
        time.sleep(0.01)
    return False


_CPU = tfluid.CPUPlace()


def test_device_loader_abandoned_consumer_unblocks_worker():
    produced = []

    def reader():
        for i in range(50):
            produced.append(i)
            yield {"x": np.full((2, 2), i, np.float32)}

    loader = DeviceLoader(reader, feed_names=["x"], depth=2, place=_CPU)
    it = iter(loader)
    _stop, _q, thread = loader._active
    first = next(it)
    assert set(first) == {"x"} and isinstance(first["x"], torch.Tensor)
    assert first["x"].device.type == "cpu"
    it.close()
    thread.join(5.0)
    assert not thread.is_alive(), "worker still blocked after close"
    assert loader._active is None
    assert len(produced) <= 8, produced


def test_device_loader_break_in_for_loop_releases_worker():
    def reader():
        while True:
            yield {"x": np.zeros((2, 2), np.float32)}

    loader = DeviceLoader(reader, feed_names=["x"], depth=3, place=_CPU)
    for i, batch in enumerate(loader):
        if i >= 1:
            break
    del batch
    loader.close()
    assert _no_loader_threads()


def test_device_loader_reiteration_does_not_leak_previous_worker():
    def reader():
        while True:
            yield {"x": np.zeros((2, 2), np.float32)}

    loader = DeviceLoader(reader, feed_names=["x"], depth=2, place=_CPU)
    it1 = iter(loader)
    _stop1, _q1, t1 = loader._active
    next(it1)
    it2 = iter(loader)
    t1.join(5.0)
    assert not t1.is_alive()
    next(it2)
    loader.close()
    assert _no_loader_threads()


def test_pyreader_reset_stops_active_loader():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[4], dtype="float32")

    def batches():
        while True:
            yield [(np.ones(4, np.float32),)] * 2

    pr = PyReader(feed_list=[x], capacity=2)
    pr.decorate_sample_list_generator(batches, places=[_CPU])
    it1 = iter(pr)
    assert set(next(it1)) == {"x"}
    t1 = pr._loader._active[2]
    it2 = iter(pr)
    t1.join(5.0)
    assert not t1.is_alive()
    assert set(next(it2)) == {"x"}
    pr.reset()
    assert _no_loader_threads()
    pr.start()
    with pytest.raises(RuntimeError, match="no reader"):
        PyReader(feed_list=[x]).start()


def test_device_loader_exhaustion_still_propagates_reader_error():
    def bad_reader():
        yield {"x": np.zeros((2, 2), np.float32)}
        raise ValueError("producer died")

    loader = DeviceLoader(bad_reader, feed_names=["x"], depth=2, place=_CPU)
    out = []
    with pytest.raises(RuntimeError, match="producer died"):
        for b in loader:
            out.append(b)
    assert len(out) == 1
    assert _no_loader_threads()


def test_prefetch_oom_surfaces_with_forensics():
    """An out-of-memory error staging a batch reaches the consumer after
    the batches before it, with the monitor's OOM record (phase
    'prefetch')."""
    from paddle_tpu_torch import flags as tflags

    tflags.set_flags({"telemetry": True})
    try:
        tmonitor.reset()
        tfaults.arm("pipeline.prefetch:raise(RESOURCE_EXHAUSTED staging)@3")

        def reader():
            for i in range(6):
                yield {"x": np.full((2,), i, np.float32)}

        loader = DeviceLoader(reader, ["x"], depth=2, place=_CPU)
        got = []
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            for b in loader:
                got.append(float(b["x"][0]))
        assert got == [0.0, 1.0]
        recs = tmonitor.oom_records()
        assert recs and recs[-1]["phase"] == "prefetch"
    finally:
        tfaults.disarm()
        tflags.set_flags({"telemetry": False})
        tmonitor.reset()


def test_sequence_samples_follow_feed_names_and_copy():
    src = np.arange(6, dtype=np.int64).reshape(2, 3)

    def reader():
        yield (src, np.ones(2, np.float32))

    loader = DeviceLoader(reader, ["a", "b"], depth=1, place=_CPU)
    (feed,) = list(loader)
    assert sorted(feed) == ["a", "b"]
    src[0, 0] = 99  # the staged batch owns its bytes
    assert int(feed["a"][0, 0]) == 0


def test_loader_on_the_card_by_default_and_sharding_waits():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            DeviceLoader(lambda: iter(()), ["x"])
    with pytest.raises(NotImplementedError, match="item 9"):
        DeviceLoader(lambda: iter(()), ["x"], sharding=object(), place=_CPU)
    assert os.environ.get("JAX_PLATFORMS", "cpu") is not None
