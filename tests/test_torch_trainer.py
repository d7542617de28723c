"""The port's contrib.Trainer against the JAX package's, on the CPU, and
the port's own guarantees: prefetch against synchronous staging, a
bit-exact auto-resume at dropout 0.1, checkpoints either package resumes,
Executor.train_from_dataset and release_scope.

The model is tests/test_torch_train.py's tiny transformer (two layers,
d_model 16), fed from dataset.wmt16 padded to 12 tokens. Tolerances:

- JAX Trainer against port Trainer (dropout 0, the JAX package's
  parameters carried into the port Trainer's scope by name through
  ``io.scope_from_numpy``), 2 epochs x 3 steps of Adam under
  noam_decay(16, 4, 0.03): the losses within atol 1e-5, the Adam
  tolerance of tests/test_torch_train.py (Adam divides each gradient by
  the root of its own running square, so f32 summation-order noise in a
  near-zero element moves its update by up to the learning rate);
- train_from_dataset on both packages with SGD: the parameters within
  atol 1e-5 (f32 sums in another order);
- everything port against port (prefetch and sync, resumed and
  uninterrupted, the JAX package resuming the port's checkpoint): bit for
  bit.
"""

import warnings

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu import contrib as pcontrib
from paddle_tpu import flags as pflags
from paddle_tpu import layers as players
from paddle_tpu.dataset import wmt16 as pwmt16
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import contrib as tcontrib
from paddle_tpu_torch import faults as tfaults
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import checkpoint as tck

_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=2, dropout=0.0,
            label_smooth_eps=0.1)
_T = 12
_FEEDS = ["src_ids", "trg_ids", "lbl_ids", "src_pad_mask", "trg_pad_mask"]
_PKGS = {"jax": (pfluid, PT, players, pcontrib),
         "torch": (tfluid, TT, tlayers, tcontrib)}


@pytest.fixture(autouse=True)
def _clean():
    tfaults.disarm()
    tflags.set_flags({"prefetch_depth": 2})
    pflags.set_flags({"prefetch_depth": 2})
    yield
    tfaults.disarm()
    tflags.set_flags({"prefetch_depth": 2})
    pflags.set_flags({"prefetch_depth": 2})


def _reader(steps=3, batch=3):
    """wmt16 pairs (the toy vocabularies) padded to 12 tokens with their
    masks, ``steps`` batches of ``batch``."""
    def pad(sample):
        out = []
        for a in sample:
            ids = np.zeros(_T, np.int64)
            ids[:len(a)] = a
            out.append(ids)
        out.append((np.arange(_T) < len(sample[0])).astype(np.float32))
        out.append((np.arange(_T) < len(sample[1])).astype(np.float32))
        return tuple(out)

    samples = treader.map_readers(pad, pwmt16.train(37, 41, max_len=_T))
    return treader.batch(treader.firstn(samples, steps * batch), batch)


def _trainer(pkg, dropout=0.0, ckpt=None, seed=7, place=None):
    fluid, T, layers, contrib = _PKGS[pkg]
    cfg = T.TransformerConfig(**{**_CFG, "dropout": dropout})
    lr = {}

    def train_func():
        fluid.default_main_program().random_seed = seed
        fluid.default_startup_program().random_seed = seed
        model = T.build(cfg)
        lr["var"] = layers.noam_decay(16, 4, learning_rate=0.03)
        return [model["loss"], lr["var"]]

    with fluid.unique_name.guard():
        return contrib.Trainer(
            train_func, lambda: fluid.optimizer.Adam(lr["var"]),
            place or fluid.CPUPlace(), checkpoint_config=ckpt)


def _train(trainer, contrib, epochs, reader=None, fail=None):
    """Train; returns [loss of each step] (read after the run)."""
    got = []

    def handler(e):
        if isinstance(e, contrib.EndStepEvent):
            got.append(e.metrics)
            if fail is not None and len(got) == fail:
                fail_now()

    def fail_now():
        raise RuntimeError("handler fault")

    trainer.train(epochs, handler, reader or _reader(), _FEEDS)
    return [float(np.asarray(m[0]).reshape(-1)[0]) for m in got]


def _state(scope):
    return {n: np.array(scope.find_var(n)) for n in scope.var_names()}


def _assert_same_state(a, b):
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_trainer_losses_match_jax():
    jt = _trainer("jax")
    tt = _trainer("torch")
    start = _state(jt.scope)
    params = {p.name for p in tt.main_program.all_parameters()}
    assert params == {p.name for p in jt.main_program.all_parameters()}
    carried = tio.scope_from_numpy({n: start[n] for n in params},
                                   tfluid.CPUPlace())
    for n in carried.var_names():
        tt.scope.set(n, carried.find_var(n))
    want = _train(jt, pcontrib, 2)
    got = _train(tt, tcontrib, 2)
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the LR step counter counted the six steps in both
    step = [n for n in tt.scope.var_names()
            if n.startswith("learning_rate_sched_step")]
    assert float(np.array(tt.scope.find_var(step[0]))[0]) == 6.0
    np.testing.assert_array_equal(np.array(tt.scope.find_var(step[0])),
                                  np.array(jt.scope.find_var(step[0])))


def test_prefetch_and_sync_give_equal_losses():
    runs = {}
    for depth in (0, 2):
        tflags.set_flags({"prefetch_depth": depth})
        t = _trainer("torch", dropout=0.1)
        runs[depth] = (_train(t, tcontrib, 2), _state(t.scope))
        if depth:
            assert t.loader is not None and t.loader.stats["batches"] == 3
    assert runs[0][0] == runs[2][0]
    _assert_same_state(runs[0][1], runs[2][1])


def test_auto_resume_is_bit_exact_at_dropout(tmp_path):
    """reader.next fails in epoch 2 with one resume allowed and async
    saves: the trainer resumes from checkpoint_2 and ends where an
    uninterrupted run ends, dropout masks included."""
    plain = _trainer("torch", dropout=0.1, ckpt=tcontrib.CheckpointConfig(
        str(tmp_path / "a"), max_num_checkpoints=2, async_save=True))
    want = _train(plain, tcontrib, 3)
    tr = _trainer("torch", dropout=0.1, ckpt=tcontrib.CheckpointConfig(
        str(tmp_path / "b"), max_num_checkpoints=2, max_resume_retries=1,
        async_save=True))
    tfaults.arm("reader.next:raise@8")
    with pytest.warns(RuntimeWarning, match="auto-resuming from "
                                            "checkpoint_2"):
        got = _train(tr, tcontrib, 3)
    tfaults.disarm()
    assert got[:7] == want[:7] and got[7:] == want[6:]
    _assert_same_state(_state(tr.scope), _state(plain.scope))
    assert tck.available_steps(str(tmp_path / "b")) == [2, 3]
    assert [r["serial"] for r in tr.save_log] == [1, 2, 3]
    assert all(r["snapshot_s"] is not None and r["write_s"] is not None
               for r in tr.save_log)


def test_a_new_trainer_resumes_bit_exact(tmp_path):
    """A process restart: a new Trainer over the same directory resumes
    from the newest serial, its RNG cursor included."""
    cfg = lambda: tcontrib.CheckpointConfig(str(tmp_path),  # noqa: E731
                                            max_num_checkpoints=3)
    plain = _trainer("torch", dropout=0.1)
    want = _train(plain, tcontrib, 3)
    first = _trainer("torch", dropout=0.1, ckpt=cfg())
    _train(first, tcontrib, 2)
    second = _trainer("torch", dropout=0.1, ckpt=cfg())
    assert second._start_epoch == 2
    assert second.exe._step == first.exe._step == plain.exe._step - 3
    got = _train(second, tcontrib, 3)
    assert got == want[6:]
    _assert_same_state(_state(second.scope), _state(plain.scope))


def test_resume_budget_exhausts_then_raises(tmp_path):
    tr = _trainer("torch", ckpt=tcontrib.CheckpointConfig(
        str(tmp_path), max_resume_retries=1))
    tfaults.arm("reader.next:raise@p1")
    with pytest.raises(tfaults.InjectedFault), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _train(tr, tcontrib, 2)


def test_stop_mid_epoch_writes_no_checkpoint(tmp_path):
    tr = _trainer("torch", ckpt=tcontrib.CheckpointConfig(str(tmp_path)))

    def handler(e):
        if isinstance(e, tcontrib.EndStepEvent) and e.step == 1:
            tr.stop()

    tr.train(2, handler, _reader(), _FEEDS)
    assert tck.available_steps(str(tmp_path)) == []
    assert tr.loader._active is None  # the worker was released


def test_port_checkpoint_resumes_in_the_jax_trainer(tmp_path):
    """A checkpoint the port's Trainer wrote resumes a JAX Trainer: its
    parameters, moments, LR step and RNG cursor are the port's bits."""
    tr = _trainer("torch", ckpt=tcontrib.CheckpointConfig(str(tmp_path)))
    _train(tr, tcontrib, 1)
    port_state = _state(tr.scope)
    jt = _trainer("jax", ckpt=pcontrib.CheckpointConfig(str(tmp_path)))
    assert jt._start_epoch == 1 and jt.exe._step == tr.exe._step
    jax_state = _state(jt.scope)
    for n in port_state:
        np.testing.assert_array_equal(jax_state[n], port_state[n],
                                      err_msg=n)


def test_test_save_params_and_inference_model(tmp_path):
    tr = _trainer("torch")
    _train(tr, tcontrib, 1)
    means = tr.test(_reader(steps=2), _FEEDS)
    assert len(means) == 2 and np.isfinite(means).all()
    tr.save_params(str(tmp_path / "params"))
    tr.save_inference_model(str(tmp_path / "model"), _FEEDS,
                            [tr.train_outputs[0]])
    scope = tio.scope_from_params_file(str(tmp_path / "params"),
                                       tfluid.CPUPlace())
    for p in tr.main_program.all_parameters():
        np.testing.assert_array_equal(np.array(scope.find_var(p.name)),
                                      np.array(tr.scope.find_var(p.name)))


def test_parallel_and_strategy_wait_for_item_9():
    for kw in ({"parallel": True}, {"strategy": object()}):
        with pytest.raises(NotImplementedError, match="item 9"):
            tcontrib.Trainer(lambda: None, lambda: None, tfluid.CPUPlace(),
                             **kw)


# --- Executor.train_from_dataset / release_scope -----------------------------


def _dataset_files(tmp_path):
    r = np.random.RandomState(3)
    paths = []
    for i in range(2):
        p = tmp_path / f"part-{i}.txt"
        p.write_text("".join(
            " ".join(f"{v:.6f}" for v in r.randn(6)) + f" {r.randint(3)}\n"
            for _ in range(10)))
        paths.append(str(p))
    return paths


def _parse(line):
    v = line.split()
    return (np.array(v[:6], np.float32), np.array(v[6:], np.int64))


def _dataset_program(fluid, layers):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[6], dtype="float32")
        y = layers.data("label", shape=[1], dtype="int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(x, 3, param_attr=fluid.ParamAttr(name="ds_fc.w"),
                      bias_attr=fluid.ParamAttr(name="ds_fc.b")), y))
        fluid.optimizer.SGD(0.2).minimize(loss)
    return main, startup, x, y, loss


def test_train_from_dataset_matches_jax_and_release_scope(tmp_path):
    files = _dataset_files(tmp_path)
    names = ("ds_fc.w", "ds_fc.b")
    start, out = None, {}
    for name, fluid, layers in (("jax", pfluid, players),
                                ("torch", tfluid, tlayers)):
        main, startup, x, y, loss = _dataset_program(fluid, layers)
        ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_filelist(files)
        ds.set_batch_size(4)
        ds.set_use_var([x, y])
        ds.set_parse_fn(_parse)
        ds.load_into_memory()
        ds.set_shuffle_seed(5)
        ds.local_shuffle()
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if start is None:  # the port starts from the JAX weights
                start = {n: np.array(scope.find_var(n)) for n in names}
            else:
                for n in names:
                    scope.set(n, start[n])
            steps = exe.train_from_dataset(main, ds, fetch_list=[loss])
            assert exe.infer_from_dataset(main.clone(for_test=True), ds,
                                          fetch_list=[loss]) == steps
        out[name] = (steps, {n: np.array(scope.find_var(n))
                             for n in names}, exe, scope)
    assert out["torch"][0] == out["jax"][0] == 5
    for n in names:
        np.testing.assert_allclose(out["torch"][1][n], out["jax"][1][n],
                                   atol=1e-5, rtol=0, err_msg=n)
        assert not np.array_equal(out["torch"][1][n], start[n])
    _, _, exe, scope = out["torch"]
    assert exe.release_scope(scope) == 3   # startup, train and test
    assert exe.release_scope(scope) == 0
    assert exe.release_scope(tfluid.Scope()) == 0
