"""The label-semantic-roles chapter (the reference's
book/test_label_semantic_roles.py) built in both packages from their
public layers, on the CPU.

- ``db_lstm``, the book's network: six word-context embeddings sharing
  the frozen ``emb`` table (startup weights here; the H100 run loads
  ``dataset.conll05.get_embedding()``), a predicate and a mark embedding
  (row-sparse), fc + ``sums`` into ``depth`` stacked ``dynamic_lstm`` of
  alternating direction (candidate ReLU, cell sigmoid, peepholes off),
  each layer's fc over the previous layer's (hidden, cell) pair as in the
  reference, ``linear_chain_crf`` on a ``crfw`` transition with its own
  learning rate, ``crf_decoding`` and ``chunk_eval`` (IOB, 29 chunk
  types) on the test program. Here at depth 2, hidden 32, word vocab 64,
  from ``dataset.conll05.train()`` records (ids folded into the small
  vocabularies) through ``DataFeeder`` padded to T 30: three Adam steps'
  losses, the ``crfw`` and an LSTM weight's gradients and the decode
  path equal the JAX package's (1e-5 / 1e-4 of the largest |value|;
  paths and chunk counts exactly), and the path through
  ``save_inference_model`` / ``load_inference_model`` equals the test
  program's bit for bit.
- The DynamicRNN + IfElse version of the chapter (the JAX package's
  tests/test_book_srl.py): three Adam steps equal."""

import numpy as np
import pytest
from torch_model_parity import rel, train_both

import paddle_tpu as pfluid
from paddle_tpu.data_feeder import DataFeeder as PFeeder
from paddle_tpu.dataset import conll05 as pconll05

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder

WORD, PRED, MARK, LABELS = 64, 16, 2, 59
WORD_DIM, MARK_DIM, HIDDEN, DEPTH, T, B = 32, 5, 32, 2, 30, 4
CHUNK_TYPES = (LABELS - 1 + 1) // 2  # ceil((59 - 1) / 2) = 29
FIELDS = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
          "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data", "target"]
TOL_FWD, TOL_GRAD = 1e-5, 1e-4


def db_lstm(fluid):
    """The book's network and its training objective, in ``fluid``."""
    L = fluid.layers
    feeds = {n: L.data(n, shape=[T], dtype="int64") for n in FIELDS}
    length = L.data("word_data_len", shape=[], dtype="int64")
    pred_emb = L.embedding(feeds["verb_data"], size=[PRED, WORD_DIM],
                           is_sparse=True, param_attr="vemb")
    mark_emb = L.embedding(feeds["mark_data"], size=[MARK, MARK_DIM],
                           is_sparse=True)
    embs = [L.embedding(feeds[n], size=[WORD, WORD_DIM], is_sparse=True,
                        param_attr=fluid.ParamAttr(name="emb",
                                                   trainable=False))
            for n in FIELDS[:6]] + [pred_emb, mark_emb]
    hidden_0 = L.sums([L.fc(e, HIDDEN, num_flatten_dims=2, act="tanh")
                       for e in embs])
    lstm_0 = L.dynamic_lstm(hidden_0, HIDDEN, length=length,
                            candidate_activation="relu",
                            gate_activation="sigmoid",
                            cell_activation="sigmoid")
    # the reference feeds each layer's fc the lstm's (hidden, cell) pair
    tmp = [hidden_0, lstm_0]
    for i in range(1, DEPTH):
        mix = L.sums([L.fc(tmp[0], HIDDEN, num_flatten_dims=2, act="tanh"),
                      L.fc(list(tmp[1]), HIDDEN, num_flatten_dims=2,
                           act="tanh")])
        lstm = L.dynamic_lstm(mix, HIDDEN, length=length,
                              candidate_activation="relu",
                              gate_activation="sigmoid",
                              cell_activation="sigmoid",
                              is_reverse=(i % 2) == 1)
        tmp = [mix, lstm]
    feature = L.sums([L.fc(tmp[0], LABELS, num_flatten_dims=2, act="tanh"),
                      L.fc(list(tmp[1]), LABELS, num_flatten_dims=2,
                           act="tanh")])
    cost = L.linear_chain_crf(feature, feeds["target"], length=length,
                              param_attr=fluid.ParamAttr(
                                  name="crfw", learning_rate=1e-3))
    decode = L.crf_decoding(feature, param_attr=fluid.ParamAttr(name="crfw"),
                            length=length)
    chunks = L.chunk_eval(decode, feeds["target"], "IOB", CHUNK_TYPES,
                          seq_length=length)
    return {"loss": L.mean(cost), "feature": feature, "decode": decode,
            "f1": chunks[2], "n_correct": chunks[5],
            "feed_vars": [feeds[n] for n in FIELDS]}


def _batches(fluid, feeder_cls, model, n):
    """``n`` batches of B records of ``conll05.train()``, ids folded into
    the small vocabularies, padded to T by the package's DataFeeder."""
    reader = pconll05.train()()
    feeder = feeder_cls(model["feed_vars"], pad_to={f: T for f in FIELDS})
    out = []
    for _ in range(n):
        recs = []
        for _ in range(B):
            rec = next(reader)
            recs.append([np.asarray(v) % m for v, m in zip(
                rec, [WORD] * 6 + [PRED, MARK, LABELS])])
        fd = feeder.feed(recs)
        out.append({k: fd[k] for k in FIELDS + ["word_data_len"]})
    return out


def _book_sgd(fluid):
    """The book's optimizer: SGD on a staircase exponential decay."""
    return fluid.optimizer.SGD(
        learning_rate=fluid.layers.exponential_decay(
            learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
            staircase=True))


@pytest.mark.parametrize("opt", ["adam", "book_sgd"])
def test_srl_chapter_trains_and_decodes_as_jax(tmp_path, opt):
    """Three Adam steps (and three of the book's SGD): losses, gradients
    and the final state equal the JAX package's; the test program's
    decode path and chunk counts too."""
    prog = {}

    def model_fn(fluid):
        m = db_lstm(fluid)
        prog[fluid] = fluid.default_main_program().clone(for_test=True)
        return m

    main = pfluid.Program()
    with pfluid.program_guard(main, pfluid.Program()), \
            pfluid.unique_name.guard():
        feeds = _batches(pfluid, PFeeder, db_lstm(pfluid), 4)
    tfeeds = []
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()), \
            tfluid.unique_name.guard():
        tfeeds = _batches(tfluid, TFeeder, db_lstm(tfluid), 4)
    for a, b in zip(feeds, tfeeds):  # the two feeders pad alike
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    fetch = ["crfw@GRAD", "lstm_0.w_0@GRAD", "vemb@GRAD@VALUES"]
    j, t, jf, tf, tmain = train_both(
        model_fn, (lambda fluid: fluid.optimizer.Adam(1e-3))
        if opt == "adam" else _book_sgd, feeds[:3],
        lambda m: [m["loss"]] + fetch)
    for sj, st in zip(j, t):
        assert rel(st[0], sj[0]) <= TOL_FWD
        for a, b in zip(sj[1:], st[1:]):
            assert rel(b, a) <= TOL_GRAD, rel(b, a)
    assert float(t[-1][0]) < float(t[0][0])
    for name in ("crfw", "lstm_1.w_0", "vemb", "fc_0.w_0"):
        assert rel(tf[name], jf[name]) <= TOL_GRAD, name
    np.testing.assert_array_equal(tf["emb"], jf["emb"])  # frozen

    # the decode path on the test program, from the trained state
    outs = []
    for fluid in (pfluid, tfluid):
        test_prog = prog[fluid]
        ops = test_prog.global_block().ops
        decode = next(o for o in ops if o.type == "crf_decoding").output(
            "ViterbiPath")[0]
        m_names = next(o for o in ops if o.type == "chunk_eval").output(
            "NumCorrectChunks")
        state = jf if fluid is pfluid else tf
        if fluid is pfluid:
            scope = pfluid.Scope()
            for k, v in state.items():
                scope.set(k, v)
        else:
            scope = tio.scope_from_numpy(state, tfluid.CPUPlace())
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            outs.append([np.asarray(v) for v in exe.run(
                test_prog, feed=feeds[3], fetch_list=[decode] + m_names)])
            if fluid is tfluid:
                d = str(tmp_path / "srl")
                tio.save_inference_model(
                    d, ["word_data", "ctx_n2_data", "ctx_n1_data",
                        "ctx_0_data", "ctx_p1_data", "ctx_p2_data",
                        "verb_data", "mark_data", "word_data_len"],
                    [test_prog.global_block().var(decode)], exe, tmain)
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        loaded, names, targets = tio.load_inference_model(d, exe2)
        (got,) = exe2.run(loaded, feed={k: feeds[3][k] for k in names},
                          fetch_list=targets)
    np.testing.assert_array_equal(got, outs[1][0])


def test_frozen_table_gets_no_gradient_and_stays():
    """The six word lookups share ``emb``; it is frozen (trainable False),
    so no sparse gradient is built for it and the optimizer leaves it."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        m = db_lstm(tfluid)
        tfluid.optimizer.SGD(0.1).minimize(m["loss"])
    names = {n for op in main.global_block().ops
             for n in op.output_arg_names}
    assert not any(n.startswith("emb@GRAD") for n in names)
    assert "vemb@GRAD@VALUES" in names


# --- the DynamicRNN chapter (tests/test_book_srl.py) -------------------------


def _book_srl(fluid):
    L = fluid.layers
    word = L.data("word", shape=[12], dtype="int64")
    mark = L.data("mark", shape=[12], dtype="int64")
    label = L.data("label", shape=[12], dtype="int64")
    length = L.data("length", shape=[1], dtype="int64")
    feat = L.concat([L.embedding(word, size=[64, 24]),
                     L.embedding(mark, size=[2, 12])], axis=-1)
    drnn = L.DynamicRNN()
    with drnn.block():
        w = drnn.step_input(feat, length=length)
        prev = drnn.memory(shape=[32])
        h = L.fc([w, prev], 32, act="tanh")
        drnn.update_memory(prev, h)
        drnn.output(h)
    emission = L.fc(drnn(), 8, num_flatten_dims=2)
    cost = L.linear_chain_crf(emission, label,
                              param_attr=fluid.ParamAttr(name="crfw"),
                              length=length)
    decode = L.crf_decoding(emission, param_attr=fluid.ParamAttr(
        name="crfw"), length=length)
    return {"loss": L.mean(cost), "decode": decode}


def _book_batch(seed):
    r = np.random.RandomState(seed)
    words = r.randint(1, 64, (16, 12)).astype(np.int64)
    mark = np.zeros((16, 12), np.int64)
    mark[np.arange(16), r.randint(0, 12, 16)] = 1
    length = r.randint(6, 13, (16,)).astype(np.int64)
    labels = ((words % 4) + 4 * mark) % 8
    for i in range(16):
        labels[i, length[i]:] = 0
        words[i, length[i]:] = 0
    return {"word": words, "mark": mark, "label": labels,
            "length": length[:, None]}


@pytest.mark.parametrize("steps", [3])
def test_dynamic_rnn_chapter_trains_as_jax(steps):
    j, t, _, _, _ = train_both(
        _book_srl, lambda fluid: fluid.optimizer.Adam(5e-3),
        [_book_batch(s) for s in range(steps)],
        lambda m: [m["loss"], m["decode"], "crfw@GRAD"])
    for sj, st in zip(j, t):
        assert rel(st[0], sj[0]) <= TOL_FWD
        np.testing.assert_array_equal(st[1], sj[1])
        assert rel(st[2], sj[2]) <= TOL_GRAD

