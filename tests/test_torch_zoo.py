"""The rest of the reference benchmark's models (MNIST conv and MLP,
VGG-16, the stacked dynamic LSTM, the LSTM seq2seq with attention) and
the book chapters built on the sequence and recurrent ops, built and
trained by the port against the JAX package's, on the CPU.

Both packages build each program from the same code (under
``unique_name.guard()``): the same op types in the same order and the
same parameter names and shapes. The JAX package's startup state is
carried across by name, Adam slots by (param, kind); the same numpy
feeds go through both (``torch_model_parity.train_both``). Tolerances:
losses within 1e-5 relative, gradients and the state after the steps
within 1e-4 of each tensor's largest |element|.

VGG-16 (13 ReLU convolutions) at 32 x 32 is held in full in f64
(``vgg16_f64``: every gradient of its three Adam steps at 1e-3 and the
state after them), where no pre-activation lies within rounding of a
ReLU's kink. In f32 one does: it takes the other branch of the ReLU's
derivative in the other package and every gradient upstream of it moves
(the first convolution's by 7.9e-4 of its largest element at the first
step), which Adam's sign-like first steps then spread; the f32 net is
held on its forward quantities and its classifier's gradient, and its
pieces (two conv blocks and the fc head) in every gradient and the
state."""

import numpy as np
import pytest
from torch_model_parity import rel, same_programs, train_both

import paddle_tpu as pfluid
from paddle_tpu.models import seq2seq as pseq2seq
from paddle_tpu.models import stacked_lstm as pstacked

TOL_LOSS, TOL_REL = 1e-5, 1e-4


def _zoo(name):
    """The model module ``name`` of the package ``fluid`` belongs to."""
    import importlib

    def get(fluid):
        pkg = "paddle_tpu" if fluid is pfluid else "paddle_tpu_torch"
        return importlib.import_module(f"{pkg}.models.{name}")

    return get


_mnist, _vgg = _zoo("mnist"), _zoo("vgg")
_stacked, _seq2seq = _zoo("stacked_lstm"), _zoo("seq2seq")
_SLSTM = dict(vocab_size=50, embed_dim=8, hidden_dim=8, stacked_num=2,
              max_len=12)
_S2S = dict(src_vocab_size=30, trg_vocab_size=31, embed_dim=8,
            hidden_dim=8, num_layers=2)


def _vgg_pieces(fluid):
    """Two of VGG's conv blocks and its fc head (fc_dim 64, no dropout)."""
    V, L = _vgg(fluid), fluid.layers
    img = L.data("data", shape=[3, 16, 16], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    x = V.conv_block(V.conv_block(img, 8, 2), 16, 1)
    for _ in range(2):
        x = L.fc(x, 64, act="relu")
    logits = L.fc(x, 10)
    return {"loss": L.mean(L.softmax_with_cross_entropy(logits, label)),
            "logits": logits}


def _vgg16_f64(fluid):
    """VGG-16 at 32 x 32 (fc 512, no dropout) in f64."""
    L = fluid.layers
    img = L.data("data", shape=[3, 32, 32], dtype="float64")
    label = L.data("label", shape=[1], dtype="int64")
    logits = _vgg(fluid).vgg16(img, 10, is_test=True, fc_dim=512)
    return {"loss": L.mean(L.softmax_with_cross_entropy(logits, label)),
            "logits": logits}


MODELS = {
    "mnist_conv": lambda fl: _mnist(fl).get_model(use_conv=True),
    "mnist_mlp": lambda fl: _mnist(fl).get_model(use_conv=False),
    "vgg16": lambda fl: _vgg(fl).get_model(data_shape=(3, 32, 32),
                                           class_dim=10, is_test=True),
    "vgg16_train": lambda fl: _vgg(fl).get_model(),
    "vgg16_f64": _vgg16_f64,
    "vgg_pieces": _vgg_pieces,
    "stacked_lstm": lambda fl: _stacked(fl).build(
        _stacked(fl).StackedLSTMConfig(**_SLSTM)),
    "seq2seq": lambda fl: _seq2seq(fl).build(
        _seq2seq(fl).Seq2SeqConfig(**_S2S)),
}


def _adam(lr):
    return lambda fluid: fluid.optimizer.Adam(lr)


def _feeds(name, steps=3):
    r = np.random.RandomState(0)
    if name.startswith("mnist"):
        return [{"pixel": r.rand(4, 784).astype(np.float32),
                 "label": r.randint(0, 10, (4, 1))} for _ in range(steps)]
    if name.startswith("vgg"):
        side = 16 if name == "vgg_pieces" else 32
        dtype = np.float64 if name.endswith("f64") else np.float32
        return [{"data": r.randn(2, 3, side, side).astype(dtype),
                 "label": r.randint(0, 10, (2, 1))} for _ in range(steps)]
    if name == "stacked_lstm":
        cfg = pstacked.StackedLSTMConfig(**_SLSTM)
        return [pstacked.make_batch(cfg, 4, seed=s) for s in range(steps)]
    cfg = pseq2seq.Seq2SeqConfig(**_S2S)
    return [pseq2seq.make_batch(cfg, 3, 7, 5, seed=s) for s in range(steps)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_programs_match(name):
    (jops, tops), (jp, tp) = same_programs(MODELS[name], _adam(1e-3))
    assert tops == jops and tp == jp
    want = {"stacked_lstm": ["lstm", "sequence_pool", "lstm_grad"],
            "seq2seq": ["lstm", "matmul", "tanh", "lstm_grad"],
            "vgg16_train": ["dropout", "conv2d", "pool2d"],
            "mnist_conv": ["conv2d", "pool2d"]}.get(name, [])
    assert all(op in tops for op in want), (name, want)
    if name.startswith("vgg16"):
        assert tops.count("conv2d") == 13 and tops.count("mul") == 3


def _all_grads(name):
    _, (_, tp) = same_programs(MODELS[name], _adam(1e-3))
    return sorted(n + "@GRAD" for n in tp)


@pytest.mark.parametrize("name,lr", [
    ("mnist_conv", 1e-3), ("mnist_mlp", 1e-3), ("vgg_pieces", 1e-3),
    ("vgg16_f64", 1e-3), ("stacked_lstm", 1e-3), ("seq2seq", 1e-3)])
def test_three_adam_steps_match_jax(name, lr):
    grads = _all_grads(name)
    j, t, jf, tf, _ = train_both(MODELS[name], _adam(lr), _feeds(name),
                                 lambda m: [m["loss"]] + grads)
    for step, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b[0], a[0], rtol=TOL_LOSS, err_msg=step)
        for n, ga, gb in zip(grads, a[1:], b[1:]):
            assert gb.shape == ga.shape, n
            assert rel(gb, ga) <= TOL_REL, (step, n, rel(gb, ga))
    assert sorted(tf) == sorted(jf)
    for n, v in jf.items():
        if np.issubdtype(np.asarray(v).dtype, np.floating):
            assert rel(tf[n], v) <= TOL_REL, (n, rel(tf[n], v))


def test_vgg16_forward_and_head_match_jax():
    """VGG-16 at 32 x 32 (fc 512) in f32, three Adam steps at 1e-5: each
    step's loss and logits, and the classifier's gradient (the f64 net is
    held in full by ``test_three_adam_steps_match_jax``)."""
    head = "fc_2.w_0@GRAD"
    j, t, _, _, _ = train_both(MODELS["vgg16"], _adam(1e-5), _feeds("vgg16"),
                               lambda m: [m["loss"], m["logits"], head])
    for step, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b[0], a[0], rtol=TOL_LOSS, err_msg=step)
        assert rel(b[1], a[1]) <= TOL_LOSS, (step, rel(b[1], a[1]))
        assert rel(b[2], a[2]) <= TOL_REL, (step, rel(b[2], a[2]))


# --- the book chapters (tests/test_book.py) --------------------------------


def _sentiment(fluid):
    L = fluid.layers
    words = L.data("words", shape=[64], dtype="int64")
    label = L.data("label", shape=[1], dtype="int64")
    emb = L.embedding(words, size=[5148, 32])
    h = L.fc(L.sequence_pool(emb, "average"), 32, act="relu",
             num_flatten_dims=1)
    logits = L.fc(h, 2, num_flatten_dims=1)
    return {"loss": L.mean(L.softmax_with_cross_entropy(logits, label))}


def _sentiment_feeds():
    from paddle_tpu import dataset

    ids, labels = [], []
    for w, lbl in dataset.imdb.train()():
        ids.append(w[:64])
        labels.append(lbl)
        if len(ids) == 3 * 16:
            break
    words = np.zeros((len(ids), 64), np.int64)
    for i, w in enumerate(ids):
        words[i, :len(w)] = w
    lab = np.asarray(labels, np.int64)[:, None]
    return [{"words": words[i:i + 16], "label": lab[i:i + 16]}
            for i in range(0, len(ids), 16)]


def _word2vec(fluid):
    L = fluid.layers
    ctx = L.data("ctx", shape=[4], dtype="int64")
    nxt = L.data("next", shape=[1], dtype="int64")
    embs = L.embedding(ctx, size=[128, 16],
                       param_attr=fluid.ParamAttr(name="shared_emb.w"))
    h = L.fc(L.reshape(embs, [0, 64]), 64, act="relu", num_flatten_dims=1)
    logits = L.fc(h, 128, num_flatten_dims=1)
    return {"loss": L.mean(L.softmax_with_cross_entropy(logits, nxt))}


def _word2vec_feeds():
    r = np.random.RandomState(5)
    trans = r.permutation(128)
    corpus = [0]
    for _ in range(200):
        corpus.append(int(trans[corpus[-1]] if r.rand() < 0.8
                          else r.randint(128)))
    corpus = np.asarray(corpus, np.int64)
    return [{"ctx": np.stack([corpus[i + k:i + k + 4] for k in range(32)]),
             "next": corpus[i + 4:i + 36][:, None]} for i in (0, 32, 64)]


def _recommender(fluid):
    L = fluid.layers
    uid = L.data("uid", shape=[1], dtype="int64")
    iid = L.data("iid", shape=[1], dtype="int64")
    rating = L.data("rating", shape=[1], dtype="float32")
    ue = L.reshape(L.embedding(uid, size=[64, 16]), [0, 16])
    ie = L.reshape(L.embedding(iid, size=[96, 16]), [0, 16])
    pred = L.reduce_sum(L.elementwise_mul(L.fc(ue, 16, num_flatten_dims=1),
                                          L.fc(ie, 16, num_flatten_dims=1)),
                        dim=1, keep_dim=True)
    return {"loss": L.reduce_mean(L.square_error_cost(pred, rating))}


def _recommender_feeds():
    r = np.random.RandomState(7)
    u_lat, i_lat = r.normal(0, 1, (64, 8)), r.normal(0, 1, (96, 8))
    out = []
    for _ in range(3):
        us = r.randint(0, 64, (64, 1)).astype(np.int64)
        its = r.randint(0, 96, (64, 1)).astype(np.int64)
        ratings = np.sum(u_lat[us[:, 0]] * i_lat[its[:, 0]], axis=1,
                         keepdims=True).astype(np.float32)
        out.append({"uid": us, "iid": its, "rating": ratings})
    return out


_BOOK_S2S = dict(src_vocab_size=200, trg_vocab_size=200, hidden_dim=64,
                 embed_dim=32)
_BOOK_SLSTM = dict(vocab_size=512, embed_dim=32, hidden_dim=32,
                   stacked_num=2, max_len=48)

CHAPTERS = {
    "understand_sentiment": (_sentiment, 5e-3, _sentiment_feeds),
    "word2vec": (_word2vec, 5e-3, _word2vec_feeds),
    "recommender_system": (_recommender, 1e-2, _recommender_feeds),
    "machine_translation": (
        lambda fl: _seq2seq(fl).build(_seq2seq(fl).Seq2SeqConfig(**_BOOK_S2S)),
        5e-3, lambda: [pseq2seq.make_batch(
            pseq2seq.Seq2SeqConfig(**_BOOK_S2S), 16, 12, 12, seed=s)
            for s in range(3)]),
    "stacked_dynamic_lstm": (
        lambda fl: _stacked(fl).build(
            _stacked(fl).StackedLSTMConfig(**_BOOK_SLSTM)),
        5e-3, lambda: [pstacked.make_batch(
            pstacked.StackedLSTMConfig(**_BOOK_SLSTM), 32, seed=s)
            for s in range(3)]),
}


@pytest.mark.parametrize("chapter", sorted(CHAPTERS))
def test_book_chapter_trains_as_jax(chapter):
    """Each chapter's program, optimizer and batch shapes, three Adam
    steps: losses and the final state."""
    build, lr, feeds = CHAPTERS[chapter]
    (jops, tops), (jp, tp) = same_programs(build, _adam(lr))
    assert tops == jops and tp == jp
    j, t, jf, tf, _ = train_both(build, _adam(lr), feeds(),
                                 lambda m: [m["loss"]])
    for step, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b[0], a[0], rtol=TOL_LOSS, err_msg=step)
    for n, v in jf.items():
        if np.issubdtype(np.asarray(v).dtype, np.floating):
            assert rel(tf[n], v) <= TOL_REL, (n, rel(tf[n], v))
