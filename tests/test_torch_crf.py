"""The port's structured-prediction, metric and tail ops and their layers
against the JAX package's on the CPU: ``linear_chain_crf``,
``crf_decoding``, ``warpctc``, ``edit_distance``, ``ctc_align``
(ops/crf_ops.py), ``chunk_eval``, ``precision_recall``,
``positive_negative_pair`` (ops/metric_ops.py), ``hash`` and
``tree_conv`` (ops/misc_ops.py).

Each op case runs both packages' compute on the same numpy inputs (from
a seed) and, for a differentiable op, both packages' derived grad op on
the same cotangents, one for every float output
(``torch_model_parity.run_both``): forward outputs within 1e-5 and
gradients within 1e-4 of the largest |element| of the JAX value,
integer and bool outputs exactly. The cases cover lengths ([B] and
[B, 1], a row of length 1 and one of full length), ``norm_by_times``, an
empty label row, ``blank`` other than 0, ``normalized``, the IOB and
plain schemes with excluded types, weights and accumulated states. The
losses are also held to brute-force enumeration in f64 (1e-9), and
``hash`` to a pure-Python XXH64 and to the JAX op bit for bit. The
layers build the JAX package's programs and train to its losses."""

import itertools

import numpy as np
import pytest
import torch
from torch_model_parity import assert_match, run_both, train_both

from paddle_tpu.core.registry import get_op_def as jax_op_def

from paddle_tpu_torch.core.registry import get_op_def

TOL_FWD, TOL_GRAD = 1e-5, 1e-4

CRF_OP_TYPES = ["crf_decoding", "ctc_align", "edit_distance",
                "linear_chain_crf", "warpctc"]
METRIC_OP_TYPES = ["chunk_eval", "positive_negative_pair",
                   "precision_recall"]

RS = np.random.RandomState


def _lens(*v, col=False):
    a = np.array(v, np.int64)
    return a[:, None] if col else a


def _crf(seed, b=3, t=5, c=4, dtype=np.float32):
    r = RS(seed)
    return {"Emission": [r.randn(b, t, c).astype(dtype)],
            "Transition": [(r.randn(c + 2, c) * 0.5).astype(dtype)]}


def _ctc_logits(seed, b=3, t=6, c=5):
    return RS(seed).randn(b, t, c).astype(np.float32)


CASES = {
    "linear_chain_crf": ("linear_chain_crf", dict(
        _crf(0), Label=[RS(1).randint(0, 4, (3, 5)).astype(np.int64)]), {}),
    "linear_chain_crf lengths": ("linear_chain_crf", dict(
        _crf(2), Label=[RS(3).randint(0, 4, (3, 5)).astype(np.int64)],
        Length=[_lens(5, 1, 3)]), {}),
    "linear_chain_crf lengths [B, 1], label [B, T, 1]": (
        "linear_chain_crf", dict(
            _crf(4), Label=[RS(5).randint(0, 4, (3, 5, 1)).astype(np.int64)],
            Length=[_lens(2, 5, 4, col=True)]), {}),
    "crf_decoding": ("crf_decoding", _crf(6), {}),
    "crf_decoding lengths": ("crf_decoding", dict(_crf(7),
                                                  Length=[_lens(2, 5, 1)]),
                             {}),
    "warpctc": ("warpctc", {"Logits": [_ctc_logits(8)], "Label": [
        np.array([[1, 2, 2], [3, 0, 0], [4, 1, 0]], np.int64)]}, {}),
    "warpctc lengths norm_by_times": ("warpctc", {
        "Logits": [_ctc_logits(9)],
        "Label": [np.array([[1, 2, 0], [3, 3, 0], [0, 0, 0]], np.int64)],
        "LogitsLength": [_lens(6, 4, 3)],
        "LabelLength": [_lens(2, 2, 0)]}, {"norm_by_times": True}),
    "warpctc blank 4": ("warpctc", {
        "Logits": [_ctc_logits(10)],
        "Label": [np.array([[1, 0, 0], [2, 3, 3], [1, 1, 1]], np.int64)],
        "LabelLength": [_lens(2, 3, 1, col=True)]}, {"blank": 4}),
    "edit_distance": ("edit_distance", {
        "Hyps": [RS(11).randint(0, 5, (4, 6)).astype(np.int64)],
        "Refs": [RS(12).randint(0, 5, (4, 7)).astype(np.int64)]},
        {"normalized": False}),
    "edit_distance lengths normalized": ("edit_distance", {
        "Hyps": [RS(13).randint(0, 4, (4, 6)).astype(np.int64)],
        "Refs": [RS(14).randint(0, 4, (4, 5)).astype(np.int64)],
        "HypsLength": [_lens(6, 0, 3, 2)],
        "RefsLength": [_lens(5, 2, 0, 5)]}, {"normalized": True}),
    "ctc_align": ("ctc_align", {"Input": [np.array(
        [[0, 1, 1, 0, 2, 2, 3], [0, 0, 0, 0, 0, 0, 0],
         [5, 5, 0, 5, 1, 1, 1]], np.int64)]}, {}),
    "ctc_align lengths, no merge, padding": ("ctc_align", {
        "Input": [np.array([[2, 2, 0, 3, 3], [1, 0, 1, 1, 4]], np.int64)],
        "InputLength": [_lens(4, 2, col=True)]},
        {"merge_repeated": False, "padding_value": -7, "blank": 0}),
    "chunk_eval IOB": ("chunk_eval", {
        "Inference": [RS(15).randint(0, 7, (4, 9)).astype(np.int64)],
        "Label": [RS(16).randint(0, 7, (4, 9)).astype(np.int64)]},
        {"num_chunk_types": 3, "chunk_scheme": "IOB"}),
    "chunk_eval IOB lengths, excluded, perfect rows": ("chunk_eval", {
        "Inference": [np.array([[0, 1, 6, 2, 3, 3], [4, 5, 5, 0, 1, 6]],
                               np.int64)],
        "Label": [np.array([[0, 1, 6, 2, 3, 1], [4, 5, 5, 0, 6, 6]],
                           np.int64)],
        "SeqLength": [_lens(5, 6)]},
        {"num_chunk_types": 3, "chunk_scheme": "IOB",
         "excluded_chunk_types": [2]}),
    "chunk_eval plain": ("chunk_eval", {
        "Inference": [RS(17).randint(0, 4, (3, 8)).astype(np.int64)],
        "Label": [RS(18).randint(0, 4, (3, 8)).astype(np.int64)],
        "SeqLength": [_lens(8, 5, 1, col=True)]},
        {"num_chunk_types": 3, "chunk_scheme": "plain"}),
    "precision_recall": ("precision_recall", {
        "MaxProbs": [RS(19).rand(10, 1).astype(np.float32)],
        "Indices": [RS(20).randint(0, 4, (10, 1)).astype(np.int64)],
        "Labels": [RS(21).randint(0, 4, (10, 1)).astype(np.int64)]},
        {"class_number": 4}),
    "precision_recall weights, states": ("precision_recall", {
        "MaxProbs": [RS(22).rand(8, 1).astype(np.float32)],
        "Indices": [RS(23).randint(0, 3, (8, 1)).astype(np.int64)],
        "Labels": [RS(24).randint(0, 3, (8, 1)).astype(np.int64)],
        "Weights": [RS(25).rand(8, 1).astype(np.float32)],
        "StatesInfo": [RS(26).randint(0, 5, (3, 4)).astype(np.float32)]},
        {"class_number": 3}),
    "positive_negative_pair": ("positive_negative_pair", {
        "Score": [np.array([[.5], [.2], [.9], [.2], [.7], [.1]],
                           np.float32)],
        "Label": [np.array([[1], [0], [2], [1], [0], [1]], np.float32)],
        "QueryID": [np.array([[0], [0], [0], [1], [1], [1]], np.int64)]},
        {}),
    "positive_negative_pair accumulated": ("positive_negative_pair", {
        "Score": [RS(27).rand(7, 1).astype(np.float32)],
        "Label": [RS(28).randint(0, 3, (7, 1)).astype(np.float32)],
        "QueryID": [RS(29).randint(0, 2, (7, 1)).astype(np.int64)],
        "AccumulatePositivePair": [np.array([2.0], np.float32)],
        "AccumulateNegativePair": [np.array([1.0], np.float32)],
        "AccumulateNeutralPair": [np.array([0.5], np.float32)]}, {}),
    "tree_conv": ("tree_conv", {
        "NodesVector": [RS(30).randn(2, 6, 4).astype(np.float32)],
        "EdgeSet": [np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [0, 0]],
                              [[1, 2], [2, 3], [0, 0], [3, 4], [1, 5]]],
                             np.int64)],
        "Filter": [RS(31).randn(4, 3, 3, 2).astype(np.float32)]},
        {"max_depth": 3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    op_type, ins, attrs = CASES[case]
    jo, to, jg, tg = run_both(op_type, ins, attrs)
    assert_match(jo, to, jg, tg, TOL_FWD, TOL_GRAD)
    if jg is not None:
        want = {"GRAD::" + s for s in ins
                if s in get_op_def(op_type).diff_inputs}
        assert set(tg) == want, (sorted(tg), sorted(want))


# --- the losses against enumeration (f64) ------------------------------------


def _crf_enumerated(em, trans, label, lengths):
    start, end, pair = trans[0], trans[1], trans[2:]
    b, t, c = em.shape

    def score(row, tags):
        n = lengths[row]
        s = start[tags[0]] + end[tags[n - 1]]
        s += sum(em[row, i, tags[i]] for i in range(n))
        return s + sum(pair[tags[i], tags[i + 1]] for i in range(n - 1))

    out = []
    for row in range(b):
        paths = [score(row, p) for p in itertools.product(
            range(c), repeat=int(lengths[row]))]
        m = max(paths)
        log_z = m + np.log(np.sum(np.exp(np.asarray(paths) - m)))
        out.append(log_z - score(row, list(label[row])))
    best = [max(itertools.product(range(c), repeat=int(lengths[row])),
                key=lambda p: score(row, p)) for row in range(b)]
    return np.array(out)[:, None], best


def _ctc_enumerated(logp, label, blank):
    t, c = logp.shape

    def collapse(path):
        out, prev = [], None
        for p in path:
            if p != prev and p != blank:
                out.append(p)
            prev = p
        return tuple(out)

    total = sum(np.exp(sum(logp[i, p] for i, p in enumerate(path)))
                for path in itertools.product(range(c), repeat=t)
                if collapse(path) == tuple(label))
    return -np.log(total)


def _compute(op_type, ins, attrs=None):
    outs = get_op_def(op_type).compute(
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in ins.items()}, dict(attrs or {}), torch.device("cpu"))
    return {k: v[0].numpy() for k, v in outs.items()}


def test_crf_losses_and_paths_match_enumeration():
    em = RS(40).randn(3, 4, 3)
    trans = RS(41).randn(5, 3) * 0.5
    label = RS(42).randint(0, 3, (3, 4)).astype(np.int64)
    lengths = _lens(4, 3, 2)
    want, best = _crf_enumerated(em, trans, label, lengths)
    got = _compute("linear_chain_crf", {
        "Emission": [em], "Transition": [trans], "Label": [label],
        "Length": [lengths]})["LogLikelihood"]
    np.testing.assert_allclose(got, want, atol=1e-9)
    path = _compute("crf_decoding", {"Emission": [em], "Transition": [trans],
                                     "Length": [lengths]})["ViterbiPath"]
    for row in range(3):
        n = int(lengths[row])
        assert tuple(path[row, :n]) == best[row]
        assert not path[row, n:].any()


def test_warpctc_matches_enumeration():
    logits = RS(43).randn(2, 4, 3)
    label = np.array([[1, 2], [2, 2]], np.int64)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    want = np.array([_ctc_enumerated(logp[i], label[i], 0)
                     for i in range(2)])[:, None]
    got = _compute("warpctc", {"Logits": [logits], "Label": [label]})["Loss"]
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_edit_distance_matches_a_plain_levenshtein():
    r = RS(44)
    hyp, ref = (r.randint(0, 3, (6, 8)) for _ in range(2))
    hl, rl = r.randint(0, 9, 6), r.randint(0, 9, 6)

    def lev(a, b):
        d = np.arange(len(b) + 1, dtype=float)
        for i, x in enumerate(a):
            prev, d[0] = d.copy(), i + 1
            for j, y in enumerate(b):
                d[j + 1] = min(prev[j + 1] + 1, d[j] + 1, prev[j] + (x != y))
        return d[-1]

    got = _compute("edit_distance", {"Hyps": [hyp], "Refs": [ref],
                                     "HypsLength": [hl], "RefsLength": [rl]},
                   {"normalized": False})["Out"][:, 0]
    np.testing.assert_array_equal(
        got, [lev(hyp[i, :hl[i]], ref[i, :rl[i]]) for i in range(6)])


# --- hash --------------------------------------------------------------------


def _py_xxh64(data: bytes, seed: int) -> int:
    """XXH64 from the public spec (Yann Collet) for whole 4-byte words:
    the oracle of the reference's bucket values."""
    m = (1 << 64) - 1
    p1, p2, p3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    p4, p5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return (rotl((acc + lane * p2) & m, 31) * p1) & m

    n, i = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & m, (seed + p2) & m, seed & m,
             (seed - p1) & m]
        while i + 32 <= n:
            for k in range(4):
                v[k] = rnd(v[k], int.from_bytes(data[i:i + 8], "little"))
                i += 8
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & m
        for k in range(4):
            h = ((h ^ rnd(0, v[k])) * p1 + p4) & m
    else:
        h = (seed + p5) & m
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27)
             * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        w = int.from_bytes(data[i:i + 4], "little")
        h = (rotl(h ^ (w * p1) & m, 23) * p2 + p3) & m
    h ^= h >> 33
    h = (h * p2) & m
    h ^= h >> 29
    h = (h * p3) & m
    return h ^ (h >> 32)


@pytest.mark.parametrize("d", [1, 2, 3, 8, 9, 11, 17])
def test_hash_is_xxh64_bit_for_bit(d):
    """int64 rows (the reference's 4 bytes an element: the first 4 d bytes
    of the row; negative ids too) and int32 rows, three seeds: the JAX
    op's buckets (x64) and the spec's."""
    r = RS(45 + d)
    x = r.randint(-2 ** 40, 2 ** 40, (5, d)).astype(np.int64)
    xi = r.randint(-2 ** 31, 2 ** 31 - 1, (4, d)).astype(np.int32)
    for arr, mod in ((x, 100000), (xi, 997)):
        attrs = {"num_hash": 3, "mod_by": mod}
        jo, to, _, _ = run_both("hash", {"X": [arr]}, attrs)
        np.testing.assert_array_equal(to["Out"][0], jo["Out"][0])
        assert to["Out"][0].dtype == arr.dtype
        for row in range(arr.shape[0]):
            data = arr[row].tobytes()[:4 * d]
            for s in range(3):
                assert to["Out"][0][row, s, 0] == _py_xxh64(data, s) % mod


# --- layers ------------------------------------------------------------------

B, T, C = 4, 6, 5


def _crf_model(fluid):
    L = fluid.layers
    x = L.data("x", shape=[T, 8], dtype="float32")
    label = L.data("label", shape=[T], dtype="int64")
    length = L.data("length", shape=[1], dtype="int64")
    em = L.fc(x, C, num_flatten_dims=2)
    cost = L.linear_chain_crf(em, label,
                              param_attr=fluid.ParamAttr(name="crfw"),
                              length=length)
    decode = L.crf_decoding(em, param_attr=fluid.ParamAttr(name="crfw"),
                            length=length)
    correct = L.crf_decoding(em, param_attr=fluid.ParamAttr(name="crfw"),
                             label=label, length=length)
    p, rc, f1, ni, nl, nc = L.chunk_eval(decode, label, "IOB", 2,
                                         seq_length=length)
    return {"loss": L.mean(cost), "decode": decode, "correct": correct,
            "f1": f1, "nc": nc}


def _crf_feeds(n):
    out = []
    for s in range(n):
        r = RS(50 + s)
        out.append({"x": r.randn(B, T, 8).astype(np.float32),
                    "label": r.randint(0, C, (B, T)).astype(np.int64),
                    "length": r.randint(1, T + 1, (B, 1)).astype(np.int64)})
    return out


def test_crf_layers_train_as_jax():
    """linear_chain_crf, crf_decoding (paths and the label mask) and
    chunk_eval on a shared transition parameter: three Adam steps equal
    the JAX package's."""
    j, t, jf, tf, _ = train_both(
        _crf_model, lambda fluid: fluid.optimizer.Adam(0.05),
        _crf_feeds(3), lambda m: [m["loss"], m["decode"], m["correct"],
                                  m["f1"], m["nc"], "crfw@GRAD"])
    for sj, st in zip(j, t):
        for a, b in zip(sj, st):
            a, b = np.asarray(a), np.asarray(b)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, atol=TOL_GRAD * max(
                    1.0, np.abs(a).max()))
            else:
                np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(tf["crfw"], jf["crfw"], atol=1e-5)


def _ctc_model(fluid):
    L = fluid.layers
    x = L.data("x", shape=[T, 8], dtype="float32")
    label = L.data("label", shape=[3], dtype="int64")
    xl = L.data("xl", shape=[1], dtype="int64")
    ll = L.data("ll", shape=[1], dtype="int64")
    logits = L.fc(x, C, num_flatten_dims=2)
    loss = L.warpctc(logits, label, blank=0, norm_by_times=True,
                     input_length=xl, label_length=ll)
    decoded, dlen = L.ctc_greedy_decoder(L.softmax(logits), blank=0,
                                         input_length=xl)
    dist, num = L.edit_distance(decoded, label, normalized=True,
                                input_length=dlen, label_length=ll)
    return {"loss": L.mean(loss), "decoded": decoded, "dlen": dlen,
            "dist": dist, "num": num}


def test_ctc_layers_train_as_jax():
    feeds = []
    for s in range(3):
        r = RS(60 + s)
        feeds.append({"x": r.randn(B, T, 8).astype(np.float32),
                      "label": r.randint(1, C, (B, 3)).astype(np.int64),
                      "xl": r.randint(3, T + 1, (B, 1)).astype(np.int64),
                      "ll": r.randint(0, 4, (B, 1)).astype(np.int64)})
    j, t, _, _, _ = train_both(
        _ctc_model, lambda fluid: fluid.optimizer.SGD(0.5), feeds,
        lambda m: [m["loss"], m["decoded"], m["dlen"], m["dist"], m["num"],
                   "fc_0.w_0@GRAD"])
    for sj, st in zip(j, t):
        for a, b in zip(sj, st):
            a, b = np.asarray(a), np.asarray(b)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, atol=TOL_GRAD * max(
                    1.0, np.abs(a).max()))
            else:
                np.testing.assert_array_equal(b, a)


def _tree_hash_model(fluid):
    L = fluid.layers
    nodes = L.data("nodes", shape=[6, 4], dtype="float32")
    edges = L.data("edges", shape=[5, 2], dtype="int64")
    ids = L.data("ids", shape=[3], dtype="int64")
    out = L.tree_conv(nodes, edges, 3, num_filters=2, max_depth=2)
    h = L.hash(ids, hash_size=50, num_hash=2)
    emb = L.embedding(L.reshape(h, [-1, 2]), [50, 6])
    return {"loss": L.elementwise_add(L.mean(out), L.mean(emb)), "h": h}


def test_tree_conv_and_hash_layers_train_as_jax():
    feeds = [{"nodes": RS(70 + s).randn(2, 6, 4).astype(np.float32),
              "edges": np.array([[[1, 2], [1, 3], [2, 4], [0, 0], [0, 0]],
                                 [[1, 2], [2, 3], [3, 4], [3, 5], [1, 6]]],
                                np.int64),
              "ids": RS(80 + s).randint(0, 10 ** 6, (2, 3)).astype(np.int64)}
             for s in range(2)]
    j, t, _, _, _ = train_both(
        _tree_hash_model, lambda fluid: fluid.optimizer.SGD(0.1), feeds,
        lambda m: [m["loss"], m["h"], "tree_conv_0.w_0@GRAD"])
    for sj, st in zip(j, t):
        np.testing.assert_allclose(st[0], sj[0], rtol=TOL_FWD)
        np.testing.assert_array_equal(st[1], sj[1])
        np.testing.assert_allclose(st[2], sj[2],
                                   atol=TOL_GRAD * np.abs(sj[2]).max())


@pytest.mark.parametrize("op_type", CRF_OP_TYPES + METRIC_OP_TYPES)
def test_registries_agree(op_type):
    j, t = jax_op_def(op_type), get_op_def(op_type)
    assert (t.diff_inputs, t.no_grad, t.needs_rng) == (
        j.diff_inputs, j.no_grad, j.needs_rng)
    assert (t.grad_maker is None) == (j.grad_maker is None)
    assert not (t.host_rng or t.host_loop or t.host_callback
                or t.sub_blocks)
