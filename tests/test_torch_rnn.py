"""The recurrent ops (``lstm``, ``gru``, ``gru_unit``, ``lstm_unit``,
``lstmp``) and layers (``dynamic_lstm``, ``dynamic_gru``,
``dynamic_lstmp``, ``lstm_unit``, ``gru_unit``) of the port against the
JAX package's, on the CPU.

Each op case runs both packages' compute on the same numpy inputs (f32,
from a seed) and both packages' derived grad op (``make_grad_compute``:
the port re-runs its loop under autograd, the JAX package takes
``jax.vjp`` of its ``lax.scan``) on the same cotangents, one for every
output. Forward outputs within 1e-5 and gradients within 1e-4 of the
largest |element| of the JAX value. The cases cover lengths ([B] and
[B, 1], rows of length 0 and T), ``is_reverse``, ``H0`` / ``C0``,
``forget_bias``, a missing bias and other activations. The traps the
padded layout sets (the state carried through padding, ``Cell``
repeating it, a reversed row's padded tail leaving ``H0`` untouched, the
caffe2 gate order of ``lstm_unit``) are held on their own too. The
layers build the JAX package's ops and parameters and train two SGD
steps to the JAX package's losses and gradients (1e-5 / 1e-4)."""

import numpy as np
import pytest
import torch
from torch_model_parity import (assert_match, rel, run_both,
                                same_programs, train_both)

from paddle_tpu.core.registry import get_op_def as jax_op_def

from paddle_tpu_torch.core.registry import get_op_def

TOL_FWD, TOL_GRAD = 1e-5, 1e-4  # also torch_model_parity.assert_match's
B, T, H = 3, 6, 4

# every op type this slice adds, with the test that holds its values
RNN_OP_TYPES = ["gru", "gru_unit", "lstm", "lstm_unit", "lstmp"]
SEQUENCE_OP_TYPES = [
    "add_position_encoding", "conv_shift", "im2sequence", "sequence_concat",
    "sequence_conv", "sequence_enumerate", "sequence_erase",
    "sequence_expand", "sequence_expand_as", "sequence_mask",
    "sequence_pad", "sequence_pool", "sequence_reshape", "sequence_reverse",
    "sequence_scatter", "sequence_slice", "sequence_softmax",
    "sequence_unpad"]
ACTIVATION_OP_TYPES = [
    "brelu", "ceil", "elu", "hard_shrink", "hard_sigmoid", "hard_swish",
    "leaky_relu", "logsigmoid", "reciprocal", "relu6", "round", "rsqrt",
    "selu", "silu", "sin", "soft_relu", "softplus", "softshrink",
    "softsign", "square", "stanh", "swish", "tanh", "tanh_shrink",
    "thresholded_relu"]
ZOO_OP_TYPES = ["flatten2", "matmul", "reduce_mean", "reduce_min",
                "reduce_prod", "square_error_cost"]
NEW_OP_TYPES = (RNN_OP_TYPES + SEQUENCE_OP_TYPES + ACTIVATION_OP_TYPES
                + ZOO_OP_TYPES)


def _f(r, *shape, scale=0.5):
    return (r.randn(*shape) * scale).astype(np.float32)


def _lens(*v, col=False):
    a = np.array(v, np.int64)
    return a[:, None] if col else a


def _lstm_case(seed, length=None, reverse=False, h0=False, bias=True,
               forget_bias=0.0, acts=("sigmoid", "tanh", "tanh")):
    r = np.random.RandomState(seed)
    ins = {"Input": [_f(r, B, T, 4 * H)], "Weight": [_f(r, H, 4 * H)]}
    if bias:
        ins["Bias"] = [_f(r, 4 * H)]
    if h0:
        ins["H0"] = [_f(r, B, H)]
        ins["C0"] = [_f(r, B, H)]
    if length is not None:
        ins["Length"] = [length]
    attrs = {"is_reverse": reverse, "gate_activation": acts[0],
             "cell_activation": acts[1], "candidate_activation": acts[2]}
    if forget_bias:
        attrs["forget_bias"] = forget_bias
    return ("lstm", ins, attrs)


def _gru_case(seed, length=None, reverse=False, h0=False, bias=True,
              acts=("sigmoid", "tanh")):
    r = np.random.RandomState(seed)
    ins = {"Input": [_f(r, B, T, 3 * H)], "Weight": [_f(r, H, 3 * H)]}
    if bias:
        ins["Bias"] = [_f(r, 3 * H)]
    if h0:
        ins["H0"] = [_f(r, B, H)]
    if length is not None:
        ins["Length"] = [length]
    return ("gru", ins, {"is_reverse": reverse, "gate_activation": acts[0],
                         "activation": acts[1]})


def _gru_unit_case(seed, bias=True, acts=("sigmoid", "tanh")):
    r = np.random.RandomState(seed)
    ins = {"Input": [_f(r, B, 3 * H)], "HiddenPrev": [_f(r, B, H)],
           "Weight": [_f(r, H, 3 * H)]}
    if bias:
        ins["Bias"] = [_f(r, 3 * H)]
    return ("gru_unit", ins, {"gate_activation": acts[0],
                              "activation": acts[1]})


def _lstm_unit_case(seed, forget_bias=0.0):
    r = np.random.RandomState(seed)
    return ("lstm_unit", {"X": [_f(r, B, 4 * H, scale=1.0)],
                          "C_prev": [_f(r, B, H)]},
            {"forget_bias": forget_bias})


def _lstmp_case(seed, reverse=False, bias_shape=(4 * H,), p=3,
                acts=("sigmoid", "tanh", "tanh", "tanh")):
    r = np.random.RandomState(seed)
    ins = {"Input": [_f(r, B, T, 4 * H)], "Weight": [_f(r, p, 4 * H)],
           "ProjWeight": [_f(r, H, p)]}
    if bias_shape is not None:
        ins["Bias"] = [_f(r, *bias_shape)]
    return ("lstmp", ins, {"is_reverse": reverse,
                           "gate_activation": acts[0],
                           "cell_activation": acts[1],
                           "candidate_activation": acts[2],
                           "proj_activation": acts[3]})


CASES = {
    "lstm": _lstm_case(0),
    "lstm_no_bias": _lstm_case(1, bias=False),
    "lstm_len": _lstm_case(2, _lens(6, 3, 0)),
    "lstm_len_col_reverse": _lstm_case(3, _lens(2, 6, 4, col=True), True),
    "lstm_h0_len_reverse": _lstm_case(4, _lens(0, 5, 6), True, h0=True),
    "lstm_h0_len": _lstm_case(5, _lens(4, 0, 6), h0=True),
    "lstm_forget_bias": _lstm_case(6, _lens(6, 2, 5), forget_bias=1.0),
    "lstm_acts": _lstm_case(7, _lens(3, 6, 1), h0=True,
                            acts=("sigmoid", "relu", "identity")),
    "gru": _gru_case(10),
    "gru_no_bias_h0": _gru_case(11, bias=False, h0=True),
    "gru_len": _gru_case(12, _lens(6, 0, 2)),
    "gru_len_col_reverse_h0": _gru_case(13, _lens(1, 6, 4, col=True), True,
                                        h0=True),
    "gru_acts": _gru_case(14, _lens(5, 6, 3), acts=("sigmoid", "relu")),
    "gru_unit": _gru_unit_case(20),
    "gru_unit_no_bias_acts": _gru_unit_case(21, False, ("sigmoid", "relu")),
    "lstm_unit": _lstm_unit_case(30),
    "lstm_unit_forget_bias": _lstm_unit_case(31, 1.0),
    "lstmp": _lstmp_case(40),
    "lstmp_reverse_no_bias": _lstmp_case(41, True, None),
    # the reference's peephole-sized bias [1, 7D]: the op reads its first 4D
    "lstmp_bias_7d_acts": _lstmp_case(42, bias_shape=(1, 7 * H),
                                      acts=("sigmoid", "tanh", "relu",
                                            "identity")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rnn_op_matches_jax(case):
    jo, to, jg, tg = run_both(*CASES[case])
    assert_match(jo, to, jg, tg)
    # every differentiable input present gets its gradient
    op_type, ins, _ = CASES[case]
    want = {"GRAD::" + s for s in ins
            if s in get_op_def(op_type).diff_inputs}
    assert set(tg) == want, (sorted(tg), sorted(want))


@pytest.mark.parametrize("op_type", NEW_OP_TYPES)
def test_registries_agree(op_type):
    j, t = jax_op_def(op_type), get_op_def(op_type)
    assert (t.diff_inputs, t.no_grad, t.needs_rng) == (
        j.diff_inputs, j.no_grad, j.needs_rng)
    assert (t.grad_maker is None) == (j.grad_maker is None)
    assert not (t.host_rng or t.host_loop)


def _outs(case):
    op_type, ins, attrs = case
    outs = get_op_def(op_type).compute(
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in ins.items()}, dict(attrs), torch.device("cpu"))
    return {k: v[0] for k, v in outs.items()}


def test_lstm_padding_carries_the_state():
    """At and past a row's length Hidden is zero, Cell repeats the last
    live cell, and LastH / LastC are the state after the last live step;
    a row of length 0 keeps H0 / C0."""
    case = _lstm_case(50, _lens(4, 0, 6), h0=True)
    o = _outs(case)
    h0, c0 = (torch.from_numpy(case[1][s][0]) for s in ("H0", "C0"))
    assert torch.equal(o["Hidden"][0, 4:], torch.zeros(2, H))
    assert torch.equal(o["Cell"][0, 4:], o["Cell"][0, 3:4].expand(2, H))
    assert torch.equal(o["LastH"][0], o["Hidden"][0, 3])
    assert torch.equal(o["LastC"][0], o["Cell"][0, 3])
    assert torch.equal(o["Hidden"][1], torch.zeros(T, H))
    assert torch.equal(o["Cell"][1], c0[1].expand(T, H))
    assert torch.equal(o["LastH"][1], h0[1]) and \
        torch.equal(o["LastC"][1], c0[1])
    assert torch.equal(o["LastH"][2], o["Hidden"][2, -1])


def test_reverse_meets_the_padded_tail_first():
    """is_reverse walks T - 1 ... 0: a row's padded tail comes first and
    leaves H0 untouched, so its last live step (t = len - 1) starts from
    H0, and the outputs stay in time order (LastH is step 0's)."""
    fwd = _lstm_case(51, _lens(3, 6, 5), h0=True)
    rev = _lstm_case(51, _lens(3, 6, 5), reverse=True, h0=True)
    o_rev = _outs(rev)
    for b, n in enumerate((3, 6, 5)):
        assert torch.equal(o_rev["Hidden"][b, n:], torch.zeros(T - n, H))
        assert torch.equal(o_rev["LastH"][b], o_rev["Hidden"][b, 0])
    # row 0 reversed over its live prefix = the forward op over that
    # prefix reversed in time
    ins = {k: [np.array(v[0])] for k, v in fwd[1].items()}
    ins["Input"] = [np.ascontiguousarray(ins["Input"][0][:, :3][:, ::-1])]
    ins["Length"] = [_lens(3, 3, 3)]
    o_fwd = _outs(("lstm", ins, fwd[2]))
    np.testing.assert_allclose(o_rev["Hidden"][0, :3].numpy(),
                               o_fwd["Hidden"][0].numpy()[::-1], rtol=0,
                               atol=1e-6)


def test_lstm_unit_gate_order_is_i_f_o_g():
    """lstm_unit's slot 2 is the output gate and slot 3 the tanh
    candidate (caffe2's order), where lstm's are c~ and o."""
    x = np.zeros((1, 4 * H), np.float32)
    x[0, 2 * H:3 * H] = 3.0  # o
    x[0, 3 * H:] = 0.5       # g
    c_prev = np.full((1, H), 0.25, np.float32)
    o = _outs(("lstm_unit", {"X": [x], "C_prev": [c_prev]}, {}))
    sig = 1 / (1 + np.exp(-np.float64([0.0, 3.0])))
    c = sig[0] * 0.25 + sig[0] * np.tanh(0.5)
    np.testing.assert_allclose(o["C"].numpy(), np.full((1, H), c), rtol=1e-6)
    np.testing.assert_allclose(o["H"].numpy(),
                               np.full((1, H), sig[1] * np.tanh(c)),
                               rtol=1e-6)


def test_gru_multiplies_the_reset_state_after_the_gate_product():
    """The candidate reads (r * h_prev) @ W[:, 2H:], not r * (h_prev @
    W[:, 2H:]): with a zero input and bias they differ, and the op gives
    the first."""
    r = np.random.RandomState(52)
    h0 = _f(r, 1, H, scale=1.0)
    w = _f(r, H, 3 * H, scale=1.0)
    ins = {"Input": [np.zeros((1, 1, 3 * H), np.float32)], "Weight": [w],
           "H0": [h0]}
    got = _outs(("gru", ins, {}))["LastH"].numpy().astype(np.float64)
    h, w = h0.astype(np.float64), w.astype(np.float64)
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    u, rr = np.split(sig(h @ w[:, :2 * H]), 2, axis=1)
    after = u * h + (1 - u) * np.tanh((rr * h) @ w[:, 2 * H:])
    before = u * h + (1 - u) * np.tanh(rr * (h @ w[:, 2 * H:]))
    np.testing.assert_allclose(got, after, rtol=1e-5)
    assert np.abs(after - before).max() > 1e-3


def test_shape_inference_walks_no_steps():
    """On meta tensors (a layer's shape inference) the ops give their
    outputs' shapes at the symbolic batch and time without a step."""
    meta = torch.device("meta")
    x = torch.empty(997, 997, 8, device=meta)
    w = torch.empty(2, 8, device=meta)
    outs = get_op_def("lstm").compute({"Input": [x], "Weight": [w]}, {},
                                      meta)
    assert {k: tuple(v[0].shape) for k, v in outs.items()} == {
        "Hidden": (997, 997, 2), "Cell": (997, 997, 2),
        "LastH": (997, 2), "LastC": (997, 2)}


# --- the layers -----------------------------------------------------------


def _rnn_net(kind):
    """A net over each recurrent layer: fc projections of a [B, T, 5]
    input, the layer (lengths, initial states), a masked pool, an fc
    head; the loss is the squared error against a target."""

    def build(fluid):
        L = fluid.layers
        x = L.data("x", shape=[T, 5], dtype="float32")
        n = L.data("n", shape=[], dtype="int64")
        h0 = L.data("h0", shape=[H], dtype="float32")
        c0 = L.data("c0", shape=[H], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        if kind == "lstm":
            proj = L.fc(x, 4 * H, num_flatten_dims=2)
            h, c = L.dynamic_lstm(proj, 4 * H, length=n, h_0=h0, c_0=c0)
            h2, _ = L.dynamic_lstm(L.fc(h, 4 * H, num_flatten_dims=2),
                                   4 * H, length=n, is_reverse=True)
            seq = L.elementwise_add(h2, c)
        elif kind == "gru":
            h = L.dynamic_gru(L.fc(x, 3 * H, num_flatten_dims=2), H,
                              length=n, h_0=h0)
            seq = L.dynamic_gru(L.fc(h, 3 * H, num_flatten_dims=2), H,
                                length=n, is_reverse=True,
                                candidate_activation="relu")
        else:
            seq, _ = L.dynamic_lstmp(L.fc(x, 4 * H, num_flatten_dims=2),
                                     4 * H, 3, name="lstmp")
        pooled = L.sequence_pool(seq, "max", length=n)
        pred = L.fc(pooled, 1)
        return {"loss": L.mean(L.square_error_cost(pred, y))}

    return build


def _rnn_feeds(seed):
    r = np.random.RandomState(seed)
    return {"x": _f(r, B, T, 5, scale=1.0), "n": _lens(6, 2, 4),
            "h0": _f(r, B, H), "c0": _f(r, B, H), "y": _f(r, B, 1)}


def _sgd(fluid):
    return fluid.optimizer.SGD(0.5)


@pytest.mark.parametrize("kind", ["lstm", "gru", "lstmp"])
def test_dynamic_layers_build_and_train_as_jax(kind):
    (jops, tops), (jp, tp) = same_programs(_rnn_net(kind), _sgd)
    assert tops == jops and tp == jp
    op = {"lstm": "lstm", "gru": "gru", "lstmp": "lstmp"}[kind]
    assert op + "_grad" in tops, tops
    feeds = [_rnn_feeds(s) for s in range(2)]
    grads = sorted(n + "@GRAD" for n in tp)
    j, t, jf, tf, _ = train_both(_rnn_net(kind), _sgd, feeds,
                                 lambda m: [m["loss"]] + grads)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b[0], a[0], rtol=TOL_FWD)
        for n, ga, gb in zip(grads, a[1:], b[1:]):
            assert rel(gb, ga) <= TOL_GRAD, (n, rel(gb, ga))
    for n in tp:
        assert rel(tf[n], jf[n]) <= TOL_GRAD, (n, rel(tf[n], jf[n]))


def _unit_net(kind):
    def build(fluid):
        L = fluid.layers
        x = L.data("x", shape=[5], dtype="float32")
        h0 = L.data("h0", shape=[H], dtype="float32")
        c0 = L.data("c0", shape=[H], dtype="float32")
        y = L.data("y", shape=[H], dtype="float32")
        if kind == "lstm_unit":
            h, c = L.lstm_unit(x, h0, c0, forget_bias=1.0)
            out = L.elementwise_add(h, c)
        else:
            out, reset, gate = L.gru_unit(L.fc(x, 3 * H), h0, 3 * H)
            out = L.elementwise_add(out, reset)
        return {"loss": L.mean(L.square_error_cost(out, y))}

    return build


@pytest.mark.parametrize("kind", ["lstm_unit", "gru_unit"])
def test_unit_layers_build_and_train_as_jax(kind):
    (jops, tops), (jp, tp) = same_programs(_unit_net(kind), _sgd)
    assert tops == jops and tp == jp and kind in tops
    r = np.random.RandomState(53)
    feeds = [{"x": _f(r, B, 5, scale=1.0), "h0": _f(r, B, H),
              "c0": _f(r, B, H), "y": _f(r, B, H)} for _ in range(2)]
    grads = sorted(n + "@GRAD" for n in tp)
    j, t, jf, tf, _ = train_both(_unit_net(kind), _sgd, feeds,
                                 lambda m: [m["loss"]] + grads)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b[0], a[0], rtol=TOL_FWD)
        for n, ga, gb in zip(grads, a[1:], b[1:]):
            assert rel(gb, ga) <= TOL_GRAD, (n, rel(gb, ga))


@pytest.mark.parametrize("layer", ["dynamic_lstm", "dynamic_lstmp"])
def test_peepholes_raise_as_in_jax(layer):
    import paddle_tpu as pfluid

    import paddle_tpu_torch as tfluid

    errors = []
    for fluid in (pfluid, tfluid):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data("x", shape=[T, 4 * H], dtype="float32")
            fn = getattr(fluid.layers, layer)
            args = (x, 4 * H) + ((3,) if layer == "dynamic_lstmp" else ())
            with pytest.raises((NotImplementedError, ValueError)) as e:
                fn(*args, use_peepholes=True)
            errors.append(type(e.value))
    assert errors[0] is errors[1]
