"""The sequence ops, the activations, ``matmul``, the new reductions,
``square_error_cost`` and ``flatten2`` of the port against the JAX
package's, on the CPU, with the layers that emit them.

Each case runs both packages' compute on the same numpy inputs (from a
seed) and, for an op with a gradient, both packages' derived grad op on
the same random cotangents (``torch_model_parity.run_both``). f32:
forward outputs within 1e-5 and gradients within 1e-4 of the largest
|element| of the JAX value; integer and bool outputs exactly. The inputs
keep clear of the activations' kinks (0, the thresholds), where the two
libraries' derivatives of ``clip`` / ``max`` differ by convention, and
reach the forms' edges (|x| up to 60: softplus and log-sigmoid without a
linear cut-off, soft_relu's clip). ``sequence_pool``'s MAX splits a tie's
gradient evenly in both packages (a row of length 0 ties everywhere).
The layers build the JAX package's ops and attrs and run to its values
(1e-5)."""

import numpy as np
import pytest
import torch
from torch_model_parity import assert_match, run_both

import paddle_tpu as pfluid

import paddle_tpu_torch as tfluid

_R = np.random.RandomState(0)


def _f(*shape, scale=1.0):
    return (_R.randn(*shape) * scale).astype(np.float32)


def _away(*shape, kinks=(0.0,), gap=0.05, scale=2.0):
    """Normal draws moved at least ``gap`` off each kink."""
    x = _f(*shape, scale=scale)
    for k in kinks:
        near = np.abs(x - k) < gap
        x[near] = k + np.sign(x[near] - k + 1e-9) * gap * 2
    return x


def _edges():
    """[4, 12]: a spread of values, and |x| up to 60 in the last row."""
    x = _away(3, 12, kinks=(0.0, 0.5, -0.5, 1.0, 3.0, -3.0, 6.0))
    tail = np.linspace(-60, 60, 12).astype(np.float32) + 0.37
    return np.concatenate([x, tail[None]], 0)


def _lens(*v):
    return np.array(v, np.int64)


_ACT = [
    ("tanh", {}), ("rsqrt", {"_pos": True}), ("square", {}),
    ("reciprocal", {"_pos": True}), ("ceil", {}), ("round", {}),
    ("sin", {}), ("softsign", {}), ("relu6", {}), ("silu", {}),
    ("leaky_relu", {}), ("leaky_relu", {"alpha": 0.2}), ("softplus", {}),
    ("elu", {}), ("elu", {"alpha": 0.5}), ("hard_sigmoid", {}),
    ("hard_sigmoid", {"slope": 0.3, "offset": 0.4}), ("swish", {}),
    ("swish", {"beta": 1.7}), ("hard_swish", {}),
    ("hard_swish", {"threshold": 5.0, "scale": 4.0, "offset": 2.5}),
    ("logsigmoid", {}), ("tanh_shrink", {}), ("softshrink", {}),
    ("softshrink", {"lambda": 1.0}), ("hard_shrink", {}),
    ("hard_shrink", {"threshold": 1.0}), ("brelu", {}),
    ("brelu", {"t_min": -1.0, "t_max": 3.0}), ("soft_relu", {}),
    ("soft_relu", {"threshold": 5.0}), ("stanh", {}),
    ("stanh", {"scale_a": 1.2, "scale_b": 0.5}), ("thresholded_relu", {}),
    ("thresholded_relu", {"threshold": 0.5}), ("selu", {}),
    ("selu", {"scale": 2.0, "alpha": 1.0}),
]


def _act_case(op, attrs):
    attrs = dict(attrs)
    x = _edges()
    if attrs.pop("_pos", False):
        x = np.abs(x) + 0.1
    if op in ("ceil", "round"):
        # no value within 0.05 of a half or a whole: the rounding step
        x = np.round(x * 2) / 2 + 0.2
    return (op, {"X": [x.astype(np.float32)]}, attrs)


# a tie-rich pool input: small integers, and a row of length 0
_TIES = _R.randint(-2, 2, (3, 5, 4)).astype(np.float32)

_SEQ = {
    "sequence_mask": ("sequence_mask", {"X": [_lens(3, 0, 5)]},
                      {"maxlen": 6, "out_dtype": "int64"}),
    "sequence_mask_f32": ("sequence_mask", {"X": [_lens(2, 6)]},
                          {"maxlen": 6, "out_dtype": "float32"}),
    "sequence_softmax": ("sequence_softmax",
                         {"X": [_f(3, 6, scale=3.0)], "Length": [_lens(6, 2, 0)]},
                         {}),
    "sequence_softmax_all": ("sequence_softmax", {"X": [_f(2, 5)]}, {}),
    "sequence_reverse": ("sequence_reverse",
                         {"X": [_f(3, 5, 2)], "Length": [_lens(5, 3, 0)]}, {}),
    "sequence_reverse_all": ("sequence_reverse", {"X": [_f(2, 4, 3)]}, {}),
    "sequence_expand": ("sequence_expand", {"X": [_f(3, 4)],
                                            "Y": [_f(3, 5, 2)]}, {}),
    "im2sequence": ("im2sequence", {"X": [_f(2, 3, 6, 5)]},
                    {"kernels": [2, 3], "strides": [2, 1]}),
    "sequence_pad": ("sequence_pad", {"X": [_f(3, 5, 2)],
                                      "PadValue": [np.float32([1.5])],
                                      "Length": [_lens(5, 1, 3)]}, {}),
    "sequence_pad_steps": ("sequence_pad",
                           {"X": [_f(2, 4, 3)], "PadValue": [_f(3)],
                            "Length": [_lens(2, 4)[:, None]]}, {}),
    "sequence_pad_no_len": ("sequence_pad", {"X": [_f(2, 4)]}, {}),
    "sequence_unpad": ("sequence_unpad", {"X": [_f(3, 5, 2)],
                                          "Length": [_lens(5, 0, 2)]}, {}),
    "sequence_concat": ("sequence_concat",
                        {"X": [_f(3, 4, 2), _f(3, 3, 2)],
                         "Length": [_lens(4, 1, 0), _lens(2, 3, 3)]}, {}),
    "sequence_concat_no_len": ("sequence_concat",
                               {"X": [_f(2, 3), _f(2, 2)]}, {}),
    "sequence_slice": ("sequence_slice",
                       {"X": [_f(3, 6, 2)], "Offset": [_lens(0, 2, 5)],
                        "Length": [_lens(3, 4, 1)]}, {}),
    "sequence_erase": ("sequence_erase",
                       {"X": [_R.randint(0, 6, (3, 7)).astype(np.int64)],
                        "Length": [_lens(7, 4, 0)]}, {"tokens": [2, 5]}),
    "sequence_erase_none": ("sequence_erase",
                            {"X": [_R.randint(0, 6, (2, 5)).astype(np.int64)]},
                            {"tokens": []}),
    "sequence_enumerate": ("sequence_enumerate",
                           {"X": [_R.randint(1, 9, (3, 5)).astype(np.int64)],
                            "Length": [_lens(5, 3, 1)]},
                           {"win_size": 3, "pad_value": 0}),
    "sequence_enumerate_pad": ("sequence_enumerate",
                               {"X": [_R.randint(1, 9, (2, 4)).astype(np.int64)]},
                               {"win_size": 2, "pad_value": -1}),
    "sequence_expand_as": ("sequence_expand_as",
                           {"X": [_f(3, 4)], "Y": [_f(3, 5, 2)],
                            "Length": [_lens(5, 2, 0)]}, {}),
    "sequence_conv": ("sequence_conv", {"X": [_f(2, 6, 3)],
                                        "Filter": [_f(9, 4)]},
                      {"contextLength": 3, "contextStart": -1}),
    "sequence_conv_wide": ("sequence_conv", {"X": [_f(2, 5, 2)],
                                             "Filter": [_f(10, 3)]},
                           {"contextLength": 5, "contextStart": -3}),
    "sequence_reshape": ("sequence_reshape", {"X": [_f(2, 4, 6)]},
                         {"new_dim": 3}),
    "sequence_scatter": ("sequence_scatter",
                         {"X": [_f(3, 6)],
                          "Ids": [np.array([[0, 2, 2], [5, 1, 0],
                                            [3, 3, 3]], np.int64)],
                          "Updates": [_f(3, 3)]}, {}),
    "sequence_scatter_col": ("sequence_scatter",
                             {"X": [_f(2, 4)],
                              "Ids": [np.array([[[1], [3]], [[0], [0]]],
                                               np.int64)],
                              "Updates": [_f(2, 2)]}, {}),
    "add_position_encoding": ("add_position_encoding", {"X": [_f(2, 7, 8)]},
                              {"alpha": 0.5, "beta": 2.0}),
    "conv_shift": ("conv_shift", {"X": [_f(3, 7)], "Y": [_f(3, 3)]}, {}),
    "conv_shift_5": ("conv_shift", {"X": [_f(2, 6)], "Y": [_f(2, 5)]}, {}),
}
for _p in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST"):
    _SEQ[f"sequence_pool_{_p.lower()}"] = (
        "sequence_pool", {"X": [_f(3, 5, 4)], "Length": [_lens(5, 2, 0)]},
        {"pooltype": _p})
_SEQ["sequence_pool_max_ties"] = (
    "sequence_pool", {"X": [_TIES], "Length": [_lens(5, 3, 0)]},
    {"pooltype": "MAX"})
_SEQ["sequence_pool_last_no_len"] = ("sequence_pool", {"X": [_f(2, 4, 3)]},
                                     {"pooltype": "LAST"})
_SEQ["sequence_pool_avg_col_len"] = (
    "sequence_pool", {"X": [_f(2, 4, 3)], "Length": [_lens(3, 4)[:, None]]},
    {"pooltype": "AVG"})

_ZOO = {
    "matmul": ("matmul", {"X": [_f(2, 3, 4)], "Y": [_f(2, 4, 5)]}, {}),
    "matmul_tx_ty_alpha": ("matmul", {"X": [_f(2, 4, 3)],
                                      "Y": [_f(2, 5, 4)]},
                           {"transpose_X": True, "transpose_Y": True,
                            "alpha": 0.5}),
    "matmul_broadcast": ("matmul", {"X": [_f(2, 1, 3, 4)],
                                    "Y": [_f(3, 4, 2)]}, {}),
    # 1-D operands: x a row [1, n], y a column [n, 1], kept unsqueezed
    "matmul_1d_1d": ("matmul", {"X": [_f(4)], "Y": [_f(4)]}, {}),
    "matmul_1d_2d": ("matmul", {"X": [_f(4)], "Y": [_f(4, 3)]}, {}),
    "matmul_2d_1d": ("matmul", {"X": [_f(3, 4)], "Y": [_f(4)]}, {}),
    # a 1-D Y is the column [n, 1] before transpose_Y: [3, 1] x [1, 4]
    "matmul_1d_ty": ("matmul", {"X": [_f(3, 1)], "Y": [_f(4)]},
                     {"transpose_Y": True}),
    "reduce_mean": ("reduce_mean", {"X": [_f(3, 4, 5)]},
                    {"dim": [1], "keep_dim": False}),
    "reduce_mean_all": ("reduce_mean", {"X": [_f(3, 4)]},
                        {"reduce_all": True}),
    "reduce_mean_keep": ("reduce_mean", {"X": [_f(3, 4, 5)]},
                         {"dim": [0, -1], "keep_dim": True}),
    "reduce_min": ("reduce_min", {"X": [_f(3, 4, 5)]}, {"dim": [2]}),
    "reduce_min_ties": ("reduce_min", {"X": [_TIES]},
                        {"dim": [1, 2], "keep_dim": True}),
    "reduce_min_all": ("reduce_min", {"X": [_f(3, 4)]},
                       {"reduce_all": True, "keep_dim": True}),
    "reduce_prod": ("reduce_prod", {"X": [_f(3, 4, 2)]}, {"dim": [1]}),
    "reduce_prod_two": ("reduce_prod", {"X": [_f(3, 4, 2)]},
                        {"dim": [0, 2]}),
    "reduce_prod_all_zero": ("reduce_prod",
                             {"X": [np.array([[1.5, 0.0, -2.0],
                                              [0.5, 3.0, 1.0]], np.float32)]},
                             {"reduce_all": True}),
    "square_error_cost": ("square_error_cost", {"X": [_f(4, 3)],
                                                "Label": [_f(4, 3)]}, {}),
    "flatten2": ("flatten2", {"X": [_f(2, 3, 4, 5)]}, {"axis": 2}),
    "flatten2_axis0": ("flatten2", {"X": [_f(2, 3, 4)]}, {"axis": 0}),
}


@pytest.mark.parametrize("i", range(len(_ACT)),
                         ids=[f"{a}-{i}" for i, (a, _) in enumerate(_ACT)])
def test_activation_matches_jax(i):
    assert_match(*run_both(*_act_case(*_ACT[i])))


@pytest.mark.parametrize("case", sorted(_SEQ))
def test_sequence_op_matches_jax(case):
    assert_match(*run_both(*_SEQ[case]))


@pytest.mark.parametrize("case", sorted(_ZOO))
def test_math_op_matches_jax(case):
    assert_match(*run_both(*_ZOO[case]))


def test_matmul_keeps_the_1d_dims():
    """The JAX op's quirk: 1-D by 1-D gives [1, 1], 1-D by 2-D [1, m],
    2-D by 1-D [n, 1]."""
    shapes = {c: run_both(*_ZOO[c])[1]["Out"][0].shape
              for c in ("matmul_1d_1d", "matmul_1d_2d", "matmul_2d_1d")}
    assert shapes == {"matmul_1d_1d": (1, 1), "matmul_1d_2d": (1, 3),
                      "matmul_2d_1d": (3, 1)}


def _max_pool_grad_of_ones(x, lens):
    """The port's derived gradient of MAX sequence_pool for a cotangent
    of ones."""
    from paddle_tpu_torch.core import autodiff
    from paddle_tpu_torch.core.registry import get_op_def

    opdef = get_op_def("sequence_pool")
    ins = {"X": [torch.from_numpy(x)], "Length": [torch.from_numpy(lens)]}
    attrs = {"pooltype": "MAX"}
    out = opdef.compute(ins, attrs, torch.device("cpu"))["Out"][0]
    g = autodiff.make_grad_compute(opdef)(
        dict(ins, Out=[out], **{"GRAD::Out": [torch.ones_like(out)]}),
        dict(attrs, fwd_input_slots=["X", "Length"],
             fwd_output_slots=["Out"]), torch.device("cpu"))
    return out.numpy(), g["GRAD::X"][0].numpy()


def test_max_pool_splits_a_tie_evenly():
    """MAX over tied values: each tied live step gets an even share of
    the gradient, in both packages (``torch.max(dim)`` would send it all
    to one step); a row of length 0 gives its input no gradient."""
    assert_match(*run_both(*_SEQ["sequence_pool_max_ties"]))
    lens = _lens(5, 3, 0)
    out, grad = _max_pool_grad_of_ones(_TIES, lens)
    want = np.zeros_like(_TIES)
    for b, n in enumerate(lens):
        live = _TIES[b, :n]
        ties = live == out[b][None, :]
        want[b, :n] = ties / np.maximum(ties.sum(0, keepdims=True), 1)
    assert (want[:2] == 0.5).any() or ((want[:2] > 0) & (want[:2] < 1)).any()
    np.testing.assert_allclose(grad, want, rtol=1e-6, atol=0)
    assert not grad[2].any()


def test_sequence_mask_needs_a_static_maxlen():
    from paddle_tpu.core.registry import get_op_def as jax_op_def

    from paddle_tpu_torch.core.registry import get_op_def

    lens = _lens(2, 3)
    import jax.numpy as jnp

    with pytest.raises(ValueError, match="maxlen"):
        jax_op_def("sequence_mask").compute({"X": [jnp.asarray(lens)]}, {})
    with pytest.raises(ValueError, match="maxlen"):
        get_op_def("sequence_mask").compute({"X": [torch.from_numpy(lens)]},
                                            {}, torch.device("cpu"))


# --- the layers -----------------------------------------------------------

_DECL = {"x": ([5, 4], "float32"), "v": ([4], "float32"),
         "n": ([], "int64"), "img": ([2, 6, 6], "float32"),
         "w": ([3, 4], "float32")}
_FEED = {"x": _f(3, 5, 4), "v": _f(3, 4), "n": _lens(5, 2, 3),
         "img": _f(3, 2, 6, 6), "w": _f(3, 3, 4)}

_LAYERS = {
    "activations (nn)": (lambda L, v: [
        L.tanh(v["x"]), L.square(v["x"]), L.softplus(v["x"]),
        L.softsign(v["x"]), L.relu6(v["x"]), L.swish(v["x"], beta=1.5),
        L.hard_swish(v["x"]), L.hard_sigmoid(v["x"], slope=0.3),
        L.elu(v["x"], alpha=0.7), L.leaky_relu(v["x"], alpha=0.1)]),
    "activations (more)": (lambda L, v: [
        L.brelu(v["x"], t_min=-0.5, t_max=1.0),
        L.soft_relu(v["x"], threshold=2.0), L.stanh(v["x"], 0.5, 2.0),
        L.selu(v["x"])]),
    "matmul, reduces, square_error_cost, flatten": (lambda L, v: [
        L.matmul(v["x"], v["w"], transpose_y=True, alpha=0.5),
        L.reduce_mean(v["x"], dim=1), L.reduce_min(v["x"], dim=[1, 2],
                                                  keep_dim=True),
        L.reduce_prod(v["v"], dim=-1), L.reduce_mean(v["x"]),
        L.square_error_cost(v["v"], L.scale(v["v"], 0.5)),
        L.flatten(v["img"], axis=2)]),
    "sequence": (lambda L, v: [
        L.sequence_pool(v["x"], "sum", length=v["n"]),
        L.sequence_pool(v["x"], "max"),
        L.sequence_softmax(L.reduce_sum(v["x"], dim=2), length=v["n"]),
        L.sequence_mask(v["n"], maxlen=5, dtype="float32"),
        L.sequence_reverse(v["x"], length=v["n"]),
        L.sequence_expand(v["v"], v["x"]),
        L.im2sequence(v["img"], filter_size=[2, 3], stride=2),
        L.sequence_conv(v["x"], 3, filter_size=3, act="tanh"),
        L.add_position_encoding(v["x"], alpha=0.5, beta=1.5)]),
}


@pytest.mark.parametrize("case", sorted(_LAYERS))
def test_layers_build_the_jax_ops(case):
    """The layers append the JAX package's op types and attrs and run to
    its values on the same weights (atol 1e-5)."""
    outs, weights = [], {}
    for fluid in (pfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            v = {n: fluid.layers.data(n, shape=s, dtype=d)
                 for n, (s, d) in _DECL.items()}
            fetch = _LAYERS[case](fluid.layers, v)
        ops = [(o.type, sorted(o.attrs.items()))
               for o in main.global_block().ops]
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            for p in main.all_parameters():
                if fluid is pfluid:
                    weights[p.name] = np.asarray(scope.find_var(p.name))
                else:
                    scope.set(p.name, torch.tensor(weights[p.name]))
            vals = exe.run(main, feed=_FEED, fetch_list=fetch)
        outs.append((ops, [np.asarray(x) for x in vals]))
    (jops, jv), (tops, tv) = outs
    assert tops == jops
    for i, (a, b) in enumerate(zip(jv, tv)):
        assert b.shape == a.shape, (i, b.shape, a.shape)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=i)
