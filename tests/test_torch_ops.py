"""Every op type of the serving and training paths (the training
recipe's too), the port's compute against the JAX package's (``paddle_tpu.core.registry.get_op_def(t).compute``) on the same
numpy inputs: f32 results within atol 1e-5, integer and bool results
exact, dtypes equal.

Two kinds of result cannot be held to the JAX value and get their own
reference: the random fills and the training-mode dropout mask (the two
packages draw different streams from a seed, so shape, dtype and
moments, or Out against the op's own Mask, are checked), and the
attention logsumexp rows, which the JAX op returns as zeros off the TPU
while the port computes them (checked against float64 numpy). The
attention grad op consumes the forward's saved Out and Lse, which the
JAX op ignores off the TPU; both get the port's plain forward's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu_torch.core.registry import get_op_def, registered_ops
from paddle_tpu_torch.core.rng import SeedHandle
from paddle_tpu_torch.parallel import flash_attention as tfa

# the op types of build(cfg), its startup program, Adam/SGD.minimize and
# the three serving programs (the explicitly registered grad ops included;
# the others are derived)
PATH_OP_TYPES = sorted({
    "adam", "dropout", "dropout_grad", "scaled_dot_product_attention_grad",
    "sgd", "sum",
    "assign", "attn_bias", "dynamic_update", "elementwise_add",
    "fill_constant", "layer_norm", "lookup_table", "mul", "position_ids",
    "relu", "reshape2", "scale", "scaled_dot_product_attention", "scatter",
    "split", "abs", "arg_max", "cast", "equal", "kv_cache_write",
    "kv_step_bias", "less_than", "logical_and", "logical_not", "reduce_max",
    "unsqueeze2", "where", "elementwise_div", "elementwise_max",
    "elementwise_mul", "fill_any_like", "label_smooth", "one_hot",
    "reduce_sum", "softmax_with_cross_entropy", "assign_value",
    "gaussian_random", "uniform_random",
})

_R = np.random.RandomState(0)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _i(lo, hi, *shape):
    return _R.randint(lo, hi, shape).astype(np.int64)


def _b(*shape):
    return _R.rand(*shape) > 0.5


_MASK = (np.arange(6)[None, :] < np.array([[6], [3]])).astype(np.float32)
_ONEHOT = np.eye(5, dtype=np.float32)[_R.randint(0, 5, (2, 3))]
_SDPA_BIAS = ((1.0 - (np.arange(16)[None, :] < np.array([[16], [9]]))
               .astype(np.float32)) * -1e9)[:, None, None, :]
_QKV = [_f(2, 16, 2, 8) for _ in range(3)]


def _sdpa_saved(causal):
    """The forward's (Out, Lse) that the attention grad op consumes."""
    q, k, v = (torch.from_numpy(a) for a in _QKV)
    bias = torch.from_numpy(_SDPA_BIAS)
    out, lse = tfa.flash_attention_bthd_fwd(q, k, v, bias, None, 8 ** -0.5,
                                            0.0, causal)
    return [out.numpy()], [lse.numpy()]


def _sdpa_grad_case(causal):
    out, lse = _sdpa_saved(causal)
    return ("scaled_dot_product_attention_grad",
            {"Q": [_QKV[0]], "K": [_QKV[1]], "V": [_QKV[2]],
             "Bias": [_SDPA_BIAS], "Out": out, "Lse": lse,
             "GRAD::Out": [_f(2, 16, 2, 8)]},
            {"scale": 8 ** -0.5, "layout": "bthd", "causal": causal,
             "is_test": False, "dropout_prob": 0.0,
             "fwd_input_slots": ["Q", "K", "V", "Bias"],
             "fwd_output_slots": ["Out", "Lse"], "forward_op_idx": 3})

# (op type, inputs, attrs): several cases for ops with several modes
CASES = [
    ("abs", {"X": [_f(3, 4)]}, {}),
    ("adam", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
              "Moment1": [_f(3, 4)], "Moment2": [np.abs(_f(3, 4))],
              "Beta1Pow": [np.array([0.81], np.float32)],
              "Beta2Pow": [np.array([0.998], np.float32)],
              "LearningRate": [np.array([0.01], np.float32)]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("dropout", {"X": [_f(4, 6)]}, {"dropout_prob": 0.3, "is_test": True,
                                    "dropout_implementation":
                                        "upscale_in_train"}),
    ("dropout", {"X": [_f(4, 6)]}, {"dropout_prob": 0.3, "is_test": True,
                                    "dropout_implementation":
                                        "downgrade_in_infer"}),
    ("dropout", {"X": [_f(64, 64)]}, {"dropout_prob": 0.3, "is_test": False,
                                      "dropout_implementation":
                                          "upscale_in_train"}),
    ("dropout_grad", {"X": [_f(4, 6)], "Out": [_f(4, 6)],
                      "Mask": [(_R.rand(4, 6) > 0.3).astype(np.uint8)],
                      "GRAD::Out": [_f(4, 6)]},
     {"dropout_prob": 0.3, "is_test": False,
      "dropout_implementation": "upscale_in_train"}),
    ("dropout_grad", {"X": [_f(4, 6)], "Out": [_f(4, 6)],
                      "Mask": [(_R.rand(4, 6) > 0.3).astype(np.uint8)],
                      "GRAD::Out": [_f(4, 6)]},
     {"dropout_prob": 0.3, "is_test": False,
      "dropout_implementation": "downgrade_in_infer"}),
    ("arg_max", {"X": [_f(4, 7)]}, {"axis": -1}),
    ("assign", {"X": [_f(3, 4)]}, {}),
    ("assign_value", {}, {"shape": [2, 3], "dtype": "float32",
                          "values": [0.5, -1.0, 2.0, 3.25, 0.0, 7.0]}),
    ("attn_bias", {"PadMask": [_MASK]}, {"causal": False}),
    ("attn_bias", {"PadMask": [_MASK]}, {"causal": True}),
    ("cast", {"X": [_b(5)]}, {"out_dtype": "int64"}),
    ("cast", {"X": [_i(0, 9, 5)]}, {"out_dtype": "float32"}),
    ("dynamic_update", {"X": [_f(4, 5, 3)], "Index": [np.array([2])],
                        "Value": [_f(5, 3)]}, {}),
    ("dynamic_update", {"X": [_f(4, 1, 1, 6)], "Index": [np.array([3])],
                        "Value": [_f(1, 1, 6)]}, {}),
    ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(4)]}, {"axis": 2}),
    ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(2, 3, 4)]},
     {"axis": -1}),
    ("elementwise_add", {"X": [_i(0, 9, 4)], "Y": [_i(0, 9, 4)]},
     {"axis": -1}),
    ("elementwise_div", {"X": [_f(3)], "Y": [np.abs(_f(3)) + 1.0]},
     {"axis": -1}),
    ("elementwise_max", {"X": [_f(3, 2)], "Y": [_f(3, 2)]}, {"axis": -1}),
    ("elementwise_mul", {"X": [_f(2, 6)], "Y": [_MASK]}, {"axis": -1}),
    ("equal", {"X": [_i(0, 3, 8)], "Y": [_i(0, 3, 8)]}, {}),
    ("fill_any_like", {"X": [_f(3, 2)]}, {"value": 1.0}),
    ("fill_constant", {}, {"shape": [2, 3], "dtype": "float32",
                           "value": 0.5}),
    ("fill_constant", {}, {"shape": [4], "dtype": "int64", "value": 9.0}),
    ("fill_constant", {}, {"shape": [1], "dtype": "bool", "value": 1.0}),
    ("label_smooth", {"X": [_ONEHOT]}, {"epsilon": 0.1}),
    ("layer_norm", {"X": [_f(2, 3, 8)], "Scale": [_f(8)], "Bias": [_f(8)]},
     {"begin_norm_axis": 2, "epsilon": 1e-5}),
    ("less_than", {"X": [_i(0, 5, 8)], "Y": [_i(0, 5, 8)]}, {}),
    ("logical_and", {"X": [_b(8)], "Y": [_b(8)]}, {}),
    ("logical_not", {"X": [_b(8)]}, {}),
    ("lookup_table", {"W": [_f(10, 4)], "Ids": [_i(0, 10, 2, 5)]},
     {"squeeze_last": False}),
    ("lookup_table", {"W": [_f(10, 4)], "Ids": [_i(0, 10, 3, 1)]},
     {"squeeze_last": False}),
    ("lookup_table", {"W": [_f(10, 4)], "Ids": [np.array([[0, 9, 3, 9]])]},
     {"squeeze_last": False, "padding_idx": -1}),
    ("mul", {"X": [_f(2, 3, 4)], "Y": [_f(4, 5)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("mul", {"X": [_f(3, 2, 2)], "Y": [_f(4, 5)]},
     {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    ("one_hot", {"X": [_i(0, 5, 2, 3)]}, {"depth": 5, "dtype": "float32"}),
    ("one_hot", {"X": [_i(0, 5, 4, 1)]}, {"depth": 5, "dtype": "float32"}),
    ("position_ids", {"X": [_i(0, 9, 2, 5)]}, {}),
    ("reduce_max", {"X": [_f(3, 5)]}, {"dim": [1], "keep_dim": False}),
    ("reduce_max", {"X": [_f(3, 5)]}, {"reduce_all": True,
                                       "keep_dim": False}),
    ("reduce_sum", {"X": [_f(3, 5)]}, {"reduce_all": True,
                                       "keep_dim": False}),
    ("reduce_sum", {"X": [_f(3, 5)]}, {"dim": [-1], "keep_dim": True}),
    ("relu", {"X": [_f(3, 4)]}, {}),
    ("reshape2", {"X": [_f(2, 3, 8)]}, {"shape": [0, 0, 2, 4]}),
    ("reshape2", {"X": [_f(2, 3, 8)]}, {"shape": [-1, 2, 4]}),
    ("reshape2", {"X": [_f(1, 6, 8)]}, {"shape": [1, 1, -1]}),
    ("scale", {"X": [_f(3, 4)]}, {"scale": 2.5, "bias": 0.5,
                                  "bias_after_scale": True}),
    ("scale", {"X": [_f(3, 4)]}, {"scale": 2.5, "bias": 0.5,
                                  "bias_after_scale": False}),
    ("scaled_dot_product_attention",
     {"Q": [_f(2, 16, 2, 8)], "K": [_f(2, 16, 2, 8)], "V": [_f(2, 16, 2, 8)],
      "Bias": [_SDPA_BIAS]},
     {"scale": 8 ** -0.5, "layout": "bthd", "causal": False,
      "is_test": True, "dropout_prob": 0.1}),
    ("scaled_dot_product_attention",
     {"Q": [_f(2, 16, 2, 8)], "K": [_f(2, 16, 2, 8)], "V": [_f(2, 16, 2, 8)],
      "Bias": [_SDPA_BIAS]},
     {"scale": 8 ** -0.5, "layout": "bthd", "causal": True,
      "is_test": True, "dropout_prob": 0.0}),
    ("scaled_dot_product_attention",
     {"Q": [_f(3, 1, 2, 8)], "K": [_f(3, 12, 2, 8)], "V": [_f(3, 12, 2, 8)]},
     {"scale": 8 ** -0.5, "layout": "bthd", "causal": False,
      "is_test": True}),
    _sdpa_grad_case(False),
    _sdpa_grad_case(True),
    ("scatter", {"X": [_i(0, 9, 6)], "Ids": [np.array([3])],
                 "Updates": [np.array([7])]}, {"overwrite": True}),
    ("scatter", {"X": [_b(6)], "Ids": [np.array([0])],
                 "Updates": [np.array([True])]}, {"overwrite": True}),
    ("scatter", {"X": [_f(5, 3)], "Ids": [np.array([1, 4])],
                 "Updates": [_f(2, 3)]}, {"overwrite": False}),
    ("softmax_with_cross_entropy", {"Logits": [_f(2, 3, 6)],
                                    "Label": [np.eye(6, dtype=np.float32)[
                                        _R.randint(0, 6, (2, 3))]]},
     {"soft_label": True, "ignore_index": -100}),
    ("softmax_with_cross_entropy", {"Logits": [_f(2, 3, 6)],
                                    "Label": [_i(0, 6, 2, 3, 1)]},
     {"soft_label": False, "ignore_index": -100}),
    ("sgd", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
             "LearningRate": [np.array([0.1], np.float32)]}, {}),
    ("split", {"X": [_f(2, 3, 12)]}, {"num": 3, "axis": -1}),
    ("sum", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {}),
    ("unsqueeze2", {"X": [_i(0, 9, 4)]}, {"axes": [1]}),
    ("unsqueeze2", {"X": [_f(3, 4)]}, {"axes": [0, 2]}),
    ("kv_cache_write", {"Cache": [_f(3, 5, 2, 4)], "New": [_f(3, 1, 2, 4)],
                        "Pos": [np.array([0, 4, 9])]}, {}),
    ("kv_step_bias", {"Pos": [np.array([0, 2, 4])]}, {"length": 5}),
    ("where", {"Condition": [_b(6)], "X": [_i(0, 9, 6)],
               "Y": [_i(0, 9, 6)]}, {}),
    ("gaussian_random", {}, {"shape": [4096], "dtype": "float32",
                             "mean": 0.5, "std": 2.0, "seed": 0}),
    ("uniform_random", {}, {"shape": [4096], "dtype": "float32",
                            "min": -0.25, "max": 0.75, "seed": 0}),
]


# the op types of the training recipe: the clips, the decays, the other
# optimizers and amp.decorate's loss-scaling state machine
RECIPE_OP_TYPES = sorted({
    "adadelta", "adagrad", "adamax", "adamw", "clip", "clip_by_norm",
    "decayed_adagrad", "elementwise_pow", "elementwise_sub",
    "fill_zeros_like", "ftrl", "greater_equal", "isfinite", "lamb",
    "lars_momentum", "rmsprop", "sqrt", "squared_l2_norm",
})


def _lr(v=0.01):
    return [np.array([v], np.float32)]


def _pos(*shape):
    return np.abs(_f(*shape)) + 0.1


_POW = [np.array([0.81], np.float32)]
_POW2 = [np.array([0.998], np.float32)]
_ADAM_ATTRS = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
_WITH_INF = _f(3, 4)
_WITH_INF[1, 2] = np.inf

CASES += [
    ("adadelta", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
                  "AvgSquaredGrad": [_pos(3, 4)],
                  "AvgSquaredUpdate": [_pos(3, 4)], "LearningRate": _lr()},
     {"rho": 0.95, "epsilon": 1e-6}),
    ("adagrad", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
                 "Moment": [_pos(3, 4)], "LearningRate": _lr()},
     {"epsilon": 1e-6}),
    ("adamax", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
                "Moment": [_f(3, 4)], "InfNorm": [_pos(3, 4)],
                "Beta1Pow": _POW, "LearningRate": _lr()}, _ADAM_ATTRS),
    ("adamw", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
               "Moment1": [_f(3, 4)], "Moment2": [_pos(3, 4)],
               "Beta1Pow": _POW, "Beta2Pow": _POW2, "LearningRate": _lr()},
     dict(_ADAM_ATTRS, weight_decay=0.05)),
    ("clip", {"X": [_f(3, 4)]}, {"min": -0.5, "max": 0.7}),
    ("clip_by_norm", {"X": [_f(3, 4)]}, {"max_norm": 1.0}),
    ("clip_by_norm", {"X": [_f(3, 4)]}, {"max_norm": 100.0}),
    ("decayed_adagrad", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
                         "Moment": [_pos(3, 4)], "LearningRate": _lr()},
     {"decay": 0.95, "epsilon": 1e-6}),
    ("elementwise_pow", {"X": [_pos(2, 3)], "Y": [_f(2, 3)]}, {"axis": -1}),
    ("elementwise_pow", {"X": [np.array([2.0], np.float32)],
                         "Y": [np.array([1.0], np.float32)]}, {"axis": -1}),
    ("elementwise_sub", {"X": [_f(2, 3, 4)], "Y": [_f(4)]}, {"axis": 2}),
    ("fill_zeros_like", {"X": [_f(3, 2)]}, {}),
    ("ftrl", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
              "SquaredAccumulator": [_pos(3, 4)],
              "LinearAccumulator": [_f(3, 4)], "LearningRate": _lr(0.1)},
     {"l1": 0.01, "l2": 0.01, "lr_power": -0.5}),
    ("greater_equal", {"X": [_i(0, 3, 8).astype(np.float32)],
                       "Y": [_i(0, 3, 8).astype(np.float32)]}, {}),
    ("isfinite", {"X": [_f(3, 4), _f(5)]}, {}),
    ("isfinite", {"X": [_f(5), _WITH_INF, _f(2)]}, {}),
    ("lamb", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
              "Moment1": [_f(3, 4)], "Moment2": [_pos(3, 4)],
              "Beta1Pow": _POW, "Beta2Pow": _POW2, "LearningRate": _lr()},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "weight_decay": 0.01}),
    ("lars_momentum", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
                       "Velocity": [_f(3, 4)], "LearningRate": _lr(0.1)},
     {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
    ("rmsprop", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
                 "MeanSquare": [_pos(3, 4)], "Moment": [_f(3, 4)],
                 "LearningRate": _lr()},
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9, "centered": False}),
    ("rmsprop", {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
                 "MeanSquare": [_pos(3, 4) + 2.0], "Moment": [_f(3, 4)],
                 "MeanGrad": [_f(3, 4) * 0.1], "LearningRate": _lr()},
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9, "centered": True}),
    ("sqrt", {"X": [_pos(3, 4)]}, {}),
    ("squared_l2_norm", {"X": [_f(3, 4)]}, {}),
]


# the op types of export and deploy: distillation's (cases
# here) and the quant ops (tests/test_torch_slim.py holds their cases)
DEPLOY_OP_TYPES = ["log", "log_softmax", "softmax"]
QUANT_OP_TYPES = [
    "dequantize", "fake_channel_wise_dequantize_max_abs",
    "fake_channel_wise_quantize_abs_max", "fake_dequantize_max_abs",
    "fake_quantize_abs_max", "fake_quantize_dequantize",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_moving_average_abs_max", "fake_quantize_range_abs_max",
    "moving_average_abs_max_scale", "quantize",
    "quantize_dequantize_static", "requantize",
]

CASES += [
    ("log", {"X": [_pos(3, 4)]}, {}),
    ("log_softmax", {"X": [_f(3, 5) * 4]}, {"axis": -1}),
    ("softmax", {"X": [_f(3, 5) * 4]}, {"axis": -1}),
    ("softmax", {"X": [_f(2, 3, 4) * 4]}, {"axis": 1}),
]

# the op types the vision path added; test_torch_vision_ops.py holds
# their cases
VISION_OP_TYPES = [
    "accuracy", "batch_norm", "conv2d", "depthwise_conv2d", "mean",
    "momentum", "pool2d", "sigmoid", "top_k",
]


def test_cases_cover_exactly_the_path_op_types():
    assert sorted({c[0] for c in CASES}) == sorted(
        PATH_OP_TYPES + RECIPE_OP_TYPES + DEPLOY_OP_TYPES)
    assert registered_ops() == sorted(PATH_OP_TYPES + VISION_OP_TYPES
                                      + RECIPE_OP_TYPES + DEPLOY_OP_TYPES
                                      + QUANT_OP_TYPES)


def _run_jax(op_type, ins, attrs):
    opdef = jax_op_def(op_type)
    kwargs = {"rng": jax.random.PRNGKey(0)} if opdef.needs_rng else {}
    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    return opdef.compute(jins, dict(attrs), **kwargs)


def _run_torch(op_type, ins, attrs):
    opdef = get_op_def(op_type)
    kwargs = {"device": torch.device("cpu")}
    if opdef.needs_rng:
        kwargs["seed"] = SeedHandle(torch.zeros((), dtype=torch.int64), 0)
    if opdef.host_rng:
        kwargs["generator"] = torch.Generator().manual_seed(0)
    tins = {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    return opdef.compute(tins, dict(attrs), **kwargs)


def _sdpa_lse(ins, attrs):
    q, k = (ins[s][0].astype(np.float64) for s in ("Q", "K"))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * attrs["scale"]
    if "Bias" in ins:
        s = s + ins["Bias"][0]
    if attrs["causal"]:
        tq, tk = s.shape[-2:]
        s = s + np.where(np.arange(tq)[:, None] >= np.arange(tk)[None, :],
                         0.0, -1e30)
    m = s.max(-1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(-1, keepdims=True))
    return lse.transpose(0, 2, 1, 3)


@pytest.mark.parametrize(
    "case", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    op_type, ins, attrs = case
    j_outs = _run_jax(op_type, ins, attrs)
    t_outs = _run_torch(op_type, ins, attrs)
    for slot, j_vals in j_outs.items():
        t_vals = t_outs[slot]
        assert len(t_vals) == len(j_vals), slot
        for jv, tv in zip(j_vals, t_vals):
            j = np.asarray(jv)
            t = tv.numpy()
            assert t.shape == j.shape, (slot, t.shape, j.shape)
            assert t.dtype == j.dtype, (slot, t.dtype, j.dtype)
            if op_type in ("gaussian_random", "uniform_random"):
                _check_random(op_type, t, attrs)
            elif op_type == "dropout" and not attrs["is_test"]:
                _check_dropout(ins["X"][0], t_outs, attrs)
            elif slot == "Lse":
                np.testing.assert_allclose(t, _sdpa_lse(ins, attrs),
                                           atol=1e-5, rtol=0)
            elif np.issubdtype(t.dtype, np.floating):
                np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
            else:
                np.testing.assert_array_equal(t, j)


def _check_random(op_type, t, attrs):
    """Moments of a 4096-sample draw: each bound is > 5 standard errors."""
    n = t.size
    if op_type == "gaussian_random":
        assert abs(t.mean() - attrs["mean"]) < 5 * attrs["std"] / np.sqrt(n)
        assert abs(t.std() / attrs["std"] - 1.0) < 0.06
    else:
        lo, hi = attrs["min"], attrs["max"]
        assert t.min() >= lo and t.max() < hi
        sd = (hi - lo) / np.sqrt(12.0)
        assert abs(t.mean() - (lo + hi) / 2) < 5 * sd / np.sqrt(n)


def _check_dropout(x, outs, attrs):
    """Out is X scaled by 1/(1 - p) where the op's Mask keeps it, 0 where
    it drops it; the keep rate is within 5 standard errors of 1 - p."""
    p = attrs["dropout_prob"]
    keep = outs["Mask"][0].numpy().astype(bool)
    np.testing.assert_allclose(outs["Out"][0].numpy(),
                               np.where(keep, x / (1 - p), 0.0), rtol=1e-6)
    assert abs(keep.mean() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / keep.size)
