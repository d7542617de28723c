"""The nn op types the port added in its op-library slice
(``conv2d_transpose``, the losses, normalizations, resizes, samplers,
metrics, the fused ``fc``) and the proximal optimizer ops against the JAX
package's, on the CPU (the large-vocabulary heads ``nce``,
``hierarchical_sigmoid`` and ``sample_logits``:
tests/test_torch_vocab_heads.py).

Deterministic cases as tests/test_torch_math_ops_more.py holds them
(``run_both``: f32 forward within 1e-5, gradients within 1e-4 of the
largest |element| of the JAX value, integers exactly; f64 1e-12 /
1e-10). The resizes follow the JAX op's ``align_corners`` /
``align_mode`` / ``scale`` rules, not ``F.interpolate``'s;
``grid_sampler`` pads zeros outside the image."""

import numpy as np
import pytest
import torch
from torch_model_parity import assert_match, rel, run_both

from paddle_tpu_torch.core.registry import get_op_def

_R = np.random.RandomState(23)


def _f(*shape, scale=1.0):
    return (_R.randn(*shape) * scale).astype(np.float32)


def _away(x, kinks, gap=0.05):
    for k in kinks:
        near = np.abs(x - k) < gap
        x[near] = k + np.sign(x[near] - k + 1e-9) * gap * 2
    return x


def _probs(*shape):
    p = _R.uniform(0.05, 1.0, shape)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _lbl(n, c):
    return _R.randint(0, c, (n, 1)).astype(np.int64)


_CASES = {
    "conv2d_transpose": ("conv2d_transpose", {
        "Input": [_f(2, 4, 5, 5)], "Filter": [_f(4, 3, 4, 4)]},
        {"strides": [2, 2], "paddings": [1, 1]}),
    "conv2d_transpose_groups_dil": ("conv2d_transpose", {
        "Input": [_f(2, 4, 4, 3)], "Filter": [_f(4, 3, 3, 2)]},
        {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1],
         "groups": 2}),
    "cross_entropy": ("cross_entropy", {"X": [_probs(5, 4)],
                                        "Label": [_lbl(5, 4)]}, {}),
    "cross_entropy_ignore": ("cross_entropy", {
        "X": [_probs(5, 4)], "Label": [np.array([[1], [2], [1], [0], [3]],
                                                np.int64)]},
        {"ignore_index": 1}),
    "cross_entropy_soft": ("cross_entropy", {"X": [_probs(5, 4)],
                                             "Label": [_probs(5, 4)]},
                           {"soft_label": True}),
    "cross_entropy_3d": ("cross_entropy", {
        "X": [_probs(2, 3, 4)], "Label": [_R.randint(0, 4, (2, 3))
                                          .astype(np.int64)]}, {}),
    "huber_loss": ("huber_loss", {
        "X": [_f(6, 1)], "Y": [_f(6, 1)]}, {"delta": 0.8}),
    "smooth_l1_loss": ("smooth_l1_loss", {
        "X": [_away(_f(4, 3), (0.0,))], "Y": [np.zeros((4, 3), np.float32)]},
        {"sigma": 1.5}),
    "smooth_l1_loss_weights": ("smooth_l1_loss", {
        "X": [_f(4, 3)], "Y": [_f(4, 3)],
        "InsideWeight": [np.abs(_f(4, 3)) + 0.5],
        "OutsideWeight": [np.abs(_f(4, 3))]}, {}),
    "mean_iou": ("mean_iou", {
        "Predictions": [_R.randint(0, 5, (4, 6)).astype(np.int32)],
        "Labels": [_R.randint(0, 5, (4, 6)).astype(np.int32)]},
        {"num_classes": 6}),
    "maxout": ("maxout", {"X": [_f(2, 6, 3, 2)]}, {"groups": 3}),
    "prelu_all": ("prelu", {"X": [_away(_f(2, 3, 2, 2), (0.0,))],
                            "Alpha": [np.float32([0.25])]}, {"mode": "all"}),
    "prelu_channel": ("prelu", {"X": [_away(_f(2, 3, 2, 2), (0.0,))],
                                "Alpha": [_f(3)]}, {"mode": "channel"}),
    "prelu_element": ("prelu", {"X": [_away(_f(2, 3, 2, 2), (0.0,))],
                                "Alpha": [_f(12)]}, {"mode": "element"}),
    "group_norm": ("group_norm", {"X": [_f(2, 6, 3, 4)], "Scale": [_f(6)],
                                  "Bias": [_f(6)]},
                   {"groups": 3, "epsilon": 1e-5}),
    "group_norm_no_affine": ("group_norm", {"X": [_f(3, 4, 5)]},
                             {"groups": 2}),
    "sync_batch_norm": ("sync_batch_norm", {
        "X": [_f(4, 3, 2, 2)], "Scale": [_f(3)], "Bias": [_f(3)],
        "Mean": [_f(3)], "Variance": [np.abs(_f(3)) + 0.5]},
        {"is_test": False, "momentum": 0.9}),
    "sync_batch_norm_test": ("sync_batch_norm", {
        "X": [_f(4, 3, 2, 2)], "Scale": [_f(3)], "Bias": [_f(3)],
        "Mean": [_f(3)], "Variance": [np.abs(_f(3)) + 0.5]},
        {"is_test": True}),
    "norm": ("norm", {"X": [_f(2, 3, 4)]}, {"axis": 1}),
    "affine_channel": ("affine_channel", {"X": [_f(2, 3, 2, 2)],
                                          "Scale": [_f(3)], "Bias": [_f(3)]},
                       {}),
    "affine_channel_nhwc": ("affine_channel", {
        "X": [_f(2, 2, 2, 3)], "Scale": [_f(3)], "Bias": [_f(3)]},
        {"data_layout": "NHWC"}),
    "bilinear_interp_align": ("bilinear_interp", {"X": [_f(2, 3, 4, 5)]},
                              {"out_h": 7, "out_w": 3,
                               "align_corners": True}),
    "bilinear_interp_mode1": ("bilinear_interp", {"X": [_f(2, 3, 4, 5)]},
                              {"out_h": 6, "out_w": 8,
                               "align_corners": False, "align_mode": 1}),
    "bilinear_interp_mode0": ("bilinear_interp", {"X": [_f(2, 3, 4, 5)]},
                              {"out_h": 3, "out_w": 9,
                               "align_corners": False, "align_mode": 0}),
    "bilinear_interp_scale": ("bilinear_interp", {"X": [_f(1, 2, 3, 4)]},
                              {"scale": 1.5, "out_h": 9, "out_w": 9}),
    "nearest_interp_align": ("nearest_interp", {"X": [_f(2, 3, 4, 5)]},
                             {"out_h": 7, "out_w": 9}),
    "nearest_interp_floor": ("nearest_interp", {"X": [_f(2, 3, 4, 5)]},
                             {"out_h": 6, "out_w": 3,
                              "align_corners": False}),
    "nearest_interp_mixed": ("nearest_interp", {"X": [_f(1, 1, 1, 4)]},
                             {"out_h": 1, "out_w": 7,
                              "align_corners": True}),
    "nearest_interp_scale": ("nearest_interp", {"X": [_f(1, 2, 2, 3)]},
                             {"scale": 2.0, "align_corners": False}),
    "row_conv": ("row_conv", {"X": [_f(2, 5, 3)], "Filter": [_f(3, 3)]}, {}),
    "temporal_shift": ("temporal_shift", {"X": [_f(6, 8, 2, 2)]},
                       {"seg_num": 3, "shift_ratio": 0.25}),
    "grid_sampler": ("grid_sampler", {
        "X": [_f(2, 3, 4, 5)],
        # in (-1.2, 1.2): some corners outside; kept off the integer cells
        "Grid": [_R.uniform(-1.2, 1.2, (2, 3, 2, 2)).astype(np.float32)]},
        {}),
    "bilinear_tensor_product": ("bilinear_tensor_product", {
        "X": [_f(3, 4)], "Y": [_f(3, 5)], "Weight": [_f(2, 4, 5)],
        "Bias": [_f(1, 2)]}, {}),
    "bilinear_tensor_product_no_bias": ("bilinear_tensor_product", {
        "X": [_f(3, 4)], "Y": [_f(3, 5)], "Weight": [_f(2, 4, 5)]}, {}),
    "fc": ("fc", {"Input": [_f(4, 6)], "W": [_f(6, 3)], "Bias": [_f(3)]},
           {}),
    "fc_flatten": ("fc", {"Input": [_f(2, 3, 4, 2)], "W": [_f(8, 5)]},
                   {"in_num_col_dims": 2}),
    "proximal_gd": ("proximal_gd", {
        "Param": [_f(3, 4)], "Grad": [_f(3, 4)],
        "LearningRate": [np.float32([0.1])]}, {"l1": 0.2, "l2": 0.05}),
    "proximal_gd_plain": ("proximal_gd", {
        "Param": [_f(3, 4)], "Grad": [_f(3, 4)],
        "LearningRate": [np.float32([0.1])]}, {}),
    "proximal_adagrad": ("proximal_adagrad", {
        "Param": [_f(3, 4)], "Grad": [np.where(_f(3, 4) > 0.5, 0.0, _f(3, 4))
                                      .astype(np.float32)],
        "Moment": [np.zeros((3, 4), np.float32)],
        "LearningRate": [np.float32([0.1])]}, {"l1": 0.1, "l2": 0.2}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_nn_op_matches_jax(case):
    assert_match(*run_both(*_CASES[case]))


@pytest.mark.parametrize("case", ["conv2d_transpose_groups_dil",
                                  "group_norm", "grid_sampler",
                                  "bilinear_interp_mode0"])
def test_nn_op_matches_jax_in_f64(case):
    op, ins, attrs = _CASES[case]
    ins64 = {k: [v.astype(np.float64) if v.dtype == np.float32 else v
                 for v in vs] for k, vs in ins.items()}
    assert_match(*run_both(op, ins64, attrs), tol_fwd=1e-12, tol_grad=1e-10)


def test_sync_batch_norm_is_batch_norm_on_one_device():
    op, ins, attrs = _CASES["sync_batch_norm"]
    t_ins = {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()}
    a = get_op_def("sync_batch_norm").compute(t_ins, attrs, "cpu")
    b = get_op_def("batch_norm").compute(t_ins, attrs, "cpu")
    for k in a:
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k


def test_auc_matches_jax():
    """The batch AUC over 200 buckets (the JAX op sums in its default
    float, f64 under the tests' x64; the port in f32: within 1e-6)."""
    p = _R.uniform(0, 1, (64, 1)).astype(np.float32)
    pred = np.concatenate([1 - p, p], 1)
    label = (_R.uniform(0, 1, (64, 1)) < p).astype(np.int64)
    for attrs in ({}, {"num_thresholds": 16}):
        jo, to, _, _ = run_both("auc", {"Predict": [pred], "Label": [label]},
                                attrs)
        assert to["AUC"][0].shape == () and 0.5 < float(to["AUC"][0]) <= 1
        np.testing.assert_allclose(to["AUC"][0], jo["AUC"][0], atol=1e-6)


def test_grid_sampler_zero_pads_out_of_bounds():
    op = get_op_def("grid_sampler")
    x = torch.ones(1, 1, 2, 2)
    out = op.compute({"X": [x], "Grid": [torch.full((1, 1, 1, 2), -5.0)]},
                     {}, "cpu")["Output"][0]
    np.testing.assert_allclose(out.numpy(), 0.0)
    out = op.compute({"X": [x], "Grid": [torch.full((1, 1, 1, 2), -2.0)]},
                     {}, "cpu")["Output"][0]
    np.testing.assert_allclose(out.numpy(), 0.25)


def test_interp_scale_attr_wins():
    x = _f(1, 1, 2, 2)
    out = get_op_def("nearest_interp").compute(
        {"X": [torch.from_numpy(x)]},
        {"scale": 2.0, "out_h": 3, "out_w": 3, "align_corners": False},
        "cpu")["Out"][0].numpy()
    np.testing.assert_allclose(out, x.repeat(2, 2).repeat(2, 3))


def test_conv2d_transpose_output_size_and_is_conv2d_grad():
    """out H = (H - 1) s - 2p + d (k - 1) + 1, and the op is conv2d's
    input gradient: <conv2d(y, w), x> = <y, conv2d_transpose(x, w)>."""
    x = torch.randn(2, 4, 5, 5, dtype=torch.float64)
    w = torch.randn(4, 3, 4, 4, dtype=torch.float64)
    attrs = {"strides": [2, 2], "paddings": [1, 1]}
    out = get_op_def("conv2d_transpose").compute(
        {"Input": [x], "Filter": [w]}, attrs, "cpu")["Output"][0]
    assert out.shape == (2, 3, 10, 10)
    y = torch.randn_like(out)
    fwd = torch.nn.functional.conv2d(y, w, stride=2, padding=1)
    assert rel((fwd * x).sum().numpy(), (y * out).sum().numpy()) < 1e-12
