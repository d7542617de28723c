"""The layers of the port's op-library slice against the JAX package's,
on the CPU: ``tests/test_layers_more.py``'s one-program test ported (both
packages build it, run on the same weights and feeds, and agree within
1e-5; its numpy spot checks held on the port), the numpy spot checks of
``tests/test_ops_extended.py`` and ``tests/test_passes_hsigmoid.py`` for
the slice's ops, ``hsigmoid``'s power-of-two case and training, and a
toy-size run of chip_smoke.py's phase 17 models: the N-gram model's four
heads and the DCGAN generator, the deterministic ones (the older
``cross_entropy``, ``hsigmoid``, the generator) step for step against the
JAX package from its startup state (losses within 1e-5, the state within
1e-4), the ones that draw on the device (``nce``, sampled softmax) by a
falling loss and equal eager and cached steps; and phase 17a's case list
through its runner on the CPU."""

import numpy as np
import pytest
import torch
from torch_model_parity import rel, train_both

import chip_smoke
import paddle_tpu as pfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core.registry import get_op_def

B = 4


def _one_program(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[B, 6], append_batch_size=False,
                    stop_gradient=True)
    img = layers.data("img", shape=[B, 4, 8, 8], append_batch_size=False,
                      stop_gradient=True)
    seq = layers.data("seq", shape=[B, 5, 3], append_batch_size=False,
                      stop_gradient=True)
    length = layers.data("length", shape=[B], dtype="int64",
                         append_batch_size=False)
    lbl = layers.data("lbl", shape=[B, 1], dtype="int64",
                      append_batch_size=False)
    f = {}
    f["brelu"] = layers.brelu(x, 0.0, 1.0)
    f["soft_relu"] = layers.soft_relu(x)
    f["stanh"] = layers.stanh(x)
    f["selu"] = layers.selu(x)
    f["sign"] = layers.sign(x)
    f["cos_sim"] = layers.cos_sim(x, x)
    f["reduce_all"] = layers.reduce_all(
        layers.greater_equal(x, layers.scale(x, scale=1.0)))
    f["reduce_any"] = layers.reduce_any(
        layers.not_equal(x, layers.scale(x, scale=0.0)))
    f["isfinite"] = layers.isfinite(x)
    f["has_inf"] = layers.has_inf(x)
    f["has_nan"] = layers.has_nan(x)
    f["reverse"] = layers.reverse(x, axis=1)
    f["argsort"], f["argsort_ids"] = layers.argsort(x, axis=1)
    f["diag"] = layers.diag(layers.reshape(
        layers.slice(x, axes=[0], starts=[0], ends=[1]), [6]))
    f["rank"] = layers.rank(x)
    probs = layers.softmax(x)
    f["bpr_loss"] = layers.bpr_loss(x, lbl)
    f["dice_loss"] = layers.dice_loss(probs, lbl)
    f["kldiv"] = layers.kldiv_loss(x, probs)
    half = layers.slice(x, axes=[1], starts=[0], ends=[1])
    other = layers.slice(x, axes=[1], starts=[1], ends=[2])
    flbl = layers.cast(lbl, "float32")
    f["log_loss"] = layers.log_loss(layers.sigmoid(half), flbl)
    f["margin_rank"] = layers.margin_rank_loss(flbl, half, other)
    f["rank_loss"] = layers.rank_loss(flbl, half, other)
    f["npair"] = layers.npair_loss(x, x, lbl)
    f["ts_loss"] = layers.teacher_student_sigmoid_loss(half, flbl)
    f["hinge"] = layers.hinge_loss(half, flbl)
    f["pad2d"] = layers.pad2d(img, [1, 1, 2, 2])
    f["crop"] = layers.crop(img, shape=[B, 4, 4, 4], offsets=[0, 0, 1, 1])
    f["pixshuf"] = layers.pixel_shuffle(img, 2)
    f["shufch"] = layers.shuffle_channel(img, 2)
    f["s2d"] = layers.space_to_depth(img, 2)
    f["tshift"] = layers.temporal_shift(img, seg_num=2)
    ch_scale = layers.fill_constant(shape=[4], dtype="float32", value=2.0)
    ch_bias = layers.fill_constant(shape=[4], dtype="float32", value=0.5)
    f["affch"] = layers.affine_channel(img, ch_scale, ch_bias)
    f["resize"] = layers.resize_bilinear(img, out_shape=[4, 4])
    f["resize_n"] = layers.resize_nearest(img, out_shape=[4, 4])
    f["resize_s"] = layers.image_resize_short(img, 4)
    f["fsp"] = layers.fsp_matrix(img, img)
    f["seq_first"] = layers.sequence_first_step(seq, length)
    f["seq_last"] = layers.sequence_last_step(seq, length)
    f["seq_rev"] = layers.sequence_reverse(seq)
    f["seq_reshape"] = layers.sequence_reshape(seq, 15)
    f["seq_enum"] = layers.sequence_enumerate(
        layers.cast(layers.reduce_sum(seq, dim=2), "int64"), win_size=2)
    f["seq_pad"], f["seq_pad_len"] = layers.sequence_pad(
        seq, layers.fill_constant([1], "float32", 0.5), length=length)
    f["fill_bsl"] = layers.fill_constant_batch_size_like(x, [0, 7],
                                                         "float32", 3.5)
    f["uniform_bsl"] = layers.uniform_random_batch_size_like(x, [0, 3])
    f["gaussian_bsl"] = layers.gaussian_random_batch_size_like(x, [0, 3])
    f["counter"] = layers.autoincreased_step_counter()
    f["lod_reset"] = layers.lod_reset(x)
    arr = layers.create_array("float32", 4, template=x)
    i0 = layers.fill_constant(shape=[], dtype="int64", value=1)
    arr = layers.array_write(x, i0, arr)
    f["arr_read"] = layers.array_read(arr, i0)
    f["arr_len"] = layers.array_length(arr)
    f["tensor_array"], f["tensor_array_sizes"] = \
        layers.tensor_array_to_tensor(arr, axis=1)
    f["shape"] = layers.shape(img)
    f["stack"] = layers.stack([x, x], axis=1)
    f["cumsum"] = layers.cumsum(x, axis=1, exclusive=True)
    f["mod"] = layers.elementwise_mod(x, layers.fill_constant([6], "float32",
                                                              0.7))
    f["argmin"] = layers.argmin(x, axis=1)
    f["pad"] = layers.pad(x, [0, 1, 2, 0], pad_value=-1.0)
    f["gather"] = layers.gather(x, layers.argmin(x, axis=0))
    f["expand_as"] = layers.expand_as(half, x)
    f["l2n"] = layers.l2_normalize(x, axis=1)
    f["huber"] = layers.huber_loss(half, other, 0.5)
    f["smooth_l1"] = layers.smooth_l1(x, layers.scale(x, scale=0.5))
    f["mul"] = layers.mul(x, layers.transpose(x, [1, 0]))
    f["ones"] = layers.ones([2, 3], "float32")
    f["zeros"] = layers.zeros([2], "int64")
    f["ones_like"] = layers.ones_like(x)
    f["linspace"] = layers.linspace(0.0, 1.0, 5)
    f["logical_or"] = layers.logical_or(layers.isfinite(x),
                                        layers.has_nan(x))
    f["less_equal"] = layers.less_equal(x, layers.scale(x, scale=0.5))
    return f


def _one_program_feed():
    r = np.random.RandomState(0)
    return {
        "x": r.randn(B, 6).astype(np.float32),
        "img": r.randn(B, 4, 8, 8).astype(np.float32),
        "seq": r.randn(B, 5, 3).astype(np.float32),
        "length": np.array([5, 3, 1, 4], np.int64),
        "lbl": r.randint(0, 2, (B, 1)).astype(np.int64),
    }


_RANDOM = ("uniform_bsl", "gaussian_bsl")


def test_more_layers_one_program():
    """Both packages build the program (the same op types in the same
    order) and give the same values on the same feeds (atol 1e-5; the
    random fills by shape); the port's values pass the JAX test's numpy
    checks."""
    feed = _one_program_feed()
    got, ops = {}, {}
    for fluid in (pfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetches = _one_program(fluid)
        ops[fluid] = [o.type for o in main.global_block().ops]
        names = list(fetches)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            outs = exe.run(main, feed=feed,
                           fetch_list=[fetches[n] for n in names])
        got[fluid] = dict(zip(names, [np.asarray(o) for o in outs]))
    assert ops[tfluid] == ops[pfluid]
    j, t = got[pfluid], got[tfluid]
    for k in j:
        assert t[k].shape == j[k].shape, (k, t[k].shape, j[k].shape)
        if k in _RANDOM:
            continue
        np.testing.assert_allclose(t[k].astype(np.float64),
                                   j[k].astype(np.float64), rtol=0,
                                   atol=1e-5, err_msg=k)
    xv = feed["x"]
    np.testing.assert_allclose(t["brelu"], np.clip(xv, 0, 1), rtol=1e-6)
    np.testing.assert_allclose(t["sign"], np.sign(xv), rtol=1e-6)
    np.testing.assert_allclose(t["cos_sim"].ravel(), np.ones(B), rtol=1e-5)
    assert bool(t["reduce_all"]) and bool(t["isfinite"])
    assert not bool(t["has_inf"]) and not bool(t["has_nan"])
    np.testing.assert_allclose(t["reverse"], xv[:, ::-1], rtol=1e-6)
    np.testing.assert_allclose(t["argsort"], np.sort(xv, 1), rtol=1e-6)
    assert t["rank"].ravel()[0] == 2
    assert t["pad2d"].shape == (B, 4, 10, 12)
    assert t["crop"].shape == (B, 4, 4, 4)
    assert t["pixshuf"].shape == (B, 1, 16, 16)
    assert t["s2d"].shape == (B, 16, 4, 4)
    assert t["resize"].shape == (B, 4, 4, 4)
    assert t["resize_s"].shape == (B, 4, 4, 4)
    assert t["fsp"].shape == (B, 4, 4)
    np.testing.assert_allclose(t["seq_first"], feed["seq"][:, 0], rtol=1e-6)
    expect_last = np.stack([feed["seq"][b, n - 1]
                            for b, n in enumerate(feed["length"])])
    np.testing.assert_allclose(t["seq_last"], expect_last, rtol=1e-6)
    assert t["fill_bsl"].shape == (B, 7) and t["fill_bsl"][0, 0] == 3.5
    assert t["uniform_bsl"].shape == (B, 3)
    assert (np.abs(t["uniform_bsl"]) <= 1.0).all()
    assert t["counter"].ravel()[0] == 1
    np.testing.assert_allclose(t["arr_read"], xv, rtol=1e-6)
    assert t["arr_len"].ravel()[0] == 4
    np.testing.assert_array_equal(t["shape"], [B, 4, 8, 8])
    np.testing.assert_allclose(t["linspace"], np.linspace(0, 1, 5),
                               atol=1e-6)
    for k, v in t.items():
        assert np.isfinite(v.astype(np.float64)).all() or v.dtype == bool, k


def _op(op, ins, attrs):
    out = get_op_def(op).compute(
        {k: [torch.from_numpy(np.asarray(v)) for v in vs]
         for k, vs in ins.items()}, attrs, torch.device("cpu"))
    return {k: [v.numpy() for v in vs] for k, vs in out.items()}


RS = np.random.RandomState


def _bilinear_3x3(x):
    ys = np.linspace(0, 1, 3)
    exp = np.zeros((1, 1, 3, 3))
    for i, fy in enumerate(ys):
        for j, fx in enumerate(ys):
            y0, x0 = int(np.floor(fy)), int(np.floor(fx))
            y1, x1 = min(y0 + 1, 1), min(x0 + 1, 1)
            wy, wx = fy - y0, fx - x0
            exp[0, 0, i, j] = (x[0, 0, y0, x0] * (1 - wy) * (1 - wx)
                               + x[0, 0, y1, x0] * wy * (1 - wx)
                               + x[0, 0, y0, x1] * (1 - wy) * wx
                               + x[0, 0, y1, x1] * wy * wx)
    return exp


def _spot_cases():
    """(op, inputs, attrs, {slot: expected}) from test_ops_extended.py."""
    p = RS(8).uniform(0.05, 0.95, (4, 1))
    y = RS(9).randint(0, 2, (4, 1)).astype(np.float64)
    l_, r_ = RS(10).randn(4, 1), RS(11).randn(4, 1)
    y2 = np.where(RS(12).randint(0, 2, (4, 1)) > 0, 1.0, -1.0)
    logits = RS(13).randn(4, 1)
    xk = np.log(RS(15).dirichlet(np.ones(5), 3))
    tk = RS(16).dirichlet(np.ones(5), 3)
    scores = RS(17).randn(3, 4)
    label = np.array([[1], [0], [3]], np.int64)
    pos = np.take_along_axis(scores, label, 1)
    mask = np.zeros_like(scores)
    np.put_along_axis(mask, label, 1.0, 1)
    a, b = RS(18).randn(3, 5), RS(19).randn(3, 5)
    x = RS(20).randn(3, 4)
    d = RS(21).randn(4)
    xg = RS(22).randn(3, 4)
    idx = np.array([[0, 1], [2, 3]], np.int64)
    upd = RS(23).randn(2)
    scat = xg.copy()
    scat[0, 1] += upd[0]
    scat[2, 3] += upd[1]
    xp = RS(24).randn(1, 2, 3, 3)
    big, small = RS(25).randn(3, 4), RS(26).randn(2, 3)
    xs = RS(27).randn(1, 4, 2, 2)
    x2 = RS(28).randn(1, 4, 2, 2)
    ps = np.transpose(x2.reshape(1, 1, 2, 2, 2, 2),
                      (0, 1, 4, 2, 5, 3)).reshape(1, 1, 4, 4)
    ma, mb = RS(29).randn(3, 2), RS(30).randn(3, 2)
    xi = RS(31).randn(1, 1, 2, 2)
    xn = RS(32).randn(2, 3, 2)
    xc, sc, bc = RS(33).randn(2, 3, 2, 2), RS(34).randn(3), RS(35).randn(3)
    xt, ft = RS(36).randn(2, 5, 3), RS(37).randn(2, 3)
    xtp = np.pad(xt, ((0, 0), (0, 1), (0, 0)))
    xb = RS(38).randn(4, 3, 2, 2)
    mu, var = xb.mean(axis=(0, 2, 3)), xb.var(axis=(0, 2, 3))
    xm = RS(40).randn(1, 1, 1, 4)
    bx, by, bw, bb = (RS(50).randn(3, 4), RS(51).randn(3, 5),
                      RS(52).randn(2, 4, 5), RS(53).randn(2))
    xsc = RS(44).randn(1, 1, 2, 2)
    return {
        "log_loss": ("log_loss", {"Predicted": [p], "Labels": [y]}, {},
                     {"Loss": -(y * np.log(p + 1e-4)
                                + (1 - y) * np.log(1 - p + 1e-4))}),
        "rank_loss": ("rank_loss", {"Label": [y], "Left": [l_],
                                    "Right": [r_]}, {},
                      {"Out": np.logaddexp(0, l_ - r_) - y * (l_ - r_)}),
        "margin_rank_loss": ("margin_rank_loss",
                             {"Label": [y2], "X1": [l_], "X2": [r_]},
                             {"margin": 0.1},
                             {"Out": np.maximum(0, -y2 * (l_ - r_) + 0.1)}),
        "hinge_loss": ("hinge_loss", {"Logits": [logits], "Labels": [y]}, {},
                       {"Loss": np.maximum(0, 1 - (2 * y - 1) * logits)}),
        "kldiv_loss": ("kldiv_loss", {"X": [xk], "Target": [tk]},
                       {"reduction": "mean"},
                       {"Loss": np.mean(np.where(tk > 0, tk * (np.log(tk)
                                                               - xk), 0.0))}),
        "bpr_loss": ("bpr_loss", {"X": [scores], "Label": [label]}, {},
                     {"Y": (np.logaddexp(0, -(pos - scores)) * (1 - mask))
                      .sum(1, keepdims=True) / 3}),
        "cos_sim": ("cos_sim", {"X": [a], "Y": [b]}, {},
                    {"Out": (a * b).sum(-1, keepdims=True) / (
                        np.linalg.norm(a, axis=-1, keepdims=True)
                        * np.linalg.norm(b, axis=-1, keepdims=True))}),
        "reverse": ("reverse", {"X": [x]}, {"axis": [1]},
                    {"Out": x[:, ::-1]}),
        "argsort": ("argsort", {"X": [x]}, {},
                    {"Out": np.sort(x, -1), "Indices": np.argsort(x, -1)}),
        "diag": ("diag", {"Diagonal": [d]}, {}, {"Out": np.diag(d)}),
        "linspace": ("linspace", {"Start": [np.array([0.0])],
                                  "Stop": [np.array([1.0])]},
                     {"num": 5, "dtype": "float64"},
                     {"Out": np.linspace(0, 1, 5)}),
        "gather_nd": ("gather_nd", {"X": [xg], "Index": [idx]}, {},
                      {"Out": xg[[0, 2], [1, 3]]}),
        "scatter_nd_add": ("scatter_nd_add",
                           {"X": [xg], "Index": [idx], "Updates": [upd]},
                           {}, {"Out": scat}),
        "pad2d": ("pad2d", {"X": [xp]}, {"paddings": [1, 1, 2, 2],
                                         "mode": "constant",
                                         "pad_value": 0.5},
                  {"Out": np.pad(xp, ((0, 0), (0, 0), (1, 1), (2, 2)),
                                 constant_values=0.5)}),
        "pad_constant_like": ("pad_constant_like", {"X": [big],
                                                    "Y": [small]},
                              {"pad_value": 1.0},
                              {"Out": np.pad(small, ((0, 1), (0, 1)),
                                             constant_values=1.0)}),
        "crop": ("crop", {"X": [big]}, {"offsets": [1, 1], "shape": [2, 2]},
                 {"Out": big[1:3, 1:3]}),
        "shuffle_channel": ("shuffle_channel", {"X": [xs]}, {"group": 2},
                            {"Out": xs.reshape(1, 2, 2, 2, 2).swapaxes(1, 2)
                             .reshape(1, 4, 2, 2)}),
        "pixel_shuffle": ("pixel_shuffle", {"X": [x2]},
                          {"upscale_factor": 2}, {"Out": ps}),
        "multiplex": ("multiplex", {"X": [ma, mb],
                                    "Ids": [np.array([[0], [1], [0]])]}, {},
                      {"Out": np.stack([ma[0], mb[1], ma[2]])}),
        "shard_index": ("shard_index", {"X": [np.array([[1], [7], [15]])]},
                        {"index_num": 16, "nshards": 2, "shard_id": 0,
                         "ignore_value": -1},
                        {"Out": np.array([[1], [7], [-1]])}),
        "nearest_interp": ("nearest_interp", {"X": [xi]},
                           {"out_h": 4, "out_w": 4, "align_corners": False},
                           {"Out": xi.repeat(2, axis=2).repeat(2, axis=3)}),
        "bilinear_interp": ("bilinear_interp", {"X": [xi]},
                            {"out_h": 3, "out_w": 3, "align_corners": True},
                            {"Out": _bilinear_3x3(xi)}),
        "norm": ("norm", {"X": [xn]}, {"axis": 1},
                 {"Out": xn / np.sqrt((xn * xn).sum(1, keepdims=True)
                                      + 1e-10)}),
        "affine_channel": ("affine_channel", {"X": [xc], "Scale": [sc],
                                              "Bias": [bc]}, {},
                           {"Out": xc * sc.reshape(1, 3, 1, 1)
                            + bc.reshape(1, 3, 1, 1)}),
        "row_conv": ("row_conv", {"X": [xt], "Filter": [ft]}, {},
                     {"Out": xtp[:, 0:5] * ft[0] + xtp[:, 1:6] * ft[1]}),
        "sync_batch_norm": ("sync_batch_norm",
                            {"X": [xb], "Scale": [np.ones(3)],
                             "Bias": [np.zeros(3)], "Mean": [np.zeros(3)],
                             "Variance": [np.ones(3)]}, {"is_test": False},
                            {"Y": (xb - mu.reshape(1, 3, 1, 1)) / np.sqrt(
                                var.reshape(1, 3, 1, 1) + 1e-5)}),
        "nearest_interp_mixed_axes": (
            "nearest_interp", {"X": [xm]},
            {"out_h": 1, "out_w": 7, "align_corners": True},
            {"Out": xm[:, :, :, np.round(np.linspace(0, 3, 7)).astype(int)]}),
        "interp_scale_attr": ("nearest_interp", {"X": [xsc]},
                              {"scale": 2.0, "align_corners": False},
                              {"Out": xsc.repeat(2, 2).repeat(2, 3)}),
        "bilinear_tensor_product": (
            "bilinear_tensor_product",
            {"X": [bx], "Y": [by], "Weight": [bw], "Bias": [bb]}, {},
            {"Out": np.einsum("bi,kij,bj->bk", bx, bw, by) + bb[None, :]}),
    }


_SPOT = _spot_cases()


@pytest.mark.parametrize("case", sorted(_SPOT))
def test_op_matches_the_numpy_spot_check(case):
    op, ins, attrs, want = _SPOT[case]
    got = _op(op, ins, attrs)
    for slot, w in want.items():
        np.testing.assert_allclose(got[slot][0], w, rtol=1e-6, atol=1e-12,
                                   err_msg=slot)


def test_space_to_depth_holds_pixel_shuffles_values():
    x2 = RS(28).randn(1, 4, 2, 2)
    ps = _op("pixel_shuffle", {"X": [x2]}, {"upscale_factor": 2})["Out"][0]
    out = _op("space_to_depth", {"X": [ps]}, {"blocksize": 2})["Out"][0]
    assert out.shape == (1, 4, 2, 2)
    np.testing.assert_allclose(np.sort(out.ravel()), np.sort(x2.ravel()))


def test_anchor_generator_shapes_and_first_anchor():
    feat = np.zeros((1, 8, 4, 4), np.float32)
    out = _op("anchor_generator", {"Input": [feat]},
              {"anchor_sizes": [32.0], "aspect_ratios": [1.0],
               "stride": [16.0, 16.0]})
    assert out["Anchors"][0].shape == (4, 4, 1, 4)
    np.testing.assert_allclose(out["Anchors"][0][0, 0, 0],
                               [8 - 16, 8 - 16, 8 + 16, 8 + 16])


def _train(fluid, build, opt, feeds, fetch="loss"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        model = build(fluid)
        opt(fluid).minimize(model["loss"])
    startup.random_seed = main.random_seed = 5
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return [float(np.asarray(exe.run(main, feed=f,
                                         fetch_list=[model[fetch]])[0]))
                for f in feeds]


def test_hsigmoid_trains():
    """The path-node classifier learns a separable 32-class task."""
    vocab = 32
    r = np.random.RandomState(0)
    protos = r.normal(0, 2, (vocab, 16)).astype(np.float32)
    feeds = []
    for _ in range(120):
        lbl = r.randint(0, vocab, (64, 1)).astype(np.int64)
        feeds.append({"x": protos[lbl[:, 0]] + r.normal(0, 0.1, (64, 16))
                      .astype(np.float32), "y": lbl})

    def build(fluid):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        return {"loss": fluid.layers.mean(fluid.layers.hsigmoid(x, y,
                                                                 vocab))}

    losses = _train(tfluid, build, lambda f: f.optimizer.Adam(5e-2), feeds)
    assert np.mean(losses[-10:]) < 0.65, losses[::24]


def test_hsigmoid_layer_matches_the_manual_power_of_two_path():
    vocab, d, b = 8, 4, 5
    r = np.random.RandomState(1)
    x = r.normal(0, 1, (b, d)).astype(np.float32)
    w = r.normal(0, 1, (vocab - 1, d)).astype(np.float32)
    bias = r.normal(0, 1, (vocab - 1,)).astype(np.float32)
    lbl = np.arange(b).astype(np.int64)[:, None]
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", shape=[d], dtype="float32")
        yv = fluid.layers.data("y", shape=[1], dtype="int64")
        cost = fluid.layers.hsigmoid(
            xv, yv, vocab,
            param_attr=fluid.ParamAttr(
                name="hs.w",
                initializer=fluid.initializer.NumpyArrayInitializer(w)),
            bias_attr=fluid.ParamAttr(
                name="hs.b",
                initializer=fluid.initializer.NumpyArrayInitializer(bias)))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        got = exe.run(main, feed={"x": x, "y": lbl}, fetch_list=[cost])[0]
    exp = np.zeros((b, 1))
    for i in range(b):
        code = int(lbl[i, 0]) + vocab
        for j in range(3):
            shift = 2 - j
            node = (code >> (shift + 1)) - 1
            bit = (code >> shift) & 1
            pre = float(x[i] @ w[node] + bias[node])
            exp[i, 0] += np.log1p(np.exp(pre)) - bit * pre
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)


def test_sample_logits_layer_shapes_and_training_step():
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        logits = fluid.layers.data("logits", shape=[64], dtype="float32")
        lbl = fluid.layers.data("y", shape=[1], dtype="int64")
        s_logits, s_label = fluid.layers.sample_logits(logits, lbl, 16)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(s_logits, s_label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    r = np.random.RandomState(0)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        out = exe.run(main, feed={
            "logits": r.normal(0, 1, (4, 64)).astype(np.float32),
            "y": r.randint(0, 64, (4, 1)).astype(np.int64)},
            fetch_list=[s_logits, loss])
    assert out[0].shape == (4, 17)
    assert np.isfinite(out[1]).all()


def test_nce_layer_trains():
    probe = RS(1).randn(16, 50)
    rng = RS(0)
    feeds = []
    for _ in range(40):
        xv = rng.randn(64, 16).astype(np.float32)
        feeds.append({"x": xv, "label": np.argmax(xv @ probe, 1)
                      .astype(np.int64)[:, None]})

    def build(fluid):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        emb = fluid.layers.fc(x, 24, act="relu",
                              param_attr=fluid.ParamAttr(name="nce_h.w"))
        cost = fluid.layers.nce(emb, label, num_total_classes=50,
                                num_neg_samples=8,
                                param_attr=fluid.ParamAttr(name="nce.w"))
        return {"loss": fluid.layers.mean(cost)}

    losses = _train(tfluid, build, lambda f: f.optimizer.Adam(5e-3), feeds)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8


# --- phase 17 at toy size ---------------------------------------------------

_TOY_NGRAM = dict(vocab=300, emb=16, hidden=32, neg=5, samples=40)


def _ngram(head):
    return lambda fluid: chip_smoke.ngram_head_model(fluid, head,
                                                     **_TOY_NGRAM)


def _adam(fluid):
    return fluid.optimizer.Adam(1e-2)


@pytest.mark.parametrize("head", ["cross_entropy", "hsigmoid"])
def test_toy_ngram_head_trains_as_jax(head):
    """Eight steps from the JAX startup state: every loss within 1e-5,
    the final state (Adam's moments included) within 1e-4 of the largest
    element."""
    feeds = chip_smoke.ngram_feeds(np, 300, 4, 64, 8, 0)
    js, ts, jf, tf, _ = train_both(_ngram(head), _adam, feeds,
                                   lambda m: [m["loss"]])
    jl = [float(s[0]) for s in js]
    tl = [float(np.asarray(s[0])) for s in ts]
    assert max(abs(a - b) / abs(a) for a, b in zip(jl, tl)) < 1e-5, (jl, tl)
    for n, v in jf.items():
        if np.issubdtype(np.asarray(v).dtype, np.floating):
            assert rel(tf[n], v) < 1e-4, (n, rel(tf[n], v))


@pytest.mark.parametrize("head", ["nce", "sampled_softmax"])
def test_toy_random_head_trains_and_caches_equal(head):
    """The heads that draw on the device: the loss falls over 30 steps,
    and cached runs (the step runner's bookkeeping) give the uncached
    runs' losses bit for bit (the draws are a function of the step)."""
    feeds = chip_smoke.ngram_feeds(np, 300, 4, 64, 30, 1)
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        model = _ngram(head)(fluid)
        _adam(fluid).minimize(model["loss"])
    runs = []
    for cached in (False, True):
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            runs.append([float(exe.run(main, feed=f,
                                       fetch_list=[model["loss"]],
                                       use_program_cache=cached)[0])
                         for f in feeds])
    assert runs[0] == runs[1]
    assert np.mean(runs[1][-5:]) < runs[1][0], runs[1]


def test_toy_dcgan_generator_trains_as_jax():
    """The generator at widths 16 -> 8, 4, 3 (32 x 32 images), Adam(2e-3,
    beta1 0.5), four steps from the JAX startup state: losses within
    1e-5, the state within 1e-4."""
    feeds = chip_smoke.dcgan_feeds(np, 4, 4, 0, side=32)

    def build(fluid):
        return chip_smoke.dcgan_generator(fluid, base=16, widths=(8, 4, 3))

    js, ts, jf, tf, _ = train_both(
        build, lambda fluid: fluid.optimizer.Adam(2e-3, beta1=0.5), feeds,
        lambda m: [m["loss"], m["image"]])
    for (jl, ji), (tl, ti) in zip(js, ts):
        assert abs(float(jl) - float(np.asarray(tl))) / float(jl) < 1e-5
        assert rel(ti, ji) < 1e-5
    assert float(np.asarray(ts[-1][0])) < float(np.asarray(ts[0][0]))
    for n, v in jf.items():
        if np.issubdtype(np.asarray(v).dtype, np.floating):
            assert rel(tf[n], v) < 1e-4, (n, rel(tf[n], v))


def test_toy_dcgan_f32_step_held_against_f64_past_a_flipped_gate():
    """chip_smoke.hold_vs_f64, as phase 17c holds the card's f32 step:
    the toy generator's f32 step on the CPU against its f64 step holds
    the loss, every relu gate and every gradient no gate flips; a flip
    planted at the last relu frees the gradients upstream of it (printed,
    not held) and no other: the output layer's stay held."""
    def build():
        return chip_smoke.dcgan_generator(tfluid, base=16, widths=(8, 4, 3))

    main, startup, model, _ = chip_smoke._family_program(
        tfluid, build, lambda: tfluid.optimizer.Adam(2e-4, beta1=0.5),
        False)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    state = {n: scope.find_var(n).numpy() for n in scope.var_names()}
    names = [p.name for p in main.all_parameters() if p.trainable]
    feed = chip_smoke.dcgan_feeds(np, 4, 1, 0, side=32)[0]
    fetch = ([model["loss"]] + [n + "@GRAD" for n in names]
             + [n for _, n in chip_smoke._relu_gates(main)])
    ref, got = (tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={k: v.astype(wide) for k, v in feed.items()},
        fetch_list=fetch, scope=tio.scope_from_numpy(
            {n: v.astype(wide) if v.dtype == np.float32 else v
             for n, v in state.items()}, tfluid.CPUPlace()))
        for wide in (np.float64, np.float32))
    row = chip_smoke.hold_vs_f64(np, main, names, ref, got)
    assert row["flipped_gates"] == {} and row["reached_by_a_flip"] == {}
    assert sorted(row["grad_rel_err"]) == sorted(names)
    assert max(row["grad_rel_err"].values()) < 2e-5
    # a flip planted at the last relu (a pre-activation of 1e-9 of the
    # largest in f64, its negative in f32), the gradients upstream moved
    ref = list(ref)
    ref[-1] = np.array(ref[-1], copy=True)
    planted = [np.array(a, copy=True) for a in got]
    tiny = 1e-9 * np.abs(ref[-1]).max()
    ref[-1].reshape(-1)[0], planted[-1].reshape(-1)[0] = tiny, -tiny
    output = [n for n in names if n.startswith("conv2d_transpose_2.")]
    for j, n in enumerate(names):
        if n not in output:
            planted[1 + j] = planted[1 + j] * 1.01
    row = chip_smoke.hold_vs_f64(np, main, names, ref, planted)
    assert list(row["flipped_gates"]) == [chip_smoke._relu_gates(main)[-1][1]]
    assert sorted(row["grad_rel_err"]) == sorted(output)
    assert sorted(row["reached_by_a_flip"]) == sorted(set(names) - set(output))
    # the same error in the output layer, which no flip reaches, fails
    j = names.index(output[0])
    planted[1 + j] = planted[1 + j] * 1.01
    with pytest.raises(AssertionError):
        chip_smoke.hold_vs_f64(np, main, names, ref, planted)


def test_phase17a_cases_cover_the_slice_and_run_on_the_cpu():
    """chip_smoke.py's 17a list holds every op type of the slice once and
    runs through its runner on the CPU twice to the same values; the
    random ops' properties hold there too."""
    cases = chip_smoke.slice_op_cases(np)
    assert len(cases) == len({c[0] for c in cases}) == 88
    cpu = torch.device("cpu")
    for op, ins, attrs in cases:
        a = chip_smoke.slice_op_run(torch, np, op, ins, attrs, cpu, 3)
        b = chip_smoke.slice_op_run(torch, np, op, ins, attrs, cpu, 3)
        assert sorted(a) == sorted(b), op
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{op} {k}")
        opdef = get_op_def(op)
        if opdef.needs_rng or opdef.host_rng:
            chip_smoke._random_properties(torch, np, op, a, ins, cpu)
