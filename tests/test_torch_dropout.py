"""Dropout in the port, on the CPU: the attention kernels' keep mask (as
its plain version, ``dropout_keep_mask_plain``, rebuilds it bit for bit)
and the ``dropout`` op. The mask bits differ from the JAX package's by
design, so these are properties of the port alone."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.parallel import flash_attention as fa


@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
def test_keep_rate_within_three_sigma(p):
    b, h, tq, tk = 3, 4, 96, 160
    mask = fa.dropout_keep_mask_plain(2024, b, h, tq, tk, p)
    n = mask.numel()
    keep = (mask > 0).double().mean().item()
    assert abs(keep - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n)
    scale = np.float32(1.0) / np.float32(1.0 - p)
    assert set(mask.unique().tolist()) == {0.0, float(scale)}
    # no row or column pattern: each row's keep rate is near 1 - p too
    rows = (mask > 0).double().mean(-1)
    assert (rows - (1 - p)).abs().max().item() <= 5 * np.sqrt(
        p * (1 - p) / tk)


def test_same_seed_same_mask_other_seed_other_mask():
    a = fa.dropout_keep_mask_plain(7, 2, 2, 64, 64, 0.2)
    assert torch.equal(a, fa.dropout_keep_mask_plain(7, 2, 2, 64, 64, 0.2))
    for other in (8, 7 + (1 << 32)):  # low and high seed words both count
        c = fa.dropout_keep_mask_plain(other, 2, 2, 64, 64, 0.2)
        assert (a != c).double().mean().item() > 0.2


def test_mask_depends_on_absolute_positions_not_tiling():
    """The mask of a (tq, tk) attention is the top-left block of the mask
    of a larger one: a kernel tile at any offset regenerates the same
    bits from its absolute row and column."""
    big = fa.dropout_keep_mask_plain(99, 2, 3, 256, 512, 0.1)
    for tq, tk in ((32, 64), (100, 77), (256, 128)):
        small = fa.dropout_keep_mask_plain(99, 2, 3, tq, tk, 0.1)
        assert torch.equal(small, big[:, :, :tq, :tk])
    # the per-batch/head streams are distinct
    assert not torch.equal(big[0, 0], big[0, 1])
    assert not torch.equal(big[0, 0], big[1, 0])


def test_dump_layout_on_cpu_is_the_plain_mask():
    got = fa.dropout_keep_mask(5, 2, 3, 16, 24, 0.25, "cpu")
    ref = fa.dropout_keep_mask_plain(5, 2, 3, 16, 24, 0.25)
    assert got.shape == (2, 16, 3, 24)
    assert torch.equal(got, ref.permute(0, 2, 1, 3))


def _qkv(b=2, tq=64, tk=96, h=2, dh=16, seed=0):
    r = np.random.RandomState(seed)
    return [torch.from_numpy((r.randn(b, t, h, dh) * 0.5).astype(np.float32))
            for t in (tq, tk, tk)]


def test_dv_is_exactly_linear_in_the_output_gradient():
    """out is linear in v for a fixed mask, so sum(out) along v + dir and
    v - dir differs by exactly 2 <dv, dir> when the backward replays the
    forward's mask (the counterpart of the JAX package's
    test_bthd_dropout_grad_v_linear)."""
    q, k, v = _qkv()
    seed, p = 5, 0.4

    def f(vv):
        out, _ = fa.flash_attention_bthd_with_lse(q, k, vv, None, seed, None,
                                                  p)
        return out.double().sum()

    vv = v.clone().requires_grad_()
    (dv,) = torch.autograd.grad(f(vv), vv)
    direction = torch.from_numpy(
        np.random.RandomState(9).randn(*v.shape).astype(np.float32) * 0.01)
    fd = (f(v + direction) - f(v - direction)).item() / 2.0
    np.testing.assert_allclose((dv * direction).sum().item(), fd, rtol=5e-3)
    # and a backward with another seed does not give the same dv
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, seed=seed, p_drop=p)
    g = torch.ones_like(out)
    _, _, dv_same = fa.flash_attention_bthd_bwd(q, k, v, None, seed, out, lse,
                                                g, None, p)
    _, _, dv_other = fa.flash_attention_bthd_bwd(q, k, v, None, seed + 1, out,
                                                 lse, g, None, p)
    np.testing.assert_allclose(dv_same.numpy(), dv.numpy(), atol=1e-6)
    assert not torch.allclose(dv_same, dv_other, atol=1e-3)


def test_sdpa_grad_op_replays_the_forward_seed():
    """In a program, the attention grad op regenerates the forward op's
    mask: <V@GRAD, dir> equals the finite difference of the loss along
    dir, each loss from a fresh executor (whose first run draws the same
    seeds)."""
    q, k, v = (t.numpy() for t in _qkv(seed=3))
    cot = np.random.RandomState(4).randn(2, 64, 2, 16).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        block = main.global_block()
        for name, a in (("q", q), ("k", k), ("v", v)):
            block.create_var(name=name, shape=list(a.shape), dtype="float32",
                             stop_gradient=name != "v")
        out = block.create_var(name="ctx")
        lse = block.create_var(name="lse", stop_gradient=True)
        block.append_op(
            "scaled_dot_product_attention",
            inputs={"Q": "q", "K": "k", "V": "v"},
            outputs={"Out": out, "Lse": lse},
            attrs={"scale": 0.25, "dropout_prob": 0.4, "is_test": False,
                   "layout": "bthd", "causal": True})
        c = layers.data("cot", shape=list(cot.shape), dtype="float32",
                        append_batch_size=False)
        loss = layers.reduce_sum(layers.elementwise_mul(out, c))
        append_backward(loss, parameter_list=[])

    def run(vv, fetch):
        with fluid.scope_guard(fluid.Scope()):
            return fluid.Executor(fluid.CPUPlace()).run(
                main, feed={"q": q, "k": k, "v": vv, "cot": cot},
                fetch_list=fetch)

    _, dv = run(v, [loss, "v@GRAD"])
    direction = np.random.RandomState(6).randn(*v.shape).astype(
        np.float32) * 0.01
    fd = (float(run(v + direction, [loss])[0])
          - float(run(v - direction, [loss])[0])) / 2.0
    np.testing.assert_allclose(float((dv * direction).sum()), fd, rtol=5e-3)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_op_and_its_grad_share_one_mask(impl):
    p = 0.35
    x = np.random.RandomState(0).randn(8, 50).astype(np.float32)
    cot = np.random.RandomState(1).randn(8, 50).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = layers.data("x", shape=[8, 50], append_batch_size=False,
                         stop_gradient=False)
        out = layers.dropout(xv, p, dropout_implementation=impl)
        c = layers.data("cot", shape=[8, 50], append_batch_size=False)
        loss = layers.reduce_sum(layers.elementwise_mul(out, c))
        append_backward(loss, parameter_list=[])
        test_out = layers.dropout(xv, p, is_test=True,
                                  dropout_implementation=impl)
    mask_name = main.global_block().ops[0].outputs["Mask"][0]
    with fluid.scope_guard(fluid.Scope()):
        y, dx, mask, y_test = fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"x": x, "cot": cot},
            fetch_list=[out, "x@GRAD", mask_name, test_out])
    keep = mask.astype(bool)
    assert mask.dtype == np.uint8 and 0.5 < keep.mean() < 0.8
    s = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y, np.where(keep, x * s, 0.0), rtol=1e-6)
    np.testing.assert_allclose(dx, np.where(keep, cot * s, 0.0), rtol=1e-6)
    t = 1.0 if impl == "upscale_in_train" else 1.0 - p
    np.testing.assert_allclose(y_test, x * t, rtol=1e-6)
