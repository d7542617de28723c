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


# --- the dropout op's mask (ops/nn_ops.py dropout_plain; the card's
# dropout_apply_kernel gives the same bits, tests/test_torch_cuda.py) ---


@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_op_mask_keep_rate_within_three_sigma(p, dtype):
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import nn_ops

    x = torch.from_numpy(np.random.RandomState(0).randn(64, 500).astype(
        np.float32)).to(dtype)
    out, mask = nn_ops.dropout_plain(x, 2024, p, True)
    assert mask.dtype == torch.uint8 and out.dtype == dtype
    n = mask.numel()
    keep = mask.double().mean().item()
    assert abs(keep - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n)
    kept = mask.bool()
    scaled = (x.float() * rng.keep_scale(p)).to(dtype)
    assert torch.equal(out[kept], scaled[kept])
    assert (out[~kept] == 0).all()
    # the mask does not depend on the dtype, and downgrade_in_infer keeps x
    out_d, mask_d = nn_ops.dropout_plain(x.float(), 2024, p, False)
    assert torch.equal(mask_d, mask)
    assert torch.equal(out_d[kept], x.float()[kept])


def test_dropout_op_mask_from_int_tensor_and_handle_seeds():
    """An int seed, the same op seed in a 0-d tensor, and a seed handle
    whose buffer and index mix to it give the same bits; another seed
    another mask."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import nn_ops

    x = torch.ones(7, 33)
    want = rng.mix64(rng.step_seed(5, 2), 3)
    ref = nn_ops.dropout_plain(x, want, 0.4, True)[1]
    handle = rng.SeedHandle(torch.tensor(rng.step_seed(5, 2)), 3)
    for seed in (torch.tensor(want), handle):
        assert torch.equal(nn_ops.dropout_plain(x, seed, 0.4, True)[1], ref)
    other = nn_ops.dropout_plain(x, want + 1, 0.4, True)[1]
    assert (other != ref).double().mean().item() > 0.2
    # element i hashes (hi32(i), lo32(i)): the mask of a prefix is the
    # prefix of the mask
    flat = nn_ops.dropout_plain(torch.ones(231), want, 0.4, True)[1]
    assert torch.equal(flat, ref.reshape(-1))


def test_dropout_op_masks_move_with_the_step_and_the_grad_follows():
    """Each run of a program is another step: another mask; the grad of
    every run consumes that run's mask."""
    p = 0.35
    x = np.random.RandomState(0).randn(8, 50).astype(np.float32)
    cot = np.random.RandomState(1).randn(8, 50).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = layers.data("x", shape=[8, 50], append_batch_size=False,
                         stop_gradient=False)
        out = layers.dropout(xv, p, dropout_implementation="upscale_in_train")
        c = layers.data("cot", shape=[8, 50], append_batch_size=False)
        loss = layers.reduce_sum(layers.elementwise_mul(out, c))
        append_backward(loss, parameter_list=[])
    mask_name = main.global_block().ops[0].outputs["Mask"][0]
    exe = fluid.Executor(fluid.CPUPlace())
    masks = []
    with fluid.scope_guard(fluid.Scope()):
        for _ in range(3):
            y, dx, mask = exe.run(main, feed={"x": x, "cot": cot},
                                  fetch_list=[out, "x@GRAD", mask_name])
            keep = mask.astype(bool)
            s = np.float32(1.0) / np.float32(1.0 - p)
            np.testing.assert_array_equal(y, np.where(keep, x * s, 0.0))
            np.testing.assert_allclose(dx, np.where(keep, cot * s, 0.0),
                                       rtol=1e-6)
            masks.append(mask)
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[1], masks[2])


def test_attention_plain_versions_take_tensor_seeds():
    """The attention plain versions (and the mask they share) give one
    result for an int seed, the same op seed in a 0-d tensor, and a seed
    handle mixing to it."""
    from paddle_tpu_torch.core import rng

    buf = torch.tensor(rng.step_seed(9, 4))
    want = rng.mix64(rng.step_seed(9, 4), 6)
    seeds = (want, torch.tensor(want), rng.SeedHandle(buf, 6))
    masks = [fa.dropout_keep_mask_plain(s, 2, 3, 20, 24, 0.3) for s in seeds]
    assert all(torch.equal(masks[0], m) for m in masks[1:])
    q, k, v = _qkv(tq=32, tk=48)
    outs = [fa.attention_bthd_plain(q, k, v, None, None, s, 0.3)
            for s in seeds]
    assert all(torch.equal(outs[0][0], o[0]) for o in outs[1:])
    g = torch.ones_like(outs[0][0])
    grads = [fa.attention_bthd_bwd_plain(q, k, v, None, s, *outs[0], g, None,
                                         0.3) for s in seeds]
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))
    bhtd = [fa.attention_plain(*(t.transpose(1, 2) for t in (q, k, v)), None,
                               None, s, 0.3)[0] for s in seeds]
    assert all(torch.equal(bhtd[0], o) for o in bhtd[1:])
