"""BERT pretraining built by the port against the JAX package's, on the
CPU at a toy width (2 layers, d 32, 2 heads, vocab 64, b 4 x t 16), and
the new forward ops it needs (``gelu``, ``greater_than``) with their
layers.

Both packages build the same program; the JAX package's startup weights
are carried across by name, and three Adam steps run in each on the same
``make_batch`` feeds (dropout 0: the packages' dropout bits differ by
design). Tolerances (f32): losses within 2e-6 relative (read <= 3.7e-7),
the MLM logits within 1e-5 of their largest element (read 6.2e-7),
named gradients within 1e-4 (read <= 2.6e-6), final parameters and moments
within 1e-4 (read <= 1.4e-5), but for the attention's key bias, whose
gradient is rounding noise around 0 that Adam's sign-like first steps turn
into steps of +-lr (held to 3 lr). The ops match
within 1e-6 (gelu's erf in two libraries) and exactly (comparisons)."""

import numpy as np
import pytest
import torch
from torch_model_parity import rel, same_programs, train_both

import paddle_tpu as pfluid
from paddle_tpu.core.registry import get_op_def as jax_op
from paddle_tpu.models import bert as pbert

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.registry import get_op_def as torch_op
from paddle_tpu_torch.models import bert as tbert

_CFG = dict(vocab_size=64, max_position=32, d_model=32, d_inner=64,
            n_head=2, n_layer=2, dropout=0.0)


def _ops_both(op, ins, attrs):
    import jax.numpy as jnp

    want = jax_op(op).compute({k: [jnp.asarray(v)] for k, v in ins.items()},
                              dict(attrs))
    got = torch_op(op).compute({k: [torch.from_numpy(v)]
                                for k, v in ins.items()}, dict(attrs),
                               torch.device("cpu"))
    return ({k: np.asarray(v[0]) for k, v in want.items()},
            {k: v[0].numpy() for k, v in got.items()})


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = np.random.RandomState(0).normal(0, 3, (7, 33)).astype(np.float32)
    want, got = _ops_both("gelu", {"X": x}, {"approximate": approximate})
    np.testing.assert_allclose(got["Out"], want["Out"], rtol=0, atol=1e-6)
    # the exact form is not the tanh form
    if not approximate:
        tanh = _ops_both("gelu", {"X": x}, {"approximate": True})[1]["Out"]
        assert np.abs(tanh - got["Out"]).max() > 1e-4


def test_greater_than_matches_jax():
    r = np.random.RandomState(1)
    x = r.randint(-2, 3, (5, 6)).astype(np.float32)
    y = r.randint(-2, 3, (6,)).astype(np.float32)
    want, got = _ops_both("greater_than", {"X": x, "Y": y}, {"axis": -1})
    assert got["Out"].dtype == np.bool_
    np.testing.assert_array_equal(got["Out"], want["Out"])


def test_gelu_and_greater_than_layers_build_the_jax_ops():
    """``fc(act="gelu")``, ``gelu`` and ``greater_than`` append the same
    op types and attrs in both packages, and run to the same values."""
    r = np.random.RandomState(2)
    feed = {"x": r.normal(0, 1, (4, 6)).astype(np.float32)}
    outs = []
    for fluid in (pfluid, tfluid):
        layers = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = layers.data("x", shape=[6], dtype="float32")
            h = layers.fc(x, 5, act="gelu",
                          param_attr=fluid.ParamAttr(
                              name="g.w",
                              initializer=fluid.initializer.
                              ConstantInitializer(0.3)))
            g = layers.gelu(h, approximate=True)
            c = layers.cast(layers.greater_than(g, layers.fill_constant_like(
                g, 0.1)), "float32")
        ops = [(o.type, sorted(o.attrs.items())) for o in
               main.global_block().ops]
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            vals = exe.run(main, feed=feed, fetch_list=[h, g, c])
        outs.append((ops, [np.asarray(v) for v in vals]))
    (jops, jv), (tops, tv) = outs
    assert tops == jops
    assert ("gelu", []) in tops  # fc(act="gelu"): the exact form
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def _model(fluid):
    M = pbert if fluid is pfluid else tbert
    return M.build(M.BertConfig(**_CFG))


def _adam(fluid):
    return fluid.optimizer.Adam(1e-3)


_GRADS = ["bert_tok_emb.w", "bert_pos_emb.w", "enc0_attn_qkv_colp.w",
          "enc1_ffn2_rowp.w", "mlm_tr_colp.w", "mlm_proj_colp.w",
          "nsp.w", "bert_emb_ln.scale"]


def test_bert_programs_match():
    (jops, tops), (jp, tp) = same_programs(_model, _adam)
    assert tops == jops and tp == jp
    assert "gelu" in tops and "greater_than" in tops
    assert tops.count("scaled_dot_product_attention") == _CFG["n_layer"]
    missing = [n for n in _GRADS if n not in tp]
    assert not missing, (missing, sorted(tp))


def test_bert_three_adam_steps_match_jax():
    cfg = tbert.BertConfig(**_CFG)
    feeds = [tbert.make_batch(cfg, 4, 16, seed=s) for s in range(3)]
    want = pbert.make_batch(pbert.BertConfig(**_CFG), 4, 16, seed=2)
    for k, v in want.items():
        np.testing.assert_array_equal(feeds[2][k], v)
    feeds[1]["pad_mask"][:, 12:] = 0.0  # padded keys in one step
    j, t, jf, tf, _ = train_both(
        _model, _adam, feeds,
        lambda m: [m["loss"], m["mlm_loss"], m["nsp_loss"],
                   m["mlm_logits"]] + [n + "@GRAD" for n in _GRADS])
    for step, (a, b) in enumerate(zip(j, t)):
        for i in range(3):
            np.testing.assert_allclose(b[i], a[i], rtol=2e-6,
                                       err_msg=(step, i))
        assert rel(b[3], a[3]) <= 1e-5, (step, rel(b[3], a[3]))
        for n, ga, gb in zip(_GRADS, a[4:], b[4:]):
            assert gb.shape == ga.shape, n
            assert rel(gb, ga) <= 1e-4, (step, n, rel(gb, ga))
    assert t[-1][0] < t[0][0]
    assert sorted(tf) == sorted(jf)
    d = _CFG["d_model"]
    for n, v in jf.items():
        got = tf[n]
        if n.endswith("_attn_qkv_colp.b") or (
                "_attn_qkv_colp.b_moment" in n):
            # the key bias's gradient is 0 in exact arithmetic (softmax
            # is shift-invariant along the keys): Adam's first steps turn
            # its rounding into steps of +-lr, so the key third is held to
            # what three such steps can move and the rest as the others
            key = slice(d, 2 * d)
            if n.endswith(".b"):
                assert np.abs(got[key] - v[key]).max() <= 3 * 1e-3 * 1.01
            got, v = np.delete(got, np.r_[key], -1), np.delete(
                v, np.r_[key], -1)
        # (or within 1e-9: the NSP bias moves by ~3e-7 in three steps)
        assert rel(got, v) <= 1e-4 or np.abs(got - v).max() <= 1e-9, (
            n, rel(got, v))
