"""Row-sparse embedding gradients and the lazy row updates
(ops/sparse_ops.py) in the port, against the JAX package, on the CPU.

The ops on the same numpy inputs (ids with duplicates, the padding id and
row ``vocab - 1``); the six cases of tests/test_sparse_grad.py built by the
port (sparse SGD equals dense, Momentum on touched rows, lazy Adam leaves
untouched rows and moments bit-unchanged, padding rows frozen, and both
refusals); each sparse optimizer's steps against the JAX package's; and
DeepFM's first three Adam steps, dense and sparse.

Tolerances (f32). The port sums duplicate ids' gradients in a doubling
scan's order, the JAX package in index order, so the updated rows agree
within rounding: ops within 1e-6 of their largest element (read <= 1.2e-7),
losses within 2e-6 relative (read <= 6e-7), parameters within 1e-5 of the
largest (read <= 6.1e-6 after Adam's sign-like first steps). Untouched
rows are compared bit for bit."""

import numpy as np
import pytest
import torch
from torch_model_parity import rel, same_programs, train_both

import paddle_tpu as pfluid
from paddle_tpu.core.registry import get_op_def as jax_op
from paddle_tpu.models import deepfm as pdeepfm

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.registry import get_op_def as torch_op
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.ops import sparse_ops

VOCAB, DIM = 64, 8
PAD = 3


def _ids(r, shape, pad=True):
    ids = r.randint(0, VOCAB, shape).astype(np.int64)
    ids.reshape(-1)[:4] = [VOCAB - 1, VOCAB - 1, 7, 7]  # duplicates, last row
    if pad:
        ids.reshape(-1)[4] = PAD
    return ids


def _run_jax(op, ins, attrs):
    """The JAX op as one jitted program (eager JAX compiles each of its
    primitives on its own, which costs more here)."""
    import jax

    def run(arrays):
        outs = jax_op(op).compute({k: [v] for k, v in arrays.items()},
                                  dict(attrs))
        return {k: v[0] for k, v in outs.items()}

    return {k: np.asarray(v) for k, v in jax.jit(run)(ins).items()}


def _run_torch(op, ins, attrs):
    outs = torch_op(op).compute(
        {k: [torch.from_numpy(np.ascontiguousarray(v))]
         for k, v in ins.items()}, dict(attrs), torch.device("cpu"))
    return {k: v[0].numpy() for k, v in outs.items()}


def _sparse_inputs(seed=0):
    r = np.random.RandomState(seed)
    ids = _ids(r, (5, 6))
    g = r.normal(0, 1, (5, 6, DIM)).astype(np.float32)
    grad = _run_torch("lookup_table_sparse_grad", {"Ids": ids,
                                                   "GRAD::Out": g},
                      {"vocab_size": VOCAB, "squeeze_last": False,
                       "padding_idx": PAD})
    return r, ids, g, grad


def test_lookup_table_sparse_grad_matches_jax():
    _, ids, g, got = _sparse_inputs()
    want = _run_jax("lookup_table_sparse_grad",
                    {"Ids": ids, "GRAD::Out": g},
                    {"vocab_size": VOCAB, "squeeze_last": False,
                     "padding_idx": PAD})
    for k in ("Rows", "Values"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["Rows"] == VOCAB).sum() == (ids == PAD).sum()


def test_merge_rows_sums_each_row_once_in_a_fixed_order():
    r = np.random.RandomState(1)
    rows = np.concatenate([r.randint(0, 9, 200), [9, 9]]).astype(np.int32)
    vals = r.normal(0, 1, (202, 3)).astype(np.float32)
    vals[-2:] = -0.0  # a run of -0.0 keeps its sign
    mr, mv = sparse_ops._merge_rows(torch.from_numpy(rows),
                                    torch.from_numpy(vals), 9)
    mr, mv = mr.numpy(), mv.numpy()
    real = mr < 9
    assert sorted(mr[real]) == sorted(set(rows[rows < 9]))
    for row, v in zip(mr[real], mv[real]):
        np.testing.assert_allclose(v, vals[rows == row].sum(0), rtol=0,
                                   atol=2e-6)
    assert np.signbit(vals[-1]).all()
    # sentinel slots (the duplicates and the run of id 9 == vocab) carry 0
    assert (mv[~real] == 0).all()
    again = sparse_ops._merge_rows(torch.from_numpy(rows),
                                   torch.from_numpy(vals), 9)[1].numpy()
    np.testing.assert_array_equal(again, mv)


@pytest.mark.parametrize("op,attrs", [
    ("sgd_sparse", {}),
    ("momentum_sparse", {"mu": 0.9}),
    ("momentum_sparse", {"mu": 0.9, "use_nesterov": True}),
    ("adam_sparse", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
])
def test_sparse_update_ops_match_jax(op, attrs):
    """Touched rows (row vocab - 1 and duplicated ids among them) within
    rounding of the JAX op; every untouched row, the padding row
    included, bit-unchanged in the parameter and each accumulator."""
    r, ids, _, grad = _sparse_inputs(2)
    ins = {"Param": r.normal(0, 1, (VOCAB, DIM)).astype(np.float32),
           "Rows": grad["Rows"], "Values": grad["Values"],
           "LearningRate": np.array([0.1], np.float32)}
    if op == "momentum_sparse":
        ins["Velocity"] = r.normal(0, 1, (VOCAB, DIM)).astype(np.float32)
    if op == "adam_sparse":
        ins.update(Moment1=r.normal(0, 1, (VOCAB, DIM)).astype(np.float32),
                   Moment2=r.uniform(0, 1, (VOCAB, DIM)).astype(np.float32),
                   Beta1Pow=np.array([0.9], np.float32),
                   Beta2Pow=np.array([0.999], np.float32))
    got, want = _run_torch(op, ins, attrs), _run_jax(op, ins, attrs)
    touched = np.zeros(VOCAB, bool)
    touched[np.unique(ids[ids != PAD])] = True
    assert touched[VOCAB - 1] and not touched[PAD]
    for slot, w in want.items():
        g = got[slot]
        assert g.shape == w.shape and g.dtype == w.dtype, slot
        assert rel(g, w) <= 1e-6, (slot, rel(g, w))
        src = ins[{"ParamOut": "Param", "VelocityOut": "Velocity",
                   "Moment1Out": "Moment1", "Moment2Out": "Moment2"}.get(
            slot, slot.replace("Out", ""))]
        if g.shape[0] == VOCAB:
            np.testing.assert_array_equal(g[~touched], src[~touched])
            assert (g[touched] != src[touched]).any(axis=1).all(), slot


# --- the six cases of tests/test_sparse_grad.py, built by the port -------


def _program(fluid, optimizer, is_sparse, padding_idx=None):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = layers.data("ids", shape=[6], dtype="int64")
        y = layers.data("y", shape=[6, DIM], dtype="float32")
        emb = layers.embedding(
            ids, size=[VOCAB, DIM], is_sparse=is_sparse,
            padding_idx=padding_idx, name="emb",
            param_attr=fluid.ParamAttr(name="emb.w"))
        d = layers.elementwise_sub(emb, y)
        loss = layers.mean(layers.elementwise_mul(d, d))
        opt = optimizer(fluid)
        opt.minimize(loss)
    return main, startup, loss, opt


def _batches(n, seed=0, with_dups=True):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = r.randint(0, VOCAB, (4, 6)).astype(np.int64)
        if with_dups:
            ids[:, 1] = ids[:, 0]
        out.append({"ids": ids,
                    "y": r.normal(0, 1, (4, 6, DIM)).astype(np.float32)})
    return out


def _train(optimizer, is_sparse, batches, padding_idx=None):
    """The port's losses and final table from the port's own startup;
    returns (losses, final table, initial table)."""
    main, startup, loss, _ = _program(tfluid, optimizer, is_sparse,
                                      padding_idx)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        w0 = scope.find_var("emb.w").numpy().copy()
        losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                  for f in batches]
    return losses, scope.find_var("emb.w").numpy(), w0


def test_sparse_sgd_matches_dense():
    batches = _batches(8)
    opt = lambda f: f.optimizer.SGD(0.5)  # noqa: E731
    dense_l, dense_w, w0 = _train(opt, False, batches)
    sparse_l, sparse_w, s0 = _train(opt, True, batches)
    np.testing.assert_array_equal(w0, s0)
    np.testing.assert_allclose(dense_l, sparse_l, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dense_w, sparse_w, rtol=1e-5, atol=1e-6)


def test_sparse_momentum_matches_dense_on_touched_rows():
    opt = lambda f: f.optimizer.Momentum(0.2, 0.9)  # noqa: E731
    batches = _batches(6, seed=3)
    _, dense_w, _ = _train(opt, False, batches)
    _, sparse_w, _ = _train(opt, True, batches)
    touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
    untouched = np.setdiff1d(np.arange(VOCAB), touched)
    np.testing.assert_array_equal(dense_w[untouched], sparse_w[untouched])
    # a row touched every step gets the dense update (no lazy decay gap)
    batches2 = _batches(6, seed=4)
    for b in batches2:
        b["ids"][:, 0] = 7
        b["ids"][:, 1] = 7
    _, d_w, _ = _train(opt, False, batches2)
    _, s_w, _ = _train(opt, True, batches2)
    np.testing.assert_allclose(d_w[7], s_w[7], rtol=1e-5, atol=1e-6)


def test_sparse_adam_trains_and_skips_untouched_rows():
    base = _batches(4, seed=5)
    for b in base:
        b["ids"][:] = np.clip(b["ids"], 0, 31)  # rows 32+ never touched
    batches = [base[i % 4] for i in range(40)]
    opt = lambda f: f.optimizer.Adam(5e-2)  # noqa: E731
    losses, w, w0 = _train(opt, True, batches)
    assert np.mean(losses[-4:]) < 0.85 * np.mean(losses[:4]), losses[::4]
    np.testing.assert_array_equal(w[32:], w0[32:])


def test_sparse_padding_idx_rows_frozen():
    batches = _batches(5, seed=6)
    for b in batches:
        b["ids"][:, 2] = 3
    opt = lambda f: f.optimizer.SGD(0.5)  # noqa: E731
    _, w, w0 = _train(opt, True, batches, padding_idx=3)
    np.testing.assert_array_equal(w[3], w0[3])
    assert (w != w0).any()


def test_sparse_shared_table_raises():
    layers = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = layers.data("ids", shape=[4], dtype="int64")
        ids2 = layers.data("ids2", shape=[4], dtype="int64")
        attr = tfluid.ParamAttr(name="shared.w")
        e1 = layers.embedding(ids, size=[VOCAB, DIM], is_sparse=True,
                              param_attr=attr)
        e2 = layers.embedding(ids2, size=[VOCAB, DIM], is_sparse=True,
                              param_attr=attr)
        loss = layers.mean(layers.elementwise_add(e1, e2))
        with pytest.raises(ValueError, match="multiple lookups"):
            tfluid.optimizer.SGD(0.1).minimize(loss)


@pytest.mark.parametrize("penalty_first", [False, True])
def test_sparse_plus_dense_contribution_raises(penalty_first):
    """A dense penalty on a sparse table raises whichever consumer the
    backward visits first: the sparse grad maker's @RENAME check (penalty
    after the lookup) or the backward's combine check (penalty before)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    layers = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = layers.data("ids", shape=[4], dtype="int64")
        attr = tfluid.ParamAttr(name="pen.w")
        if penalty_first:
            w_var = LayerHelper("pen").create_parameter(
                attr, shape=[VOCAB, DIM], dtype="float32")
            penalty = layers.mean(layers.elementwise_mul(w_var, w_var))
        e = layers.embedding(ids, size=[VOCAB, DIM], is_sparse=True,
                             param_attr=attr)
        if not penalty_first:
            w_var = main.global_block().var("pen.w")
            penalty = layers.mean(layers.elementwise_mul(w_var, w_var))
        loss = layers.elementwise_add(layers.mean(e), penalty)
        with pytest.raises(ValueError, match=(
                "cannot be combined" if penalty_first
                else "multiple lookups")):
            tfluid.optimizer.SGD(0.1).minimize(loss)


@pytest.mark.parametrize("name,opt", [
    ("sgd", lambda f: f.optimizer.SGD(0.5)),
    ("momentum", lambda f: f.optimizer.Momentum(0.2, 0.9)),
    ("adam", lambda f: f.optimizer.Adam(5e-2)),
])
def test_sparse_steps_match_jax(name, opt):
    """Four steps from the JAX package's startup state, with the padding
    id and row vocab - 1 in every batch: the same op sequence, losses,
    and final table and accumulators."""
    batches = _batches(4, seed=7)
    for b in batches:
        b["ids"][0, 2], b["ids"][1, 3] = VOCAB - 1, PAD

    def model(fluid):
        layers = fluid.layers
        ids = layers.data("ids", shape=[6], dtype="int64")
        y = layers.data("y", shape=[6, DIM], dtype="float32")
        emb = layers.embedding(ids, size=[VOCAB, DIM], is_sparse=True,
                               padding_idx=PAD, name="emb",
                               param_attr=fluid.ParamAttr(name="emb.w"))
        d = layers.elementwise_sub(emb, y)
        return {"loss": layers.mean(layers.elementwise_mul(d, d))}

    (jops, tops), _ = same_programs(model, opt)
    assert tops == jops and f"{name}_sparse" in tops
    j, t, jf, tf, _ = train_both(model, opt, batches,
                                 lambda m: [m["loss"]])
    for step, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b[0], a[0], rtol=2e-6, err_msg=step)
    for n, v in jf.items():
        if v.ndim == 2 and v.shape[0] == VOCAB:
            assert rel(tf[n], v) <= 1e-5, (n, rel(tf[n], v))
    touched = np.unique(np.concatenate(
        [b["ids"][b["ids"] != PAD].ravel() for b in batches]))
    untouched = np.setdiff1d(np.arange(VOCAB), touched)
    assert PAD in untouched
    for n, v in jf.items():
        if v.ndim == 2 and v.shape[0] == VOCAB:
            np.testing.assert_array_equal(tf[n][untouched], v[untouched])


@pytest.mark.parametrize("opt,match", [
    (lambda f: f.optimizer.AdamW(1e-3), "no row-sparse update op"),
    (lambda f: f.optimizer.Lamb(1e-3), "no row-sparse update op"),
    (lambda f: f.optimizer.Adagrad(1e-3), "no row-sparse update op"),
    (lambda f: f.optimizer.SGD(
        0.1, regularization=f.regularizer.L2Decay(1e-4)), "regularization"),
    (lambda f: _amp(f).decorate(f.optimizer.Adam(1e-3),
                                use_dynamic_loss_scaling=True),
     "dynamic loss scaling"),
])
def test_sparse_refusals_match_jax(opt, match):
    """The optimizers with no sparse op, a decay, and dynamic loss
    scaling refuse a row-sparse gradient in both packages."""
    for fluid in (pfluid, tfluid):
        with pytest.raises(NotImplementedError, match=match):
            _program(fluid, opt, True)


def _amp(fluid):
    from paddle_tpu import amp as pamp
    from paddle_tpu_torch import amp as tamp

    return pamp if fluid is pfluid else tamp


# --- DeepFM ---------------------------------------------------------------

_DEEPFM = dict(num_fields=4, vocab_size=64, embed_dim=4, hidden=(16, 8))


@pytest.mark.parametrize("sparse,distributed", [
    (False, False), (True, False), (True, True)])
def test_deepfm_three_adam_steps_match_jax(sparse, distributed):
    """DeepFM at a toy width (4 fields, 64-row tables, factors of 4, a
    16 x 8 tower), b 16, Adam 1e-3, three steps: the same program, losses
    within 2e-6 relative, logits 1e-5, every parameter and moment within
    1e-5 of its largest element; on the sparse path the rows no batch
    touched keep their bits in the tables and both moments."""
    def model(fluid):
        M = pdeepfm if fluid is pfluid else tdeepfm
        cfg = M.DeepFMConfig(**_DEEPFM)
        return M.build(cfg, is_distributed=distributed, is_sparse=sparse)

    opt = lambda f: f.optimizer.Adam(1e-3)  # noqa: E731
    (jops, tops), (jp, tp) = same_programs(model, opt)
    assert tops == jops and tp == jp
    assert ("adam_sparse" in tops) == sparse
    cfg = tdeepfm.DeepFMConfig(**_DEEPFM)
    feeds = [tdeepfm.make_batch(cfg, 16, seed=s) for s in range(3)]
    want = pdeepfm.make_batch(pdeepfm.DeepFMConfig(**_DEEPFM), 16, seed=1)
    for k, v in want.items():
        np.testing.assert_array_equal(feeds[1][k], v)
    j, t, jf, tf, _ = train_both(model, opt, feeds,
                                 lambda m: [m["loss"], m["logit"]])
    for step, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b[0], a[0], rtol=2e-6, err_msg=step)
        assert rel(b[1], a[1]) <= 1e-5, (step, rel(b[1], a[1]))
    assert sorted(tf) == sorted(jf)
    for n, v in jf.items():
        assert rel(tf[n], v) <= 1e-5, (n, rel(tf[n], v))
    if sparse:
        touched = np.unique(np.concatenate([f["feat_ids"].ravel()
                                            for f in feeds]))
        untouched = np.setdiff1d(np.arange(_DEEPFM["vocab_size"]), touched)
        assert len(untouched) > 0
        tables = [n for n, v in tf.items()
                  if v.ndim == 2 and v.shape[0] == _DEEPFM["vocab_size"]]
        assert len(tables) == 6  # two tables, two moments each
        for n in tables:
            np.testing.assert_array_equal(tf[n][untouched],
                                          jf[n][untouched])
