"""The ``__model__`` export and the Predictor against the JAX package, on
the CPU.

- An export written by either package (``save_inference_model``) loads
  and runs in the other (``load_inference_model``, ``Predictor``): logits
  within rtol 1e-4, atol 1e-5 of the exporting package's direct run (as
  ``tests/test_inference_api.py:233``); for the MLP, ``resnet_cifar10``
  and a tiny Transformer. Both packages write the same ``__model__``
  bytes for the same program, so the pruned op lists are equal.
- The crash discipline: a torn export (``save_persistables`` raising,
  patched) publishes nothing; an export parked at ``<dir>.old.tmp`` is
  recovered by the next save and by a load.
- The Predictor cases of ``tests/test_inference_api.py``: direct-run
  parity (rtol 1e-5, atol 1e-6), shape polymorphism, input validation,
  isolated scopes, warmup and ``run_batch``, close, batch buckets (at
  most one captured step a bucket) and their validation.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu import inference as pinference
from paddle_tpu import io as pio
from paddle_tpu.models import resnet as PR
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import transformer as TT

_PKG = {"jax": (pfluid, pio, PT, PR), "torch": (tfluid, tio, TT, TR)}
_TCFG = dict(src_vocab_size=100, trg_vocab_size=100, d_model=32, d_inner=64,
             n_head=2, n_layer=1, max_length=20, dropout=0.0)


def _mlp(fluid, T, R):
    img = fluid.layers.data("img", shape=[64], dtype="float32")
    probs = fluid.layers.softmax(
        fluid.layers.fc(fluid.layers.fc(img, 32, act="relu"), 10))
    feed = {"img": np.random.RandomState(0).randn(4, 64).astype(np.float32)}
    return ["img"], [probs], feed


def _resnet(fluid, T, R):
    img = fluid.layers.data("data", shape=[3, 32, 32], dtype="float32")
    logits = R.resnet_cifar10(img, class_dim=10, depth=20, is_test=True)
    feed = {"data": np.random.RandomState(1).randn(2, 3, 32, 32).astype(
        np.float32)}
    return ["data"], [logits], feed


def _transformer(fluid, T, R):
    cfg = T.TransformerConfig(**_TCFG)
    model = T.build(cfg, is_test=True)
    feed = T.make_batch(cfg, batch=2, src_len=8, trg_len=8, seed=3)
    # the direct run reads the labels (the loss head); the logits do not
    return sorted(set(feed) - {"lbl_ids"}), [model["logits"]], feed


_ZOO = {"mlp": _mlp, "resnet_cifar10": _resnet, "transformer": _transformer}


def _exe(pkg):
    return _PKG[pkg][0].Executor(_PKG[pkg][0].CPUPlace())


def _export(pkg, name, d, weights=None):
    """Build zoo model ``name`` in ``pkg``, run its startup (or set
    ``weights``), run it directly and export it to ``d``. Returns (feed,
    direct fetches, weights, program)."""
    fluid, io, T, R = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, fetches, feed = _ZOO[name](fluid, T, R)
    scope, exe = fluid.Scope(), _exe(pkg)
    with fluid.scope_guard(scope):
        exe.run(startup)
        if weights is not None:
            for n, v in weights.items():
                scope.set(n, torch.tensor(v) if pkg == "torch" else v)
        ref = exe.run(main, feed=feed, fetch_list=fetches)
        io.save_inference_model(d, feeds, fetches, exe, main)
        weights = {v.name: np.array(scope.find_var(v.name))
                   for v in main.list_vars() if v.persistable}
    return feed, ref, weights, main


def _load_and_run(pkg, d, feed):
    fluid, io = _PKG[pkg][:2]
    scope, exe = fluid.Scope(), _exe(pkg)
    with fluid.scope_guard(scope):
        prog, feed_names, fetch_vars = io.load_inference_model(d, exe)
        return prog, exe.run(prog, feed={k: feed[k] for k in feed_names},
                             fetch_list=fetch_vars)


@pytest.mark.parametrize("name", sorted(_ZOO))
def test_export_loads_and_runs_in_the_other_package(name, tmp_path):
    """JAX export -> port run, port export -> JAX run, on the JAX
    startup's weights; both ``__model__`` files are the same bytes."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    feed, jref, weights, _ = _export("jax", name, jd)
    _, tref, _, _ = _export("torch", name, td, weights)
    for r in (jref, tref):
        np.testing.assert_allclose(r[0], jref[0], rtol=1e-4, atol=1e-5)
    tprog, tout = _load_and_run("torch", jd, feed)
    jprog, jout = _load_and_run("jax", td, feed)
    np.testing.assert_allclose(tout[0], jref[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(jout[0], tref[0], rtol=1e-4, atol=1e-5)
    model = [open(os.path.join(d, "__model__"), "rb").read()
             for d in (jd, td)]
    assert model[0] == model[1]
    assert [op.type for op in tprog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]
    with open(os.path.join(jd, "__meta__.json")) as f, \
            open(os.path.join(td, "__meta__.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("name", sorted(_ZOO))
def test_zoo_export_predictor_parity(name, tmp_path):
    """The port's own export through the port's Predictor equals the
    direct run (rtol 1e-4, atol 1e-5)."""
    d = str(tmp_path / name)
    feed, ref, _, _ = _export("torch", name, d)
    pred = tinference.create_predictor(tinference.Config(d).disable_gpu())
    got = pred.run({k: feed[k] for k in pred.get_input_names()})
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


def test_prune_keeps_what_the_targets_need(tmp_path):
    """Training ops and the loss head are pruned away: the exported
    transformer logits program holds no op the JAX export leaves out."""
    progs = []
    for pkg in ("jax", "torch"):
        fluid, io, T, _ = _PKG[pkg]
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            cfg = T.TransformerConfig(**dict(_TCFG, dropout=0.1))
            m = T.build(cfg)
            fluid.optimizer.Adam(1e-3).minimize(m["loss"])
        feeds = ["src_ids", "src_pad_mask", "trg_ids", "trg_pad_mask"]
        progs.append(io._prune_for_inference(main, feeds, [m["logits"]]))
    jp, tp = progs
    assert tp.desc_str() == jp.desc_str()
    types = [op.type for op in tp.global_block().ops]
    assert "adam" not in types and "softmax_with_cross_entropy" not in types
    assert all(op.attrs["is_test"] for op in tp.global_block().ops
               if "is_test" in op.attrs)


# --- crash discipline ----------------------------------------------------


def _small(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8], dtype="float32")
        probs = fluid.layers.softmax(fluid.layers.fc(x, 4))
    return main, startup, probs


def test_torn_export_publishes_nothing_and_parked_exports_recover(
        tmp_path, monkeypatch):
    main, startup, probs = _small(tfluid)
    exe, scope = _exe("torch"), tfluid.Scope()
    d = str(tmp_path / "model")
    xv = np.ones((2, 8), np.float32)
    with tfluid.scope_guard(scope):
        exe.run(startup)
        (ref,) = exe.run(main, feed={"x": xv}, fetch_list=[probs])

        def torn(*a, **k):
            raise OSError("disk full")

        real = tio.save_persistables
        monkeypatch.setattr(tio, "save_persistables", torn)
        with pytest.raises(OSError, match="disk full"):
            tio.save_inference_model(d, ["x"], [probs], exe, main)
        assert not os.path.isdir(d)
        assert os.path.exists(os.path.join(d + ".tmp", "__model__"))
        monkeypatch.setattr(tio, "save_persistables", real)
        tio.save_inference_model(d, ["x"], [probs], exe, main)
        assert not os.path.isdir(d + ".tmp")
        # a crash between the two publish renames parks the old export;
        # the next save restores it before replacing it
        os.rename(d, d + ".old.tmp")
        open(os.path.join(d + ".old.tmp", "marker"), "w").close()
        tio.save_inference_model(d, ["x"], [probs], exe, main)
        assert not os.path.isdir(d + ".old.tmp")
        assert not os.path.exists(os.path.join(d, "marker"))
    # ... and a load alone recovers a parked export too
    os.rename(d, d + ".old.tmp")
    _, (out,) = _load_and_run("torch", d, {"x": xv})
    assert os.path.isdir(d) and not os.path.isdir(d + ".old.tmp")
    np.testing.assert_allclose(out, ref, rtol=1e-6)


# --- the Predictor (tests/test_inference_api.py's cases) ----------------


@pytest.fixture()
def saved_model(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[16], dtype="float32")
        h = tfluid.layers.fc(x, 32, act="relu",
                             param_attr=tfluid.ParamAttr(name="p1.w"),
                             bias_attr=tfluid.ParamAttr(name="p1.b"))
        logits = tfluid.layers.fc(h, 4,
                                  param_attr=tfluid.ParamAttr(name="p2.w"),
                                  bias_attr=tfluid.ParamAttr(name="p2.b"))
        probs = tfluid.layers.softmax(logits)
    exe, scope = _exe("torch"), tfluid.Scope()
    d = str(tmp_path / "model")
    xv = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    with tfluid.scope_guard(scope):
        exe.run(startup)
        (ref,) = exe.run(main, feed={"x": xv}, fetch_list=[probs])
        tio.save_inference_model(d, ["x"], [probs], exe, main)
    return d, xv, ref


def _pred(d, **buckets):
    cfg = tinference.Config(d).disable_gpu()
    if buckets:
        cfg.set_batch_buckets(buckets["sizes"])
    return tinference.create_predictor(cfg)


def _graph_steps(pred):
    """The predictor's compiled steps (one captured graph each on the
    card)."""
    return sum(len(r) for r in pred._exe._runners.values())


def test_predictor_defaults_to_the_card():
    cfg = tinference.Config("unused")
    assert cfg._use_gpu and cfg.disable_gpu() is cfg and not cfg._use_gpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            tinference.Predictor(tinference.Config("unused"))


def test_predictor_matches_direct_run(saved_model):
    d, xv, ref = saved_model
    pred = _pred(d)
    assert pred.get_input_names() == ["x"]
    assert len(pred.get_output_names()) == 1
    (out,) = pred.run([xv])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    (out2,) = pred.run({"x": xv})
    np.testing.assert_allclose(out2, ref, rtol=1e-5, atol=1e-6)
    # the JAX package's Predictor over the port's export
    jpred = pinference.create_predictor(
        pinference.Config(d).disable_tpu())
    np.testing.assert_allclose(jpred.run([xv])[0], ref, rtol=1e-5,
                               atol=1e-6)


def test_predictor_shape_polymorphism(saved_model):
    d, xv, _ = saved_model
    pred = _pred(d)
    for b in (1, 3, 8):
        (out,) = pred.run([xv[:b]])
        assert out.shape == (b, 4)
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    assert _graph_steps(pred) == 3


def test_predictor_input_validation(saved_model):
    d, xv, _ = saved_model
    pred = _pred(d)
    with pytest.raises(ValueError, match="expected 1 inputs"):
        pred.run([xv, xv])
    with pytest.raises(KeyError, match="missing"):
        pred.run({"not_x": xv})


def test_predictor_isolated_scopes(saved_model):
    d, xv, ref = saved_model
    p1, p2 = _pred(d), _pred(d)
    p2.scope.set("p1.w", torch.zeros_like(p2.scope.find_var("p1.w")))
    (out1,) = p1.run([xv])
    np.testing.assert_allclose(out1, ref, rtol=1e-5, atol=1e-6)


def test_predictor_warmup_and_run_batch(saved_model):
    d, xv, ref = saved_model
    pred = _pred(d)
    pred.warmup(shapes={"x": (4, 16)})
    big = np.concatenate([xv, xv[:3]])
    out = pred.run_batch({"x": big}, max_batch_size=4)[0]
    assert out.shape[0] == 11
    np.testing.assert_allclose(out[:8], ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[8:], ref[:3], rtol=1e-5, atol=1e-6)
    # one signature, (4, 16): one lowered program, one compiled step
    assert len(pred._exe._cache) == 1 and _graph_steps(pred) == 1


def test_predictor_close_releases_entries_and_blocks_run(saved_model):
    d, xv, ref = saved_model
    pred = _pred(d)
    (out,) = pred.run([xv])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert len(pred._exe._cache) == 1
    assert len(pred.scope.var_names()) > 0
    pred.close()
    assert len(pred._exe._cache) == 0 and _graph_steps(pred) == 0
    assert pred.scope.var_names() == []
    with pytest.raises(RuntimeError, match="close"):
        pred.run([xv])
    pred.close()  # idempotent


def test_batch_bucketing_bounds_compiled_shapes(saved_model):
    d, xv, _ = saved_model
    exact = _pred(d)
    pred = _pred(d, sizes=[2, 4, 8])
    rng = np.random.RandomState(7)
    sizes = list(rng.randint(1, 11, size=12)) + [1, 10, 8, 3]
    for n in sizes:
        x = rng.randn(int(n), 16).astype(np.float32)
        (out,) = pred.run([x])
        assert out.shape[0] == n
        (want,) = exact.run([x])
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    assert _graph_steps(pred) <= 3
    assert _graph_steps(exact) == len({int(n) for n in sizes})


def test_batch_bucket_validation():
    with pytest.raises(ValueError, match="positive"):
        tinference.Config("x").set_batch_buckets([0, 2])
    with pytest.raises(ValueError, match="positive"):
        tinference.Config("x").set_batch_buckets([])


def test_enable_bf16_marks_the_program(saved_model):
    d, xv, ref = saved_model
    pred = tinference.create_predictor(
        tinference.Config(d).disable_gpu().enable_bf16())
    assert pred.program._amp
    (out,) = pred.run([xv])
    np.testing.assert_allclose(out, ref, atol=2e-2)
