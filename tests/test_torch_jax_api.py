"""The port's public calls take the JAX package's arguments, on the CPU.

Each test calls both packages exactly as the JAX package is called and
holds the port to the same result:

- ``flash_attention_bthd_fwd`` in the JAX package's positional order
  ``(q, k, v, bias, seed, scale, p_drop, causal)``;
- the plain forward casts the probabilities to v's dtype before the
  context product, as the JAX reference and every JAX forward kernel do,
  so at bf16 its output equals theirs but for rare one-ulp ties;
- ``Executor.run`` / ``run_steps`` with ``return_numpy`` and
  ``use_program_cache`` in the JAX package's positions;
- ``io.load_params(executor, dirname, main_program, filename)``, which
  refuses a file that lacks a parameter of the program;
- the layers' JAX keywords (every public layer the port shares with the
  JAX package takes the JAX package's parameters in its order);
- heads up to 256 wide (the JAX small kernel's dh = 256) take the
  kernels on the card, with no dense call; a wider head raises there;
- ``async_fetch=True`` returns ``LazyFetches`` (numpy elements, ``ready``,
  ``wait()``) from ``run`` and ``run_steps``, as the JAX package does,
  and ``return_numpy=False`` still returns tensors;
- ``top_k`` puts the lower index first among equal values, as
  ``jax.lax.top_k`` does, index for index, and ``accuracy`` on tied
  logits reads the same share in both packages.

The JAX side runs its Pallas kernels in interpret mode. Inputs come from
numpy seeds; tolerances are stated at each test."""

import inspect
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pfluid
from paddle_tpu import executor as pexecutor
from paddle_tpu import io as pio
from paddle_tpu import layers as players
from paddle_tpu.parallel import flash_attention as jfa

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import kernels
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.parallel import flash_attention as tfa


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _qkv(b, tq, tk, h, dh, seed, scale=0.3):
    r = np.random.RandomState(seed)
    q, k, v = ((r.randn(b, t, h, dh) * scale).astype(np.float32)
               for t in (tq, tk, tk))
    lens = r.randint(tk // 2, tk + 1, b)
    keep = np.arange(tk)[None, :] < lens[:, None]
    bias = ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias


# --- flash_attention_bthd_fwd: the JAX package's argument order ----------


@pytest.mark.parametrize("causal", [False, True])
def test_bthd_fwd_takes_the_jax_positional_order(causal):
    """One positional call (q, k, v, bias, seed, scale, p_drop, causal),
    a scale other than the default: out atol 2e-5, lse atol 1e-5 (f32)."""
    b, t, h, dh = 2, 128, 2, 32
    q, k, v, bias = _qkv(b, t, t, h, dh, seed=1)
    args = (None, 0.2, 0.0, causal)
    j_out, j_lse = jfa.flash_attention_bthd_fwd(
        *(jnp.asarray(x) for x in (q, k, v, bias)), *args)
    t_out, t_lse = tfa.flash_attention_bthd_fwd(
        *(torch.from_numpy(x) for x in (q, k, v, bias)), *args)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)


# --- the plain forward's bf16 rounding of P --------------------------------


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|."""
    return float(np.exp2(np.floor(np.log2(abs(x))) - 7))


def test_plain_bf16_forward_rounds_p_as_the_jax_package():
    """bf16 b2 t256 h4 dh64: the plain output equals the JAX reference
    (``_reference_attention_bthd``) and the interpret-mode small kernel
    in at least 99.5% of elements, and is within one bf16 ulp of the
    largest output everywhere (an output that sums terms of both signs
    keeps the terms' absolute error). With P kept in f32 for the context
    product, 41.6% differ."""
    b, t, h, dh = 2, 256, 4, 64
    q, k, v, bias = _qkv(b, t, t, h, dh, seed=2, scale=1.0)
    scale = float(1.0 / np.sqrt(dh))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    tq_, tk_, tv_ = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in (q, k, v))
    ref = np.asarray(jfa._reference_attention_bthd(
        jq, jk, jv, jnp.asarray(bias), scale).astype(jnp.float32))
    assert jfa._use_bthd_small(t, t)
    small, _ = jfa.flash_attention_bthd_fwd(jq, jk, jv, jnp.asarray(bias),
                                            None, scale)
    small = np.asarray(small.astype(jnp.float32))
    out, _ = tfa.attention_bthd_plain(tq_, tk_, tv_, torch.from_numpy(bias),
                                      scale)
    out = out.float().numpy()
    for name, want in (("reference", ref), ("small kernel", small)):
        diff = np.abs(out - want)
        assert (diff == 0).mean() >= 0.995, (name, (diff > 0).mean())
        assert diff.max() <= _bf16_ulp(np.abs(want).max()), (name, diff.max())


# --- Executor.run / run_steps: return_numpy, use_program_cache ------------


def _fc_program(fluid, layers):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[6], dtype="float32")
        y = layers.fc(x, 4, param_attr=fluid.ParamAttr(name="api_fc.w"),
                      bias_attr=fluid.ParamAttr(name="api_fc.b"), act="relu")
    return main, startup, y


_W = np.random.RandomState(3).randn(6, 4).astype(np.float32)
_B = np.random.RandomState(4).randn(4).astype(np.float32)
_X = np.random.RandomState(5).randn(3, 6).astype(np.float32)


def _run_both(call):
    """``call(fluid, exe, main, y)`` in each package on the same weights:
    (JAX result, port result, port executor)."""
    results = []
    for fluid, layers in ((pfluid, players), (tfluid, tlayers)):
        main, startup, y = _fc_program(fluid, layers)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            scope.set("api_fc.w", _W if fluid is pfluid
                      else torch.from_numpy(_W))
            scope.set("api_fc.b", _B if fluid is pfluid
                      else torch.from_numpy(_B))
            results.append(call(fluid, exe, main, y))
    return results[0], results[1], exe


@pytest.mark.parametrize("return_numpy", [True, False])
def test_run_takes_return_numpy_in_the_jax_position(return_numpy):
    """run(program, feed, fetch_list, scope, return_numpy): numpy arrays
    when True, device tensors when False; values equal (atol 1e-6)."""
    j, t, _ = _run_both(lambda fluid, exe, main, y: exe.run(
        main, {"x": _X}, [y], None, return_numpy))
    if return_numpy:
        assert isinstance(t[0], np.ndarray)
    else:
        assert isinstance(t[0], torch.Tensor)
    np.testing.assert_allclose(np.asarray(t[0]), np.asarray(j[0]), atol=1e-6)


@pytest.mark.parametrize("use_program_cache", [True, False])
def test_run_takes_use_program_cache(use_program_cache):
    """run(..., return_numpy, use_program_cache): False lowers the program
    afresh and keeps nothing; the fetches are the same either way."""
    j, t, exe = _run_both(lambda fluid, exe, main, y: exe.run(
        main, {"x": _X}, [y], None, True, use_program_cache))
    np.testing.assert_allclose(t[0], np.asarray(j[0]), atol=1e-6)
    # the startup program's run is cached; the main program's only when
    # asked to
    assert len(exe._cache) == (2 if use_program_cache else 1)


def test_run_steps_takes_return_numpy():
    """run_steps(program, feed_list, steps, fetch_list, scope,
    return_numpy=False): the last step's fetches as device tensors."""
    j, t, _ = _run_both(lambda fluid, exe, main, y: exe.run_steps(
        main, [{"x": _X}, {"x": _X * 2}], 2, [y], None, False))
    assert isinstance(t[0], torch.Tensor)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-6)


# --- async_fetch: LazyFetches ----------------------------------------------


@pytest.mark.parametrize("entry", ["run", "run_steps"])
def test_async_fetch_returns_lazy_fetches(entry):
    """run / run_steps(..., async_fetch=True) return LazyFetches in both
    packages: list-like, not materialized until read, numpy elements
    (values atol 1e-6), ``wait()`` idempotent; with return_numpy=False
    the port still returns its tensors."""
    def call(fluid, exe, main, y, **kw):
        if entry == "run":
            return exe.run(main, {"x": _X}, [y], **kw)
        return exe.run_steps(main, [{"x": _X}, {"x": _X * 2}], 2, [y],
                             **kw)

    j, t, _ = _run_both(lambda fluid, exe, main, y: call(
        fluid, exe, main, y, async_fetch=True))
    assert isinstance(j, pexecutor.LazyFetches)
    assert isinstance(t, texecutor.LazyFetches)
    assert len(t) == 1 and not t.ready
    got = t.wait()
    assert t.ready and t.wait() is got
    assert isinstance(got, list) and isinstance(t[0], np.ndarray)
    assert [type(a) for a in t] == [np.ndarray]
    np.testing.assert_allclose(t[0], np.asarray(j[0]), atol=1e-6)
    _, tt, _ = _run_both(lambda fluid, exe, main, y: call(
        fluid, exe, main, y, return_numpy=False, async_fetch=True))
    assert isinstance(tt, list) and isinstance(tt[0], torch.Tensor)
    np.testing.assert_allclose(tt[0].numpy(), t[0], atol=0)


# --- top_k: the order among ties --------------------------------------------


def _tied_rows():
    """(rows, k): a row of the ROADMAP's, an all-zero row, and 4 x 1000
    values in {0, 1, 2}."""
    r = np.random.RandomState(12)
    return [
        (np.array([[1, 3, 3, 3, 0, 3, 2, 3]], np.float32), 3),
        (np.zeros((1, 40), np.float32), 5),
        (r.randint(0, 3, (4, 1000)).astype(np.float32), 5),
    ]


def _run_layer(fluid, layers, build, feeds):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        v = {n: layers.data(n, shape=list(a.shape[1:]), dtype=a.dtype.name)
             for n, a in feeds.items()}
        outs = build(layers, v)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        return [np.asarray(o) for o in exe.run(main, feeds, list(outs))]


@pytest.mark.parametrize("case", range(3))
def test_top_k_breaks_ties_as_jax(case):
    """Equal values come lowest index first, as jax.lax.top_k orders
    them: the port's top_k op equals the JAX package's index for index
    (and value for value) on rows full of ties."""
    x, k = _tied_rows()[case]
    want = _run_layer(pfluid, players,
                      lambda L, v: L.topk(v["x"], k), {"x": x})
    got = _run_layer(tfluid, tlayers,
                     lambda L, v: L.topk(v["x"], k), {"x": x})
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    if case == 0:
        np.testing.assert_array_equal(got[1], [[1, 2, 3]])


def test_accuracy_on_tied_logits_matches_jax():
    """accuracy reads top_k's indices: on logits tied at their maximum
    (values in {0, 1} over 40 classes), each label is the 3rd or the 8th
    index holding the row's maximum, inside or outside a stable top 5;
    both packages report the same share (exactly), 0.5."""
    r = np.random.RandomState(13)
    x = r.randint(0, 2, (8, 40)).astype(np.float32)
    label = np.array([[np.flatnonzero(row == row.max())[2 if i % 2 else 7]]
                      for i, row in enumerate(x)], np.int64)
    feeds = {"x": x, "label": label}
    build = lambda L, v: [L.accuracy(v["x"], v["label"], k=5)]  # noqa: E731
    want = _run_layer(pfluid, players, build, feeds)[0]
    got = _run_layer(tfluid, tlayers, build, feeds)[0]
    assert float(got) == float(want) == 0.5


# --- io.load_params --------------------------------------------------------


def test_load_params_loads_the_program_parameters(tmp_path):
    """The JAX package saves the parameters; the port's load_params(exe,
    dirname, main_program) puts them into the current scope, where the
    program runs on them."""
    main, startup, y = _fc_program(pfluid, players)
    with pfluid.scope_guard(pfluid.Scope()):
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup)
        pio.save_params(exe, str(tmp_path), main)
        want = exe.run(main, {"x": _X}, [y])[0]
    tmain, tstartup, ty = _fc_program(tfluid, tlayers)
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstartup)
        assert tio.load_params(texe, str(tmp_path), tmain) is None
        got = texe.run(tmain, {"x": _X}, [ty])[0]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_load_params_refuses_a_partial_file(tmp_path):
    """A file without one of the program's parameters raises, as the JAX
    package's does, and loads none of the others."""
    np.savez(tmp_path / "weights.npz", **{"api_fc.w": _W})
    for fluid, layers, io in ((pfluid, players, pio), (tfluid, tlayers, tio)):
        main, startup, _ = _fc_program(fluid, layers)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            before = np.array(scope.find_var("api_fc.w"))
            with pytest.raises(RuntimeError, match="refusing to partially"):
                io.load_params(exe, str(tmp_path), main, "weights.npz")
            np.testing.assert_array_equal(
                np.array(scope.find_var("api_fc.w")), before)


# --- the layers' JAX keywords ---------------------------------------------


def _shared_layers():
    names = []
    for name in sorted(dir(tlayers)):
        fn = getattr(tlayers, name)
        if (name.startswith("_") or not inspect.isfunction(fn)
                or not inspect.isfunction(getattr(players, name, None))):
            continue
        names.append(name)
    return names


def _params(fn):
    return [p for p in inspect.signature(fn).parameters
            if p not in ("args", "kwargs")]


def test_shared_layers_take_the_jax_parameters_in_order():
    names = _shared_layers()
    assert len(names) >= 30, names
    for name in names:
        want = _params(getattr(players, name))
        got = _params(getattr(tlayers, name))
        assert got[:len(want)] == want, (name, want, got)


# (layer call with the JAX keywords, feeds): each builds one output
_KEYWORD_CALLS = {
    "fc(is_test)": (lambda L, fluid, v: L.fc(
        v["x"], 3, param_attr=fluid.ParamAttr(name="kw_fc.w"),
        bias_attr=False, is_test=True), ["x"]),
    "embedding(is_sparse, is_distributed)": (lambda L, fluid, v: L.embedding(
        v["ids"], [10, 3], is_sparse=False, is_distributed=True,
        param_attr=fluid.ParamAttr(name="kw_emb.w")), ["ids"]),
    "reshape(actual_shape, inplace)": (lambda L, fluid, v: L.reshape(
        v["x"], [-1, 12], actual_shape=None, inplace=True), ["x"]),
    "less_than(force_cpu)": (lambda L, fluid, v: L.cast(L.less_than(
        v["x"], v["y"], force_cpu=True), "float32"), ["x", "y"]),
    "softmax_with_cross_entropy(numeric_stable_mode)": (
        lambda L, fluid, v: L.softmax_with_cross_entropy(
            v["x"], v["label"], False, -100, True), ["x", "label"]),
    "softmax(use_cudnn, axis)": (lambda L, fluid, v: L.softmax(
        v["x"], use_cudnn=True, name=None, axis=0), ["x"]),
    "log_softmax(axis)": (lambda L, fluid, v: L.log_softmax(
        v["x"], axis=-1), ["x"]),
    "log": (lambda L, fluid, v: L.log(L.abs(v["x"])), ["x"]),
    "create_global_var(force_cpu)": (lambda L, fluid, v: L.elementwise_add(
        v["x"], L.create_global_var([1], 0.5, "float32", True, True,
                                    name="kw_gv")), ["x"]),
}

_FEEDS = {
    "x": np.random.RandomState(6).randn(4, 6).astype(np.float32),
    "y": np.random.RandomState(7).randn(4, 6).astype(np.float32),
    "ids": np.random.RandomState(8).randint(0, 10, (4, 5)).astype(np.int64),
    "label": np.random.RandomState(9).randint(0, 6, (4, 1)).astype(np.int64),
}
_DECL = {"x": ([6], "float32"), "y": ([6], "float32"), "ids": ([5], "int64"),
         "label": ([1], "int64")}


@pytest.mark.parametrize("case", sorted(_KEYWORD_CALLS))
def test_layer_takes_the_jax_keywords(case):
    """The same call in both packages builds and runs; outputs within
    atol 1e-5 on the same weights."""
    build, feeds = _KEYWORD_CALLS[case]
    outs = []
    weights = {}
    for fluid, layers in ((pfluid, players), (tfluid, tlayers)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            v = {n: layers.data(n, shape=_DECL[n][0], dtype=_DECL[n][1])
                 for n in feeds}
            out = build(layers, fluid, v)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            for p in main.all_parameters():
                if fluid is pfluid:
                    weights[p.name] = np.asarray(scope.find_var(p.name))
                else:
                    scope.set(p.name, torch.tensor(weights[p.name]))
            outs.append(exe.run(main, {n: _FEEDS[n] for n in feeds},
                                [out])[0])
    np.testing.assert_allclose(outs[1], np.asarray(outs[0]), atol=1e-5)


def test_variable_takes_the_jax_kind():
    """framework.Variable(..., kind) keeps the VarDesc kind it is given;
    a var is a dense tensor unless it says otherwise."""
    block = tfluid.Program().global_block()
    dense = tframework.Variable(block, "v_dense", shape=[2])
    other = tframework.Variable(block, "v_other", shape=[2], kind=7)
    assert dense.kind == tframework.DENSE_TENSOR == 0
    assert other.kind == 7
    assert "kind" in _params(pfluid.framework.Variable.__init__)


def test_embedding_is_sparse_raises_until_ported():
    """The row-sparse gradient of is_sparse=True is not ported: the layer
    refuses it rather than train with dense updates."""
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        ids = tlayers.data("ids", shape=[5], dtype="int64")
        with pytest.raises(NotImplementedError, match="is_sparse"):
            tlayers.embedding(ids, [10, 3], is_sparse=True)


# --- dh > 128 --------------------------------------------------------------


def test_wide_heads_match_the_jax_small_kernel():
    """dh = 256 at t <= 512: the JAX package takes its small kernel
    (interpret mode), the port its plain composition; out atol 2e-5, lse
    atol 1e-5 (f32), and both name the same route."""
    b, t, h, dh = 1, 64, 2, 256
    assert tfa.attention_route(t, t, h, dh) == "small"
    assert jfa._use_bthd_small(t, t)
    q, k, v, bias = _qkv(b, t, t, h, dh, seed=10)
    scale = float(1.0 / np.sqrt(dh))
    j_out, j_lse = jfa.flash_attention_bthd_fwd(
        *(jnp.asarray(x) for x in (q, k, v, bias)), None, scale, 0.0, True)
    t_out, t_lse = tfa.flash_attention_bthd_fwd(
        *(torch.from_numpy(x) for x in (q, k, v, bias)), None, scale, 0.0,
        True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dh,takes", [(64, True), (128, True), (136, True),
                                      (256, True), (264, False)])
def test_wide_heads_launch_the_kernels_on_the_card(dh, takes):
    """The dispatch for a card tensor (only its device kind and shape are
    read): a kernel route never hands a head of any width to the plain
    composition (no dense call), and the launch check takes heads up to
    KERNEL_MAX_DH (256) and raises above it."""
    q = types.SimpleNamespace(device=torch.device("cuda", 0),
                              shape=(1, 64, 2, dh))
    kernels.reset_counts()
    assert tfa._takes_plain("flash_attention_bthd_fwd", q, "small") is False
    assert kernels.launch_counts["attention_dense"] == 0
    assert tfa.KERNEL_MAX_DH == 256
    q, k, v = (torch.empty(1, 64, 2, dh, dtype=torch.bfloat16, device="meta")
               for _ in range(3))
    if takes:
        tfa._check_qkv("flash_attention_bthd_fwd", q, k, v)
    else:
        with pytest.raises(NotImplementedError, match="dh=264"):
            tfa._check_qkv("flash_attention_bthd_fwd", q, k, v)
