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


# the layers of the op-library slice, by module: each takes exactly the
# JAX twin's parameters in its order
_SLICE_LAYERS = {
    "nn": ["argmin", "bilinear_tensor_product", "conv2d_transpose",
           "cross_entropy", "cumsum", "elementwise_mod", "expand_as",
           "gather", "group_norm", "hsigmoid", "huber_loss", "l2_normalize",
           "logical_or", "lookup_table", "maxout", "mean_iou", "mul", "nce",
           "pad", "prelu", "sample_logits", "smooth_l1", "spectral_norm",
           "stack", "unstack"],
    "tensor": ["create_tensor", "gaussian_random", "linspace", "ones",
               "ones_like", "shape", "uniform_random", "zeros"],
    "more": ["affine_channel", "argsort", "array_length",
             "autoincreased_step_counter", "beam_search",
             "beam_search_decode", "bpr_loss", "continuous_value_model",
             "cos_sim", "crop", "data_norm", "diag", "dice_loss",
             "fill_constant_batch_size_like", "fsp_matrix",
             "gaussian_random_batch_size_like", "grid_sampler", "has_inf",
             "has_nan", "hinge_loss", "image_resize", "image_resize_short",
             "is_empty", "kldiv_loss", "less_equal", "lod_reset", "log_loss",
             "logical_xor", "lstm", "margin_rank_loss", "multiplex",
             "not_equal", "npair_loss", "pad2d", "pad_constant_like",
             "pixel_shuffle", "range", "rank", "rank_loss", "reduce_all",
             "reduce_any", "resize_bilinear", "resize_nearest", "reverse",
             "row_conv", "sampled_softmax_with_cross_entropy", "sampling_id",
             "sequence_concat", "sequence_enumerate", "sequence_expand_as",
             "sequence_first_step", "sequence_last_step", "sequence_pad",
             "sequence_reshape", "sequence_scatter", "sequence_slice",
             "sequence_unpad", "shuffle_channel", "sign", "space_to_depth",
             "sum", "teacher_student_sigmoid_loss", "temporal_shift",
             "tensor_array_to_tensor", "uniform_random_batch_size_like"],
    "detection": ["anchor_generator"],
}


@pytest.mark.parametrize("module", sorted(_SLICE_LAYERS))
def test_slice_layers_take_exactly_the_jax_parameters(module):
    """Every layer the op-library slice added is in the port's module
    and its ``layers`` namespace, with the JAX twin's parameter names in
    the JAX order (defaults included)."""
    import importlib

    jm = importlib.import_module(f"paddle_tpu.layers.{module}")
    tm = importlib.import_module(f"paddle_tpu_torch.layers.{module}")
    for name in _SLICE_LAYERS[module]:
        want = inspect.signature(getattr(jm, name)).parameters
        got = inspect.signature(getattr(tm, name)).parameters
        assert list(got) == list(want), (name, list(want), list(got))
        assert [p.default for p in got.values()] == [
            p.default for p in want.values()], name
        assert getattr(tlayers, name) is getattr(tm, name), name


def test_truncated_normal_initializer_builds_the_jax_op():
    """initializer.TruncatedNormal(Initializer) appends
    truncated_gaussian_random with the JAX package's attrs."""
    ops = []
    for fluid in (pfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fluid.layers.fc(fluid.layers.data("x", shape=[3]), 4,
                            param_attr=fluid.ParamAttr(
                                name="tn.w",
                                initializer=fluid.initializer.TruncatedNormal(
                                    0.5, 0.02, seed=3)))
        op = startup.global_block().ops[0]
        ops.append((op.type, sorted(op.attrs.items())))
    assert ops[0] == ops[1]
    assert ops[1][0] == "truncated_gaussian_random"
    assert tfluid.initializer.TruncatedNormal is \
        tfluid.initializer.TruncatedNormalInitializer


def test_registry_lacks_exactly_the_vision_detection_moe_and_dgc_ops():
    """The JAX forward op types the port does not register are the 22
    vision ops, the 9 detection ops, switch_moe and dgc_momentum; the
    port registers no forward op type the JAX package lacks."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    j = {o for o in jreg.registered_ops() if not o.endswith("_grad")}
    t = {o for o in treg.registered_ops() if not o.endswith("_grad")}
    vision = {"adaptive_pool2d", "adaptive_pool3d", "affine_grid",
              "box_clip", "conv3d", "conv3d_transpose", "density_prior_box",
              "depthwise_conv2d_transpose", "lrn", "max_pool2d_with_index",
              "max_pool3d_with_index", "polygon_box_transform", "pool3d",
              "psroi_pool", "random_crop", "roi_align",
              "roi_perspective_transform", "roi_pool", "similarity_focus",
              "spp", "unpool", "yolo_box"}
    detection = {"box_decoder_and_assign", "collect_fpn_proposals",
                 "detection_map", "distribute_fpn_proposals",
                 "generate_mask_labels", "generate_proposal_labels",
                 "generate_proposals", "rpn_target_assign", "yolov3_loss"}
    assert len(vision) == 22 and len(detection) == 9
    assert j - t == vision | detection | {"switch_moe", "dgc_momentum"}
    assert len(j & t) == 275 and not t - j


_SLICE_FLAGS = ("diff_inputs", "no_grad", "needs_rng")


def test_slice_ops_register_the_jax_flags():
    """Each op of the slice declares the JAX registration's diff_inputs,
    no_grad and needs_rng, except the initializer
    truncated_gaussian_random, which is host_rng as gaussian_random is."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    ops = [o for o in jreg.registered_ops() if treg.has_op(o)]
    for op in ops:
        jd, td = jreg.get_op_def(op), treg.get_op_def(op)
        if op in ("truncated_gaussian_random", "gaussian_random",
                  "uniform_random"):
            assert td.host_rng and td.no_grad and not td.needs_rng, op
            continue
        for flag in _SLICE_FLAGS:
            want, got = getattr(jd, flag), getattr(td, flag)
            if flag == "diff_inputs" and want is not None:
                want = tuple(want)
            assert got == want, (op, flag, want, got)


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
    "gelu(approximate)": (lambda L, fluid, v: L.gelu(
        v["x"], approximate=False, name=None), ["x"]),
    "greater_than(cond)": (lambda L, fluid, v: L.cast(L.greater_than(
        v["x"], v["y"], cond=None), "float32"), ["x", "y"]),
    "sigmoid_cross_entropy_with_logits(ignore_index)": (
        lambda L, fluid, v: L.sigmoid_cross_entropy_with_logits(
            v["x"], L.sigmoid(v["y"]), ignore_index=-100), ["x", "y"]),
    "concat(axis)": (lambda L, fluid, v: L.concat([v["x"], v["y"]], axis=1),
                     ["x", "y"]),
    "create_global_var(force_cpu)": (lambda L, fluid, v: L.elementwise_add(
        v["x"], L.create_global_var([1], 0.5, "float32", True, True,
                                    name="kw_gv")), ["x"]),
    # the activations, reductions, sequence and recurrent layers, each
    # with every keyword the JAX layer takes
    "tanh(name)": (lambda L, fluid, v: L.tanh(v["x"], name="kw_tanh"),
                   ["x"]),
    "square, softplus, softsign, relu6": (lambda L, fluid, v: L.relu6(
        L.softsign(L.softplus(L.square(v["x"])))), ["x"]),
    "swish(beta), hard_swish(threshold, scale, offset)": (
        lambda L, fluid, v: L.hard_swish(L.swish(v["x"], beta=1.5),
                                         threshold=5.0, scale=4.0,
                                         offset=2.0), ["x"]),
    "hard_sigmoid(slope, offset), elu(alpha)": (
        lambda L, fluid, v: L.elu(L.hard_sigmoid(v["x"], slope=0.3,
                                                 offset=0.4), alpha=0.5),
        ["x"]),
    "leaky_relu(alpha, name)": (lambda L, fluid, v: L.leaky_relu(
        v["x"], alpha=0.1, name=None), ["x"]),
    "brelu, soft_relu, stanh, selu": (lambda L, fluid, v: L.selu(L.stanh(
        L.soft_relu(L.brelu(v["x"], t_min=-1.0, t_max=1.0, name=None),
                    threshold=30.0), scale_a=0.5, scale_b=1.5),
        scale=None, alpha=None), ["x"]),
    "matmul(transpose_x, transpose_y, alpha)": (lambda L, fluid, v: L.matmul(
        v["x"], v["y"], transpose_x=False, transpose_y=True, alpha=0.5,
        name=None), ["x", "y"]),
    "reduce_mean, reduce_min, reduce_prod(dim, keep_dim)": (
        lambda L, fluid, v: L.elementwise_add(
            L.reduce_mean(v["x"], dim=1, keep_dim=True, name=None),
            L.elementwise_mul(L.reduce_min(v["x"], dim=[1], keep_dim=True),
                              L.reduce_prod(v["y"], dim=1, keep_dim=True))),
        ["x", "y"]),
    "square_error_cost(input, label)": (lambda L, fluid, v:
                                        L.square_error_cost(
                                            input=v["x"], label=v["y"]),
                                        ["x", "y"]),
    "flatten(axis)": (lambda L, fluid, v: L.flatten(v["s"], axis=2,
                                                    name=None), ["s"]),
    "sequence_pool(pool_type, length)": (lambda L, fluid, v:
                                         L.sequence_pool(
                                             v["s"], pool_type="sqrt",
                                             length=v["n"]), ["s", "n"]),
    "sequence_softmax(length, use_cudnn)": (
        lambda L, fluid, v: L.sequence_softmax(
            v["x"], length=v["n"], use_cudnn=True, name=None), ["x", "n"]),
    "sequence_mask(maxlen, dtype)": (lambda L, fluid, v: L.sequence_mask(
        v["n"], maxlen=6, dtype="float32", name=None), ["n"]),
    "sequence_reverse(length)": (lambda L, fluid, v: L.sequence_reverse(
        v["s"], length=v["n"], name=None), ["s", "n"]),
    "sequence_expand(ref_level)": (lambda L, fluid, v: L.sequence_expand(
        v["x"], v["s"], ref_level=-1, name=None), ["x", "s"]),
    "im2sequence(filter_size, stride, padding, ...)": (
        lambda L, fluid, v: L.im2sequence(
            L.unsqueeze(v["s"], [1]), filter_size=2, stride=[1, 2],
            padding=0, input_image_size=None, out_stride=1, name=None),
        ["s"]),
    "sequence_conv(filter_size, filter_stride, padding, ...)": (
        lambda L, fluid, v: L.sequence_conv(
            v["s"], 3, filter_size=3, filter_stride=1, padding=True,
            param_attr=fluid.ParamAttr(name="kw_sc.w"),
            bias_attr=fluid.ParamAttr(name="kw_sc.b"), act="tanh",
            name=None), ["s"]),
    "add_position_encoding(alpha, beta)": (
        lambda L, fluid, v: L.add_position_encoding(v["s"], alpha=0.5,
                                                    beta=2.0, name=None),
        ["s"]),
    "dynamic_lstm(length, h_0, c_0, ...)": (
        lambda L, fluid, v: L.dynamic_lstm(
            L.fc(v["s"], 8, num_flatten_dims=2), 8, length=v["n"],
            h_0=L.fc(v["x"], 2), c_0=L.fc(v["y"], 2),
            param_attr=fluid.ParamAttr(name="kw_lstm.w"),
            bias_attr=fluid.ParamAttr(name="kw_lstm.b"),
            use_peepholes=False, is_reverse=True,
            gate_activation="sigmoid", cell_activation="tanh",
            candidate_activation="relu", dtype="float32", name=None)[1],
        ["s", "n", "x", "y"]),
    "dynamic_gru(length, h_0, ...)": (
        lambda L, fluid, v: L.dynamic_gru(
            L.fc(v["s"], 6, num_flatten_dims=2), 2, length=v["n"],
            h_0=L.fc(v["x"], 2), param_attr=None, bias_attr=None,
            is_reverse=False, gate_activation="sigmoid",
            candidate_activation="tanh", dtype="float32", name=None),
        ["s", "n", "x"]),
    "dynamic_lstmp(proj_size, ...)": (
        lambda L, fluid, v: L.dynamic_lstmp(
            L.fc(v["s"], 8, num_flatten_dims=2), 8, 3, param_attr=None,
            bias_attr=None, use_peepholes=False, is_reverse=False,
            gate_activation="sigmoid", cell_activation="tanh",
            candidate_activation="tanh", proj_activation="identity",
            dtype="float32", name="kw_lstmp")[0], ["s"]),
    "lstm_unit(forget_bias)": (lambda L, fluid, v: L.lstm_unit(
        v["x"], L.fc(v["y"], 3), L.fc(v["x"], 3), forget_bias=1.0,
        param_attr=None, bias_attr=None, name=None)[1], ["x", "y"]),
    "gru_unit(activation, gate_activation, origin_mode)": (
        lambda L, fluid, v: L.gru_unit(
            L.fc(v["x"], 6), L.fc(v["y"], 2), 6, param_attr=None,
            bias_attr=None, activation="tanh", gate_activation="sigmoid",
            origin_mode=False)[0], ["x", "y"]),
    # slice 20: structured prediction, metrics, host callbacks, control
    # flow and the dense arrays
    "fc(list of inputs, list of param_attrs)": (lambda L, fluid, v: L.fc(
        [v["x"], v["y"]], 3, param_attr=[fluid.ParamAttr(name="kw_fl0.w"),
                                         fluid.ParamAttr(name="kw_fl1.w")],
        act="tanh"), ["x", "y"]),
    "linear_chain_crf(param_attr, length)": (
        lambda L, fluid, v: L.linear_chain_crf(
            v["s"], v["tags"], param_attr=fluid.ParamAttr(name="kw_crfw"),
            length=v["m"]), ["s", "tags", "m"]),
    "crf_decoding(param_attr, label, length)": (
        lambda L, fluid, v: L.crf_decoding(
            v["s"], param_attr=fluid.ParamAttr(name="kw_crfw2"),
            label=v["tags"], length=v["m"]), ["s", "tags", "m"]),
    "warpctc(blank, norm_by_times, input_length, label_length)": (
        lambda L, fluid, v: L.warpctc(
            v["s"], v["lab2"], blank=0, norm_by_times=True,
            input_length=v["m"], label_length=v["k"]),
        ["s", "lab2", "m", "k"]),
    "edit_distance(normalized, input_length, label_length)": (
        lambda L, fluid, v: L.edit_distance(
            v["tags"], v["lab2"], normalized=True, input_length=v["m"],
            label_length=v["k"])[0], ["tags", "lab2", "m", "k"]),
    "chunk_eval(excluded_chunk_types, seq_length)": (
        lambda L, fluid, v: L.chunk_eval(
            v["tags"], L.scale(v["tags"], scale=1.0), chunk_scheme="IOB",
            num_chunk_types=2, excluded_chunk_types=[1],
            seq_length=v["m"])[2], ["tags", "m"]),
    "ctc_greedy_decoder(blank, input_length)": (
        lambda L, fluid, v: L.ctc_greedy_decoder(
            L.softmax(v["s"]), blank=0, input_length=v["m"], name=None)[0],
        ["s", "m"]),
    "hash(hash_size, num_hash)": (lambda L, fluid, v: L.hash(
        v["ids"], hash_size=100, num_hash=2, name=None), ["ids"]),
    "tree_conv(output_size, num_filters, max_depth, act, ...)": (
        lambda L, fluid, v: L.tree_conv(
            v["s"], v["edges"], 3, num_filters=2, max_depth=2, act="tanh",
            param_attr=fluid.ParamAttr(name="kw_tc.w"), bias_attr=None,
            name=None), ["s", "edges"]),
    "Print(first_n, message, summarize, ...)": (lambda L, fluid, v: L.Print(
        v["x"], first_n=1, message="kw", summarize=3,
        print_tensor_name=True, print_tensor_type=True,
        print_tensor_shape=True, print_tensor_lod=True,
        print_phase="both"), ["x"]),
    "cond(pred, true_fn, false_fn, name)": (lambda L, fluid, v: L.cond(
        L.less_than(L.reduce_sum(v["x"]),
                    L.fill_constant([1], "float32", 0.0)),
        lambda: L.scale(v["x"], 2.0), lambda: L.scale(v["y"], -1.0),
        name=None), ["x", "y"]),
    "create_parameter, create_array, array_write, array_read": (
        lambda L, fluid, v: L.elementwise_add(v["x"], L.array_read(
            L.array_write(
                L.create_parameter([6], "float32", name="kw_cp", attr=None,
                                   is_bias=True, default_initializer=None),
                L.fill_constant([1], "int64", 1),
                L.create_array("float32", 3,
                               template=L.fill_constant([6], "float32", 0.0),
                               value=0.5)),
            L.fill_constant([1], "int64", 1))), ["x"]),
}

_FEEDS = {
    "x": np.random.RandomState(6).randn(4, 6).astype(np.float32),
    "y": np.random.RandomState(7).randn(4, 6).astype(np.float32),
    "ids": np.random.RandomState(8).randint(0, 10, (4, 5)).astype(np.int64),
    "label": np.random.RandomState(9).randint(0, 6, (4, 1)).astype(np.int64),
    "s": np.random.RandomState(10).randn(4, 6, 4).astype(np.float32),
    "n": np.array([6, 3, 0, 5], np.int64),
    "m": np.array([6, 3, 2, 5], np.int64),
    "k": np.array([2, 1, 0, 2], np.int64),
    "tags": np.random.RandomState(11).randint(0, 4, (4, 6)).astype(np.int64),
    "lab2": np.random.RandomState(12).randint(1, 4, (4, 2)).astype(np.int64),
    "edges": np.tile(np.array([[1, 2], [1, 3], [2, 4], [0, 0], [0, 0]],
                              np.int64), (4, 1, 1)),
}
_DECL = {"x": ([6], "float32"), "y": ([6], "float32"), "ids": ([5], "int64"),
         "label": ([1], "int64"), "s": ([6, 4], "float32"),
         "n": ([], "int64"), "m": ([], "int64"), "k": ([], "int64"), "tags": ([6], "int64"),
         "lab2": ([2], "int64"), "edges": ([5, 2], "int64")}


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
    """The row-sparse gradient of is_sparse=True is ported
    (ops/sparse_ops.py): the layer builds the JAX package's lookup op,
    attrs and all, minimize emits the sparse grad op and the optimizer's
    sparse update, and what the JAX package refuses (here a table that
    two lookups share) raises in the port too."""
    ops = []
    for fluid, layers in ((pfluid, players), (tfluid, tlayers)):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            ids = layers.data("ids", shape=[5], dtype="int64")
            emb = layers.embedding(ids, [10, 3], is_sparse=True,
                                   is_distributed=True)
            fluid.optimizer.SGD(0.1).minimize(layers.mean(emb))
        ops.append([(o.type, sorted(o.attrs.items()))
                    for o in main.global_block().ops])
    assert ops[1] == ops[0]
    types = [t for t, _ in ops[1]]
    assert "lookup_table_sparse_grad" in types and "sgd_sparse" in types
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        ids = tlayers.data("ids", shape=[5], dtype="int64")
        attr = tfluid.ParamAttr(name="shared_sparse.w")
        e1 = tlayers.embedding(ids, [10, 3], is_sparse=True, param_attr=attr)
        e2 = tlayers.embedding(ids, [10, 3], is_sparse=True, param_attr=attr)
        with pytest.raises(ValueError, match="multiple lookups"):
            tfluid.optimizer.SGD(0.1).minimize(
                tlayers.mean(tlayers.elementwise_add(e1, e2)))


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


# --- the serving planes: every public name takes the JAX parameters ------

_PLANES = ("flags", "faults", "retry", "monitor", "numerics",
           "serving_trace", "serving")


def _public_callables(mod):
    """(name, callable) of a module's own public functions and classes,
    and of each class's public methods."""
    out = []
    for name in sorted(dir(mod)):
        obj = getattr(mod, name)
        if name.startswith("_") or getattr(obj, "__module__", "") != \
                mod.__name__:
            continue
        if inspect.isfunction(obj):
            out.append((name, obj))
        elif inspect.isclass(obj):
            out.append((name, obj.__init__))
            for m, fn in sorted(vars(obj).items()):
                if not m.startswith("_") and inspect.isfunction(fn):
                    out.append((f"{name}.{m}", fn))
    return out


@pytest.mark.parametrize("plane", _PLANES)
def test_plane_names_take_the_jax_parameters_in_order(plane):
    import importlib

    jmod = importlib.import_module(f"paddle_tpu.{plane}")
    tmod = importlib.import_module(f"paddle_tpu_torch.{plane}")
    theirs = _public_callables(jmod)
    ours = dict(_public_callables(tmod))
    assert len(theirs) >= 4, plane
    for name, fn in theirs:
        assert name in ours, f"{plane}.{name} is missing"
        want = _params(fn) if inspect.isfunction(fn) else []
        got = _params(ours[name]) if inspect.isfunction(ours[name]) else []
        assert got[:len(want)] == want, (plane, name, want, got)


def test_serving_keywords_take_the_jax_order():
    """ServingEngine, EngineSupervisor and serve take the JAX keywords
    in the JAX order; the port adds admission_control after them."""
    from paddle_tpu import serving as jserving
    from paddle_tpu_torch import serving as tserving

    for name in ("ServingEngine", "EngineSupervisor"):
        want = _params(getattr(jserving, name).__init__)
        got = _params(getattr(tserving, name).__init__)
        assert got[:len(want)] == want, (name, want, got)
    assert _params(tserving.ServingEngine.__init__)[-1] == \
        "admission_control"
    sig = inspect.signature(tserving.serve)
    assert list(sig.parameters)[:3] == list(
        inspect.signature(jserving.serve).parameters)[:3]
    assert sig.parameters["supervised"].default is False
    from paddle_tpu import inference as jinference
    from paddle_tpu_torch import inference as tinference

    assert _params(tinference.Predictor.serving_engine) == _params(
        jinference.Predictor.serving_engine)


# --- the training runtime: the JAX keywords in the JAX order -------------

_RUNTIME_NAMES = [
    ("contrib.trainer", "Trainer"), ("contrib.trainer", "Trainer.train"),
    ("contrib.trainer", "Trainer.test"),
    ("contrib.trainer", "Trainer.save_params"),
    ("contrib.trainer", "Trainer.save_inference_model"),
    ("contrib.trainer", "CheckpointConfig"),
    ("data_feeder", "DataFeeder"), ("data_feeder", "DataFeeder.feed"),
    ("reader.pipeline", "DeviceLoader"), ("reader.pipeline", "PyReader"),
    ("reader.pipeline", "PyReader.decorate_sample_list_generator"),
    ("reader.pipeline", "PyReader.decorate_batch_generator"),
    ("reader", "batch"), ("reader.decorator", "shuffle"),
    ("reader.decorator", "buffered"), ("reader.decorator", "xmap_readers"),
    ("reader.decorator", "multiprocess_reader"),
    ("reader.decorator", "firstn"), ("reader.decorator", "cache"),
    ("parallel.checkpoint", "save_checkpoint"),
    ("parallel.checkpoint", "load_checkpoint"),
    ("parallel.checkpoint", "load_latest"),
    ("parallel.checkpoint", "latest_step"),
    ("parallel.checkpoint", "available_steps"),
    ("parallel.checkpoint", "validate_checkpoint"),
    ("parallel.checkpoint", "manifest_slots"),
    ("parallel.checkpoint", "reshard"),
    ("parallel.checkpoint", "reshard_optimizer_state"),
    ("parallel.checkpoint", "save_scope"),
    ("parallel.checkpoint", "restore_scope"),
    ("parallel.checkpoint", "FleetCommitCoordinator"),
    ("executor", "Executor.train_from_dataset"),
    ("executor", "Executor.infer_from_dataset"),
    ("executor", "Executor.release_scope"),
    ("dataset_api", "InMemoryDataset.global_shuffle"),
    ("metrics", "DetectionMAP"), ("metrics", "Auc"),
    ("metrics", "ChunkEvaluator.update"),
] + [("layers.learning_rate_scheduler", n) for n in (
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup")]


def _resolve(package, module, dotted):
    import importlib

    obj = importlib.import_module(f"{package}.{module}")
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj.__init__ if inspect.isclass(obj) else obj


@pytest.mark.parametrize("module,name", _RUNTIME_NAMES,
                         ids=[f"{m}.{n}" for m, n in _RUNTIME_NAMES])
def test_runtime_names_take_the_jax_parameters_in_order(module, name):
    want = _params(_resolve("paddle_tpu", module, name))
    got = _params(_resolve("paddle_tpu_torch", module, name))
    assert got[:len(want)] == want, (module, name, want, got)


def test_runtime_entry_points_default_to_the_card():
    """Trainer and DeviceLoader run on CUDAPlace(0) unless given
    CPUPlace(): without a card their default raises, naming CPUPlace."""
    from paddle_tpu_torch.contrib import Trainer
    from paddle_tpu_torch.reader import DeviceLoader

    assert _params(DeviceLoader.__init__)[-1] == "place"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is valid")

    def train_func():
        x = tlayers.data("x", shape=[2], dtype="float32")
        return [tlayers.mean(tlayers.fc(x, 1))]

    with pytest.raises(RuntimeError, match="CPUPlace"):
        Trainer(train_func, lambda: tfluid.optimizer.SGD(0.1))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        DeviceLoader(lambda: iter(()), ["x"])
