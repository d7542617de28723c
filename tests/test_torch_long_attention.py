"""The port's long-context attention (paddle_tpu_torch/parallel/
flash_attention.py: the ``kblock`` and ``bhtd`` routes, the BHTD public
functions, the dense route's bias gradient) against the JAX package's, on
the CPU, and the slice as a whole (training and serving a tiny
Transformer at t = 768 and 1280).

On the CPU the port runs its plain versions; the JAX side runs the real
Pallas kernels (``_fwd_kb_kernel``, ``_dqdkv_kb_kernel``, ``_fwd_kernel``,
``_dq_kernel``, ``_dkv_kernel``) in interpret mode, as
tests/test_flash_attention.py does, with dropout 0 (the interpreter has
no TPU PRNG). Inputs come from numpy seeds. Tolerances (f32, the two sum
in different orders): out atol 2e-5, lse atol 1e-5, gradients within
1e-5 of the largest |element| of the JAX gradient; model losses and
gradients atol 1e-5; greedy tokens exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pfluid
from paddle_tpu import serving as pserving
from paddle_tpu import unique_name as punique
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu.models import transformer as PT
from paddle_tpu.parallel import flash_attention as jfa

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import kernels
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import unique_name as tunique
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.core.rng import SeedHandle
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import flash_attention as tfa


def _seed_handle():
    """A random op's seed as the interpreter passes it: the run's seed
    buffer (step seed 0) and the op's index."""
    return SeedHandle(torch.zeros((), dtype=torch.int64), 0)


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _inputs(b, tq, tk, h, dh, kind, seed=0, bhtd=False):
    """q, k, v (x 0.3 normal) and the bias of ``kind``: none, pad ([1, 1,
    1, tk], the last tk/8 keys padded) or cross ([b, 1, 1, tk], per-row
    lengths in [tk/2, tk])."""
    r = np.random.RandomState(seed)
    shape = (lambda t: (b, h, t, dh)) if bhtd else (lambda t: (b, t, h, dh))
    q, k, v = ((r.randn(*shape(t)) * 0.3).astype(np.float32)
               for t in (tq, tk, tk))
    bias = None
    if kind == "pad":
        keep = np.arange(tk) < tk - tk // 8
        bias = ((1.0 - keep) * -1e9).astype(np.float32)[None, None, None]
    elif kind == "cross":
        lens = r.randint(tk // 2, tk + 1, b)
        keep = np.arange(tk)[None, :] < lens[:, None]
        bias = ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :]
    g = (r.randn(*q.shape) * 0.3).astype(np.float32)
    return q, k, v, bias, g


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _close_rel(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=1e-5, rtol=0, err_msg=err_msg)


def _check_bthd(b, tq, tk, h, dh, kind, causal, route, seed=0):
    """Forward and backward of the BTHD wrappers on ``route``, against the
    JAX functions (Pallas in interpret mode), from the same inputs; the
    backward of both sides takes the JAX forward's (out, lse)."""
    assert tfa.attention_route(tq, tk, h, dh) == route
    q, k, v, bias, g = _inputs(b, tq, tk, h, dh, kind, seed)
    scale = float(1.0 / np.sqrt(dh))
    jq, jk, jv, jb, jg = _j(q, k, v, bias, g)
    j_out, j_lse = jfa.flash_attention_bthd_fwd(jq, jk, jv, jb, None, scale,
                                                0.0, causal)
    tq_, tk_, tv_, tb_, tg_ = _t(q, k, v, bias, g)
    t_out, t_lse = tfa.flash_attention_bthd_fwd(tq_, tk_, tv_, tb_, None,
                                                scale, 0.0, causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)
    j_grads = jfa.flash_attention_bthd_bwd(jq, jk, jv, jb, None, j_out, j_lse,
                                           jg, scale, 0.0, causal)
    t_grads = tfa.flash_attention_bthd_bwd(
        tq_, tk_, tv_, tb_, None, *_t(j_out, j_lse), tg_, scale, 0.0, causal)
    for name, tgr, jgr in zip("qkv", t_grads, j_grads):
        assert tgr.shape == jgr.shape
        _close_rel(tgr.numpy(), jgr, f"d{name}")


@pytest.mark.parametrize("tq", [128, 256])
@pytest.mark.parametrize("tk", [768, 1024])
@pytest.mark.parametrize("kind", ["none", "pad", "cross"])
def test_kblock_route_matches_pallas_kb_kernels(tq, tk, kind):
    """``_fwd_kb_kernel`` / ``_dqdkv_kb_kernel`` (512 < tk <= 1024)."""
    assert jfa._use_bthd_kblock(tq, tk, 2, 64)
    _check_bthd(1 if kind != "cross" else 2, tq, tk, 2, 64, kind, False,
                "kblock")


def test_kblock_route_causal_matches_pallas_kb_kernels():
    """The in-kernel causal mask and dead-block skip of the k-blocked
    kernels at tq = tk = 768 (three 256-wide key blocks)."""
    _check_bthd(1, 768, 768, 2, 64, "pad", True, "kblock", seed=3)


@pytest.mark.parametrize("kind,tq,causal", [("pad", 1280, True),
                                            ("cross", 512, False)])
def test_bhtd_route_through_the_bthd_wrapper(kind, tq, causal):
    """tk = 1280 > 1024: the BTHD wrapper takes the BHTD kernels
    (``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``), causal in-kernel."""
    _check_bthd(1, tq, 1280, 2, 32, kind, causal, "bhtd", seed=4)


@pytest.mark.parametrize("causal", [False, True])
def test_bhtd_functions_with_lse_cotangent(causal):
    """``flash_attention_fwd`` / ``flash_attention_bwd`` called in BHTD at
    t = 512 with a nonzero lse cotangent, which folds into delta."""
    b, h, t, dh = 1, 2, 512, 64
    assert tfa.attention_route(t, t, h, dh, "bhtd") == "bhtd"
    q, k, v, bias, g = _inputs(b, t, t, h, dh, "pad", seed=5, bhtd=True)
    g_lse = (np.random.RandomState(6).randn(b, h, t, 1) * 0.3).astype(
        np.float32)
    jq, jk, jv, jb, jg, jgl = _j(q, k, v, bias, g, g_lse)
    j_out, j_lse = jfa.flash_attention_fwd(jq, jk, jv, jb, None, None, 0.0,
                                           causal=causal)
    tq_, tk_, tv_, tb_, tg_, tgl = _t(q, k, v, bias, g, g_lse)
    t_out, t_lse = tfa.flash_attention_fwd(tq_, tk_, tv_, tb_, None, None,
                                           0.0, causal=causal)
    assert t_out.shape == (b, h, t, dh) and t_lse.shape == (b, h, t, 1)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)
    j_grads = jfa.flash_attention_bwd(jq, jk, jv, jb, None, j_out, j_lse, jg,
                                      causal=causal, g_lse=jgl)
    t_grads = tfa.flash_attention_bwd(tq_, tk_, tv_, tb_, None,
                                      *_t(j_out, j_lse), tg_, causal=causal,
                                      g_lse=tgl)
    for name, tgr, jgr in zip("qkv", t_grads, j_grads):
        _close_rel(tgr.numpy(), jgr, f"d{name}")


def test_decode_shape_takes_the_bhtd_route():
    """One decode token over a 1024-row cache (tq = 1): the BTHD wrapper
    takes ``_fwd_kernel`` with bq = 1, as the JAX package's serving decode
    step does once max_len or src_len is above 512."""
    b, tk, h, dh = 3, 1024, 2, 64
    assert tfa.attention_route(1, tk, h, dh) == "bhtd"
    q, k, v, bias, _ = _inputs(b, 1, tk, h, dh, "cross", seed=7)
    j_out, j_lse = jfa.flash_attention_bthd_fwd(*_j(q, k, v, bias))
    before = kernels.launch_counts["attention_dense"]
    t_out, t_lse = tfa.flash_attention_bthd_fwd(*_t(q, k, v, bias))
    assert kernels.launch_counts["attention_dense"] == before
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)


# --- the autograd wrappers' bias cotangent ---


@pytest.mark.parametrize("tq,tk,causal,route", [
    (200, 256, False, "dense"), (200, 256, True, "dense"),
    (4, 256, False, "dense"), (64, 128, True, "small"),
    (128, 768, False, "kblock"),
])
def test_bthd_with_lse_bias_cotangent_follows_the_jax_rule(tq, tk, causal,
                                                           route):
    """``flash_attention_bthd_with_lse`` with a bias that requires grad:
    on the dense route dbias is the plain composition's (the causal fold
    inside the differentiated function), on the kernel routes zeros; dq,
    dk, dv, dbias against the JAX function's custom vjp."""
    b, h, dh = 2, 2, 16
    assert tfa.attention_route(tq, tk, h, dh) == route
    q, k, v, bias, g = _inputs(b, tq, tk, h, dh, "cross", seed=8)
    bias = bias + np.random.RandomState(9).randn(*bias.shape).astype(
        np.float32)
    scale = float(1.0 / np.sqrt(dh))

    def jf(q_, k_, v_, b_):
        return jfa.flash_attention_bthd_with_lse(q_, k_, v_, b_, None, scale,
                                                 0.0, causal)[0]

    _, vjp = jax.vjp(jf, *_j(q, k, v, bias))
    j_grads = vjp(jnp.asarray(g))
    xs = [x.requires_grad_() for x in _t(q, k, v, bias)]
    out, _ = tfa.flash_attention_bthd_with_lse(*xs, None, scale, 0.0, causal)
    t_grads = torch.autograd.grad(out, xs, torch.from_numpy(g))
    for name, tgr, jgr in zip(["dq", "dk", "dv", "dbias"], t_grads, j_grads):
        assert tuple(tgr.shape) == jgr.shape, name
        np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert t_grads[3].abs().max() > 0 if route == "dense" else \
        not t_grads[3].any()


@pytest.mark.parametrize("t,route", [(256, "bhtd"), (300, "dense")])
def test_bhtd_with_lse_autograd_follows_the_jax_rule(t, route):
    """``flash_attention_with_lse`` (BHTD) differentiated through both
    outputs: the kernel route's backward with the lse cotangent and a zero
    dbias, the dense route's plain cotangents, dbias included."""
    b, h, dh = 1, 2, 16
    assert tfa.attention_route(t, t, h, dh, "bhtd") == route
    q, k, v, bias, g = _inputs(b, t, t, h, dh, "cross", seed=10, bhtd=True)
    g_lse = (np.random.RandomState(11).randn(b, h, t, 1) * 0.3).astype(
        np.float32)

    def jf(q_, k_, v_, b_):
        return jfa.flash_attention_with_lse(q_, k_, v_, b_, None, None, 0.0,
                                            causal=True)

    _, vjp = jax.vjp(jf, *_j(q, k, v, bias))
    j_grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    xs = [x.requires_grad_() for x in _t(q, k, v, bias)]
    out, lse = tfa.flash_attention_with_lse(*xs, None, None, 0.0,
                                            causal=True)
    t_grads = torch.autograd.grad((out, lse), xs, _t(g, g_lse))
    for name, tgr, jgr in zip(["dq", "dk", "dv", "dbias"], t_grads, j_grads):
        np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert (t_grads[3].abs().max() > 0) == (route == "dense")


# --- the sdpa op pair in the BHTD layout ---

_OP_CASES = [(16, 16, False), (16, 16, True), (4, 12, False)]


@pytest.mark.parametrize("tq,tk,causal", _OP_CASES)
def test_sdpa_op_pair_bhtd_matches_jax_op(tq, tk, causal):
    """The op and its grad op with ``layout="bhtd"`` against the JAX
    package's (off the TPU its reference composition): Out and the grad
    op's dQ, dK, dV within atol 1e-5; the port's Lse, which the JAX op
    returns as zeros off the TPU, against float64 numpy."""
    b, h, dh = 2, 2, 8
    q, k, v, bias, g = _inputs(b, tq, tk, h, dh, "cross", seed=12,
                               bhtd=True)
    attrs = {"scale": dh ** -0.5, "layout": "bhtd", "causal": causal,
             "is_test": False, "dropout_prob": 0.0}
    ins = {"Q": [q], "K": [k], "V": [v], "Bias": [bias]}
    cpu = torch.device("cpu")
    fwd = get_op_def("scaled_dot_product_attention").compute(
        {s: _t(*a) for s, a in ins.items()}, dict(attrs), device=cpu,
        seed=_seed_handle())
    j_fwd = jax_op_def("scaled_dot_product_attention").compute(
        {s: _j(*a) for s, a in ins.items()}, dict(attrs),
        rng=jax.random.PRNGKey(0))
    np.testing.assert_allclose(fwd["Out"][0].numpy(),
                               np.asarray(j_fwd["Out"][0]), atol=1e-5, rtol=0)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * dh ** -0.5
    s = s + bias
    if causal:
        s = np.where(np.arange(tq)[:, None] >= np.arange(tk)[None, :], s,
                     -1e30)
    m = s.max(-1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(-1, keepdims=True))
    np.testing.assert_allclose(fwd["Lse"][0].numpy(), lse, atol=1e-5, rtol=0)
    gins = {**ins, "Out": [fwd["Out"][0].numpy()],
            "Lse": [fwd["Lse"][0].numpy()], "GRAD::Out": [g]}
    gattrs = {**attrs, "forward_op_idx": 0}
    grads = get_op_def("scaled_dot_product_attention_grad").compute(
        {s_: _t(*a) for s_, a in gins.items()}, dict(gattrs), device=cpu,
        seed=_seed_handle())
    j_grads = jax_op_def("scaled_dot_product_attention_grad").compute(
        {s_: _j(*a) for s_, a in gins.items()}, dict(gattrs),
        rng=jax.random.PRNGKey(0))
    for slot in ("GRAD::Q", "GRAD::K", "GRAD::V"):
        np.testing.assert_allclose(grads[slot][0].numpy(),
                                   np.asarray(j_grads[slot][0]), atol=1e-5,
                                   rtol=0, err_msg=slot)


# --- the slice as a whole: a tiny Transformer at long sequence lengths ---


def _cfg(seq, **kw):
    """bench.py's long-context configuration cut to 1+1 layers and
    d_model 32 (max_length = seq + 2, as bench.py sets it)."""
    return {**dict(src_vocab_size=37, trg_vocab_size=41, max_length=seq + 2,
                   d_model=32, d_inner=64, n_head=2, n_layer=1, dropout=0.0,
                   label_smooth_eps=0.1), **kw}


def _pair(seq, make_opt):
    """Both packages' training programs; the port's scope holds the JAX
    package's initial state."""
    progs = {}
    for name, fluid, T, unique in (("jax", pfluid, PT, punique),
                                   ("torch", tfluid, TT, tunique)):
        main, startup = fluid.Program(), fluid.Program()
        with unique.guard(), fluid.program_guard(main, startup):
            model = T.build(T.TransformerConfig(**_cfg(seq)))
            make_opt(fluid).minimize(model["loss"])
        progs[name] = (main, startup, model)
    pscope, tscope = pfluid.Scope(), tfluid.Scope()
    pexe = pfluid.Executor(pfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with pfluid.scope_guard(pscope):
        pexe.run(progs["jax"][1])
    with tfluid.scope_guard(tscope):
        texe.run(progs["torch"][1])
    for p in progs["torch"][0].all_parameters():
        tscope.set(p.name, np.array(pscope.find_var(p.name)))

    def step(fetch, feed):
        with pfluid.scope_guard(pscope):
            j = pexe.run(progs["jax"][0], feed=feed,
                         fetch_list=[progs["jax"][2]["loss"]] + fetch)
        before = kernels.launch_counts["attention_dense"]
        with tfluid.scope_guard(tscope):
            t = texe.run(progs["torch"][0], feed=feed,
                         fetch_list=[progs["torch"][2]["loss"]] + fetch)
        # every attention of the step took a kernel route
        assert kernels.launch_counts["attention_dense"] == before
        return [np.asarray(x) for x in j], t

    return progs["torch"][0], step


def _feed(seq, seed=0):
    return PT.make_batch(PT.TransformerConfig(**_cfg(seq)), 2, seq, seq,
                         seed=seed)


@pytest.mark.parametrize("seq,route", [(768, "kblock"), (1280, "bhtd")])
def test_long_context_first_step_loss_and_every_gradient_match_jax(seq,
                                                                   route):
    assert tfa.attention_route(seq, seq, 2, 16) == route
    tmain, step = _pair(seq, lambda f: f.optimizer.SGD(0.5))
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    j, t = step(grads, _feed(seq))
    for name, jv, tv in zip(["loss"] + grads, j, t):
        assert tv.shape == jv.shape, name
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("seq", [768, 1280])
def test_long_context_three_adam_steps_match_jax(seq):
    _, step = _pair(seq, lambda f: f.optimizer.Adam(1e-3))
    for i in range(3):
        (jl,), (tl,) = step([], _feed(seq, seed=i))
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0, err_msg=i)


def test_long_serving_tokens_equal_jax_tokens():
    """ServingEngine at src_len = max_len = 768: the prefill's encoder
    self-attention takes the ``kblock`` route, every decode step's two
    attentions per layer the ``bhtd`` route; tokens equal the JAX
    engine's, and no attention falls to the dense route. The matrices are
    redrawn from a numpy seed with std 0.5 (the initializers' scale makes
    this tiny model emit EOS first for every source)."""
    cfg = _cfg(766, label_smooth_eps=0.0)
    scope = pfluid.Scope()
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        PT.build(PT.TransformerConfig(**cfg), is_test=True)
    with pfluid.scope_guard(scope):
        pfluid.Executor(pfluid.CPUPlace()).run(startup)
    r = np.random.RandomState(13)
    for p in main.all_parameters():
        if p.trainable and len(p.shape) == 2:
            scope.set(p.name, (r.randn(*p.shape) * 0.5).astype(np.float32))
    params = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}
    srcs = [r.randint(2, 37, (n,)).astype(np.int64) for n in (700, 520, 768)]

    def serve(mod, T, w, place):
        eng = mod.ServingEngine(T.TransformerConfig(**cfg), w, slots=2,
                                src_len=768, max_len=768, place=place)
        hs = [eng.submit(s, max_new_tokens=4) for s in srcs]
        eng.run_until_idle()
        eng.close()
        return [(list(h.tokens), h.outcome) for h in hs]

    jax_out = serve(pserving, PT, scope, pfluid.CPUPlace())
    before = kernels.launch_counts["attention_dense"]
    port_out = serve(tserving, TT,
                     tio.scope_from_numpy(params, tfluid.CPUPlace()),
                     tfluid.CPUPlace())
    assert kernels.launch_counts["attention_dense"] == before
    assert port_out == jax_out
    assert all(len(toks) > 0 for toks, _ in port_out)
