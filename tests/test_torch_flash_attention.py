"""The port's BTHD attention (paddle_tpu_torch/parallel/flash_attention.py)
against the JAX package's: on the CPU the port runs its plain PyTorch
versions, and the JAX side runs the real Pallas kernels
(``_fwd_small_kernel``, ``_dqdkv_small_kernel``) in interpret mode, as
tests/test_flash_attention.py does (dropout 0: the interpreter has no TPU
PRNG). The routing predicates must agree shape for shape, so both
packages send every attention to the same kind of kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.parallel import flash_attention as jfa
from paddle_tpu_torch.parallel import flash_attention as tfa


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _inputs(b, tq, tk, h, dh, kind, seed=0):
    r = np.random.RandomState(seed)
    q = (r.randn(b, tq, h, dh) * 0.3).astype(np.float32)
    k = (r.randn(b, tk, h, dh) * 0.3).astype(np.float32)
    v = (r.randn(b, tk, h, dh) * 0.3).astype(np.float32)
    bias = None
    if kind in ("pad", "cross"):
        lens = r.randint(tk // 2, tk + 1, b)
        mask = (np.arange(tk)[None, :] < lens[:, None]).astype(np.float32)
        bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    return q, k, v, bias


@pytest.mark.parametrize("kind,tq,tk", [
    ("none", 128, 128), ("pad", 128, 128), ("causal", 128, 128),
    ("cross", 64, 128),
])
def test_plain_matches_pallas_small_kernel(kind, tq, tk):
    """out atol 2e-5, lse atol 1e-5 (f32; the two sum in different
    orders)."""
    b, h, dh = 2, 2, 64
    assert jfa._use_bthd_small(tq, tk)  # the JAX side runs the kernel
    q, k, v, bias = _inputs(b, tq, tk, h, dh, kind)
    causal = kind == "causal"
    scale = float(1.0 / np.sqrt(dh))
    j_out, j_lse = jfa.flash_attention_bthd_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), None, scale, 0.0, causal)
    t_out, t_lse = tfa.flash_attention_bthd_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), None, scale, 0.0,
        causal)
    assert t_out.shape == (b, tq, h, dh) and t_lse.shape == (b, tq, h, 1)
    assert t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)


_GRID = (1, 7, 8, 9, 64, 100, 127, 128, 129, 192, 256, 384, 500, 512, 513,
         640, 768, 1000, 1024, 2048)


def _jax_route(tq, tk, h, dh, layout):
    """The route the JAX package's functions take (interpret mode stands
    in for the TPU backend): flash_attention_bthd_fwd/bwd's branches for
    BTHD, flash_attention_fwd/bwd's ``_use_pallas`` for BHTD."""
    def bhtd():
        bq, bk = jfa._pick_blocks(h, tq, tk, jfa.DEFAULT_Q_BLOCK,
                                  jfa.DEFAULT_K_BLOCK)
        return "bhtd" if jfa._use_pallas(tq, tk, bq, bk) else "dense"

    if layout == "bhtd":
        return bhtd()
    if jfa._use_bthd_small(tq, tk):
        return "small"
    if jfa._use_bthd_kblock(tq, tk, h, dh):
        return "kblock"
    return bhtd() if tk > jfa._SMALL_T_MAX else "dense"


@pytest.mark.parametrize("h,dh", [(2, 64), (8, 64), (16, 128)])
def test_routing_predicates_match_jax(h, dh):
    """attention_route names the JAX package's route for every shape of
    the grid, in both layouts: each TPU kernel's shapes reach its Hopper
    counterpart, and the dense leftovers stay dense."""
    for tq in _GRID:
        for tk in _GRID:
            assert tfa._use_bthd_small(tq, tk) == jfa._use_bthd_small(tq, tk), \
                (tq, tk)
            for layout in ("bthd", "bhtd"):
                assert tfa.attention_route(tq, tk, h, dh, layout) == \
                    _jax_route(tq, tk, h, dh, layout), (tq, tk, layout)


def test_decode_shape_takes_the_dense_path_on_cpu():
    """tq=1 (one decode token) is outside both kernel regimes: the plain
    composition, with a real lse, and no kernel launch."""
    b, tk, h, dh = 3, 12, 2, 8
    q, k, v, bias = _inputs(b, 1, tk, h, dh, "pad", seed=3)
    before = tfa.launched("fwd")
    out, lse = tfa.flash_attention_bthd_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias))
    assert tfa.launched("fwd") == before
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(dh) + bias
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))
    np.testing.assert_allclose(lse.numpy(), ref_lse.transpose(0, 2, 1, 3),
                               atol=1e-5, rtol=0)
    p = np.exp(s - ref_lse)
    ref = np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind,tq,tk", [
    ("none", 128, 128), ("pad", 128, 128), ("causal", 128, 128),
    ("cross", 64, 128),
])
def test_plain_bwd_matches_pallas_small_kernel(kind, tq, tk):
    """attention_bthd_bwd_plain (the formula written out) against
    ``_dqdkv_small_kernel`` in interpret mode, both fed the JAX forward's
    (out, lse) and one output gradient: dq, dk, dv within atol 2e-5 (f32,
    different summation orders)."""
    b, h, dh = 2, 2, 64
    assert jfa._use_bthd_small(tq, tk)
    q, k, v, bias = _inputs(b, tq, tk, h, dh, kind, seed=1)
    g = (np.random.RandomState(4).randn(b, tq, h, dh) * 0.3).astype(
        np.float32)
    causal = kind == "causal"
    scale = float(1.0 / np.sqrt(dh))
    jb = None if bias is None else jnp.asarray(bias)
    j_out, j_lse = jfa.flash_attention_bthd_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, None, scale, 0.0,
        causal)
    j_grads = jfa.flash_attention_bthd_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, None, j_out,
        j_lse, jnp.asarray(g), scale, 0.0, causal)
    t = torch.from_numpy
    t_grads = tfa.flash_attention_bthd_bwd(
        t(q), t(k), t(v), None if bias is None else t(bias), None,
        t(np.array(j_out)), t(np.array(j_lse)), t(g), scale, 0.0, causal)
    for name, tg, jg in zip("qkv", t_grads, j_grads):
        assert tg.shape == jg.shape and tg.dtype == torch.float32
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("p_drop,causal", [(0.0, False), (0.0, True),
                                           (0.3, True)])
def test_autograd_function_gives_the_plain_grads(p_drop, causal):
    """flash_attention_bthd_with_lse's backward (the registered backward)
    equals autograd through the plain forward, dropout included: the
    backward regenerates the forward's mask from the seed. The bias
    cotangent is zeros, as on the JAX package's kernel path."""
    q, k, v, bias = (None if a is None else torch.from_numpy(a)
                     for a in _inputs(2, 64, 128, 2, 16, "pad", seed=2))
    g = torch.from_numpy(np.random.RandomState(5).randn(2, 64, 2, 16)
                         .astype(np.float32))
    bias = bias.requires_grad_()
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_attention_bthd_with_lse(*xs, bias, 11, None, p_drop,
                                                 causal)
    got = torch.autograd.grad(out, xs + [bias], g)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    eff = (tfa._combined_causal_bias(bias.detach(), 64, 128, "cpu")
           if causal else bias.detach())
    ref_out, ref_lse = tfa.attention_bthd_plain(*ys, eff, None, 11, p_drop)
    ref = torch.autograd.grad(ref_out, ys, g)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    for a, r in zip(got[:3], ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-6, rtol=0)
    assert not got[3].any()
