"""The port's BTHD attention (paddle_tpu_torch/parallel/flash_attention.py)
against the JAX package's: on the CPU the port runs its plain PyTorch
version, and the JAX side runs the real Pallas kernel
(``_fwd_small_kernel``) in interpret mode, as tests/test_flash_attention.py
does. The routing predicates must agree shape for shape, so both packages
send every attention to the same kind of kernel."""

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
        None if bias is None else torch.from_numpy(bias), scale, causal)
    assert t_out.shape == (b, tq, h, dh) and t_lse.shape == (b, tq, h, 1)
    assert t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)


_GRID = (1, 7, 8, 9, 64, 100, 127, 128, 129, 192, 256, 384, 500, 512, 513,
         640, 768, 1000, 1024, 2048)


def test_routing_predicates_match_jax():
    for tq in _GRID:
        for tk in _GRID:
            assert tfa._use_bthd_small(tq, tk) == jfa._use_bthd_small(tq, tk), \
                (tq, tk)
            if jfa._use_bthd_small(tq, tk):
                continue
            # the port raises on a CUDA tensor for tk > 512: exactly where
            # the JAX package takes a kernel that has no Hopper port yet
            for h, dh in ((2, 64), (8, 64), (16, 128)):
                j_kernel = (jfa._use_bthd_kblock(tq, tk, h, dh)
                            or tk > jfa._SMALL_T_MAX)
                assert (tk > tfa._SMALL_T_MAX) == j_kernel, (tq, tk, h, dh)


def test_decode_shape_takes_the_dense_path_on_cpu():
    """tq=1 (one decode token) is outside both kernel regimes: the plain
    composition, with a real lse, and no kernel launch."""
    b, tk, h, dh = 3, 12, 2, 8
    q, k, v, bias = _inputs(b, 1, tk, h, dh, "pad", seed=3)
    before = tfa.launches
    out, lse = tfa.flash_attention_bthd_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias))
    assert tfa.launches == before
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(dh) + bias
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))
    np.testing.assert_allclose(lse.numpy(), ref_lse.transpose(0, 2, 1, 3),
                               atol=1e-5, rtol=0)
    p = np.exp(s - ref_lse)
    ref = np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
