"""The rounding contract of the bf16 attention forward kernel
(paddle_tpu_torch/csrc/flash_attention_bthd_fwd.cu, fwd_wgmma_kernel), on
the CPU.

The kernel runs only on the card. Its arithmetic is modelled here in
PyTorch: bf16 inputs; S = scale * q k^T (f32 products) plus the f32 bias,
the causal and ragged masks; sweep 1 over 64-key tiles keeps a running
max per row and the f32 sum l of the unrounded, undropped exponentials
against it, so lse = m + log(l); sweep 2 forms P o M = exp(s - lse) times
the dropout keep mask, rounds it to bf16 once, and sums O = (P o M) V in
f32; out is O rounded to bf16 once. The model is held against the
port's plain version (the card's comparison), the JAX package's forward
(its Pallas kernels in interpret mode, dropout 0: the interpreter has no
TPU PRNG) and the plain version in f64, on the three kernel routes with
causal masks, padding, dropout, ragged edges and dh 32, 72, 128 and 256.
The limits are the card's (``TOL_OUT["bfloat16"]``, ``TOL_LSE`` in
chip_smoke.py): out 8e-3, lse 5e-6. Inputs come from numpy seeds."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.parallel import flash_attention as jfa
from paddle_tpu_torch.parallel import flash_attention as tfa

TOL_OUT = 8e-3
TOL_LSE = 5e-6
TILE = 64  # keys of the kernel's streamed tile


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _scores(q, k, bias, scale, causal):
    """f32 S of bf16 q, k: scale * q k^T + bias, -inf where masked."""
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        live = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
        s = torch.where(live, s, -math.inf)
    return s


def kernel_model(q, k, v, bias, seed, scale, p_drop, causal, sweeps=2):
    """(out bf16 [b, tq, h, dh], lse f32 [b, tq, h, 1]) as the tensor-core
    kernel computes them. ``bias`` and ``causal`` are the route's (the
    small route folds causal into the bias). ``sweeps=1``: the one-sweep
    online softmax instead, P o M = exp(s - running max of its tile)
    rounded to bf16, O rescaled per tile, out = O / l."""
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    s = _scores(q, k, bias, scale, causal)
    mask = (tfa.dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop)
            if p_drop > 0 else None)
    vf = v.float().permute(0, 2, 1, 3)                     # [b, h, tk, dh]
    m = torch.full((b, h, tq, 1), -math.inf)
    l = torch.zeros(b, h, tq, 1)
    o = torch.zeros(b, h, tq, v.shape[-1])
    for k0 in range(0, tk, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        e = torch.exp(st - m_new)          # tile 0 holds key 0: m finite
        corr = torch.exp(m - m_new)
        l = l * corr + e.sum(-1, keepdim=True)
        if sweeps == 1:
            pm = e if mask is None else e * mask[..., k0:k0 + TILE]
            o = o * corr + (pm.to(torch.bfloat16).float()
                            @ vf[:, :, k0:k0 + TILE])
        m = m_new
    lse = m + torch.log(l)
    if sweeps == 1:
        o = o / l
    else:
        p = torch.exp(s - lse)
        if mask is not None:
            p = p * mask
        o = p.to(torch.bfloat16).float() @ vf
    out = o.permute(0, 2, 1, 3).to(torch.bfloat16)
    return out, lse.permute(0, 2, 1, 3)


def _inputs(b, tq, tk, h, dh, kind, seed, scale=1.0):
    """bf16 q, k, v (``scale`` x normal) and the f32 padding bias of
    ``kind``: none, or pad ([b, 1, 1, tk], per-row lengths in [tk/2,
    tk])."""
    r = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy((r.randn(b, t, h, dh) * scale)
                                .astype(np.float32)).to(torch.bfloat16)
               for t in (tq, tk, tk))
    bias = None
    if kind == "pad":
        lens = r.randint(tk // 2, tk + 1, b)
        keep = np.arange(tk)[None, :] < lens[:, None]
        bias = torch.from_numpy(
            ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :])
    return q, k, v, bias


CASES = pytest.mark.parametrize("route,b,tq,tk,h,dh,kind,causal,p_drop", [
    ("small", 2, 256, 256, 2, 64, "pad", False, 0.1),
    ("small", 2, 256, 256, 2, 64, "pad", True, 0.1),
    ("small", 2, 100, 77, 2, 64, "none", True, 0.0),
    ("small", 1, 96, 200, 2, 32, "pad", False, 0.0),
    ("small", 1, 128, 128, 2, 72, "pad", False, 0.1),
    ("small", 1, 128, 128, 2, 128, "pad", True, 0.0),
    ("small", 1, 128, 128, 2, 256, "pad", True, 0.1),
    ("kblock", 1, 128, 768, 2, 64, "pad", True, 0.1),
    ("kblock", 1, 128, 1024, 2, 72, "none", False, 0.0),
    ("bhtd", 1, 256, 1280, 2, 64, "pad", False, 0.0),
    ("bhtd", 1, 1280, 1280, 1, 64, "pad", True, 0.1),
])


def _case(route, b, tq, tk, h, dh, kind, causal, p_drop, scale=1.0):
    q, k, v, bias = _inputs(b, tq, tk, h, dh, kind, seed=tq + tk + dh,
                            scale=scale)
    assert tfa.attention_route(tq, tk, h, dh) == route
    seed = 53 if p_drop else None
    # the wrapper's route: causal folded into the bias on the small route
    _, rbias, rcausal = tfa._bthd_route(q, k, causal, bias)
    return q, k, v, bias, rbias, rcausal, seed


def _err(got, want):
    return (got.double() - want.double()).abs().max().item()


@CASES
def test_model_holds_the_plain_version(route, b, tq, tk, h, dh, kind,
                                       causal, p_drop):
    """The card's comparison: model vs ``attention_bthd_plain`` on the
    same bf16 inputs, under the card's limits."""
    q, k, v, _, rbias, rcausal, seed = _case(route, b, tq, tk, h, dh, kind,
                                             causal, p_drop)
    scale = 1.0 / math.sqrt(dh)
    out, lse = kernel_model(q, k, v, rbias, seed, scale, p_drop, rcausal)
    ref_out, ref_lse = tfa.attention_bthd_plain(q, k, v, rbias, scale, seed,
                                                p_drop, rcausal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _err(out, ref_out) <= TOL_OUT, _err(out, ref_out)
    assert _err(lse, ref_lse) <= TOL_LSE, _err(lse, ref_lse)


@CASES
def test_model_holds_the_f64_plain_version(route, b, tq, tk, h, dh, kind,
                                           causal, p_drop):
    """Model vs the plain version in f64 on the same bf16 values (P never
    rounded): out within the card's limit at inputs of 0.3 x normal (the
    JAX package's test scale), lse within 5e-6."""
    q, k, v, _, rbias, rcausal, seed = _case(route, b, tq, tk, h, dh, kind,
                                             causal, p_drop, scale=0.3)
    scale = 1.0 / math.sqrt(dh)
    out, lse = kernel_model(q, k, v, rbias, seed, scale, p_drop, rcausal)
    ref_out, ref_lse = tfa.attention_bthd_plain(
        *(x.double() for x in (q, k, v)),
        None if rbias is None else rbias.double(), scale, seed, p_drop,
        rcausal)
    assert ref_out.dtype == torch.float64
    assert _err(out, ref_out) <= TOL_OUT, _err(out, ref_out)
    assert _err(lse, ref_lse) <= TOL_LSE, _err(lse, ref_lse)


@CASES
def test_model_holds_the_jax_forward(route, b, tq, tk, h, dh, kind, causal,
                                     p_drop):
    """Model vs the JAX package's ``flash_attention_bthd_fwd`` on the same
    bf16 inputs (its kernels in interpret mode), dropout 0, inputs of 0.3
    x normal: out and lse within the card's limits."""
    q, k, v, bias, rbias, rcausal, _ = _case(route, b, tq, tk, h, dh, kind,
                                             causal, 0.0, scale=0.3)
    scale = 1.0 / math.sqrt(dh)
    out, lse = kernel_model(q, k, v, rbias, None, scale, 0.0, rcausal)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    j_out, j_lse = jfa.flash_attention_bthd_fwd(
        jq, jk, jv, None if bias is None else jnp.asarray(bias.numpy()),
        None, scale, 0.0, causal)
    j_out = torch.from_numpy(np.asarray(j_out.astype(jnp.float32)))
    assert _err(out, j_out) <= TOL_OUT, _err(out, j_out)
    if jfa._use_bthd_small(tq, tk) or route != "small":
        # the JAX dense fallback returns zeros for lse off the TPU
        j_lse = torch.from_numpy(np.asarray(j_lse))
        assert _err(lse, j_lse) <= TOL_LSE, _err(lse, j_lse)


def test_one_sweep_rounding_breaks_the_out_limit():
    """Why the kernel sweeps the keys twice: a one-sweep online softmax
    rounds exp(s - running max) to bf16, not the normalized p, and on the
    t = 256 decoder self-attention (causal, inputs of unit scale) its out
    leaves the card's limit against the plain version, where the
    two-sweep model stays within it."""
    q, k, v, _, rbias, rcausal, _ = _case("small", 2, 256, 256, 8, 64,
                                          "none", True, 0.0)
    scale = 1.0 / math.sqrt(64)
    ref_out, _ = tfa.attention_bthd_plain(q, k, v, rbias, scale)
    two, _ = kernel_model(q, k, v, rbias, None, scale, 0.0, rcausal)
    one, _ = kernel_model(q, k, v, rbias, None, scale, 0.0, rcausal,
                          sweeps=1)
    assert _err(two, ref_out) <= TOL_OUT, _err(two, ref_out)
    assert _err(one, ref_out) > TOL_OUT, _err(one, ref_out)
