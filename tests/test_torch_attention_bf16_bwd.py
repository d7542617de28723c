"""The rounding contract of the bf16 attention backward kernels
(paddle_tpu_torch/csrc/flash_attention_bthd_bwd.cu, bwd_dkdv_wgmma_kernel
and bwd_dq_wgmma_kernel), on the CPU.

The kernels run only on the card. Their arithmetic is modelled here in
PyTorch: bf16 inputs; s = q k^T and dp = dout v^T as f32 products; p, the
keep mask M, delta and dS = p o (dp o M - delta) * scale in f32; P o M and
dS each carried into the tensor cores as two bf16 terms (hi = bf16(x), lo
= bf16(x - hi)); dq, dk, dv summed in f32 and rounded to bf16 once. The
model is held against ``attention_bthd_bwd_plain`` run in f64 on the same
bf16 values, on small shapes of the three kernel routes, with causal
masks, padding, dropout and dh 32 to 256. The limit is the card's: 8e-3
of the largest |gradient| (``TOL_GRAD_REL["bfloat16"]`` in
chip_smoke.py), one bf16 ulp of the largest element. Inputs come from numpy seeds."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import flash_attention as fa

TOL_GRAD_REL = 8e-3
# before dq, dk, dv are rounded to bf16: with P o M and dS as two bf16
# terms (16 bits) the model reads 5.4e-6 of the f64 version at most over
# these cases (3.6e-3 once rounded); with a single bf16 term it reads
# 1.1e-3 to 2.9e-3, over ten times this limit
TOL_UNROUNDED_REL = 1e-4


def _bf16(x):
    """x rounded to bf16, in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _terms(x, n=2):
    """The bf16 terms the kernels feed the tensor cores for x: hi and lo
    = bf16(x - hi); ``n=1``: hi alone."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi))[:n]


def kernel_model(q, k, v, bias, seed, out, lse, g, scale, p_drop, causal,
                 terms=2):
    """dq, dk, dv as the tensor-core kernels compute them, in f32 (the
    outputs not yet rounded). ``bias`` and ``causal`` are the route's: the
    small route has causal folded into ``bias``, the others mask
    in-kernel. BTHD tensors; lse [b, tq, h, 1]. ``terms``: bf16 terms of
    P o M and dS (the kernels use 2)."""
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse.permute(0, 2, 1, 3))
    if causal:
        live = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
        p = torch.where(live, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    m = (fa.dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop)
         if p_drop > 0 else torch.ones_like(p))
    delta = (gf * out.float()).sum(-1, keepdim=True).permute(0, 2, 1, 3)
    ds = p * (dp * m - delta) * scale
    dq = sum(torch.einsum("bhqk,bkhd->bqhd", t, kf)
             for t in _terms(ds, terms))
    dk = sum(torch.einsum("bhqk,bqhd->bkhd", t, qf)
             for t in _terms(ds, terms))
    dv = sum(torch.einsum("bhqk,bqhd->bkhd", t, gf)
             for t in _terms(p * m, terms))
    return dq, dk, dv


def _inputs(b, tq, tk, h, dh, kind, seed):
    """bf16 q, k, v, dout (normal) and the f32 padding bias of ``kind``
    (none or pad: [b, 1, 1, tk], per-row lengths in [tk/2, tk])."""
    r = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(r.randn(b, t, h, dh).astype(np.float32))
                  .to(torch.bfloat16) for t in (tq, tk, tk, tq))
    bias = None
    if kind == "pad":
        lens = r.randint(tk // 2, tk + 1, b)
        keep = np.arange(tk)[None, :] < lens[:, None]
        bias = torch.from_numpy(
            ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :])
    return q, k, v, g, bias


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


CASES = pytest.mark.parametrize("route,b,tq,tk,h,dh,kind,causal,p_drop", [
    ("small", 2, 64, 64, 2, 64, "pad", False, 0.1),
    ("small", 2, 128, 128, 2, 64, "pad", True, 0.1),
    ("small", 2, 100, 77, 2, 64, "none", True, 0.0),
    ("small", 1, 96, 200, 2, 32, "pad", False, 0.0),
    ("small", 1, 128, 128, 2, 72, "pad", False, 0.1),
    ("small", 1, 128, 128, 2, 128, "pad", True, 0.0),
    ("small", 1, 128, 128, 2, 256, "pad", True, 0.1),
    ("kblock", 1, 128, 768, 2, 64, "pad", True, 0.1),
    ("bhtd", 1, 256, 1280, 2, 64, "pad", False, 0.0),
    ("bhtd", 1, 1280, 1280, 1, 64, "pad", True, 0.1),
])


def _model_and_refs(route, b, tq, tk, h, dh, kind, causal, p_drop, terms):
    """(model dq, dk, dv; the plain version's in f64) for one case."""
    q, k, v, g, bias = _inputs(b, tq, tk, h, dh, kind, seed=tq + tk + dh)
    assert fa.attention_route(tq, tk, h, dh) == route
    scale = 1.0 / math.sqrt(dh)
    seed = 97 if p_drop else None
    # the wrapper's route: causal folded into the bias on the small route
    _, rbias, rcausal = fa._bthd_route(q, k, causal, bias)
    out, lse = fa.attention_bthd_plain(q, k, v, rbias, scale, seed, p_drop,
                                       rcausal)
    model = kernel_model(q, k, v, rbias, seed, out, lse, g, scale, p_drop,
                         rcausal, terms)
    refs = fa.attention_bthd_bwd_plain(
        *(x.double() for x in (q, k, v)),
        None if rbias is None else rbias.double(), seed, out.double(),
        lse.double(), g.double(), scale, p_drop, rcausal)
    return model, refs


@CASES
def test_two_term_model_holds_the_f64_plain_backward(route, b, tq, tk, h,
                                                     dh, kind, causal,
                                                     p_drop):
    model, refs = _model_and_refs(route, b, tq, tk, h, dh, kind, causal,
                                  p_drop, terms=2)
    for name, got, ref in zip(("dq", "dk", "dv"), model, refs):
        assert ref.dtype == torch.float64 and torch.isfinite(got).all()
        assert _rel(got, ref) <= TOL_UNROUNDED_REL, (name, _rel(got, ref))
        assert _rel(_bf16(got), ref) <= TOL_GRAD_REL, (name,
                                                       _rel(_bf16(got), ref))


@CASES
def test_one_bf16_term_misses_the_unrounded_limit(route, b, tq, tk, h, dh,
                                                  kind, causal, p_drop):
    """Why the kernels carry two terms: P o M and dS rounded once leave
    the gradients over ten times further from the f64 version."""
    model, refs = _model_and_refs(route, b, tq, tk, h, dh, kind, causal,
                                  p_drop, terms=1)
    worst = max(_rel(got, ref) for got, ref in zip(model, refs))
    assert worst > 10 * TOL_UNROUNDED_REL, worst


def test_two_bf16_terms_carry_sixteen_bits():
    """hi + lo reconstructs an f32 value within 2^-16 of it, where one
    bf16 term alone is off by up to 2^-8."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32))
    hi, lo = _terms(x)
    one = ((hi - x).abs() / x.abs()).max().item()
    two = ((hi + lo - x).abs() / x.abs()).max().item()
    assert 2.0 ** -9 < one <= 2.0 ** -8
    assert two <= 2.0 ** -16
