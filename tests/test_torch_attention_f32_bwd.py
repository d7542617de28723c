"""The arithmetic of the f32 attention backward kernels
(paddle_tpu_torch/csrc/flash_attention_bthd_bwd.cu, bwd_dkdv_tf32_kernel
and bwd_dq_tf32_kernel), on the CPU.

The kernels run only on the card. They compute every matrix product on
the tensor cores in 3xTF32: each f32 operand x is split into big =
tf32(x), rounded as ``cvt.rna.tf32.f32`` rounds (10 explicit mantissa
bits, to nearest, ties away from zero; the kernels add half of the
dropped range to the f32 bit pattern and mask it, with integer ops), and
small = x - big, exact in f32, of which the tensor cores read the top 19
bits (truncated toward zero); a b is taken as big(a) big(b) + big(a)
small(b) + small(a) big(b), summed in f32 (small(a) small(b), about 2^-22
of a b, is dropped). The model
here does the same in PyTorch: f32 inputs; s = q k^T and dp = dout v^T
as 3xTF32 products; p, the keep mask M, delta (with the lse cotangent)
and dS = p o (dp o M - delta) * scale in f32; dq = dS k, dk = dS^T q and
dv = (p o M)^T dout as 3xTF32 products, written as f32. It is held
against ``attention_bthd_bwd_plain`` run in f64 on the same f32 values,
on small shapes of the three kernel routes, with causal masks, padding,
dropout, an lse cotangent and dh 20 to 256. The limit is the card's:
1e-5 of the largest |gradient| (``TOL_GRAD_REL["float32"]`` in
chip_smoke.py). One TF32 product (big(a) big(b) alone) misses it, which
is why the kernels take three. Inputs come from numpy seeds."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import flash_attention as fa

TOL_GRAD_REL = 1e-5


def tf32(x):
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 rounds it: the low 13
    bits of the f32 pattern dropped, to nearest, ties away from zero (half
    of the dropped range added to the magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x):
    """x (f32) as the tensor cores read an f32 pattern that is not TF32:
    the low 13 bits dropped, toward zero."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """(big, small) = (tf32(x), x - big as the tensor cores read it): the
    two TF32 terms the kernels feed the tensor cores for an f32 value x."""
    big = tf32(x)
    return big, truncate(x - big)


def product(eq, a, b, terms=3):
    """einsum(eq, a, b) as the kernels' tensor cores take it: ``terms``
    = 3 sums big big + big small + small big in f32; 1 takes big big
    alone (a single TF32 product)."""
    (ab, as_), (bb, bs) = split(a.float()), split(b.float())
    if terms == 1:
        return torch.einsum(eq, ab, bb)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
            + torch.einsum(eq, ab, bb))


def kernel_model(q, k, v, bias, seed, out, lse, g, scale, p_drop, causal,
                 g_lse=None, terms=3):
    """dq, dk, dv as the tensor-core kernels compute them, f32. ``bias``
    and ``causal`` are the route's: the small route has causal folded
    into ``bias``, the others mask in-kernel. BTHD tensors; lse and
    g_lse [b, tq, h, 1]."""
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    s = product("bqhd,bkhd->bhqk", q, k, terms) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse.permute(0, 2, 1, 3))
    if causal:
        live = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
        p = torch.where(live, p, 0.0)
    dp = product("bqhd,bkhd->bhqk", g, v, terms)
    m = (fa.dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop)
         if p_drop > 0 else torch.ones_like(p))
    delta = (g * out).sum(-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse
    ds = p * (dp * m - delta.permute(0, 2, 1, 3)) * scale
    dq = product("bhqk,bkhd->bqhd", ds, k, terms)
    dk = product("bhqk,bqhd->bkhd", ds, q, terms)
    dv = product("bhqk,bqhd->bkhd", p * m, g, terms)
    return dq, dk, dv


def _inputs(b, tq, tk, h, dh, kind, seed):
    """f32 q, k, v, dout (normal), the f32 padding bias of ``kind`` (none
    or pad: [b, 1, 1, tk], per-row lengths in [tk/2, tk]) and an lse
    cotangent [b, tq, h, 1]."""
    r = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(r.randn(b, t, h, dh).astype(np.float32))
                  for t in (tq, tk, tk, tq))
    bias = None
    if kind == "pad":
        lens = r.randint(tk // 2, tk + 1, b)
        keep = np.arange(tk)[None, :] < lens[:, None]
        bias = torch.from_numpy(
            ((1.0 - keep) * -1e9).astype(np.float32)[:, None, None, :])
    g_lse = torch.from_numpy(r.randn(b, tq, h, 1).astype(np.float32))
    return q, k, v, g, bias, g_lse


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


CASES = pytest.mark.parametrize(
    "route,b,tq,tk,h,dh,kind,causal,p_drop,lse_cot", [
        ("small", 2, 64, 64, 2, 64, "pad", False, 0.1, False),
        ("small", 2, 128, 128, 2, 64, "pad", True, 0.1, False),
        ("small", 2, 100, 77, 2, 64, "none", True, 0.0, False),
        ("small", 2, 100, 77, 2, 20, "none", False, 0.0, False),
        ("small", 1, 96, 200, 2, 32, "pad", False, 0.0, False),
        ("small", 1, 128, 128, 2, 128, "pad", True, 0.2, False),
        ("small", 1, 128, 128, 2, 256, "pad", False, 0.1, False),
        ("small", 1, 128, 128, 2, 256, "pad", True, 0.0, False),
        ("kblock", 1, 128, 768, 2, 64, "pad", True, 0.1, False),
        ("bhtd", 1, 256, 1280, 2, 64, "pad", False, 0.0, True),
        ("bhtd", 1, 1280, 1280, 1, 64, "pad", True, 0.1, True),
    ])


def _model_and_refs(route, b, tq, tk, h, dh, kind, causal, p_drop, lse_cot,
                    terms):
    """(model dq, dk, dv; the plain version's in f64) for one case."""
    q, k, v, g, bias, g_lse = _inputs(b, tq, tk, h, dh, kind,
                                      seed=tq + tk + dh)
    assert fa.attention_route(tq, tk, h, dh) == route
    if not lse_cot:
        g_lse = None
    scale = 1.0 / math.sqrt(dh)
    seed = 97 if p_drop else None
    # the wrapper's route: causal folded into the bias on the small route
    _, rbias, rcausal = fa._bthd_route(q, k, causal, bias)
    out, lse = fa.attention_bthd_plain(q, k, v, rbias, scale, seed, p_drop,
                                       rcausal)
    model = kernel_model(q, k, v, rbias, seed, out, lse, g, scale, p_drop,
                         rcausal, g_lse, terms)
    refs = fa.attention_bthd_bwd_plain(
        *(x.double() for x in (q, k, v)),
        None if rbias is None else rbias.double(), seed, out.double(),
        lse.double(), g.double(), scale, p_drop, rcausal,
        None if g_lse is None else g_lse.double())
    return model, refs


@CASES
def test_three_tf32_products_hold_the_f64_plain_backward(
        route, b, tq, tk, h, dh, kind, causal, p_drop, lse_cot):
    model, refs = _model_and_refs(route, b, tq, tk, h, dh, kind, causal,
                                  p_drop, lse_cot, terms=3)
    for name, got, ref in zip(("dq", "dk", "dv"), model, refs):
        assert ref.dtype == torch.float64 and got.dtype == torch.float32
        assert torch.isfinite(got).all()
        assert _rel(got, ref) <= TOL_GRAD_REL, (name, _rel(got, ref))


@CASES
def test_one_tf32_product_misses_the_f32_limit(route, b, tq, tk, h, dh,
                                               kind, causal, p_drop,
                                               lse_cot):
    """Why the kernels take three products: a single TF32 product leaves
    the gradients over ten times further from the f64 version than the
    card's f32 limit."""
    model, refs = _model_and_refs(route, b, tq, tk, h, dh, kind, causal,
                                  p_drop, lse_cot, terms=1)
    worst = max(_rel(got, ref) for got, ref in zip(model, refs))
    assert worst > 10 * TOL_GRAD_REL, worst


def test_big_plus_small_carries_twenty_one_bits():
    """big + small reconstructs an f32 value within 2^-21 of it (small
    is at most 2^-11 of x and truncates at 2^-10 of itself), where big
    alone (one TF32 rounding) is off by up to 2^-11."""
    x = torch.from_numpy(np.random.RandomState(3).randn(1 << 16)
                         .astype(np.float32))
    big, small = split(x)
    one = ((big - x).abs() / x.abs()).max().item()
    two = ((big + small - x).abs() / x.abs()).max().item()
    assert 2.0 ** -12 < one <= 2.0 ** -11
    assert two <= 2.0 ** -21


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna: ten explicit mantissa bits kept, the nearest
    value taken, a tie rounded away from zero in both signs."""
    ulp = 2.0 ** -10  # TF32's mantissa step at 1
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4, 1.0 + ulp + ulp / 2],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp,
                         1.0 + 2 * ulp], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    low = tf32(torch.randn(1000, generator=torch.Generator().manual_seed(5)))
    assert (low.view(torch.int32) & 0x1FFF).eq(0).all()
