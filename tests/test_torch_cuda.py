"""Card-only checks of the port's CUDA kernels against their plain
versions.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: out 5e-6 in f32 (both sum in f32, in
different orders) and 8e-3 in bf16 (one bf16 ulp of outputs below 2);
lse, f32 in both dtypes, 5e-6; dq/dk/dv relative to the largest
|gradient|, 1e-5 in f32 and 8e-3 (one bf16 ulp) in bf16. The dropout
mask is compared bit for bit."""

import pytest
import torch

from paddle_tpu_torch.parallel import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,b,tq,tk,dh,causal,pad", [
    (torch.float32, 1, 128, 128, 64, False, True),
    (torch.bfloat16, 8, 256, 256, 64, True, False),
    (torch.float32, 2, 64, 128, 64, False, True),
    (torch.float32, 2, 100, 77, 64, False, False),
    (torch.float32, 1, 8, 512, 64, False, True),
    (torch.float32, 2, 128, 128, 128, False, True),
    (torch.bfloat16, 2, 96, 200, 32, False, True),
])
def test_kernel_matches_plain(cuda, dtype, b, tq, tk, dh, causal, pad):
    g = torch.Generator(device=cuda).manual_seed(0)
    h = 8
    q, k, v = (torch.randn(b, t, h, dh, generator=g, device=cuda).to(dtype)
               for t in (tq, tk, tk))
    bias = None
    if pad:
        bias = torch.where(torch.arange(tk, device=cuda) < tk - 5, 0.0,
                           -1e9)[None, None, None, :]
    before = fa.launches
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, None, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    eff = fa._combined_causal_bias(bias, tq, tk, cuda) if causal else bias
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, eff)
    tol = 5e-6 if dtype == torch.float32 else 8e-3
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 5e-6


def test_unported_regimes_raise_and_decode_stays_plain(cuda):
    """Every long shape takes its route: tk = 2048 (and tq = 1 over a
    1024-row cache) launches the kernels on the bhtd route; tk = 640 at tq
    = 128 divides no BHTD block, so it stays dense, as does the decode
    step over a 128-row cache."""
    h, dh = 8, 64
    q = torch.randn(1, 128, h, dh, device=cuda)
    for tq, tk, route in ((128, 640, "dense"), (128, 2048, "bhtd"),
                          (1, 1024, "bhtd"), (1, 128, "dense")):
        assert fa.attention_route(tq, tk, h, dh) == route
        kv = torch.randn(1, tk, h, dh, device=cuda)
        fa.reset_counts()
        out, lse = fa.flash_attention_bthd_fwd(q[:, :tq], kv, kv)
        grads = fa.flash_attention_bthd_bwd(q[:, :tq], kv, kv, None, None,
                                            out, lse, out)
        torch.cuda.synchronize()
        kernel = route != "dense"
        assert fa.launch_counts.get((route, "fwd"), 0) == int(kernel)
        assert fa.launch_counts.get((route, "bwd"), 0) == int(kernel)
        assert fa.dense_calls == 2 * (not kernel)
        assert out.shape == (1, tq, h, dh) and grads[1].shape == kv.shape


def _bwd_inputs(cuda, dtype, b, tq, tk, dh, kind, h=8):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, t, h, dh, generator=g, device=cuda).to(dtype)
               for t in (tq, tk, tk))
    bias = None
    if kind in ("pad", "cross", "causal_pad"):
        lens = torch.randint(tk // 2, tk + 1, (b, 1), generator=g,
                             device=cuda)
        bias = torch.where(torch.arange(tk, device=cuda)[None] < lens, 0.0,
                           -1e9)[:, None, None, :]
    dout = torch.randn(b, tq, h, dh, generator=g, device=cuda).to(dtype)
    return q, k, v, bias, kind.startswith("causal"), dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,tq,tk,p_drop", [
    ("causal_pad", 256, 256, 0.0), ("pad", 256, 256, 0.0),
    ("cross", 128, 256, 0.0), ("causal_pad", 256, 256, 0.1),
    ("cross", 64, 128, 0.3),
])
def test_bwd_kernel_matches_plain(cuda, dtype, kind, tq, tk, p_drop):
    """The backward kernel and the forward kernel with dropout against
    their plain versions, which rebuild the same keep mask."""
    q, k, v, bias, causal, dout = _bwd_inputs(cuda, dtype, 4, tq, tk, 64,
                                              kind)
    seed = 77 if p_drop else None
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, None, causal,
                                           seed=seed, p_drop=p_drop)
    eff = fa._combined_causal_bias(bias, tq, tk, cuda) if causal else bias
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, eff, None, seed,
                                               p_drop)
    f32 = dtype == torch.float32
    assert (out.float() - ref_out.float()).abs().max().item() <= \
        (5e-6 if f32 else 8e-3)
    assert (lse - ref_lse).abs().max().item() <= 5e-6
    before = fa.bwd_launches
    grads = fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, dout,
                                        None, p_drop, causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    refs = fa.attention_bthd_bwd_plain(q, k, v, eff, seed, out, lse, dout,
                                       None, p_drop)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype
        rel = ((got.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert rel <= (1e-5 if f32 else 8e-3), rel


@pytest.mark.parametrize("dh,tq,tk", [(128, 128, 128), (32, 100, 77)])
def test_bwd_kernel_head_widths_and_ragged(cuda, dh, tq, tk):
    q, k, v, bias, _, dout = _bwd_inputs(cuda, torch.float32, 2, tq, tk,
                                         dh, "pad", h=4)
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed=5,
                                           p_drop=0.2)
    grads = fa.flash_attention_bthd_bwd(q, k, v, bias, 5, out, lse, dout,
                                        None, 0.2)
    refs = fa.attention_bthd_bwd_plain(q, k, v, bias, 5, out, lse, dout,
                                       None, 0.2)
    for got, ref in zip(grads, refs):
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-5, rel


def test_mask_dump_equals_plain_mask(cuda):
    before = fa.mask_launches
    got = fa.dropout_keep_mask(123, 3, 5, 256, 200, 0.1, cuda)
    torch.cuda.synchronize()
    assert fa.mask_launches == before + 1
    ref = fa.dropout_keep_mask_plain(123, 3, 5, 256, 200, 0.1, cuda)
    assert torch.equal(got, ref.permute(0, 2, 1, 3))


def test_autograd_function_runs_the_backward_kernel(cuda):
    q, k, v, bias, _, dout = _bwd_inputs(cuda, torch.float32, 2, 128, 128,
                                         64, "pad")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = fa.bwd_launches
    out, _ = fa.flash_attention_bthd_with_lse(q, k, v, bias, 9, None, 0.1,
                                              True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.bwd_launches == before + 1
    q2, k2, v2 = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    out2, _ = fa.attention_bthd_plain(
        q2, k2, v2, fa._combined_causal_bias(bias.cpu(), 128, 128, "cpu"),
        None, 9, 0.1)
    refs = torch.autograd.grad(out2, (q2, k2, v2), dout.cpu())
    for got, ref in zip((dq, dk, dv), refs):
        rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, rel


# --- the long-context routes (kblock, bhtd): in-kernel causal mask ---


def _long_inputs(cuda, dtype, b, tq, tk, kind, bhtd=False, h=8, dh=64):
    g = torch.Generator(device=cuda).manual_seed(2)
    shape = (lambda t: (b, h, t, dh)) if bhtd else (lambda t: (b, t, h, dh))
    q, k, v = (torch.randn(*shape(t), generator=g, device=cuda).to(dtype)
               for t in (tq, tk, tk))
    bias = None
    if kind in ("pad", "causal_pad"):
        lens = torch.randint(tk // 2, tk + 1, (b, 1), generator=g,
                             device=cuda)
        bias = torch.where(torch.arange(tk, device=cuda)[None] < lens, 0.0,
                           -1e9)[:, None, None, :]
    dout = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    return q, k, v, bias, kind.startswith("causal"), dout


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _abs(got, ref):
    return (got.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,b,tq,tk,kind,p_drop", [
    ("kblock", 2, 1024, 1024, "causal_pad", 0.1),
    ("kblock", 2, 256, 768, "pad", 0.0),
    ("bhtd", 1, 2048, 2048, "causal_pad", 0.0),
    ("bhtd", 1, 512, 1280, "pad", 0.1),
])
def test_long_routes_match_plain(cuda, dtype, route, b, tq, tk, kind,
                                 p_drop):
    """Forward and backward kernels on the kblock and bhtd routes, causal
    in-kernel and not, with and without dropout, against the plain
    versions; one launch of each on the route."""
    q, k, v, bias, causal, dout = _long_inputs(cuda, dtype, b, tq, tk, kind)
    assert fa.attention_route(tq, tk, 8, 64) == route
    seed = 31 if p_drop else None
    fa.reset_counts()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, None, causal,
                                           seed=seed, p_drop=p_drop)
    grads = fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, dout,
                                        None, p_drop, causal)
    torch.cuda.synchronize()
    assert fa.launch_counts[(route, "fwd")] == 1
    assert fa.launch_counts[(route, "bwd")] == 1 and fa.dense_calls == 0
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, bias, None, seed,
                                               p_drop, causal)
    f32 = dtype == torch.float32
    assert _abs(out, ref_out) <= (5e-6 if f32 else 8e-3)
    assert _abs(lse, ref_lse) <= 5e-6
    refs = fa.attention_bthd_bwd_plain(q, k, v, bias, seed, out, lse, dout,
                                       None, p_drop, causal)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype
        assert _rel(got, ref) <= (1e-5 if f32 else 8e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_bhtd_layout_strides_and_lse_cotangent(cuda, causal):
    """BHTD tensors run through the head strides with no transpose, and
    the lse cotangent folds into delta."""
    q, k, v, bias, _, dout = _long_inputs(cuda, torch.float32, 2, 512, 512,
                                          "pad", bhtd=True)
    g_lse = torch.randn(2, 8, 512, 1, device=cuda)
    fa.reset_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, bias, causal=causal)
    grads = fa.flash_attention_bwd(q, k, v, bias, None, out, lse, dout,
                                   causal=causal, g_lse=g_lse)
    torch.cuda.synchronize()
    assert fa.launch_counts[("bhtd", "fwd")] == 1
    assert fa.launch_counts[("bhtd", "bwd")] == 1
    ref_out, ref_lse = fa.attention_plain(q, k, v, bias, causal=causal)
    assert out.shape == q.shape and lse.shape == (2, 8, 512, 1)
    assert _abs(out, ref_out) <= 5e-6 and _abs(lse, ref_lse) <= 5e-6
    refs = fa.attention_bwd_plain(q, k, v, bias, None, out, lse, dout,
                                  causal=causal, g_lse=g_lse)
    for got, ref in zip(grads, refs):
        assert _rel(got, ref) <= 1e-5


def test_decode_step_shape_launches_the_bhtd_forward(cuda):
    """tq = 1 over a 1024-row cache (the serving decode step at max_len
    1024): the bhtd forward kernel, against the plain version."""
    q, k, v, bias, _, _ = _long_inputs(cuda, torch.float32, 4, 1, 1024,
                                       "pad")
    fa.reset_counts()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.launch_counts[("bhtd", "fwd")] == 1
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, bias)
    assert _abs(out, ref_out) <= 5e-6 and _abs(lse, ref_lse) <= 5e-6


def test_causal_long_call_builds_no_score_sized_tensor(cuda):
    """A causal forward and backward at t = 8192 (bhtd route, bf16) rise
    less than 32 MiB above their inputs and outputs: no [tq, tk] tensor
    (a folded f32 bias would be 256 MiB)."""
    q, k, v, _, _, dout = _long_inputs(cuda, torch.bfloat16, 1, 8192, 8192,
                                       "none")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, None, None, True)
    grads = fa.flash_attention_bthd_bwd(q, k, v, None, None, out, lse, dout,
                                        None, 0.0, True)
    torch.cuda.synchronize()
    made = sum(t.numel() * t.element_size() for t in (out, lse, *grads))
    rise = torch.cuda.max_memory_allocated() - base - made
    assert rise < 32 * 2**20, rise
