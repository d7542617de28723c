"""Card-only checks of the port's CUDA kernels against their plain
versions.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: out 5e-6 in f32 (both sum in f32, in
different orders) and 8e-3 in bf16 (one bf16 ulp of outputs below 2);
lse, f32 in both dtypes, 5e-6; dq/dk/dv relative to the largest
|gradient|, 1e-5 in f32 and 8e-3 (one bf16 ulp) in bf16. The dropout
mask is compared bit for bit. The kernel studies' tolerances stand above
their tests."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
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
    before = fa.launched("fwd")
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, None, None, 0.0,
                                           causal)
    torch.cuda.synchronize()
    assert fa.launched("fwd") == before + 1
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
        kernels.reset_counts()
        out, lse = fa.flash_attention_bthd_fwd(q[:, :tq], kv, kv)
        grads = fa.flash_attention_bthd_bwd(q[:, :tq], kv, kv, None, None,
                                            out, lse, out)
        torch.cuda.synchronize()
        kernel = route != "dense"
        assert kernels.launch_counts["attention", route, "fwd"] == int(kernel)
        assert kernels.launch_counts["attention", route, "bwd"] == int(kernel)
        assert kernels.launch_counts["attention_dense"] == 2 * (not kernel)
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
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                           p_drop, causal)
    eff = fa._combined_causal_bias(bias, tq, tk, cuda) if causal else bias
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, eff, None, seed,
                                               p_drop)
    f32 = dtype == torch.float32
    assert (out.float() - ref_out.float()).abs().max().item() <= \
        (5e-6 if f32 else 8e-3)
    assert (lse - ref_lse).abs().max().item() <= 5e-6
    before = fa.launched("bwd")
    grads = fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, dout,
                                        None, p_drop, causal)
    torch.cuda.synchronize()
    assert fa.launched("bwd") == before + 1
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


@pytest.mark.parametrize("b,h,tq,tk", [
    (3, 5, 256, 200),
    (2, 8, 7, 1),     # tk = 1: every run is one scalar
    (2, 3, 9, 77),    # h * tk odd: runs start at every 16-byte offset
    (1, 5, 3, 3),
])
def test_mask_dump_equals_plain_mask(cuda, b, h, tq, tk):
    before = kernels.launch_counts["attention_mask"]
    got = fa.dropout_keep_mask(123, b, h, tq, tk, 0.1, cuda)
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention_mask"] == before + 1
    ref = fa.dropout_keep_mask_plain(123, b, h, tq, tk, 0.1, cuda)
    assert torch.equal(got, ref.permute(0, 2, 1, 3))


def test_autograd_function_runs_the_backward_kernel(cuda):
    q, k, v, bias, _, dout = _bwd_inputs(cuda, torch.float32, 2, 128, 128,
                                         64, "pad")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = fa.launched("bwd")
    out, _ = fa.flash_attention_bthd_with_lse(q, k, v, bias, 9, None, 0.1,
                                              True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.launched("bwd") == before + 1
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
    kernels.reset_counts()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                           p_drop, causal)
    grads = fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, dout,
                                        None, p_drop, causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention", route, "fwd"] == 1
    assert kernels.launch_counts["attention", route, "bwd"] == 1
    assert kernels.launch_counts["attention_dense"] == 0
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
    kernels.reset_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, bias, causal=causal)
    grads = fa.flash_attention_bwd(q, k, v, bias, None, out, lse, dout,
                                   causal=causal, g_lse=g_lse)
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention", "bhtd", "fwd"] == 1
    assert kernels.launch_counts["attention", "bhtd", "bwd"] == 1
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
    kernels.reset_counts()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention", "bhtd", "fwd"] == 1
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
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, causal=True)
    grads = fa.flash_attention_bthd_bwd(q, k, v, None, None, out, lse, dout,
                                        None, 0.0, True)
    torch.cuda.synchronize()
    made = sum(t.numel() * t.element_size() for t in (out, lse, *grads))
    rise = torch.cuda.max_memory_allocated() - base - made
    assert rise < 32 * 2**20, rise


# --- the backward on the tensor cores: bf16 on wgmma
# (bwd_dkdv_wgmma_kernel, pass A; bwd_dq_wgmma_kernel, pass B), f32 in
# 3xTF32 on mma.sync (bwd_dkdv_tf32_kernel, bwd_dq_tf32_kernel) ---


def _bwd_vs_plain(cuda, b, tq, tk, h, dh, kind, p_drop=0.0, causal=False,
              bhtd=False, g_lse=False, dtype=torch.bfloat16):
    """(kernel grads, plain grads, launches on each route) of one backward
    call (bf16 unless ``dtype``), fed the kernel forward's (out, lse)."""
    q, k, v, bias, _, dout = _long_inputs(cuda, dtype, b, tq, tk,
                                          kind, bhtd=bhtd, h=h, dh=dh)
    seed = 23 if p_drop else None
    if bhtd:
        out, lse = fa.flash_attention_fwd(q, k, v, bias, seed, None, p_drop,
                                          causal=causal)
        gl = (torch.randn(lse.shape, device=cuda,
                          generator=torch.Generator(device=cuda)
                          .manual_seed(4)) if g_lse else None)
        kernels.reset_counts()
        grads = fa.flash_attention_bwd(q, k, v, bias, seed, out, lse, dout,
                                       None, p_drop, causal=causal, g_lse=gl)
        torch.cuda.synchronize()
        counts = fa.route_counts()
        refs = fa.attention_bwd_plain(q, k, v, bias, seed, out, lse, dout,
                                      None, p_drop, causal, gl)
        return grads, refs, counts
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                           p_drop, causal)
    kernels.reset_counts()
    grads = fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, dout,
                                        None, p_drop, causal)
    torch.cuda.synchronize()
    counts = fa.route_counts()
    route, rbias, rcausal = fa._bthd_route(q, k, causal, bias)
    refs = fa.attention_bthd_bwd_plain(q, k, v, rbias, seed, out, lse, dout,
                                       None, p_drop, rcausal)
    return grads, refs, counts


def _assert_bf16_grads(grads, refs):
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        assert _rel(got, ref) <= 8e-3, _rel(got, ref)


@pytest.mark.parametrize("dh", [32, 64, 72, 128, 136, 256])
def test_bf16_bwd_head_widths(cuda, dh):
    """Every head width the wrapper takes runs in bf16: dh <= 64 in the
    64-column tiles (two warpgroups), 72 and 128 in the 128-column ones,
    136 and 256 in the 256-column ones (two blocks a tile, each writing
    128 columns), the columns past dh zero-padded."""
    grads, refs, counts = _bwd_vs_plain(cuda, 2, 128, 128, 4, dh, "pad",
                                        p_drop=0.1)
    assert counts[("small", "bwd")] == 1
    _assert_bf16_grads(grads, refs)


@pytest.mark.parametrize("dh,causal", [(64, False), (64, True), (20, False)])
def test_bf16_bwd_ragged(cuda, dh, causal):
    """Ragged tq = 100 and tk = 77 are masked in both passes (causal folded
    into the bias, whose rows then stream through shared memory); dh = 20
    copies rows that are not 16-byte aligned element by element."""
    grads, refs, counts = _bwd_vs_plain(cuda, 2, 100, 77, 8, dh, "none",
                                        causal=causal)
    assert counts[("small", "bwd")] == 1
    _assert_bf16_grads(grads, refs)


@pytest.mark.parametrize("route,tq,tk,p_drop", [
    ("kblock", 256, 1024, 0.1), ("bhtd", 1024, 2048, 0.0),
])
def test_bf16_bwd_causal_in_kernel(cuda, route, tq, tk, p_drop):
    grads, refs, counts = _bwd_vs_plain(cuda, 1, tq, tk, 8, 64, "causal_pad",
                                        p_drop=p_drop, causal=True)
    assert counts[(route, "bwd")] == 1
    _assert_bf16_grads(grads, refs)


@pytest.mark.parametrize("tq,tk,route", [(256, 256, "small"),
                                         (1024, 1024, "kblock")])
def test_bf16_bwd_dropout(cuda, tq, tk, route):
    grads, refs, counts = _bwd_vs_plain(cuda, 2, tq, tk, 8, 64, "pad",
                                        p_drop=0.1)
    assert counts[(route, "bwd")] == 1
    _assert_bf16_grads(grads, refs)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_bwd_bhtd_layout_with_lse_cotangent(cuda, causal):
    grads, refs, counts = _bwd_vs_plain(cuda, 2, 512, 512, 8, 64, "pad",
                                        causal=causal, bhtd=True, g_lse=True)
    assert counts[("bhtd", "bwd")] == 1
    _assert_bf16_grads(grads, refs)


@pytest.mark.parametrize("tq,kind,p_drop,causal", [
    (2048, "causal_pad", 0.0, True), (256, "pad", 0.1, False),
])
def test_bf16_bwd_bit_equal_over_two_launches(cuda, tq, kind, p_drop,
                                              causal):
    """No atomics: two launches on the same inputs give equal bits."""
    q, k, v, bias, _, dout = _long_inputs(cuda, torch.bfloat16, 2, tq, tq,
                                          kind)
    seed = 29 if p_drop else None
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                           p_drop, causal)
    first, second = (fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out,
                                                 lse, dout, None, p_drop,
                                                 causal) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bwd_kernel_family_follows_the_dtype(cuda):
    """bf16 launches the wgmma kernels, f32 the 3xTF32 ones, and neither
    launches any other backward pass."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias, _, dout = _long_inputs(cuda, dtype, 1, 256, 256,
                                              "pad")
        out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_attention_bthd_bwd(q, k, v, bias, None, out, lse, dout)
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.key for e in prof.key_averages())
    for dtype, family in ((torch.bfloat16, "wgmma"), (torch.float32, "tf32")):
        for kernel in ("bwd_dkdv", "bwd_dq"):
            assert f"{kernel}_{family}_kernel<" in names[dtype]
            assert names[dtype].count(f"{kernel}_") == 1, names[dtype]


def test_bwd_refuses_what_the_kernel_does_not_take(cuda):
    """float16 raises before any launch, and so does a head dim past 256,
    which the kernels do not take."""
    q = torch.randn(1, 256, 2, 64, device=cuda).to(torch.float16)
    before = fa.launched("bwd")
    with pytest.raises(TypeError):
        fa.flash_attention_bthd_bwd(q, q, q, None, None, q,
                                    torch.zeros(1, 256, 2, 1, device=cuda),
                                    q)
    assert fa.launched("bwd") == before
    q = torch.randn(1, 256, 2, 264, device=cuda).to(torch.bfloat16)
    kernels.reset_counts()
    with pytest.raises(NotImplementedError, match="dh=264"):
        fa.flash_attention_bthd_fwd(q, q, q)
    with pytest.raises(NotImplementedError, match="dh=264"):
        fa.flash_attention_bthd_bwd(q, q, q, None, None, q,
                                    torch.zeros(1, 256, 2, 1, device=cuda),
                                    q)
    assert fa.launched("fwd") == fa.launched("bwd") == 0
    assert kernels.launch_counts["attention_dense"] == 0


def _assert_f32_grads(grads, refs):
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.float32
        assert torch.isfinite(got).all()
        assert _rel(got, ref) <= 1e-5, _rel(got, ref)


@pytest.mark.parametrize("dh", [20, 30, 32, 64, 72, 128, 136, 256])
def test_f32_bwd_head_widths(cuda, dh):
    """Every head width runs in f32 on the 3xTF32 kernels within the f32
    limit: dh <= 64 in the 64-column tiles, 72 and 128 in the 128-column
    ones, 136 and 256 in the 256-column ones (two blocks a tile, each
    writing 128 columns), the columns past dh zero-padded; dh 30 rows are
    not 16-byte aligned and are copied element by element."""
    grads, refs, counts = _bwd_vs_plain(cuda, 2, 128, 128, 4, dh, "pad",
                                        p_drop=0.1, dtype=torch.float32)
    assert counts[("small", "bwd")] == 1
    _assert_f32_grads(grads, refs)


@pytest.mark.parametrize("dh,causal", [(64, False), (64, True), (20, True)])
def test_f32_bwd_ragged(cuda, dh, causal):
    """Ragged tq = 100 and tk = 77 in f32, the causal mask folded into a
    bias whose rows stream through shared memory."""
    grads, refs, counts = _bwd_vs_plain(cuda, 2, 100, 77, 8, dh, "none",
                                        causal=causal, dtype=torch.float32)
    assert counts[("small", "bwd")] == 1
    _assert_f32_grads(grads, refs)


@pytest.mark.parametrize("route,tq,tk,p_drop", [
    ("kblock", 256, 1024, 0.1), ("kblock", 1024, 1024, 0.0),
    ("bhtd", 1024, 2048, 0.0), ("bhtd", 1280, 1280, 0.1),
])
def test_f32_bwd_causal_in_kernel(cuda, route, tq, tk, p_drop):
    grads, refs, counts = _bwd_vs_plain(cuda, 1, tq, tk, 8, 64, "causal_pad",
                                        p_drop=p_drop, causal=True,
                                        dtype=torch.float32)
    assert counts[(route, "bwd")] == 1
    _assert_f32_grads(grads, refs)


@pytest.mark.parametrize("causal", [False, True])
def test_f32_bwd_bhtd_layout_with_lse_cotangent(cuda, causal):
    grads, refs, counts = _bwd_vs_plain(cuda, 2, 512, 512, 8, 64, "pad",
                                        causal=causal, bhtd=True, g_lse=True,
                                        dtype=torch.float32)
    assert counts[("bhtd", "bwd")] == 1
    _assert_f32_grads(grads, refs)


@pytest.mark.parametrize("dh,passes", [(64, 1), (64, 2), (256, 1), (256, 2)])
def test_f32_bwd_each_pass_alone(cuda, dh, passes):
    """Pass A (dk, dv) or pass B (dq) launched alone writes its gradients
    within the f32 limit and leaves the others untouched."""
    q, k, v, bias, _, dout = _long_inputs(cuda, torch.float32, 2, 256, 256,
                                          "pad", h=2, dh=dh)
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, 3, None, 0.1)
    grads = [torch.zeros_like(x) for x in (q, k, v)]
    fa._launch_bwd("small", q, k, v, bias, 3, out, lse, dout, None,
                   1.0 / dh ** 0.5, 0.1, False, *grads, passes=passes)
    torch.cuda.synchronize()
    refs = fa.attention_bthd_bwd_plain(q, k, v, bias, 3, out, lse, dout,
                                       None, 0.1)
    for i, (got, ref) in enumerate(zip(grads, refs)):
        if (i == 0) == (passes == 2):
            assert _rel(got, ref) <= 1e-5, (i, _rel(got, ref))
        else:
            assert not got.any(), i


@pytest.mark.parametrize("tq,kind,p_drop,causal,bhtd", [
    (256, "pad", 0.1, False, False), (2048, "causal_pad", 0.0, True, False),
    (512, "pad", 0.0, True, True),
])
def test_f32_bwd_bit_equal_over_two_launches(cuda, tq, kind, p_drop,
                                             causal, bhtd):
    """No atomics in f32 either: two launches on the same inputs give
    equal bits."""
    q, k, v, bias, _, dout = _long_inputs(cuda, torch.float32, 2, tq, tq,
                                          kind, bhtd=bhtd)
    seed = 29 if p_drop else None
    if bhtd:
        out, lse = fa.flash_attention_fwd(q, k, v, bias, seed, None, p_drop,
                                          causal=causal)
        first, second = (fa.flash_attention_bwd(q, k, v, bias, seed, out, lse,
                                                dout, None, p_drop,
                                                causal=causal)
                         for _ in range(2))
    else:
        out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                               p_drop, causal)
        first, second = (fa.flash_attention_bthd_bwd(q, k, v, bias, seed,
                                                     out, lse, dout, None,
                                                     p_drop, causal)
                         for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# --- bf16 forward on the tensor cores (fwd_wgmma_kernel); f32 keeps the
# CUDA-core fwd_kernel ---


def _bf16_fwd(cuda, b, tq, tk, h, dh, kind, p_drop=0.0, causal=False,
              bhtd=False, fused=False):
    """(kernel out, lse; plain out, lse; launches on each route) of one
    bf16 forward call. ``fused``: q, k, v are strided views of one [b, t,
    3 h dh] projection."""
    q, k, v, bias, _, _ = _long_inputs(cuda, torch.bfloat16, b, tq, tk,
                                       kind, bhtd=bhtd, h=h, dh=dh)
    if fused:
        qkv = torch.cat([x.reshape(b, tq, h * dh) for x in (q, k, v)], -1)
        q, k, v = (x.reshape(b, tq, h, dh) for x in qkv.split(h * dh, -1))
    seed = 37 if p_drop else None
    kernels.reset_counts()
    if bhtd:
        out, lse = fa.flash_attention_fwd(q, k, v, bias, seed, None, p_drop,
                                          causal=causal)
        torch.cuda.synchronize()
        refs = fa.attention_plain(q, k, v, bias, None, seed, p_drop, causal)
    else:
        out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                               p_drop, causal)
        torch.cuda.synchronize()
        _, rbias, rcausal = fa._bthd_route(q, k, causal, bias)
        refs = fa.attention_bthd_plain(q, k, v, rbias, None, seed, p_drop,
                                       rcausal)
    return (out, lse), refs, fa.route_counts()


def _assert_bf16_fwd(got, refs, shape):
    out, lse = got
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert _abs(out, refs[0]) <= 8e-3, _abs(out, refs[0])
    assert _abs(lse, refs[1]) <= 5e-6, _abs(lse, refs[1])


@pytest.mark.parametrize("route,b,tq,tk,h,dh,kind,p_drop,causal", [
    ("small", 4, 256, 256, 8, 64, "pad", 0.1, False),
    ("small", 4, 256, 256, 8, 64, "pad", 0.1, True),  # bias rows stream
    ("small", 2, 100, 77, 8, 64, "none", 0.0, True),  # ragged edges
    ("small", 2, 96, 200, 4, 32, "pad", 0.0, False),
    ("small", 2, 128, 128, 4, 72, "pad", 0.1, False),
    ("small", 2, 128, 128, 4, 128, "pad", 0.2, False),
    ("small", 2, 128, 128, 2, 256, "pad", 0.1, False),
    ("small", 2, 100, 77, 4, 20, "none", 0.0, False),  # unaligned rows
    ("kblock", 2, 1024, 1024, 8, 64, "causal_pad", 0.1, True),
    ("kblock", 1, 256, 768, 4, 128, "pad", 0.0, False),
    ("bhtd", 1, 2048, 2048, 8, 64, "causal_pad", 0.0, True),
    ("bhtd", 1, 512, 1280, 4, 72, "pad", 0.1, True),
])
def test_bf16_fwd_kernel_matches_plain(cuda, route, b, tq, tk, h, dh, kind,
                                       p_drop, causal):
    got, refs, counts = _bf16_fwd(cuda, b, tq, tk, h, dh, kind, p_drop,
                                  causal)
    assert fa.attention_route(tq, tk, h, dh) == route
    assert counts[(route, "fwd")] == 1
    assert kernels.launch_counts["attention_dense"] == 0
    _assert_bf16_fwd(got, refs, (b, tq, h, dh))


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_fwd_strided_layouts(cuda, causal):
    """BHTD tensors (the bhtd route's head strides) and the q/k/v views of
    a fused projection run with no copy."""
    got, refs, counts = _bf16_fwd(cuda, 2, 512, 512, 8, 64, "pad",
                                  causal=causal, bhtd=True)
    assert counts[("bhtd", "fwd")] == 1
    _assert_bf16_fwd(got, refs, (2, 8, 512, 64))
    got, refs, counts = _bf16_fwd(cuda, 2, 256, 256, 8, 64, "pad", 0.1,
                                  causal=causal, fused=True)
    assert counts[("small", "fwd")] == 1
    _assert_bf16_fwd(got, refs, (2, 256, 8, 64))


@pytest.mark.parametrize("tq,kind,p_drop,causal", [
    (2048, "causal_pad", 0.0, True), (256, "pad", 0.1, False),
])
def test_bf16_fwd_bit_equal_over_two_launches(cuda, tq, kind, p_drop,
                                              causal):
    """No atomics: two launches on the same inputs give equal bits."""
    q, k, v, bias, _, _ = _long_inputs(cuda, torch.bfloat16, 2, tq, tq, kind)
    seed = 41 if p_drop else None
    first, second = (fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                                 p_drop, causal)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fwd_kernel_family_follows_the_dtype(cuda):
    """bf16 launches fwd_wgmma_kernel, f32 the CUDA-core fwd_kernel."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias, _, _ = _long_inputs(cuda, dtype, 1, 256, 256, "pad")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_attention_bthd_fwd(q, k, v, bias)
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.key for e in prof.key_averages())
    assert "fwd_wgmma_kernel" in names[torch.bfloat16]
    assert "fwd_kernel<" not in names[torch.bfloat16]
    assert "fwd_kernel<" in names[torch.float32]
    assert "fwd_wgmma_kernel" not in names[torch.float32]


# --- the f32 forward: split-KV decode (tq <= 8), tiled, and the merge ---


@pytest.mark.parametrize("layout,b,tq,tk,kind,p_drop,dh", [
    ("bthd", 4, 1, 1024, "pad", 0.0, 64),    # the serving decode step
    ("bthd", 4, 1, 4096, "pad", 0.1, 64),
    ("bhtd", 4, 1, 1024, "pad", 0.0, 64),
    ("bhtd", 2, 1, 1, "none", 0.0, 64),      # tk = 1
    ("bhtd", 2, 3, 77, "pad", 0.1, 64),      # tk no multiple of a split
    ("bthd", 2, 8, 77, "pad", 0.0, 64),      # small route, tq = 8
    ("bhtd", 1, 5, 1024, "causal_pad", 0.0, 64),
    ("bhtd", 2, 2, 1024, "pad", 0.2, 256),   # the widest head
    ("bhtd", 2, 6, 256, "pad", 0.0, 20),     # a head dim of 20
])
def test_f32_decode_kernel_matches_plain(cuda, layout, b, tq, tk, kind,
                                         p_drop, dh):
    """tq 1..8 runs fwd_decode_kernel over the plan's key splits (and
    fwd_merge_kernel when there are several), against the plain version at
    the f32 limits (out and lse 5e-6), BHTD and BTHD, with the batch's pad
    bias, dropout and the in-kernel causal mask; a second launch gives
    equal bits."""
    bhtd = layout == "bhtd"
    q, k, v, bias, causal, _ = _long_inputs(cuda, torch.float32, b, tq, tk,
                                            kind, bhtd=bhtd, dh=dh)
    seed = 5 if p_drop else None
    if bhtd:
        def run():
            return fa.flash_attention_fwd(q, k, v, bias, seed, None, p_drop,
                                          causal=causal)
        route = fa.attention_route(tq, tk, 8, dh, "bhtd")
        ref = fa.attention_plain(q, k, v, bias, None, seed, p_drop, causal)
    else:
        def run():
            return fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                               p_drop, causal)
        route = fa.attention_route(tq, tk, 8, dh)
        ref = fa.attention_bthd_plain(q, k, v, bias, None, seed, p_drop,
                                      causal)
    assert route != "dense"
    kernels.reset_counts()
    out, lse = run()
    out2, lse2 = run()
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention", route, "fwd"] == 2
    assert kernels.launch_counts["attention_dense"] == 0
    assert _abs(out, ref[0]) <= 5e-6, _abs(out, ref[0])
    assert _abs(lse, ref[1]) <= 5e-6, _abs(lse, ref[1])
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("b,tq,tk,kind,p_drop,dh", [
    (1, 1024, 1024, "pad", 0.1, 64),   # the 1024 prefill: two key splits
    (1, 128, 128, "pad", 0.0, 64),     # the 128 prefill
    (2, 256, 256, "pad", 0.0, 256),    # dh 256: four splits of 64 keys
    (1, 100, 200, "none", 0.1, 72),    # ragged tiles, padded head dim
    (2, 1024, 1024, "causal_pad", 0.1, 128),
])
def test_f32_tiled_kernel_matches_plain_and_repeats(cuda, b, tq, tk, kind,
                                                    p_drop, dh):
    """tq > 8 runs fwd_kernel (64-row query tiles, split over keys when
    the grid leaves SMs idle, then fwd_merge_kernel): f32 limits, equal
    bits over two launches."""
    q, k, v, bias, causal, _ = _long_inputs(cuda, torch.float32, b, tq, tk,
                                            kind, h=2, dh=dh)
    seed = 9 if p_drop else None
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None, p_drop,
                                           causal)
    out2, lse2 = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                             p_drop, causal)
    torch.cuda.synchronize()
    _, rbias, rcausal = fa._bthd_route(q, k, causal, bias)
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, rbias, None, seed,
                                               p_drop, rcausal)
    assert _abs(out, ref_out) <= 5e-6, _abs(out, ref_out)
    assert _abs(lse, ref_lse) <= 5e-6, _abs(lse, ref_lse)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,tq,tk,dh,causal", [
    ("small", 256, 256, 256, False), ("small", 100, 77, 136, True),
    ("kblock", 128, 768, 256, True), ("bhtd", 256, 2048, 256, True),
])
def test_wide_heads_launch_the_kernels(cuda, dtype, route, tq, tk, dh,
                                       causal):
    """dh up to 256 (the JAX small kernel takes any width) launches the
    forward and the backward kernels, one each on the route and no dense
    call, within the limits of the narrower heads."""
    q, k, v, bias, _, dout = _long_inputs(cuda, dtype, 1, tq, tk, "pad",
                                          h=2, dh=dh)
    assert fa.attention_route(tq, tk, 2, dh) == route
    kernels.reset_counts()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, causal=causal)
    grads = fa.flash_attention_bthd_bwd(q, k, v, bias, None, out, lse, dout,
                                        None, 0.0, causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention", route, "fwd"] == 1
    assert kernels.launch_counts["attention", route, "bwd"] == 1
    assert kernels.launch_counts["attention_dense"] == 0
    _, rbias, rcausal = fa._bthd_route(q, k, causal, bias)
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, rbias, None, None,
                                               0.0, rcausal)
    f32 = dtype == torch.float32
    assert _abs(out, ref_out) <= (5e-6 if f32 else 8e-3), _abs(out, ref_out)
    assert _abs(lse, ref_lse) <= 5e-6, _abs(lse, ref_lse)
    refs = fa.attention_bthd_bwd_plain(q, k, v, rbias, None, out, lse, dout,
                                       None, 0.0, rcausal)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype
        assert _rel(got, ref) <= (1e-5 if f32 else 8e-3), _rel(got, ref)


# --- the kernel studies (paddle_tpu_torch/benchmarks) ---
#
# bf16 outputs within one bf16 ulp (2^-7 relative) of the largest output
# (kernel and plain version sum the same bf16 products in f32, in other
# orders, and round once); the f32 dW of the 1x1-conv backward within 1e-5
# of its largest element (read 2e-6 on an H100).

_ULP = 2.0 ** -7


@pytest.mark.parametrize("n,ci,co", [
    (4096, 64, 256),    # whole tiles, one slice
    (3000, 128, 512),   # ragged: n is no multiple of the n-tile
    (77, 64, 1024),     # fewer rows than one n-range; 16-channel slices
    (5000, 48, 16),     # the narrowest co; a 48-channel slice
    (1000, 32, 48),
    (25089, 256, 1024),  # the widest study shape, one row past a tile
    (129, 16, 1024),    # ci = 16 (one 16-channel slice), co = 1024
    (300, 16, 1008),    # co padded within the last dy chunk
    (401409, 64, 256),  # the largest study shape, ragged
    (9601, 96, 1024),   # co split over a cluster pair with 32-ch slices
])
def test_conv1x1_bwd_kernel_matches_plain(cuda, n, ci, co):
    """Ragged n is handled (the JAX function asserts n % tn == 0): rows
    past n are masked in the kernel's last tile."""
    from paddle_tpu_torch.benchmarks import conv_bwd as cb

    x, dy, w = cb.make_inputs(n, ci, co, seed=1, device=cuda)
    before = kernels.launch_counts[cb.SOURCE]
    dx, dw = cb.combined_conv1x1_bwd(x, dy, w)
    dx2, dw2 = cb.combined_conv1x1_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts[cb.SOURCE] == before + 2
    ref_dx, ref_dw = cb.combined_conv1x1_bwd_plain(x, dy, w)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert (dx.float() - ref_dx.float()).abs().max() <= \
        _ULP * ref_dx.float().abs().max()
    assert (dw - ref_dw).abs().max() <= 1e-5 * ref_dw.abs().max()
    # the partial sums are added in a fixed order: the same bits every run
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)


def test_conv1x1_bwd_refuses_what_the_kernel_does_not_take(cuda):
    from paddle_tpu_torch.benchmarks import conv_bwd as cb

    x, dy, w = cb.make_inputs(64, 24, 32, device=cuda)  # ci % 16 != 0
    with pytest.raises(NotImplementedError, match="multiples of 16"):
        cb.combined_conv1x1_bwd(x, dy, w)
    x, dy, w = cb.make_inputs(64, 32, 2048, device=cuda)
    with pytest.raises(NotImplementedError, match="co <= 1024"):
        cb.combined_conv1x1_bwd(x, dy, w)
    x, dy, w = cb.make_inputs(64, 32, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cb.combined_conv1x1_bwd(x, dy, w.t().contiguous().t())
    with pytest.raises(ValueError, match="is on"):
        cb.combined_conv1x1_bwd(x, dy.cpu(), w)


@pytest.mark.parametrize("n,h,w,c,groups", [
    (4, 56, 56, 128, 32),   # 4 channels a group, whole tiles
    (2, 28, 28, 256, 32),   # 8 channels a group
    (3, 13, 17, 96, 12),    # ragged H, W and a last chunk of 32 channels
    (2, 5, 30, 64, 16),
    (1, 1, 1, 8, 2),        # a single pixel: every tap but one is padding
    (2, 14, 14, 512, 32),   # 16 channels a group (dense B tiles)
    (2, 7, 7, 1024, 32),    # 32 channels a group: two k-steps a tap
    (2, 9, 11, 256, 4),     # 64 channels a group: B tiles read a k-step
    (1, 6, 5, 256, 2),      # 128 channels a group
    (3, 13, 17, 96, 6),     # ragged at 16 channels a group
    (2, 30, 5, 64, 4),
    (1, 1, 30, 32, 2),
    (2, 5, 5, 128, 64),     # 2 channels a group
    (128, 7, 7, 128, 128),  # 1 channel a group
])
def test_grouped_conv_kernel_matches_plain_and_library(cuda, n, h, w, c,
                                                       groups):
    from paddle_tpu_torch.benchmarks import grouped_conv as gc

    x, wg = gc.make_inputs(n, h, w, c, groups=groups, seed=1, device=cuda)
    before = kernels.launch_counts[gc.SOURCE]
    y = gc.grouped_conv(x, wg, groups)
    y2 = gc.grouped_conv(x, wg, groups)
    torch.cuda.synchronize()
    assert kernels.launch_counts[gc.SOURCE] == before + 2
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    for ref in (gc.grouped_conv_plain(x, wg, groups),
                gc.conv_ref(x, wg, groups)):
        assert (y.float() - ref.float()).abs().max() <= \
            _ULP * ref.float().abs().max()
    # no atomics: a second launch gives the same bits
    assert torch.equal(y, y2)


def test_grouped_conv_refuses_what_the_kernel_does_not_take(cuda):
    from paddle_tpu_torch.benchmarks import grouped_conv as gc

    # cg = 12 divides no 128: the block-diagonal packing cannot take it
    x, wg = gc.make_inputs(1, 4, 4, 96, groups=8, device=cuda)
    with pytest.raises(NotImplementedError, match="divides 128"):
        gc.grouped_conv(x, wg, 8)
    x, wg = gc.make_inputs(1, 4, 4, 32, groups=8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gc.grouped_conv(x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
                        wg, 8)


@pytest.mark.parametrize("variant", ["matmul-floor", "full", "no-rowmax",
                                     "bf16-exp"])
@pytest.mark.parametrize("b,h,t,dh,bk", [
    (4, 8, 256, 64, 256),   # the study's head shape, one key block
    (2, 4, 256, 128, 64),   # the wide head, four key blocks
    (2, 3, 128, 32, 64),    # a head width below the template bound
    (1, 2, 512, 96, 128),
])
def test_attn_ablate_kernel_matches_plain(cuda, variant, b, h, t, dh, bk):
    from paddle_tpu_torch.benchmarks import attn_ablate as aa

    q, k, v = aa.make_inputs(b, h, t, dh, seed=1, device=cuda)
    fwd = aa.make_fwd(variant, b, h, t, dh, t, bk)
    before = kernels.launch_counts[aa.SOURCE]
    out = fwd(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts[aa.SOURCE] == before + 1
    ref = aa.attn_ablate_plain(q, k, v, variant, bk)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max() <= \
        _ULP * ref.float().abs().max()


@pytest.mark.parametrize("variant", ["full", "bf16-exp"])
def test_attn_ablate_widest_block_and_equal_bits(cuda, variant):
    """bk = 512, the widest key block the kernel takes (eight 64-key tiles
    under one row max); two launches give equal bits."""
    from paddle_tpu_torch.benchmarks import attn_ablate as aa

    q, k, v = aa.make_inputs(2, 4, 1024, 64, seed=2, device=cuda)
    fwd = aa.make_fwd(variant, 2, 4, 1024, 64, 1024, 512)
    out = fwd(q, k, v)
    assert torch.equal(out, fwd(q, k, v))
    ref = aa.attn_ablate_plain(q, k, v, variant, 512)
    assert (out.float() - ref.float()).abs().max() <= \
        _ULP * ref.float().abs().max()


def test_attn_ablate_refuses_what_the_kernel_does_not_take(cuda):
    """A ragged key block (bk no multiple of 64) raises: the JAX script
    runs only t % bk == 0, and the kernel's key tiles are 64 wide."""
    from paddle_tpu_torch.benchmarks import attn_ablate as aa

    q, k, v = aa.make_inputs(1, 2, 96, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="multiple of 64"):
        aa.make_fwd("full", 1, 2, 96, 64, 96, 48)(q, k, v)
    q, k, v = aa.make_inputs(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        aa.make_fwd("full", 1, 2, 64, 64, 64, 64)(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


def test_vision_ops_run_on_the_card(cuda):
    """One AMP training step of a two-block SE-ResNeXt through the
    executor on the card: finite loss, moving statistics updated, and the
    f32 step within 1e-4 of the CPU's."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.models import se_resnext as S

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            img = fluid.layers.data("data", shape=[3, 32, 32])
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            x = S.conv_bn_layer(img, 16, 3, act="relu", prefix="stem")
            x = S.bottleneck_block(x, 16, 1, 4, 4, False, "b0")
            x = S.bottleneck_block(x, 32, 2, 4, 4, False, "b1")
            x = fluid.layers.pool2d(x, pool_type="avg", global_pooling=True)
            logits = fluid.layers.fc(x, 10)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, label))
            fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    startup.random_seed = 3
    r = np.random.RandomState(0)
    feed = {"data": r.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32),
            "label": r.randint(0, 10, (4, 1)).astype(np.int64)}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            state = {n: scope.find_var(n).cpu().numpy()
                     for n in scope.var_names()}
            (gpu,) = exe.run(main, feed=feed, fetch_list=[loss])
            assert float(scope.find_var("stem_bn.mean").abs().max()) > 0
        with fluid.scope_guard(tio.scope_from_numpy(state,
                                                    fluid.CPUPlace())):
            (cpu,) = fluid.Executor(fluid.CPUPlace()).run(
                main, feed=feed, fetch_list=[loss])
        assert abs(float(gpu) - float(cpu)) <= 1e-4
        fluid.amp.enable_amp(main)
        with fluid.scope_guard(tio.scope_from_numpy(state,
                                                    fluid.CUDAPlace(0))):
            (amp_loss,) = fluid.Executor(fluid.CUDAPlace(0)).run(
                main, feed=feed, fetch_list=[loss])
        assert np.isfinite(amp_loss) and abs(float(amp_loss) - float(cpu)) < 0.1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# --- the dropout op's kernel and the device seeds ---


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [
    ((1,), 0),            # the tail alone
    ((7,), 0),
    ((13, 33), 0),        # ragged: a tail after the vectors
    ((64, 250, 3), 0),
    ((5, 1029), 3),       # an unaligned view: copied to 16 bytes first
])
@pytest.mark.parametrize("p,upscale", [(0.1, True), (0.5, False)])
def test_dropout_kernel_bit_for_bit_against_plain(cuda, dtype, shape, offset,
                                                  p, upscale):
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import nn_ops

    n = int(torch.tensor(shape).prod())
    base = torch.randn(n + offset, generator=torch.Generator(device=cuda)
                       .manual_seed(9), device=cuda).to(dtype)
    x = base[offset:].reshape(shape)
    before = kernels.launch_counts["dropout"]
    out, mask = nn_ops.dropout_fwd(x, 2024, p, upscale)
    assert kernels.launch_counts["dropout"] == before + 1
    ref_out, ref_mask = nn_ops.dropout_plain(x, 2024, p, upscale)
    assert out.dtype == dtype and mask.dtype == torch.uint8
    assert torch.equal(mask, ref_mask)
    assert torch.equal(out.view(torch.uint8 if dtype == torch.bfloat16
                                else torch.int32),
                       ref_out.view(torch.uint8 if dtype == torch.bfloat16
                                    else torch.int32))
    # an int seed, the same seed in a device tensor, and a handle whose op
    # seed is that seed give one mask
    buf = torch.full((), 11, dtype=torch.int64, device=cuda)
    handle = rng.SeedHandle(buf, 4)
    want = rng.mix64(11, 4)
    for seed in (torch.full((), want, dtype=torch.int64, device=cuda),
                 handle):
        assert torch.equal(nn_ops.dropout_fwd(x, seed, p, upscale)[1],
                           nn_ops.dropout_fwd(x, want, p, upscale)[1])


def test_attention_kernels_take_device_seeds(cuda):
    """An int seed, its device tensor and a seed handle mixing to it give
    the kernels one mask: forward outputs and gradients equal bit for
    bit."""
    from paddle_tpu_torch.core import rng

    q, k, v, bias, _, dout = _bwd_inputs(cuda, torch.bfloat16, 2, 128, 128,
                                         64, "pad")
    buf = torch.full((), 5, dtype=torch.int64, device=cuda)
    want = rng.mix64(5, 17)
    results = []
    for seed in (want, torch.full((), want, dtype=torch.int64, device=cuda),
                 rng.SeedHandle(buf, 17)):
        out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, seed, None,
                                               0.2)
        grads = fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse,
                                            dout, None, 0.2)
        results.append((out, *grads))
    for other in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(results[0], other))
    assert torch.equal(
        fa.dropout_keep_mask(rng.SeedHandle(buf, 17), 2, 8, 128, 128, 0.2,
                             cuda),
        fa.dropout_keep_mask_plain(want, 2, 8, 128, 128, 0.2,
                                   cuda).permute(0, 2, 1, 3))


# --- the captured step ---


def _tiny_training(dropout, seed=3):
    """A two-layer Transformer training program (Adam) and its feeds."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(src_vocab_size=37, trg_vocab_size=41,
                              max_length=64, d_model=64, d_inner=128,
                              n_head=2, n_layer=2, dropout=dropout,
                              label_smooth_eps=0.1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            model = T.build(cfg)
            fluid.optimizer.Adam(1e-3).minimize(model["loss"])
    main.random_seed = startup.random_seed = seed
    feeds = [T.make_batch(cfg, 4, 32, 32, seed=i) for i in range(2)]
    return fluid, main, startup, model, feeds


def _dropout_masks(main):
    return [op.outputs["Mask"][0] for op in main.global_block().ops
            if op.type == "dropout"]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_captured_steps_equal_eager_steps(cuda, dropout):
    """Four steps through the captured path (step 1 eager, then capture
    and replays) against four uncached eager runs from the same startup
    state: the same losses, dropout masks and parameters, bit for bit,
    and the kernels' launch counts alike."""
    fluid, main, startup, model, feeds = _tiny_training(dropout)
    masks = _dropout_masks(main)
    fetch = [model["loss"]] + masks[:2]
    runs = {}
    for cached in (False, True):
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(scope):
            exe.run(startup)
            kernels.reset_counts()
            got = [exe.run(main, feed=feeds[i % 2], fetch_list=fetch,
                           use_program_cache=cached) for i in range(4)]
            counts = (fa.launched("fwd"), fa.launched("bwd"),
                      fa.route_counts())
            params = {p.name: scope.find_var(p.name).clone()
                      for p in main.all_parameters()}
        runs[cached] = (got, counts, params)
        exe.close()
    (eager, e_counts, e_params), (capt, c_counts, c_params) = (runs[False],
                                                               runs[True])
    assert e_counts == c_counts and e_counts[0] == 4 * 6
    for step, (a, b) in enumerate(zip(eager, capt)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y), step
    if dropout:
        # a new mask every step
        assert not np.array_equal(eager[2][1], eager[3][1])
    for n in e_params:
        assert torch.equal(e_params[n], c_params[n]), n


def test_run_steps_replays_the_window(cuda):
    """run_steps(5) equals five runs, and the replays count their
    launches: 6 forward and 6 backward attention launches a step."""
    fluid, main, startup, model, feeds = _tiny_training(0.1)
    results = []
    for window in (True, False):
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(scope):
            exe.run(startup)
            kernels.reset_counts()
            if window:
                (loss,) = exe.run_steps(main, feeds, 5, [model["loss"]])
            else:
                for i in range(5):
                    (loss,) = exe.run(main, feed=feeds[i % 2],
                                      fetch_list=[model["loss"]])
            results.append((loss, fa.launched("fwd"), fa.launched("bwd")))
        exe.close()
    assert results[0] == results[1]
    assert results[0][1] == results[0][2] == 5 * 6


def test_fetches_survive_the_next_replay(cuda):
    fluid, main, startup, model, feeds = _tiny_training(0.1)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feeds[0], fetch_list=[model["loss"]])
        first = exe.run(main, feed=feeds[0], fetch_list=[model["loss"]],
                        return_numpy=False)[0]
        kept = first.clone()
        second = exe.run(main, feed=feeds[1], fetch_list=[model["loss"]],
                         return_numpy=False)[0]
        torch.cuda.synchronize()
        assert torch.equal(first, kept) and not torch.equal(first, second)
    exe.close()


def _wide_mlp(fluid, width=1024, depth=4):
    """A training program of ``depth`` fc layers (SGD) whose activations
    dominate its memory at a large batch."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[width], dtype="float32")
            h = x
            for _ in range(depth):
                h = fluid.layers.fc(h, width, act="relu")
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGD(1e-3).minimize(loss)
    main.random_seed = startup.random_seed = 5
    return main, startup, h, loss


def test_graphs_of_one_executor_share_one_pool(cuda):
    """One program with a second fetch list and at a second feed shape
    captures three graphs; they share the executor's memory pool, so the
    memory they reserve stays under 1.5x what the first capture reserved
    (three private pools would hold about 2.5x)."""
    import paddle_tpu_torch as fluid

    main, startup, h, loss = _wide_mlp(fluid)
    rng = np.random.default_rng(0)
    big = {"x": rng.standard_normal((16384, 1024), np.float32)}
    small = {"x": big["x"][:8192]}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=big, fetch_list=[loss])  # eager: the warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_reserved()
        exe.run(main, feed=big, fetch_list=[loss])  # captured
        torch.cuda.synchronize()
        first = torch.cuda.memory_reserved() - base
        for feed, fetch in ((big, [loss, h]), (small, [loss]),
                            (small, [loss, h])):
            for _ in range(3):
                got = exe.run(main, feed=feed, fetch_list=fetch)
            assert np.isfinite(got[0]) and got[-1].size in (
                1, feed["x"].size)
        torch.cuda.synchronize()
        total = torch.cuda.memory_reserved() - base
    exe.close()
    # a 16384 x 1024 f32 activation is 64 MiB; the step holds several
    assert first > 256 * 2**20, first
    assert total < 1.5 * first, (first, total)


def test_a_step_that_cannot_be_captured_raises(cuda):
    """assign_value copies its constant from host memory, which a CUDA
    graph cannot capture: the second run raises, naming the op, and does
    not run eagerly instead; a block of host-seeded random fills (a
    startup program) is never captured and runs at every call."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        c = fluid.layers.assign(np.arange(4, dtype=np.float32))
        out = fluid.layers.elementwise_add(fluid.layers.fc(x, 4), c)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = {"x": np.ones((2, 4), np.float32)}
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(startup)
        (first,) = exe.run(main, feed=feed, fetch_list=[out])
        with pytest.raises(RuntimeError, match="assign_value"):
            exe.run(main, feed=feed, fetch_list=[out])
    assert first.shape == (2, 4)
    exe.close()


# --- the training recipe and the deferred fetches (slice 11) --------------


def _replays(exe, scope):
    """Call counts of the scope's step runners that replay a graph."""
    return sorted(r.calls for r in exe._runners[scope].values()
                  if r.graph is not None)


def test_overflow_skip_in_a_captured_step(cuda):
    """amp.decorate's dynamic loss scaling inside a replayed CUDA graph
    (tests/test_amp.py's net and feeds): an overflowing replay leaves the
    weights bit-unchanged, halves the scale, counts one skip and fetches
    a finite loss; the next replay updates the weights."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 2, bias_attr=False))
        opt = fluid.amp.decorate(fluid.optimizer.SGD(0.1),
                                 init_loss_scaling=1e30,
                                 use_dynamic_loss_scaling=True)
        opt.minimize(loss)
    w = main.all_parameters()[0].name
    ok = {"x": np.ones((2, 4), np.float32)}
    huge = {"x": np.full((2, 4), 1e10, np.float32)}  # 1e40 gradients
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(2):  # eager, then captured
            exe.run(main, feed=ok, fetch_list=[loss])
        before = scope.find_var(w).clone()
        (value,) = exe.run(main, feed=huge, fetch_list=[loss])
        assert _replays(exe, scope) == [3]
        assert torch.equal(scope.find_var(w), before)
        assert np.isfinite(value)
        assert float(scope.find_var(opt.loss_scaling_name)[0]) == float(
            np.float32(1e30) * np.float32(0.5))
        assert float(scope.find_var(opt.skip_count_name)[0]) == 1.0
        exe.run(main, feed=ok, fetch_list=[loss])
        assert not torch.equal(scope.find_var(w), before)
    exe.close()


def test_lazy_fetches_on_the_card(cuda):
    """async_fetch=True on the card: LazyFetches whose pinned host copies
    are queued with the step; read after the next step was queued, each
    equals the same step's synced fetch bit for bit (bf16 logits as
    float32 numpy); return_numpy=False gives device tensors."""
    fluid, main, startup, model, feeds = _tiny_training(0.0)
    fluid.amp.enable_amp(main)
    fetch = [model["loss"], model["logits"]]
    got = {}
    for lazy in (True, False):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            runs = [exe.run(main, feed=feeds[i % 2], fetch_list=fetch,
                            async_fetch=lazy) for i in range(4)]
            if lazy:
                assert all(isinstance(r, fluid.executor.LazyFetches)
                           for r in runs)
                assert not runs[-1].ready
                assert runs[-1]._host[0].is_pinned()
                runs = [r.wait() for r in runs]
            got[lazy] = runs
            tensors = exe.run(main, feed=feeds[0], fetch_list=fetch,
                              return_numpy=False, async_fetch=True)
            assert tensors[1].is_cuda and tensors[1].dtype == torch.bfloat16
        exe.close()
    for a, b in zip(got[True], got[False]):
        assert a[1].dtype == np.float32
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_ema_apply_restore_through_the_captured_step(cuda):
    """ExponentialMovingAverage.apply puts tensors of its own into the
    Scope, which the captured step copies into its buffers before the
    next replay: that replay computes from the debiased shadows, and after
    restore the next one from the parameters as they were (fc output
    against a host product, atol 1e-5)."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8], dtype="float32")
        y = fluid.layers.fc(x, 3)
        fluid.optimizer.SGD(0.5).minimize(fluid.layers.mean(y))
        ema = fluid.optimizer.ExponentialMovingAverage(0.9)
        ema.update()
    w, b = (p.name for p in main.all_parameters())
    feed = {"x": np.random.RandomState(0).randn(4, 8).astype(np.float32)}
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()

    def host_y():
        return feed["x"] @ scope.find_var(w).cpu().numpy() + \
            scope.find_var(b).cpu().numpy()

    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):  # eager, captured, replayed
            exe.run(main, feed=feed, fetch_list=[y])
        live = {n: scope.find_var(n).clone() for n in (w, b)}
        with ema.apply():
            applied = host_y()
            assert not np.allclose(scope.find_var(w).cpu().numpy(),
                                   live[w].cpu().numpy())
            (got,) = exe.run(main, feed=feed, fetch_list=[y])
            np.testing.assert_allclose(got, applied, atol=1e-5, rtol=0)
        for n in (w, b):
            assert torch.equal(scope.find_var(n), live[n])
        restored = host_y()
        (got,) = exe.run(main, feed=feed, fetch_list=[y])
        np.testing.assert_allclose(got, restored, atol=1e-5, rtol=0)
        assert _replays(exe, scope) == [5]
    exe.close()


# --- export and deploy ---------------------------------------------------


def _mlp_export(tmp_path, place):
    """An fc net exported on ``place``; returns (dir, feed, probs)."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        probs = fluid.layers.softmax(fluid.layers.fc(
            fluid.layers.fc(x, 32, act="relu"), 4))
    d = str(tmp_path / "model")
    exe, scope = fluid.Executor(place), fluid.Scope()
    xv = np.random.RandomState(0).randn(21, 16).astype(np.float32)
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [probs], exe, main)
    exe.close()
    return d, xv


def test_bucketed_predictor_captures_one_graph_a_bucket(cuda, tmp_path):
    """Batch sizes 1..21 through buckets [4, 8]: at most two captured
    graphs, each size's rows within 1e-5 of an exact-shape run."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference

    d, xv = _mlp_export(tmp_path, fluid.CUDAPlace(0))
    exact = inference.create_predictor(inference.Config(d))
    pred = inference.create_predictor(
        inference.Config(d).set_batch_buckets([4, 8]))
    for n in (1, 3, 4, 5, 8, 13, 21, 2, 7):
        (got,) = pred.run([xv[:n]])
        (want,) = exact.run([xv[:n]])
        assert got.shape == (n, 4)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    graphs = [r.graph is not None for rs in pred._exe._runners.values()
              for r in rs.values()]
    assert len(graphs) == 2 and all(graphs)
    pred.close()
    exact.close()


def test_pruning_after_a_captured_step_reaches_the_next_replay(cuda):
    """UniformPruneStrategy on the fc weight after a captured SGD step: the
    mask multiplies the Scope's tensor in place, so the next replay
    computes from the masked weight (its fc output against a host
    product, atol 1e-5); the optimizer step moves the pruned rows and
    ``on_batch_end`` zeroes them again."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import slim

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8], dtype="float32")
        y = fluid.layers.fc(x, 6, param_attr=fluid.ParamAttr(name="fc_w"),
                            bias_attr=fluid.ParamAttr(name="fc_b"))
        fluid.optimizer.SGD(0.5).minimize(fluid.layers.mean(
            fluid.layers.elementwise_mul(y, y)))
    feed = {"x": np.random.RandomState(0).randn(4, 8).astype(np.float32)}
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(2):  # eager, then captured
            exe.run(main, feed=feed, fetch_list=[y])
        strat = slim.UniformPruneStrategy(target_ratio=0.5,
                                          pruned_params="fc_w")
        w = scope.find_var("fc_w")
        masks = strat.on_compression_begin(scope)
        assert scope.find_var("fc_w") is w
        pruned = np.where(masks["fc_w"] == 0)[0]
        assert len(pruned) == 4 and not w[pruned].any()
        host = feed["x"] @ w.cpu().numpy() + \
            scope.find_var("fc_b").cpu().numpy()
        (got,) = exe.run(main, feed=feed, fetch_list=[y])
        np.testing.assert_allclose(got, host, atol=1e-5, rtol=0)
        assert w[pruned].abs().sum().item() > 0  # SGD moved them
        strat.on_batch_end(scope)
        assert scope.find_var("fc_w") is w and not w[pruned].any()
        assert _replays(exe, scope) == [3]
    exe.close()


def test_int8_engine_is_deterministic_on_the_card(cuda, tmp_path):
    """A tiny Transformer calibrated on the card and exported as the int8
    artifact: two engines over it give the same greedy tokens, and the
    engine's weights are the host dequantization bit for bit."""
    import json

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.slim import calibration

    cfg = T.TransformerConfig(src_vocab_size=37, trg_vocab_size=41,
                              max_length=64, d_model=32, d_inner=64,
                              n_head=2, n_layer=2, dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        model = T.build(cfg, is_test=True)
    startup.random_seed = 7
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    d = str(tmp_path / "int8")
    with fluid.scope_guard(scope):
        exe.run(startup)
        calib = calibration.Calibrator(main, exe, scope=scope, algo="KL")
        for s in range(2):
            calib.sample(T.make_batch(cfg, 4, 12, 12, seed=s))
        calibration.save_int8_inference_model(
            d, ["src_ids", "src_pad_mask", "trg_ids", "trg_pad_mask"],
            [model["logits"]], exe, main, calib, scope=scope)
    exe.close()
    r = np.random.RandomState(3)
    srcs = [r.randint(3, 37, (n,)).astype(np.int64) for n in (9, 4, 12, 6)]
    with open(tmp_path / "int8" / "__int8_scales__.json") as f:
        wscales = json.load(f)["weight_scales"]
    q8 = np.load(tmp_path / "int8" / "__params_int8__.npz")
    runs = []
    for _ in range(2):
        eng = serving.ServingEngine(cfg, d, slots=2, src_len=16,
                                    max_len=10)
        assert eng.int8 and eng.stats()["int8"]
        assert eng._exe.device.type == "cuda"
        for n in q8.files:
            want = q8[n].astype(np.float32) * wscales[n] / 127.0
            assert np.array_equal(eng.scope.find_var(n).cpu().numpy(), want)
        hs = [eng.submit(s) for s in srcs]
        eng.run_until_idle()
        runs.append([list(h.tokens) for h in hs])
        eng.close()
    assert runs[0] == runs[1] and all(runs[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op_type,attrs", [
    ("quantize_dequantize_static", {"scale": 1.7, "bits": 8}),
    ("fake_quantize_dequantize", {"bits": 8}),
    ("fake_quantize_abs_max", {"bit_length": 4}),
])
def test_qdq_op_on_the_card_equals_the_cpu_bit_for_bit(cuda, dtype,
                                                        op_type, attrs):
    from paddle_tpu_torch.core.registry import get_op_def

    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(1))
    x = (x * 3).to(dtype)
    op = get_op_def(op_type)
    cpu = op.compute({"X": [x]}, dict(attrs), device=torch.device("cpu"))
    dev = op.compute({"X": [x.to(cuda)]}, dict(attrs), device=cuda)
    for slot in cpu:
        a, b = cpu[slot][0], dev[slot][0].cpu()
        assert a.dtype == b.dtype == (dtype if slot == "Out" else a.dtype)
        assert torch.equal(a, b), (slot, (a.float() - b.float()).abs().max())
