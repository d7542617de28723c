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
    from paddle_tpu_torch.benchmarks import timing

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias, _, dout = _long_inputs(cuda, dtype, 1, 256, 256,
                                              "pad")
        out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias)
        # the kernels a call ran, from a trace bracketed by markers and
        # taken again when it lost them
        names[dtype] = " ".join(timing.device_times(
            lambda: fa.flash_attention_bthd_bwd(q, k, v, bias, None, out,
                                                lse, dout), iters=1))
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
    from paddle_tpu_torch.benchmarks import timing

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias, _, _ = _long_inputs(cuda, dtype, 1, 256, 256, "pad")
        names[dtype] = " ".join(timing.device_times(
            lambda: fa.flash_attention_bthd_fwd(q, k, v, bias), iters=1))
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


# --- the serving planes on the card (phase 10's drills, a tiny model) ----


def _tiny_serving(cuda):
    """A tiny Transformer's is_test weights on the card, from a seed."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(
        src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=32,
        d_inner=64, n_head=2, n_layer=2, dropout=0.0, label_smooth_eps=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        T.build(cfg, is_test=True)
    startup.random_seed = 7
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    exe.close()
    r = np.random.RandomState(5)
    srcs = [r.randint(3, 37, (n,)).astype(np.int64)
            for n in (9, 4, 12, 6, 16, 3)]
    return cfg, scope, srcs


def _serve_clean(cfg, scope, srcs, **geom):
    from paddle_tpu_torch import serving

    eng = serving.ServingEngine(cfg, scope, **geom)
    hs = [eng.submit(s, max_new_tokens=8) for s in srcs]
    eng.run_until_idle()
    eng.close()
    return [list(h.tokens) for h in hs]


_GEOM = dict(slots=4, src_len=16, max_len=16)


def test_capture_beside_route_and_device_memory_reads(cuda):
    """Engines capture their graphs on the loop thread while another
    thread reads /metrics, /serve and device_memory() in a loop: every
    read answers and the tokens equal an engine stepped alone."""
    import threading
    import urllib.request

    from paddle_tpu_torch import flags, monitor, serving

    cfg, scope, srcs = _tiny_serving(cuda)
    clean = _serve_clean(cfg, scope, srcs, **_GEOM)
    flags.set_flags({"telemetry": True})
    port = monitor.serve(port=0, host="127.0.0.1")
    stop, reads, errors = threading.Event(), [0], []

    def read():
        while not stop.is_set():
            try:
                for route in ("/metrics", "/serve"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{route}",
                            timeout=10) as r:
                        assert r.status == 200
                assert "cuda:0" in monitor.device_memory()
                reads[0] += 1
            except Exception as e:
                errors.append(e)
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    try:
        for _ in range(2):  # two supervisors: two rounds of captures
            sup = serving.EngineSupervisor(cfg, scope, **_GEOM)
            hs = [sup.submit(s, max_new_tokens=8) for s in srcs]
            got = [h.result(timeout=120) for h in hs]
            graphs = sum(r.graph is not None for rs in
                         sup.engine._exe._runners.values()
                         for r in rs.values())
            sup.close()
            assert got == clean and graphs >= 2
    finally:
        stop.set()
        t.join(timeout=30)
        monitor.stop_server()
        flags.set_flags({"telemetry": False})
    assert not errors, errors
    assert reads[0] > 0


def test_woken_wedged_thread_after_restart_is_harmless(cuda):
    from paddle_tpu_torch import faults, serving

    cfg, scope, srcs = _tiny_serving(cuda)
    clean = _serve_clean(cfg, scope, srcs, **_GEOM)
    sup = serving.EngineSupervisor(cfg, scope, wedge_timeout_ms=200,
                                   **_GEOM)
    try:
        sup.submit(srcs[0], max_new_tokens=4).result(timeout=120)
        old, old_thread = sup.engine, sup._loop_thread
        assert old._wedge_armed()
        steps0, runs0 = old.decode_steps, dict(old._runs)
        faults.arm("serve.decode:delay(0.8)@2")
        hs = [sup.submit(s, max_new_tokens=8) for s in srcs]
        got = [h.result(timeout=120) for h in hs]
        old_thread.join(timeout=10)
    finally:
        faults.disarm()
    restarts = sup.restarts
    sup.close()
    assert not old_thread.is_alive()
    assert restarts == 1 and got == clean
    # hit 1 dispatched, hit 2 parked: nothing ran after the wake-up
    dec = old._progs["decode_program"]._uid
    assert old.decode_steps == steps0 + 1
    assert old._runs[dec] == runs0[dec] + 1
    assert old._exe._retired is not None


def test_real_out_of_memory_is_classified(cuda):
    from paddle_tpu_torch import monitor

    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(1 << 40, dtype=torch.uint8, device=cuda)
    assert monitor.is_oom_error(ei.value)
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    blocks = monitor._largest_live_buffers()
    assert blocks and blocks[0]["nbytes"] >= 64 << 20
    assert monitor.device_memory()["cuda:0"]["bytes_in_use"] >= 64 << 20
    del keep
    torch.cuda.empty_cache()


@pytest.mark.parametrize("bins", [0, 16])
def test_numerics_stats_in_a_captured_graph_equals_eager(cuda, bins):
    from paddle_tpu_torch import numerics

    g = torch.Generator(device=cuda).manual_seed(3)
    xs = [torch.randn(4096, 512, device=cuda, generator=g),
          (torch.randn(1000, device=cuda, generator=g) * 1e4).bfloat16(),
          torch.zeros(7, device=cuda)]
    xs[0][3, 5] = float("nan")
    xs[0][9, 1] = float("-inf")
    aux = [torch.full((1,), 32768.0, device=cuda)]

    def run():
        return numerics._numerics_stats({"X": xs, "A": aux},
                                         {"hist_bins": bins}, cuda)["Out"][0]

    eager = run().clone()
    for _ in range(2):  # warm-up on a side stream, as capture wants
        run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    cpu = numerics._numerics_stats(
        {"X": [x.cpu() for x in xs], "A": [a.cpu() for a in aux]},
        {"hist_bins": bins}, torch.device("cpu"))["Out"][0]
    w = 3 + bins
    for i in range(len(xs)):
        a, b = eager[i * w:(i + 1) * w].cpu(), cpu[i * w:(i + 1) * w]
        assert a[0] == b[0] and a[1] == b[1]
        assert abs(a[2] - b[2]) <= 1e-6 * abs(b[2])
        assert a[3:].sum() == b[3:].sum()


def test_numerics_histogram_counts_repeat_past_two_to_the_24(cuda):
    """A bin of more than 2^24 elements: its count is the f32 rounding
    of the exact count, the same bits at every launch (histc's partial
    counts add in f64)."""
    from paddle_tpu_torch import numerics

    n = (1 << 25) + 3
    x = torch.ones(n, device=cuda)
    runs = [numerics._numerics_stats({"X": [x]}, {"hist_bins": 16},
                                     cuda)["Out"][0].cpu()
            for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    assert runs[0][3 + 8].item() == float(np.float32(n))
    assert runs[0][3:].sum().item() == float(np.float32(n))


def test_reserved_memory_holds_across_three_restarts(cuda):
    from paddle_tpu_torch import faults, serving

    cfg, scope, srcs = _tiny_serving(cuda)
    clean = _serve_clean(cfg, scope, srcs, **_GEOM)

    class Noting(serving.EngineSupervisor):
        def __init__(self, *a, **k):
            self.reserved = []
            super().__init__(*a, **k)

        def _restart_locked(self, old, reason):
            self.reserved.append(torch.cuda.memory_reserved())
            super()._restart_locked(old, reason)

    sup = Noting(cfg, scope, **_GEOM)
    faults.arm("serve.decode:raise(drill)@3,8,13")
    try:
        hs = [sup.submit(s, max_new_tokens=8) for s in srcs]
        got = [h.result(timeout=120) for h in hs]
    finally:
        faults.disarm()
    sup.reserved.append(torch.cuda.memory_reserved())
    restarts = sup.restarts
    sup.close()
    assert restarts == 3 and got == clean
    # reserved while the engines of restarts 1 and 3 served
    assert abs(sup.reserved[3] - sup.reserved[1]) <= 0.25 * 2**30, \
        sup.reserved


def _eager_engine(cfg, scope, **geom):
    """An engine whose executor runs every program eagerly (uncached)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving

    class Eager(fluid.Executor):
        def run(self, *args, **kwargs):
            kwargs["use_program_cache"] = False
            return super().run(*args, **kwargs)

    eng = serving.ServingEngine(cfg, scope, **geom)
    eng._exe = Eager(fluid.CUDAPlace(0))
    return eng


def test_capture_beside_a_replaying_engine(cuda):
    """Two engines on two threads: one replays its captured steps in a
    loop while fresh engines lower and capture theirs beside it. Every
    stream of both equals an eager engine's bit for bit. (Without a gate
    over the process's CUDA calls a capture beside the replays is
    invalidated.)"""
    import threading

    from paddle_tpu_torch import serving

    cfg, scope, srcs = _tiny_serving(cuda)
    eager = _eager_engine(cfg, scope, **_GEOM)
    hs = [eager.submit(s, max_new_tokens=8) for s in srcs]
    eager.run_until_idle()
    eager.close()
    want = [list(h.tokens) for h in hs]
    warm = serving.ServingEngine(cfg, scope, **_GEOM)
    for s in srcs[:2]:
        warm.submit(s, max_new_tokens=4)
        warm.run_until_idle()
    stop, replayed, errors = threading.Event(), [], []

    def replay():
        try:
            while not stop.is_set():
                hs = [warm.submit(s, max_new_tokens=8) for s in srcs]
                warm.run_until_idle()
                replayed.append([list(h.tokens) for h in hs])
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=replay, daemon=True)
    t.start()
    fresh = []
    try:
        for _ in range(3):  # three engines: six captures beside replays
            eng = serving.ServingEngine(cfg, scope, **_GEOM)
            got = []
            for s in srcs:
                h = eng.submit(s, max_new_tokens=8)
                eng.run_until_idle()
                got.append(list(h.tokens))
            eng.close()
            fresh.append(got)
    finally:
        stop.set()
        t.join(timeout=60)
    warm.close()
    assert not t.is_alive()
    assert not errors, errors
    assert replayed and all(r == want for r in replayed)
    assert all(f == want for f in fresh)


def test_gate_wait_is_not_a_wedge(cuda):
    """A warm supervised replica held back by a capture for five times
    its watchdog's timeout is not declared wedged: no restart, the
    tokens of an engine alone."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.core.lowering import GATE

    cfg, scope, srcs = _tiny_serving(cuda)
    clean = _serve_clean(cfg, scope, srcs, **_GEOM)
    sup = serving.EngineSupervisor(cfg, scope, wedge_timeout_ms=200,
                                   **_GEOM)
    try:
        for s in srcs[:2]:
            sup.submit(s, max_new_tokens=4).result(timeout=120)
        eng = sup.engine
        assert eng._wedge_armed()
        with GATE.exclusive(cuda):    # another executor's capture
            hs = [sup.submit(s, max_new_tokens=8) for s in srcs]
            import time

            time.sleep(1.0)
            assert GATE.waiting(eng._loop_ident)
            assert not eng._wedge_armed()
        got = [h.result(timeout=120) for h in hs]
        restarts = sup.restarts
    finally:
        sup.close()
    assert restarts == 0 and got == clean


def test_fleet_kill_drill_on_the_card(cuda):
    """Three replicas on the card, one killed mid-decode once every
    replica's decode graph is captured: every stream equals an engine
    alone, the router swallowed no error, and no capture failed."""
    import time

    from paddle_tpu_torch import faults, fleet_serving, serving
    from paddle_tpu_torch.core.lowering import GATE

    cfg, scope, srcs = _tiny_serving(cuda)
    srcs = srcs * 2
    clean = _serve_clean(cfg, scope, srcs, **_GEOM)
    GATE.reset_stats()
    fleet = fleet_serving.ServingFleet(cfg, scope, replicas=3, poll_s=0.002,
                                       **_GEOM)
    try:
        for rep in list(fleet._replicas.values()):
            for s in srcs[:2]:
                rep.sup.submit(s, max_new_tokens=4).result(timeout=120)
            assert rep.sup.engine._wedge_armed()
            assert rep.sup.engine._exe.device.type == "cuda"
        faults.arm("serve.decode:delay(0.01)@p1.0", seed=3)
        frs = [fleet.submit(s, max_new_tokens=8) for s in srcs]
        t0 = time.time()
        while not all(len(fr.tokens) >= 1 or fr.done for fr in frs):
            assert time.time() - t0 < 120
            time.sleep(0.001)
        # the victim: the lowest-id live replica still holding work
        live = sorted(fleet._replicas.values(), key=lambda r: r.id)
        victim = next(i for i, rep in enumerate(live)
                      if any(fr.replica_id == rep.id and not fr.done
                             for fr in frs))
        faults.arm("serve.decode:delay(0.01)@p1.0;"
                   f"router.replica_crash:raise(replica={victim})@1",
                   seed=3)
        got = [fr.result(timeout=120) for fr in frs]
    finally:
        faults.disarm()
    stats = fleet.stats()
    fleet.close()
    assert got == clean
    assert stats["failovers"] == 1 and stats["replica_count"] == 2
    assert any(fr.failovers >= 1 for fr in frs)
    assert stats["pump_errors"] == 0, stats["last_pump_error"]
    assert GATE.stats()["capture_failures"] == 0


# --- the while op: a loop body captured and replayed (slice 16) -----------


def _loop_program(fluid):
    """A while loop with a data-dependent trip count whose body reads
    captured fc weights and draws a dropout mask each iteration: it runs
    until the accumulated |h| passes the fed limit."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data("x", shape=[64], dtype="float32")
        lim = L.data("lim", shape=[1], dtype="float32",
                     append_batch_size=False)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(acc, lim)
        w = L.While(cond)
        with w.block():
            h = L.fc(L.dropout(x, 0.2,
                               dropout_implementation="upscale_in_train"),
                     64, act="sigmoid")
            L.assign(h, output=x)
            L.assign(L.elementwise_add(acc, L.reduce_sum(L.abs(h))),
                     output=acc)
            L.less_than(acc, lim, cond=cond)
    main.random_seed = startup.random_seed = 11
    return main, startup, [x, acc, w._steps_var, cond]


def test_captured_loop_body_equals_the_eager_loop(cuda):
    """Three runs uncached (the eager loop) and three cached (run 1: the
    warm-up iteration, the capture, replays; runs 2, 3: replays only)
    from one startup: equal bits in every fetch, new dropout masks every
    iteration and run, and a limit reached early (the trip count read
    from the data, far below the 10^6 the limit would allow)."""
    import paddle_tpu_torch as fluid

    main, startup, fetch = _loop_program(fluid)
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((16, 64), np.float32),
            "lim": np.array([3000.0], np.float32)}
    runs = {}
    for cached in (False, True):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            runs[cached] = [exe.run(main, feed=feed, fetch_list=fetch,
                                    use_program_cache=cached)
                            for _ in range(3)]
        if cached:
            (runner,) = exe._loop_runners.values()
            assert runner.graph is not None and runner.loops == 3
        exe.close()
    for a, b in zip(runs[False], runs[True]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    steps = [int(r[2]) for r in runs[True]]
    assert all(2 < s < 1000 for s in steps), steps
    assert not bool(runs[True][0][3])
    # each run's executor step draws other masks
    assert not np.array_equal(runs[True][0][0], runs[True][1][0])


def test_beam_decode_captured_equals_eager_with_an_early_end(cuda):
    """A small Transformer's translate on the card, cached (the loop body
    captured and replayed) and uncached, with an end_id that one of its
    hypotheses emits: the same ids and bit-equal scores, the fwd_kernel
    launched once an encoder layer and twice a decoder layer a step in
    both, the captured runs' loop ending where the eager one's does."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(src_vocab_size=37, trg_vocab_size=41,
                              max_length=64, d_model=64, d_inner=128,
                              n_head=2, n_layer=2, dropout=0.0,
                              label_smooth_eps=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        T.build(cfg, is_test=True)
    startup.random_seed = 5
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    r = np.random.RandomState(0)
    src = r.randint(2, 37, (3, 16)).astype(np.int64)
    pad = np.ones((3, 16), np.float32)

    class Eager(fluid.Executor):
        def run(self, *args, **kwargs):
            kwargs["use_program_cache"] = False
            return super().run(*args, **kwargs)

    def translate(exe, end_id):
        kernels.reset_counts()
        ids, scores = T.translate(exe, scope, src, pad, cfg, beam_size=4,
                                  max_len=16, end_id=end_id)
        return ids, scores, fa.route_counts()[("small", "fwd")]

    first = translate(Eager(fluid.CUDAPlace(0)), 1)
    end_id = int(first[0][0, 0, 3])
    got = {}
    for name, exe in (("eager", Eager(fluid.CUDAPlace(0))),
                      ("captured", fluid.Executor(fluid.CUDAPlace(0)))):
        got[name] = [translate(exe, end_id) for _ in range(2)]
    want = got["eager"][0]
    # one launch an encoder layer, then two a decoder layer a step
    steps = (want[2] - cfg.n_layer) // (2 * cfg.n_layer)
    assert want[2] == (1 + 2 * steps) * cfg.n_layer and 0 < steps <= 15
    for ids, scores, launches in got["eager"] + got["captured"]:
        assert np.array_equal(ids, want[0])
        assert np.array_equal(scores, want[1])
        assert launches == want[2]
    for seq in want[0].reshape(-1, 16):
        seq = list(seq)
        if end_id in seq[1:steps + 1]:
            first_end = seq[1:].index(end_id) + 1
            assert all(t == end_id for t in seq[first_end:steps + 1]), seq


# --- row-sparse updates and the SSD loss (slice 17) ------------------------


def _sparse_case(dev, vocab=1000, dim=16, n=4096, seed=0):
    """A row-sparse gradient over ``vocab`` rows with duplicated ids, row
    vocab - 1 and the padding id 3 among them, and the op inputs of each
    sparse optimizer, on ``dev``."""
    from paddle_tpu_torch.core.registry import get_op_def

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (n,), generator=g)
    ids[:6] = torch.tensor([vocab - 1, vocab - 1, 7, 7, 7, 3])
    d_out = torch.randn(n, dim, generator=g)
    grad = get_op_def("lookup_table_sparse_grad").compute(
        {"Ids": [ids.to(dev)], "GRAD::Out": [d_out.to(dev)]},
        {"vocab_size": vocab, "padding_idx": 3, "squeeze_last": False}, dev)
    state = {"Param": torch.randn(vocab, dim, generator=g),
             "Velocity": torch.randn(vocab, dim, generator=g),
             "Moment1": torch.randn(vocab, dim, generator=g),
             "Moment2": torch.rand(vocab, dim, generator=g),
             "Beta1Pow": torch.tensor([0.9]), "Beta2Pow": torch.tensor([0.999]),
             "LearningRate": torch.tensor([0.01])}
    ins = {k: [v.to(dev)] for k, v in state.items()}
    ins["Rows"], ins["Values"] = grad["Rows"], grad["Values"]
    touched = torch.zeros(vocab, dtype=torch.bool)
    touched[ids[ids != 3]] = True
    return ins, touched


_SPARSE_OPS = [("adam_sparse", {"beta1": 0.9, "beta2": 0.999,
                                "epsilon": 1e-8}),
               ("momentum_sparse", {"mu": 0.9}),
               ("momentum_sparse", {"mu": 0.9, "use_nesterov": True}),
               ("sgd_sparse", {})]


@pytest.mark.parametrize("op,attrs", _SPARSE_OPS)
def test_sparse_update_on_the_card_equals_the_cpu(cuda, op, attrs):
    """The same inputs on the card and the CPU: every output within 1e-6
    of its largest element (elementwise f32 arithmetic in the same order;
    the merged sums in one fixed order on both), untouched rows (the
    padding row among them) bit-unchanged, row vocab - 1 updated."""
    from paddle_tpu_torch.core.registry import get_op_def

    cpu = torch.device("cpu")
    outs = {}
    for dev in (cuda, cpu):
        ins, touched = _sparse_case(dev)
        outs[dev.type] = get_op_def(op).compute(ins, dict(attrs), dev)
    slot_in = {"ParamOut": "Param", "VelocityOut": "Velocity",
               "Moment1Out": "Moment1", "Moment2Out": "Moment2"}
    for slot, (want,) in outs["cpu"].items():
        (got,) = outs["cuda"][slot]
        got = got.cpu()
        err = (got - want).abs().max().item()
        assert err <= 1e-6 * max(want.abs().max().item(), 1e-30), (slot, err)
        if slot in slot_in:
            before = ins[slot_in[slot]][0]
            assert torch.equal(got[~touched], before[~touched]), slot
            assert not torch.equal(got[-1], before[-1]), slot
            assert torch.equal(got[3], before[3]), slot


@pytest.mark.parametrize("op,attrs", _SPARSE_OPS[:2])
def test_sparse_update_repeats_bit_for_bit_on_the_card(cuda, op, attrs):
    """Two launches of the sparse step at DeepFM's scale (1M rows, 16
    columns, 4096 x 26 ids) give equal bits: the duplicates are summed in
    a fixed order and every store into a row carries the same value."""
    from paddle_tpu_torch.core.registry import get_op_def

    ins, _ = _sparse_case(cuda, vocab=1_000_000, n=4096 * 26, seed=1)
    first = get_op_def(op).compute(ins, dict(attrs), cuda)
    second = get_op_def(op).compute(ins, dict(attrs), cuda)
    for slot, (a,) in first.items():
        assert torch.equal(a, second[slot][0]), slot


def test_ssd_loss_on_the_card_equals_the_cpu(cuda):
    """The fused SSD loss and its gradients (autograd through the op's
    compute, as the derived grad op takes them) on the card against the
    CPU at SSD-300's gt capacity (50 rows) over 1,000 priors: the loss
    within 1e-6 relative, the gradients within 1e-5 of their largest
    element."""
    from paddle_tpu_torch.core.registry import get_op_def

    g = torch.Generator().manual_seed(3)
    n, p, c, gt = 4, 1000, 21, 50
    lo = torch.rand(p, 2, generator=g) * 0.8
    prior = torch.cat([lo, lo + 0.05 + torch.rand(p, 2, generator=g) * 0.15],
                      dim=1)
    boxes = torch.zeros(n, gt, 4)
    labels = torch.zeros(n, gt, dtype=torch.int64)
    for i in range(n):
        k = 3 + 5 * i
        pick = torch.randperm(p, generator=g)[:k]
        boxes[i, :k] = prior[pick] + 0.01 * torch.randn(k, 4, generator=g)
        labels[i, :k] = torch.randint(1, c, (k,), generator=g)
    loc = torch.randn(n, p, 4, generator=g)
    conf = torch.randn(n, p, c, generator=g)
    pvar = torch.tensor([0.1, 0.1, 0.2, 0.2]).expand(p, 4).contiguous()
    attrs = {"background_label": 0, "overlap_threshold": 0.5,
             "neg_pos_ratio": 3.0, "neg_overlap": 0.5,
             "match_type": "per_prediction", "normalize": True}
    res = {}
    for dev in (cuda, torch.device("cpu")):
        lv = loc.to(dev).requires_grad_(True)
        cv = conf.to(dev).requires_grad_(True)
        with torch.enable_grad():
            loss = get_op_def("ssd_loss").compute(
                {"Location": [lv], "Confidence": [cv],
                 "GtBox": [boxes.to(dev)], "GtLabel": [labels.to(dev)],
                 "PriorBox": [prior.to(dev)], "PriorBoxVar": [pvar.to(dev)]},
                attrs, dev)["Loss"][0]
            loss.sum().backward()
        res[dev.type] = (loss.detach().cpu(), lv.grad.cpu(), cv.grad.cpu())
    (l_gpu, dl_gpu, dc_gpu), (l_cpu, dl_cpu, dc_cpu) = res["cuda"], res["cpu"]
    assert ((l_gpu - l_cpu).abs() <= 1e-6 * l_cpu.abs()).all()
    for got, want in ((dl_gpu, dl_cpu), (dc_gpu, dc_cpu)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert dl_cpu.abs().max() > 0


# --- the training runtime: the prefetch loader and async checkpoints -------


def _fc_step(fluid, seed):
    from paddle_tpu_torch import layers

    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        x = layers.data("x", shape=[128], dtype="float32")
        loss = layers.mean(layers.fc(layers.fc(x, 128, act="relu"), 4))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    startup.random_seed = main_prog.random_seed = seed
    return main_prog, startup, loss


def test_device_loader_streams_while_another_thread_captures(cuda):
    """A DeviceLoader copies batches to a consumer thread while the main
    thread captures fresh executors' steps: no capture fails, the
    loader's copies wait for the captures, and every batch arrives
    intact (the consumer reads each back under the capture gate)."""
    import threading

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.lowering import GATE
    from paddle_tpu_torch.reader import DeviceLoader

    def endless():
        i = 0
        while True:
            yield {"a": np.full((64, 256), i, np.int64)}
            i += 1

    loader = DeviceLoader(endless, ["a"], depth=2, place=fluid.CUDAPlace(0))
    stop, bad, seen = [False], [], [0]

    def consume():
        for n, feed in enumerate(loader):
            # reading a value back is a CUDA call of this thread: under
            # the gate, as every CUDA call beside a capture must be
            with GATE.shared():
                ends = (int(feed["a"][0, 0]), int(feed["a"][-1, -1]))
            if ends != (n, n):
                bad.append(n)
            seen[0] += 1
            if stop[0]:
                break

    GATE.reset_stats()
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    try:
        for i in range(4):
            main_prog, startup, loss = _fc_step(fluid, 11 + i)
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            feed = {"x": np.random.RandomState(i).randn(32, 128).astype(
                np.float32)}
            with fluid.scope_guard(scope):
                exe.run(startup)
                for _ in range(3):
                    exe.run(main_prog, feed=feed, fetch_list=[loss])
            exe.close()
    finally:
        stop[0] = True
        t.join(30)
    loader.close()
    assert not t.is_alive()
    gate = GATE.stats()
    assert gate["capture_failures"] == 0 and gate["captures"] >= 4, gate
    assert loader.stats["gate_waits"] >= 1, loader.stats
    assert seen[0] > 0 and not bad, (seen, bad[:5])


def test_pinned_slot_waits_for_its_copy(cuda):
    """Large batches through a ring of two pinned slots (depth 1), every
    batch kept on the card until the end: each holds its own values, so
    no slot was written again before its copy had read it; and each
    slot's last event had completed when the slot was written."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.reader import DeviceLoader
    from paddle_tpu_torch.reader import pipeline

    checked = []
    real = pipeline._PinnedSlot.buffer

    def buffer(self, name, a):
        checked.append(self.event is None or self.event.query())
        return real(self, name, a)

    pipeline._PinnedSlot.buffer = buffer
    try:
        def reader():
            for i in range(12):
                yield {"x": np.full((2048, 2048), float(i), np.float32)}

        loader = DeviceLoader(reader, ["x"], depth=1,
                              place=fluid.CUDAPlace(0))
        kept = [feed["x"] for feed in loader]
    finally:
        pipeline._PinnedSlot.buffer = real
    torch.cuda.synchronize()
    assert len(kept) == 12 and all(checked) and len(checked) == 12
    for i, x in enumerate(kept):
        assert float(x.min()) == float(x.max()) == float(i), i


def test_async_save_payload_is_unchanged_by_later_replays(cuda, tmp_path):
    """An async save of a captured step's state returns after its
    snapshot; the replays that follow write the state tensors in place
    while the background thread serializes, and the checkpoint holds the
    values of the moment of the save."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import checkpoint as ck

    main_prog, startup, loss = _fc_step(fluid, 5)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    feed = {"x": np.random.RandomState(0).randn(32, 128).astype(np.float32)}
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):  # eager, capture, replay
            exe.run(main_prog, feed=feed, fetch_list=[loss])
        want = {n: scope.find_var(n).detach().cpu().clone()
                for n in scope.var_names()}
        handle = ck.save_scope(str(tmp_path), scope, step=1,
                               async_save=True)
        for _ in range(20):
            exe.run(main_prog, feed=feed, fetch_list=[loss])
        handle.wait()
        moved = [n for n in want
                 if not torch.equal(scope.find_var(n).cpu(), want[n])]
    exe.close()
    assert moved, "the replays did not change the state"
    got = ck.load_checkpoint(str(tmp_path))
    assert sorted(got) == sorted(want)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v.numpy(), err_msg=n)


# --- the recurrent ops ---------------------------------------------------

def _rnn_cases():
    """(op type, f64 inputs, attrs): each recurrent op with lengths (rows
    of length 0 and T), is_reverse, H0 / C0 and forget_bias among them."""
    r = np.random.RandomState(19)
    b, t, h = 3, 7, 8

    def f(*shape):
        return r.normal(0, 0.5, shape)

    lens = np.array([7, 0, 4], np.int64)
    return [
        ("lstm", {"Input": [f(b, t, 4 * h)], "Weight": [f(h, 4 * h)],
                  "Bias": [f(4 * h)], "H0": [f(b, h)], "C0": [f(b, h)],
                  "Length": [lens]}, {"forget_bias": 1.0}),
        ("lstm", {"Input": [f(b, t, 4 * h)], "Weight": [f(h, 4 * h)],
                  "Length": [lens[:, None]]}, {"is_reverse": True}),
        ("gru", {"Input": [f(b, t, 3 * h)], "Weight": [f(h, 3 * h)],
                 "Bias": [f(3 * h)], "H0": [f(b, h)], "Length": [lens]},
         {"is_reverse": True}),
        ("gru_unit", {"Input": [f(b, 3 * h)], "HiddenPrev": [f(b, h)],
                      "Weight": [f(h, 3 * h)], "Bias": [f(3 * h)]}, {}),
        ("lstm_unit", {"X": [f(b, 4 * h)], "C_prev": [f(b, h)]},
         {"forget_bias": 1.0}),
        ("lstmp", {"Input": [f(b, t, 4 * h)], "Weight": [f(5, 4 * h)],
                   "ProjWeight": [f(h, 5)], "Bias": [f(4 * h)]},
         {"is_reverse": True}),
    ]


@pytest.mark.parametrize("i", range(6))
def test_rnn_op_on_the_card_equals_the_cpu(cuda, i):
    """Each recurrent op's outputs and derived gradients in f64 on the card
    against the CPU: within 1e-10 of the largest |element| (cuBLAS and the
    CPU's BLAS sum in other orders)."""
    from chip_smoke import op_and_grads

    op_type, ins, attrs = _rnn_cases()[i]
    got, want = (op_and_grads(torch, np, op_type, ins, attrs, dev, 20)
                 for dev in (cuda, torch.device("cpu")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-10, (op_type, k, err)


def test_captured_lstm_step_equals_the_eager_step(cuda):
    """A two-block stacked LSTM (lengths, a masked max pool) trained three
    Adam steps uncached (eager) and three cached (the second captured,
    the third a replay) from one startup: every loss and every state
    tensor bit for bit equal."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import stacked_lstm as SL

    cfg = SL.StackedLSTMConfig(vocab_size=300, embed_dim=16, hidden_dim=32,
                               stacked_num=2, max_len=20)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        model = SL.build(cfg)
        fluid.optimizer.Adam(1e-3).minimize(model["loss"])
    startup.random_seed = 19
    feeds = [SL.make_batch(cfg, 8, seed=s) for s in range(3)]
    runs = {}
    for cached in (False, True):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            losses = [exe.run(main_prog, feed=f, fetch_list=[model["loss"]],
                              use_program_cache=cached)[0] for f in feeds]
            state = {n: scope.find_var(n).cpu().clone()
                     for n in scope.var_names()}
        if cached:
            assert sum(r.graph is not None for rs in exe._runners.values()
                       for r in rs.values()) == 1
        exe.close()
        runs[cached] = (losses, state)
    (le, se), (lc, sc) = runs[False], runs[True]
    assert all(np.array_equal(a, b) for a, b in zip(le, lc)), (le, lc)
    assert sorted(se) == sorted(sc)
    for n in se:
        assert torch.equal(se[n], sc[n]), n
    assert float(lc[-1]) != float(lc[0])


# --- slice 20: scan, cond, hash on the card -------------------------------


def _scan_layer_grads(dev, amp):
    """One build_scan step (2 + 2 layers, dropout 0.1 in attention and in
    the layer bodies) on ``dev`` from the CPU's startup state: the loss
    and the stacked weights' gradients, which come from the derived
    scan_grad re-running each layer (the attention and dropout kernels
    through their autograd.Functions on the card)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(src_vocab_size=64, trg_vocab_size=64,
                              max_length=32, d_model=128, d_inner=256,
                              n_head=2, n_layer=2, dropout=0.1,
                              label_smooth_eps=0.1)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        model = T.build_scan(cfg)
        fluid.append_backward(model["loss"])
    if amp:
        fluid.amp.enable_amp(main_prog)
    main_prog.random_seed = startup.random_seed = 20
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    state = {n: scope.find_var(n).numpy() for n in scope.var_names()}
    names = ["enc_stack_qkv.w_stacked@GRAD", "enc_stack_ffn1.w_stacked@GRAD",
             "dec_stack_self_q.w_stacked@GRAD", "dec_stack_q.w_stacked@GRAD",
             "src_emb.w@GRAD"]
    place = fluid.CUDAPlace(0) if dev.type == "cuda" else fluid.CPUPlace()
    exe = fluid.Executor(place)
    with fluid.scope_guard(tio.scope_from_numpy(state, place)):
        got = exe.run(main_prog, feed=T.make_batch(cfg, 4, 16, 12, seed=3),
                      fetch_list=[model["loss"]] + names)
    exe.close()
    return [np.asarray(g, np.float64) for g in got]


@pytest.mark.parametrize("amp,tol", [(False, 1e-4), (True, 3e-2)])
def test_scan_grad_through_the_kernels_equals_the_cpu(cuda, amp, tol):
    """scan_grad over Transformer layers with dropout on the card against
    the CPU: the dropout masks are one hash on both, so the gradients
    agree within f32 (1e-4 of the largest element) or bf16 AMP (3e-2)
    rounding; none is zero (the kernels' outputs reach autograd)."""
    from paddle_tpu_torch import kernels

    kernels.reset_counts()
    got = _scan_layer_grads(cuda, amp)
    assert kernels.launch_counts["dropout"] > 0
    assert fa.launched("fwd") > 0 and fa.launched("bwd") > 0
    want = _scan_layer_grads(torch.device("cpu"), amp)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, err


def test_cond_grad_is_finite_on_the_card(cuda):
    """cond(False, log(x), 2 x) at x = 0: the registered cond_grad's
    gradient is 2 everywhere on the card (the untaken log's inf never
    reaches it)."""
    import paddle_tpu_torch as fluid

    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        blk = main.global_block()
        x = blk.create_var(name="x", shape=(3,), dtype="float32",
                           stop_gradient=False)
        flag = blk.create_var(name="flag", shape=(1,), dtype="bool")
        out = fluid.layers.cond(flag, lambda: fluid.layers.log(x),
                                lambda: fluid.layers.scale(x, 2.0))
        (dx,) = fluid.gradients(fluid.layers.reduce_sum(out), x)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        for cached in (False, True, True):
            o, g = exe.run(main, feed={"x": np.zeros(3, np.float32),
                                       "flag": np.array([False])},
                           fetch_list=[out, dx], use_program_cache=cached)
            np.testing.assert_array_equal(g, np.full(3, 2.0, np.float32))
            np.testing.assert_array_equal(o, np.zeros(3, np.float32))
    exe.close()


@pytest.mark.parametrize("dtype,d", [(np.int64, 9), (np.int64, 2),
                                     (np.int32, 11)])
def test_hash_bits_on_the_card_equal_the_cpu(cuda, dtype, d):
    """XXH64 buckets in int64 tensor ops: the card's bits are the CPU's
    (tests/test_torch_crf.py holds the CPU to the JAX op and the
    spec)."""
    from paddle_tpu_torch.core.registry import get_op_def

    x = np.random.RandomState(d).randint(-2 ** 31, 2 ** 31 - 1,
                                         (64, d)).astype(dtype)
    attrs = {"num_hash": 4, "mod_by": 100003}
    outs = [get_op_def("hash").compute(
        {"X": [torch.from_numpy(x).to(dev)]}, dict(attrs), dev)["Out"][0]
        for dev in (cuda, torch.device("cpu"))]
    assert torch.equal(outs[0].cpu(), outs[1])


# --- the op-library slice: random ops and in-place state on the card ----

_DRAWN = ("uniform_random_batch_size_like", "gaussian_random_batch_size_like",
          "sampling_id", "nce", "sample_logits")


@pytest.mark.parametrize("op", _DRAWN)
def test_random_op_draws_the_cpus_bits_on_the_card(cuda, op):
    """The op's draws on the card equal the CPU's bit for bit for the same
    op seed (the words, the batch-size-like values, sampling_id's ids,
    sample_logits' samples); the rest of its outputs and gradients within
    1e-10 in f64 (chip_smoke.slice_op_run, phase 17a's case)."""
    import chip_smoke
    from paddle_tpu_torch.core import rng

    (case,) = [c for c in chip_smoke.slice_op_cases(np) if c[0] == op]
    got, want = (chip_smoke.slice_op_run(torch, np, *case, dev, 31)
                 for dev in (cuda, torch.device("cpu")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if op in chip_smoke._DRAW_OPS or not np.issubdtype(w.dtype,
                                                           np.floating):
            assert np.array_equal(got[k], w), (op, k)
        else:
            err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= 1e-10, (op, k, err)
    words = [rng.op_words(rng.SeedHandle(torch.full(
        (), 31, dtype=torch.int64, device=dev), 0), (128, 64), dev).cpu()
        for dev in (cuda, torch.device("cpu"))]
    assert torch.equal(*words)


def _slice_program(fluid, kind):
    layers = fluid.layers
    x = layers.data("x", shape=[12], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    h = layers.fc(x, 16, act="relu")
    fetch = {}
    if kind == "nce":
        cost = layers.nce(h, label, 50, num_neg_samples=6)
    elif kind == "sampled":
        cost = layers.sampled_softmax_with_cross_entropy(
            layers.fc(h, 50), label, 20)
    else:
        w = layers.create_parameter([16, 50], "float32", name="sn.w")
        cost = layers.softmax_with_cross_entropy(
            layers.matmul(h, layers.spectral_norm(w, power_iters=1)),
            label)
    noise = layers.uniform_random_batch_size_like(x, [0, 3])
    fetch["noise"] = noise
    loss = layers.mean(cost)
    fluid.optimizer.Adam(1e-2).minimize(loss)
    return loss, fetch


@pytest.mark.parametrize("kind", ["nce", "sampled", "spectral_norm"])
def test_slice_step_captured_equals_eager_and_draws_afresh(cuda, kind):
    """Four Adam steps of a program holding the kind's op and a
    batch-size-like random fill, uncached (eager) and cached (the second
    captured, the rest replays) from one startup: every loss, every
    draw and every state tensor (spectral_norm's U and V, written back in
    place, included) bit for bit equal; the draws differ from step to
    step, and spectral_norm's U moves every step."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, fetch = _slice_program(fluid, kind)
    startup.random_seed = main.random_seed = 3
    r = np.random.RandomState(0)
    feeds = [{"x": r.randn(8, 12).astype(np.float32),
              "label": r.randint(0, 50, (8, 1)).astype(np.int64)}
             for _ in range(4)]
    runs = []
    for cached in (False, True):
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(scope):
            exe.run(startup)
            steps, us = [], []
            for f in feeds:
                steps.append(exe.run(main, feed=f,
                                     fetch_list=[loss, fetch["noise"]],
                                     use_program_cache=cached))
                if kind == "spectral_norm":
                    us.append(scope.find_var("spectral_norm_0.u_0").clone())
            state = {n: scope.find_var(n).clone() for n in scope.var_names()}
        runs.append((steps, state, us))
        exe.close()
    (se, ste, ue), (sc, stc, uc) = runs
    for a, b in zip(se, sc):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for n in ste:
        assert torch.equal(ste[n], stc[n]), n
    for a, b in zip(sc, sc[1:]):
        assert not np.array_equal(a[1], b[1])
    if kind == "spectral_norm":
        assert all(not torch.equal(a, b) for a, b in zip(uc, uc[1:]))
        for a, b in zip(ue, uc):
            assert torch.equal(a, b)


def test_auc_and_mean_iou_in_a_captured_step_equal_eager(cuda):
    """The batch-local metrics (the JAX ops keep no accumulator) in a
    cached step on the card equal the uncached step's every step, and
    the CPU's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.layer_helper import LayerHelper

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        p = fluid.layers.data("p", shape=[2], dtype="float32")
        lbl = fluid.layers.data("label", shape=[1], dtype="int64")
        pred = fluid.layers.data("pred", shape=[6], dtype="int32")
        truth = fluid.layers.data("truth", shape=[6], dtype="int32")
        auc = LayerHelper("auc").create_variable_for_type_inference(
            "float32")
        main.global_block().append_op(
            "auc", inputs={"Predict": [p], "Label": [lbl]},
            outputs={"AUC": [auc]}, attrs={"num_thresholds": 200})
        miou = fluid.layers.mean_iou(pred, truth, 5)
    r = np.random.RandomState(1)
    feeds = []
    for _ in range(4):
        q = r.uniform(0, 1, (64, 1)).astype(np.float32)
        feeds.append({"p": np.concatenate([1 - q, q], 1),
                      "label": (r.uniform(0, 1, (64, 1)) < q)
                      .astype(np.int64),
                      "pred": r.randint(0, 5, (64, 6)).astype(np.int32),
                      "truth": r.randint(0, 5, (64, 6)).astype(np.int32)})
    got = []
    for place, cached in ((fluid.CUDAPlace(0), False),
                          (fluid.CUDAPlace(0), True),
                          (fluid.CPUPlace(), False)):
        exe = fluid.Executor(place)
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            got.append([
                [float(v) for v in exe.run(main, feed=f,
                                           fetch_list=[auc, miou],
                                           use_program_cache=cached)]
                for f in feeds])
        exe.close()
    eager, captured, cpu = got
    assert eager == captured
    np.testing.assert_allclose(np.array(eager), np.array(cpu), atol=1e-6)
    assert len({tuple(s) for s in eager}) == 4


# --- the NMS sweep's kernels (csrc/nms_sweep.cu) and the vision slice ---


@pytest.mark.parametrize("m,sets,thr", [(64, 8, 0.5), (64, 8, -0.1),
                                        (400, 32, 0.5), (1000, 4, 0.0),
                                        (2000, 2, 0.7), (12000, 2, 0.7),
                                        (12000, 2, -0.1), (20000, 1, 0.7)])
def test_nms_sweep_kernel_equals_the_plain_keep(cuda, m, sets, thr):
    """The sweep's kernels (nms_sweep_mask_kernel, nms_sweep_scan_kernel)
    against the plain sweep (``_nms_keep``'s) bit for bit, ties,
    zero-width, inverted, duplicate, NaN and infinite boxes included, at m
    up to 12,000 (past the first design's shared-memory cap of 11,068 f32
    candidates) and 20,000 (the scan's removed set in two windows); one
    count a call; a second launch gives the same bits; the RPN's sweep
    (detection_ops' ``_nms_mask``: the kernels at thresholds >= 0) against
    the plain sweep over box_util.iou_xyxy."""
    from chip_smoke import nms_sets
    from paddle_tpu_torch.ops import detection_ops, vision_ops
    from paddle_tpu_torch.ops.box_util import iou_xyxy

    boxes, keep0 = nms_sets(torch, np, sets, m, m + sets)
    kernels.reset_counts()
    got = vision_ops.nms_sweep(boxes, keep0, thr)
    again = vision_ops.nms_sweep(boxes, keep0, thr)
    got_rpn = detection_ops._nms_mask(boxes, keep0, thr)
    torch.cuda.synchronize()
    assert kernels.launch_counts["nms_sweep"] == (3 if thr >= 0 else 2)
    want = vision_ops.nms_sweep_plain(boxes, keep0, thr)
    assert torch.equal(got, want) and torch.equal(again, got)
    want_rpn = vision_ops.sweep_mask(iou_xyxy(boxes, boxes) > thr, keep0)
    assert torch.equal(got_rpn, want_rpn)
    assert 0 < int(got.sum()) < int(keep0.sum())


@pytest.mark.parametrize("m,sets,thr", [(64, 64, 0.45), (400, 640, 0.45),
                                        (2000, 2, 0.7), (2000, 2, -0.1)])
def test_nms_mask_words_equal_the_plain_words(cuda, m, sets, thr):
    """nms_sweep_mask_kernel's packed tests (``nms_mask_words``: the mask
    kernel alone, one count a call) equal ``nms_mask_words_plain``'s bit
    for bit: bit 63, the last partial word, the diagonal block and the
    zero words below it."""
    from chip_smoke import nms_sets
    from paddle_tpu_torch.ops import vision_ops

    boxes, _ = nms_sets(torch, np, sets, m, m + sets + 1)
    kernels.reset_counts()
    got = vision_ops.nms_mask_words(boxes, thr)
    torch.cuda.synchronize()
    assert kernels.launch_counts["nms_sweep_mask"] == 1
    assert torch.equal(got, vision_ops.nms_mask_words_plain(boxes, thr))


def test_generate_proposals_at_12000_candidates_equals_the_cpu(cuda):
    """generate_proposals at Detectron's C4 training setting
    (lib/core/config.py: TRAIN.RPN_PRE_NMS_TOP_N 12,000, POST_NMS_TOP_N
    2,000, NMS 0.7) on a stride-16 map of 38 x 63 with 15 anchors (35,910
    a image): the sweep's kernels over 12,000 candidates (the first
    design refused more than 11,068) give the CPU's proposals, bit for
    bit. The deltas move the anchors' centres only (dw = dh = 0: exp(0)
    is exact on both devices)."""
    from paddle_tpu_torch.core.registry import get_op_def

    n, a, h, w, stride = 2, 15, 38, 63, 16.0
    r = np.random.RandomState(12)
    size = np.array([32.0, 64.0, 128.0, 256.0, 512.0])
    ratio = np.array([0.5, 1.0, 2.0])
    aw = (size[:, None] / np.sqrt(ratio)[None, :]).reshape(-1)
    ah = (size[:, None] * np.sqrt(ratio)[None, :]).reshape(-1)
    cy, cx = np.meshgrid((np.arange(h) + 0.5) * stride,
                         (np.arange(w) + 0.5) * stride, indexing="ij")
    anchors = np.stack([cx[..., None] - aw / 2, cy[..., None] - ah / 2,
                        cx[..., None] + aw / 2, cy[..., None] + ah / 2],
                       -1).astype(np.float32)                # [h, w, a, 4]
    deltas = np.zeros((n, a, 4, h, w), np.float32)
    deltas[:, :, :2] = r.normal(0, 0.2, (n, a, 2, h, w))
    ins = {"Scores": np.round(r.uniform(0, 1, (n, a, h, w)), 3)
           .astype(np.float32),
           "BboxDeltas": deltas.reshape(n, 4 * a, h, w),
           "ImInfo": np.array([[600.0, 1000.0, 1.0]] * n, np.float32),
           "Anchors": anchors, "Variances": np.ones_like(anchors)}
    attrs = {"pre_nms_topN": 12000, "post_nms_topN": 2000,
             "nms_thresh": 0.7, "min_size": 0.0}
    op = get_op_def("generate_proposals")
    cpu = torch.device("cpu")
    want = op.compute({k: [torch.from_numpy(v)] for k, v in ins.items()},
                      dict(attrs), cpu)
    kernels.reset_counts()
    got = op.compute({k: [torch.from_numpy(v).to(cuda)]
                      for k, v in ins.items()}, dict(attrs), cuda)
    torch.cuda.synchronize()
    assert kernels.launch_counts["nms_sweep"] == 1
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k][0].cpu(), want[k][0]), k
    assert (want["RpnRoisNum"][0] == 2000).all()


def test_nms_keep_on_the_card_equals_the_cpu(cuda):
    """``_nms_keep`` (sort and plain sweep) and ``multiclass_nms`` (sort
    and kernel) on the card give the CPU's orders, masks and rows."""
    from paddle_tpu_torch.core.registry import get_op_def
    from paddle_tpu_torch.ops import vision_ops

    r = np.random.RandomState(3)
    c = r.uniform(0, 1, (4, 300, 2))
    wh = r.uniform(0.02, 0.3, (4, 300, 2))
    boxes = torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                             .astype(np.float32))
    scores = torch.from_numpy(np.round(r.uniform(0, 1, (4, 5, 300)), 2)
                              .astype(np.float32))
    order, keep = vision_ops._nms_keep(boxes, scores[:, 1], 0.45, 200)
    g_order, g_keep = vision_ops._nms_keep(boxes.to(cuda),
                                           scores[:, 1].to(cuda), 0.45, 200)
    assert torch.equal(g_order.cpu(), order) and torch.equal(g_keep.cpu(),
                                                             keep)
    attrs = {"score_threshold": 0.05, "nms_top_k": 200, "keep_top_k": 50,
             "nms_threshold": 0.45, "background_label": 0}
    op = get_op_def("multiclass_nms")
    want = op.compute({"BBoxes": [boxes], "Scores": [scores]}, dict(attrs),
                      torch.device("cpu"))["Out"][0]
    kernels.reset_counts()
    got = op.compute({"BBoxes": [boxes.to(cuda)], "Scores": [scores.to(
        cuda)]}, dict(attrs), cuda)["Out"][0]
    torch.cuda.synchronize()
    assert kernels.launch_counts["nms_sweep"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("i", range(31))
def test_vision_slice_op_on_the_card_equals_the_cpu(cuda, i):
    """Phase 18a's case i (chip_smoke.vision_op_cases) on the card against
    the CPU: f64 within 1e-10 of the largest element, f32 (and the ops
    that compute in f32) 1e-5, integers and the sampling ops' selections
    exactly."""
    import chip_smoke as cs

    op, ins, attrs = cs.vision_op_cases(np)[i]
    gpu, cpu = (cs.slice_op_run(torch, np, op, ins, attrs, d, cs.SEED)
                for d in (cuda, torch.device("cpu")))
    assert sorted(gpu) == sorted(cpu)
    for k, c in cpu.items():
        g = gpu[k]
        assert g.shape == c.shape and g.dtype == c.dtype, (op, k)
        if k in cs._SAMPLED_EXACT.get(op, ()) or not np.issubdtype(
                c.dtype, np.floating):
            assert np.array_equal(g, c), (op, k)
            continue
        fin = np.isfinite(c)
        assert np.array_equal(fin, np.isfinite(g)), (op, k)
        tol = (1e-10 if c.dtype == np.float64
               and op not in cs.F32_ARITHMETIC_OPS else 1e-5)
        if fin.any():
            assert cs._rel_err(np, g[fin], c[fin]) <= tol, (op, k)
