"""Card-only checks of the port's CUDA kernel against its plain version.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: out 5e-6 in f32 (both sum in f32, in
different orders) and 8e-3 in bf16 (one bf16 ulp of outputs below 2);
lse, f32 in both dtypes, 5e-6."""

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
    h, dh = 8, 64
    q = torch.randn(1, 128, h, dh, device=cuda)
    for tk in (640, 2048):  # k-blocked and long-context TPU kernels
        kv = torch.randn(1, tk, h, dh, device=cuda)
        with pytest.raises(NotImplementedError):
            fa.flash_attention_bthd_fwd(q, kv, kv)
    before = fa.launches
    kv = torch.randn(1, 128, h, dh, device=cuda)
    out, lse = fa.flash_attention_bthd_fwd(q[:, :1], kv, kv)  # one token
    assert fa.launches == before and out.shape == (1, 1, h, dh)
