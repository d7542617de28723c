"""The f32 attention forward's work split (``f32_fwd_plan`` in
paddle_tpu_torch/parallel/flash_attention.py), which the CUDA kernels of
csrc/flash_attention_bthd_fwd.cu take as given: every live key of every
query row is walked by exactly one block, and the split-and-merge
arithmetic of ``fwd_decode_kernel`` / ``fwd_kernel`` + ``fwd_merge_kernel``
(per split the row max m_s, the sum l_s of exp(s - m_s) and the
unnormalized out row; merged in the splits' order) gives the plain
version's out and lse. The kernels themselves run only on the card
(tests/test_torch_cuda.py); here the plan and a PyTorch model of that
arithmetic run on the CPU, within the kernels' f32 limit of 5e-6."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import flash_attention as fa

_SHAPES = [
    # b, h, tq, tk, dh, causal
    (4, 8, 1, 1024, 64, False),    # the serving decode step
    (4, 8, 1, 4096, 64, False),
    (1, 8, 1, 1, 64, False),       # tk = 1
    (2, 8, 3, 77, 64, False),      # tk no multiple of anything
    (2, 2, 8, 1024, 256, False),   # dh 256, the widest head
    (1, 3, 5, 9, 20, True),        # causal decode: only keys < tq live
    (1, 8, 128, 128, 64, False),   # the serving prefill at 128
    (1, 8, 1024, 1024, 64, False),  # the serving prefill at 1024: split
    (8, 8, 1024, 1024, 64, False),
    (2, 2, 256, 256, 256, False),  # dh 256: split in 32-key tiles
    (2, 2, 256, 200, 256, False),  # ragged last tile
    (2, 8, 1024, 1024, 64, True),  # causal: never split
    (1, 1, 100, 77, 72, False),
    (1, 1, 9, 3000, 128, False),
]


def _walk(plan, tq, tk, causal):
    """How often the blocks of a plan hand each (query row, key) pair of
    one (batch, head) to the softmax, block by block as the kernels walk
    them (every (batch, head) has the same blocks): a [tq, tk] count."""
    kernel, splits, split_keys = plan
    seen = np.zeros((tq, tk), np.int64)
    below = np.tril(np.ones((tq, tk), bool))  # key <= row
    row_tiles = ([(0, tq)] if kernel == "fwd_decode_kernel"
                 else [(q0, min(q0 + 64, tq)) for q0 in range(0, tq, 64)])
    live = min(tk, tq) if causal and kernel == "fwd_decode_kernel" else tk
    for split in range(splits):
        k_begin = split * split_keys
        for q0, q1 in row_tiles:
            k_end = min(live, k_begin + split_keys)
            if causal and kernel == "fwd_kernel":
                k_end = min(k_end, q1)  # the tile's last live key
            assert k_end > k_begin, "a block without keys"
            walked = np.zeros((tq, tk), bool)
            walked[q0:q1, k_begin:k_end] = True
            seen += walked & below if causal else walked
    return seen


@pytest.mark.parametrize("b,h,tq,tk,dh,causal", _SHAPES)
@pytest.mark.parametrize("sms", [132, 16, 1])
def test_f32_fwd_plan_covers_each_row_and_key_once(b, h, tq, tk, dh, causal,
                                                    sms):
    plan = fa.f32_fwd_plan(b, h, tq, tk, dh, causal, sms)
    kernel, splits, split_keys = plan
    assert kernel == ("fwd_decode_kernel" if tq <= fa.F32_DECODE_MAX_TQ
                      else "fwd_kernel")
    live = min(tk, tq) if causal and kernel == "fwd_decode_kernel" else tk
    # the C entry's check: the splits cover the live keys, the last ragged
    assert splits >= 1 and split_keys >= 1
    assert (splits - 1) * split_keys < live <= splits * split_keys
    if kernel == "fwd_kernel":
        assert splits == 1 or (not causal and
                               split_keys % fa.f32_key_tile(dh) == 0)
    else:
        # the split's K and V rows fit the decode kernel's 64 KB
        assert 2 * split_keys * fa.f32_row_floats(dh) * 4 <= 64 * 1024
    seen = _walk(plan, tq, tk, causal)
    want = (np.tril(np.ones((tq, tk), np.int64)) if causal
            else np.ones((tq, tk), np.int64))
    np.testing.assert_array_equal(seen, want)


def test_f32_fwd_plan_fills_the_card_on_the_decode_step():
    """The serving decode step (b4 h8 tq1 tk1024): 32 (batch, head)
    pairs alone would leave 100 of 132 SMs idle; the split gives every SM
    blocks, and the tiled kernel splits the b1 t1024 prefill (128 query
    tiles) but not the t1024 training row (1024)."""
    kernel, splits, _ = fa.f32_fwd_plan(4, 8, 1, 1024, 64, False, 132)
    assert kernel == "fwd_decode_kernel" and 32 * splits >= 3 * 132
    assert fa.f32_fwd_plan(1, 8, 1024, 1024, 64, False, 132)[1] == 2
    assert fa.f32_fwd_plan(8, 8, 1024, 1024, 64, False, 132)[1] == 1


def _split_merge_model(q, k, v, bias, scale, keep, plan, causal):
    """The kernels' arithmetic in PyTorch: per split the row max, the sum
    of exp(s - m) (undropped) and the unnormalized out row (dropped), then
    the merge in the splits' order. q [b, tq, h, dh], k/v [b, tk, h, dh];
    ``keep`` [b, h, tq, tk] scales (keep / (1 - p) or 0)."""
    _, splits, split_keys = plan
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    tq, tk = s.shape[2], s.shape[3]
    if causal:
        s = s.masked_fill(torch.ones(tq, tk, dtype=torch.bool).triu(1),
                          -math.inf)
    ms, ls, os_ = [], [], []
    for i in range(splits):
        sl = slice(i * split_keys, min(tk, (i + 1) * split_keys))
        m = s[..., sl].amax(-1, keepdim=True)
        m_use = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s[..., sl] - m_use)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        os_.append(torch.einsum("bhqk,bkhd->bhqd", p * keep[..., sl],
                                v[:, sl]))
    mx = torch.stack(ms).amax(0)
    w = [torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - mx))
         for m in ms]
    lsum = sum(wi * li for wi, li in zip(w, ls))
    out = sum(wi * oi for wi, oi in zip(w, os_)) / lsum
    return out.transpose(1, 2), (mx + torch.log(lsum)).transpose(1, 2)


@pytest.mark.parametrize("b,h,tq,tk,dh,causal,p_drop", [
    (4, 2, 1, 1024, 64, False, 0.0),
    (2, 2, 3, 77, 64, False, 0.1),
    (1, 1, 5, 9, 20, True, 0.0),
    (1, 2, 8, 200, 256, False, 0.2),
    (1, 2, 100, 300, 72, False, 0.1),
    (1, 2, 130, 130, 64, True, 0.0),
])
def test_split_merge_arithmetic_matches_plain(b, h, tq, tk, dh, causal,
                                              p_drop):
    r = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(r.randn(b, t, h, dh).astype(np.float32))
               for t in (tq, tk, tk))
    lens = r.randint(max(1, tk // 2), tk + 1, b)
    bias = torch.from_numpy(
        ((np.arange(tk)[None] >= lens[:, None]) * -1e9).astype(np.float32)
    )[:, None, None, :]
    scale = 1.0 / math.sqrt(dh)
    seed = 11 if p_drop else None
    keep = (fa.dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop)
            if p_drop else torch.ones(b, h, tq, tk))
    # a card of 4 SMs makes even small shapes split
    plan = fa.f32_fwd_plan(b, h, tq, tk, dh, causal, 4 if not causal else 132)
    out, lse = _split_merge_model(q, k, v, bias, scale, keep, plan, causal)
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, bias, scale, seed,
                                               p_drop, causal)
    assert (out - ref_out).abs().max() <= 5e-6
    assert (lse - ref_lse).abs().max() <= 5e-6
