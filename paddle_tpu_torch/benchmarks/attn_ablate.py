"""Attention-forward ablation. The counterpart of the JAX package's
``benchmarks/attn_ablate.py``: the attention forward at the
Transformer-base shape (b = 64, h = 8, t = 256, dh = 64; and h = 4,
dh = 128 at the same model width), without bias, mask or lse, in
variants that isolate each part of the softmax:

  matmul-floor   score and p.v products only (no softmax)
  full           row max, exp, correction, row sum
  no-rowmax      exp(s) without the running max (unsafe numerically;
                 measures the cost of the max and the correction)
  bf16-exp       the exponentials in bf16

``make_fwd`` returns the forward for one variant: on CUDA tensors it
launches the hand-written kernel (``csrc/attn_ablate.cu``), on CPU
tensors it takes the plain version. No model's op calls the kernel.

    python3 -m paddle_tpu_torch.benchmarks.attn_ablate
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from paddle_tpu_torch import kernels

SOURCE = "attn_ablate"

VARIANTS = ("matmul-floor", "full", "no-rowmax", "bf16-exp")

# Kernel launches made by the forwards of ``make_fwd``:
# kernels.launch_counts[SOURCE], one per call on a CUDA tensor.

# the lowest finite f32: the running max starts here
_NEG_INF = float(np.finfo(np.float32).min)
_MAX_BK = 512


def _bf16(x):
    """``x`` rounded to bf16 and widened back to f32."""
    return x.to(torch.bfloat16).float()


def attn_ablate_plain(q, k, v, variant, bk):
    """The variant's arithmetic written out over key blocks of ``bk``: f32
    scores of the bf16 inputs, p rounded to bf16 before it multiplies v,
    f32 running max, sum and accumulator, out rounded to bf16 once."""
    b, h, t, dh = q.shape
    scale = 1.0 / np.sqrt(dh)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, t, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, t, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, bk):
        kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if variant == "matmul-floor":
            acc = acc + torch.matmul(_bf16(s), vb)
        elif variant == "no-rowmax":
            p = torch.exp(s)
            l = l + p.sum(dim=-1, keepdim=True)
            acc = acc + torch.matmul(_bf16(p), vb)
        elif variant == "bf16-exp":
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = _bf16(torch.exp(_bf16(s - m_new)))
            corr = _bf16(torch.exp(_bf16(m - m_new)))
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p, vb)
            m = m_new
        else:  # full
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(_bf16(p), vb)
            m = m_new
    if variant in ("full", "bf16-exp"):
        acc = acc / l
    elif variant == "no-rowmax":
        acc = acc / l.clamp_min(1e-9)
    return acc.to(torch.bfloat16)


def _check(q, k, v, variant, b, h, t, dh, bk):
    fn = "attn_ablate"
    for name, x in (("q", q), ("k", k), ("v", v)):
        if tuple(x.shape) != (b, h, t, dh):
            raise ValueError(f"{fn}: {name} is {tuple(x.shape)}, expected "
                             f"{(b, h, t, dh)}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: {name} is {x.dtype}, expected bfloat16")
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, q on "
                             f"{q.device}")


def _launch(q, k, v, variant, bk):
    fn = "attn_ablate"
    b, h, t, dh = q.shape
    if dh > 128 or bk % 64 or bk > _MAX_BK:
        raise NotImplementedError(
            f"{fn}: dh={dh}, bk={bk}; the kernel takes dh <= 128 and bk a "
            f"multiple of 64 up to {_MAX_BK}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} strides {x.stride()} are not "
                             f"contiguous")
    out = torch.empty_like(q)
    entry = kernels.function(
        SOURCE, "pt_attn_ablate_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, h, t, dh, bk, VARIANTS.index(variant),
               float(1.0 / np.sqrt(dh)),
               torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(SOURCE, rc, f"{fn}[{variant}]")
    kernels.count(SOURCE)
    return out


def make_fwd(variant: str, b, h, t, dh, bq, bk):
    """The forward of one variant for q, k, v [b, h, t, dh] bf16 -> out
    [b, h, t, dh] bf16, keys taken in blocks of ``bk`` (which divides t).
    As in the JAX script the query block covers every row: ``bq`` must
    equal t."""
    if variant not in VARIANTS:
        raise ValueError(f"attn_ablate: variant {variant!r}, expected one "
                         f"of {VARIANTS}")
    if bq != t:
        raise ValueError(f"attn_ablate: bq={bq} must equal t={t}")
    if bk < 1 or t % bk:
        raise ValueError(f"attn_ablate: bk={bk} does not divide t={t}")

    def fwd(q, k, v):
        _check(q, k, v, variant, b, h, t, dh, bk)
        if not q.is_cuda:
            return attn_ablate_plain(q, k, v, variant, bk)
        return _launch(q, k, v, variant, bk)

    return fwd


def make_inputs(b, h, t, dh, seed=0, device="cpu"):
    """q, k, v ~ 0.1 N(0, 1) in bf16, made on the host from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return tuple((torch.randn((b, h, t, dh), generator=gen) * 0.1)
                 .to(torch.bfloat16).to(device) for _ in range(3))


def head_shapes():
    """(name, (h, dh), variants) of the study's two head shapes."""
    return (("h8dh64", (8, 64), VARIANTS),
            ("h4dh128", (4, 128), ("matmul-floor", "full")))


def main():
    from paddle_tpu_torch.benchmarks import timing

    device = timing.require_card()
    print(f"card: {timing.card_line()}")
    b, t = 64, 256
    results = {}
    for name, (h, dh), variants in head_shapes():
        q, k, v = make_inputs(b, h, t, dh, device=device)
        for variant in variants:
            fn = make_fwd(variant, b, h, t, dh, 256, 256)
            us = timing.device_us(lambda: fn(q, k, v), 20)
            results[f"{name}/{variant}"] = us
            print(f"{name:8s} {variant:14s}: {us:7.1f} us/call")
    return results


if __name__ == "__main__":
    main()
