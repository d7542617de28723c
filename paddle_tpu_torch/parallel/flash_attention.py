"""Scaled dot-product attention in the BTHD layout ([b, t, h, dh]).

``flash_attention_bthd_fwd`` is the port of the JAX package's function of
the same name (paddle_tpu/parallel/flash_attention.py). It routes exactly
as that function does:

- the *small regime* (``_use_bthd_small``: 8 <= tq, tk <= 512 and tq a
  whole number of 128-row chunks or at most 128) runs the hand-written
  Hopper kernel ``csrc/flash_attention_bthd_fwd.cu``, the counterpart of
  the TPU kernel ``_fwd_small_kernel``;
- shapes the JAX package sends to its k-blocked or long-context TPU
  kernels (every tk > 512 outside the small regime) have no Hopper
  kernel yet: a CUDA tensor there raises ``NotImplementedError``;
- everything else (for example tq < 8, the single-token decode step) is
  the dense composition ``attention_bthd_plain``, as the JAX package
  leaves it to XLA.

A CPU tensor always takes ``attention_bthd_plain``, which is also the
reference the kernel is checked against on the card. Causal attention is
folded into the additive bias (``_combined_causal_bias``) before either
path, as the JAX small/k-blocked paths do.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

_SMALL_T_MAX = 512
# tq is walked in 128-row chunks by the TPU kernel; the routing predicate
# keeps that constraint so both packages route every shape alike
_CQ = 128

# Kernel launches made by flash_attention_bthd_fwd (the wrapper adds one
# per launch of the CUDA kernel and nowhere else). chip_smoke.py resets
# it before driving the serving path and reads it after.
launches = 0

_SOURCE = "flash_attention_bthd_fwd"
_lib = None


def _use_bthd_small(tq, tk):
    return (
        8 <= tq <= _SMALL_T_MAX
        and 8 <= tk <= _SMALL_T_MAX
        and (tq <= _CQ or tq % _CQ == 0)
    )


def _combined_causal_bias(bias, tq, tk, device):
    """Fold the causal future-mask into an additive f32 bias
    ([1, 1, tq, tk], plus ``bias`` broadcast when given)."""
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    tri = torch.where(rows >= cols, 0.0, _NEG_INF).to(torch.float32)[None, None]
    return tri if bias is None else bias.to(torch.float32) + tri


def attention_bthd_plain(q, k, v, bias=None, scale=None):
    """The plain PyTorch version: scores in f32 from an einsum, an
    additive f32 bias, softmax and logsumexp in f32, the context einsum in
    f32, output cast to q's dtype. Returns (out [b, tq, h, dh],
    lse [b, tq, h, 1] f32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)          # [b, h, tq, 1]
    p = torch.exp(s - lse)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse.permute(0, 2, 1, 3).contiguous()


def flash_attention_bthd_fwd(q, k, v, bias=None, scale: Optional[float] = None,
                             causal: bool = False) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """q [b, tq, h, dh], k/v [b, tk, h, dh] -> (out [b, tq, h, dh] in q's
    dtype, lse [b, tq, h, 1] f32). ``bias``: additive f32 mask
    broadcastable to [b, h, tq, tk] ([b|1, 1|h, 1|tq, tk])."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if causal:
        bias = _combined_causal_bias(bias, tq, tk, q.device)
    if q.device.type in ("cpu", "meta"):
        return attention_bthd_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash_attention_bthd_fwd: no path for device {q.device}")
    if _use_bthd_small(tq, tk):
        return _launch(q, k, v, bias, scale)
    if tk > _SMALL_T_MAX:  # the JAX package's k-blocked or BHTD kernel
        raise NotImplementedError(
            f"flash_attention_bthd_fwd: tq={tq} tk={tk} h={h} dh={dh} needs "
            f"the k-blocked/long-context attention kernel, which has no "
            f"Hopper port yet")
    return attention_bthd_plain(q, k, v, bias, scale)


def _bias_strides(bias, b, h, tq, tk):
    """Element strides of a [b|1, 1|h, 1|tq, tk] f32 bias over (batch,
    head, query row), 0 on each broadcast (size-1) dim."""
    if bias.dim() != 4 or bias.shape[3] != tk:
        raise ValueError(
            f"attention bias must be [b|1, 1|h, 1|tq, {tk}], got "
            f"{tuple(bias.shape)}")
    strides = []
    for dim, full in zip(range(3), (b, h, tq)):
        n = bias.shape[dim]
        if n not in (1, full):
            raise ValueError(
                f"attention bias dim {dim} is {n}; expected 1 or {full}")
        strides.append(0 if n == 1 else bias.stride(dim))
    return strides


def _load():
    global _lib
    if _lib is None:
        from paddle_tpu_torch import kernels

        lib = kernels.load(_SOURCE)
        lib.pt_flash_attention_bthd_fwd.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 5
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_longlong] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.pt_flash_attention_bthd_fwd.restype = ctypes.c_int
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k, v, bias, scale):
    """Check and launch the CUDA kernel on the current stream."""
    global launches
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_bthd_fwd: dtype {q.dtype} "
                        f"(kernel takes float32 or bfloat16)")
    for name, t, shape in (("k", k, (b, tk, h, dh)), ("v", v, (b, tk, h, dh))):
        if t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"flash_attention_bthd_fwd: {name} is {t.dtype} "
                f"{tuple(t.shape)}, expected {q.dtype} {shape}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        # (h, dh) rows contiguous; batch and time strides are free
        if t.stride(3) != 1 or t.stride(2) != dh:
            raise ValueError(
                f"flash_attention_bthd_fwd: {name} strides {t.stride()} "
                f"need contiguous [h, dh] rows")
    strides = (ctypes.c_longlong * 6)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1))
    if dh > 128:
        raise NotImplementedError(f"flash_attention_bthd_fwd: dh={dh} > 128")
    sb = sh = sq = 0
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
        sb, sh, sq = _bias_strides(bias, b, h, tq, tk)
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h, 1), dtype=torch.float32, device=q.device)
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.pt_flash_attention_bthd_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, tq, tk, h, dh, strides, sb, sh, sq, float(scale),
        1 if q.dtype == torch.bfloat16 else 0, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bthd_fwd launch failed: "
            f"{lib.pt_cuda_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    return out, lse
