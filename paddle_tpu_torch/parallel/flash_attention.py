"""Scaled dot-product attention in the BTHD layout ([b, t, h, dh]).

``flash_attention_bthd_fwd`` / ``flash_attention_bthd_bwd`` are the ports
of the JAX package's functions of the same names
(paddle_tpu/parallel/flash_attention.py). They route exactly as those
functions do:

- the *small regime* (``_use_bthd_small``: 8 <= tq, tk <= 512 and tq a
  whole number of 128-row chunks or at most 128) runs the hand-written
  Hopper kernels ``csrc/flash_attention_bthd_fwd.cu`` (the counterpart of
  the TPU kernel ``_fwd_small_kernel``) and
  ``csrc/flash_attention_bthd_bwd.cu`` (``_dqdkv_small_kernel``);
- shapes the JAX package sends to its k-blocked or long-context TPU
  kernels (every tk > 512 outside the small regime) have no Hopper
  kernel yet: a CUDA tensor there raises ``NotImplementedError``;
- everything else (for example tq < 8, the single-token decode step) is
  the dense composition (``attention_bthd_plain``,
  ``attention_bthd_bwd_plain``), as the JAX package leaves it to XLA.

A CPU tensor always takes the plain versions, which are also the
references the kernels are checked against on the card. Causal attention
is folded into the additive bias (``_combined_causal_bias``) before
either path, in the forward and the backward alike.

Dropout (``p_drop > 0``, with a ``seed``) is applied inside the kernels
to the normalized probabilities that feed the output; the keep mask is a
hash of (seed, batch, head, query row, key column) that
``dropout_keep_mask_plain`` rebuilds bit for bit in PyTorch integer ops
and ``dropout_keep_mask`` dumps from the device (csrc/
attention_common.cuh). Its bits differ from the TPU's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

_NEG_INF = -1e30

_SMALL_T_MAX = 512
# tq is walked in 128-row chunks by the TPU kernel; the routing predicate
# keeps that constraint so both packages route every shape alike
_CQ = 128

# Kernel launches made by each wrapper (each adds one per launch of its
# CUDA kernel and nowhere else). chip_smoke.py resets them before driving
# a path and reads them after.
launches = 0        # flash_attention_bthd_fwd
bwd_launches = 0    # flash_attention_bthd_bwd
mask_launches = 0   # dropout_keep_mask

_FWD_SOURCE = "flash_attention_bthd_fwd"
_BWD_SOURCE = "flash_attention_bthd_bwd"
_libs = {}

_U32 = 0xFFFFFFFF


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


# --- the dropout keep mask (attention_common.cuh holds the device twin) ---


def _fmix32_int(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _U32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _U32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors holding uint32 values, split in
    16-bit halves so no int64 product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _dropout_params(seed: int, p_drop: float):
    """(stream key, keep threshold, keep scale) the kernels and the plain
    mask share: a 32-bit key mixed from the seed, keep iff hash < thresh,
    and 1/(1 - p) rounded to f32."""
    seed = int(seed) & ((1 << 64) - 1)
    key = _fmix32_int(_fmix32_int((seed & _U32) ^ 0x9E3779B9) ^ (seed >> 32))
    thresh = min(int((1.0 - p_drop) * 4294967296.0), _U32)
    keep_scale = float(np.float32(1.0) / np.float32(1.0 - p_drop))
    return key, thresh, keep_scale


def dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop, device="cpu"):
    """The kernels' scaled keep mask, [b, h, tq, tk] f32: keep_scale
    (1/(1 - p_drop) in f32) where a score is kept, else 0. Bit for bit
    what the device hash gives (csrc/attention_common.cuh)."""
    key, thresh, keep_scale = _dropout_params(seed, p_drop)
    dev = torch.device(device)
    bh = (torch.arange(b, device=dev)[:, None] * h
          + torch.arange(h, device=dev)[None, :])            # [b, h]
    hbh = _fmix32(bh ^ key)
    rows = torch.arange(tq, device=dev)
    hrow = _fmix32(hbh[:, :, None] ^ rows)                   # [b, h, tq]
    cols = torch.arange(tk, device=dev)
    bits = _fmix32(hrow[..., None] ^ cols)                   # [b, h, tq, tk]
    return torch.where(bits < thresh, keep_scale, 0.0).to(torch.float32)


def dropout_keep_mask(seed, b, h, tq, tk, p_drop, device):
    """The scaled keep mask as the attention kernels apply it, [b, tq,
    h, tk] f32 (the layout of the JAX package's mask dump). On a CUDA
    device it is written by the dump kernel of
    csrc/flash_attention_bthd_fwd.cu; on the CPU it is the plain
    version."""
    global mask_launches
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop,
                                       device).permute(0, 2, 1, 3)
    if device.type != "cuda":
        raise NotImplementedError(f"dropout_keep_mask: device {device}")
    if not 0.0 < p_drop < 1.0:
        raise ValueError(f"dropout_keep_mask: p_drop={p_drop}")
    key, thresh, keep_scale = _dropout_params(seed, p_drop)
    out = torch.empty((b, tq, h, tk), dtype=torch.float32, device=device)
    lib = _load(_FWD_SOURCE)
    rc = lib.pt_dropout_keep_mask(
        out.data_ptr(), b, tq, h, tk, key, thresh, keep_scale,
        torch.cuda.current_stream(device).cuda_stream)
    _check(lib, rc, "dropout_keep_mask")
    mask_launches += 1
    return out


# --- plain versions ---


def _check_dropout(seed, p_drop):
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"attention dropout p_drop={p_drop}, expected "
                         f"0 <= p_drop < 1")
    if p_drop > 0.0 and seed is None:
        raise ValueError("flash_attention: p_drop > 0 requires `seed`")


def attention_bthd_plain(q, k, v, bias=None, scale=None, seed=None,
                         p_drop=0.0):
    """The plain PyTorch version: scores in f32 from an einsum, an
    additive f32 bias, softmax and logsumexp in f32, the normalized
    probabilities times the dropout keep mask (``p_drop > 0``), the
    context einsum in f32, output cast to q's dtype. Returns (out [b, tq,
    h, dh], lse [b, tq, h, 1] f32, of the undropped softmax)."""
    _check_dropout(seed, p_drop)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)          # [b, h, tq, 1]
    p = torch.exp(s - lse)
    if p_drop > 0.0:
        p = p * dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop, q.device)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse.permute(0, 2, 1, 3).contiguous()


def attention_bthd_bwd_plain(q, k, v, bias, seed, out, lse, g, scale=None,
                             p_drop=0.0):
    """The plain backward, the formula written out (all f32): s and p =
    exp(s - lse) recomputed, dP = g v^T, M the scaled keep mask (1
    without dropout), delta = rowsum(g o out), dS = p o (dP o M - delta)
    * scale, dq = dS k, dk = dS^T q, dv = (p o M)^T g. Returns (dq, dk,
    dv) in the dtypes of q, k, v."""
    _check_dropout(seed, p_drop)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)
    p = torch.exp(s - lse.permute(0, 2, 1, 3))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * out.float()).sum(-1, keepdim=True).permute(0, 2, 1, 3)
    pd = p
    if p_drop > 0.0:
        mask = dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop, q.device)
        pd = p * mask
        dp = dp * mask
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- routing wrappers ---


def flash_attention_bthd_fwd(q, k, v, bias=None, scale: Optional[float] = None,
                             causal: bool = False, seed: Optional[int] = None,
                             p_drop: float = 0.0) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """q [b, tq, h, dh], k/v [b, tk, h, dh] -> (out [b, tq, h, dh] in q's
    dtype, lse [b, tq, h, 1] f32). ``bias``: additive f32 mask
    broadcastable to [b, h, tq, tk] ([b|1, 1|h, 1|tq, tk]). ``p_drop``:
    attention dropout keyed by ``seed`` (required when > 0)."""
    _check_dropout(seed, p_drop)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if causal:
        bias = _combined_causal_bias(bias, tq, tk, q.device)
    if q.device.type in ("cpu", "meta"):
        return attention_bthd_plain(q, k, v, bias, scale, seed, p_drop)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash_attention_bthd_fwd: no path for device {q.device}")
    if _use_bthd_small(tq, tk):
        return _launch_fwd(q, k, v, bias, scale, seed, p_drop)
    _no_kernel_yet("flash_attention_bthd_fwd", tq, tk, h, dh)
    return attention_bthd_plain(q, k, v, bias, scale, seed, p_drop)


def flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, g,
                             scale: Optional[float] = None,
                             p_drop: float = 0.0, causal: bool = False):
    """-> (dq, dk, dv) in [b, t, h, dh], from the forward's saved (out,
    lse) and the output gradient ``g``, with the forward's ``bias``,
    ``seed``, ``p_drop`` and ``causal``: it routes exactly as the forward
    did, so the recomputed probabilities and the keep mask match."""
    _check_dropout(seed, p_drop)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if causal:
        bias = _combined_causal_bias(bias, tq, tk, q.device)
    if q.device.type in ("cpu", "meta"):
        return attention_bthd_bwd_plain(q, k, v, bias, seed, out, lse, g,
                                        scale, p_drop)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash_attention_bthd_bwd: no path for device {q.device}")
    if _use_bthd_small(tq, tk):
        return _launch_bwd(q, k, v, bias, seed, out, lse, g, scale, p_drop)
    _no_kernel_yet("flash_attention_bthd_bwd", tq, tk, h, dh)
    return attention_bthd_bwd_plain(q, k, v, bias, seed, out, lse, g,
                                    scale, p_drop)


def _no_kernel_yet(fn, tq, tk, h, dh):
    if tk > _SMALL_T_MAX:  # the JAX package's k-blocked or BHTD kernel
        raise NotImplementedError(
            f"{fn}: tq={tq} tk={tk} h={h} dh={dh} needs the "
            f"k-blocked/long-context attention kernel, which has no "
            f"Hopper port yet")


class _BthdWithLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, p_drop, causal):
        out, lse = flash_attention_bthd_fwd(q, k, v, bias, scale, causal,
                                            seed=seed, p_drop=p_drop)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.seed, ctx.scale, ctx.p_drop, ctx.causal = (seed, scale, p_drop,
                                                       causal)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bthd_bwd(
            q, k, v, bias, ctx.seed, out, lse, g.to(q.dtype), ctx.scale,
            ctx.p_drop, ctx.causal)
        # the bias is mask plumbing, not a trainable input: zeros, as on
        # the JAX package's kernel path
        dbias = None if bias is None else torch.zeros_like(bias)
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention_bthd_with_lse(q, k, v, bias=None, seed=None,
                                  scale: Optional[float] = None,
                                  p_drop: float = 0.0, causal: bool = False):
    """(out, lse) as ``flash_attention_bthd_fwd`` gives them, differentiable
    through autograd: the backward runs ``flash_attention_bthd_bwd`` (the
    backward kernel on a CUDA tensor in the small regime) from the saved
    (out, lse). The bias cotangent is zeros, as in the JAX package's
    custom vjp."""
    return _BthdWithLse.apply(q, k, v, bias, seed, scale, p_drop, causal)


# --- kernel launches ---


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


def _load(source):
    lib = _libs.get(source)
    if lib is None:
        from paddle_tpu_torch import kernels

        lib = kernels.load(source)
        drop = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
        if source == _FWD_SOURCE:
            lib.pt_flash_attention_bthd_fwd.argtypes = (
                [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_longlong)]
                + [ctypes.c_longlong] * 3
                + [ctypes.c_float, ctypes.c_int] + drop + [ctypes.c_void_p])
            lib.pt_flash_attention_bthd_fwd.restype = ctypes.c_int
            lib.pt_dropout_keep_mask.argtypes = (
                [ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                   ctypes.c_void_p])
            lib.pt_dropout_keep_mask.restype = ctypes.c_int
        else:
            lib.pt_flash_attention_bthd_bwd.argtypes = (
                [ctypes.c_void_p] * 10
                + [ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_longlong)]
                + [ctypes.c_longlong] * 3
                + [ctypes.c_float, ctypes.c_int] + drop + [ctypes.c_void_p])
            lib.pt_flash_attention_bthd_bwd.restype = ctypes.c_int
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def _check(lib, rc, fn):
    if rc != 0:
        raise RuntimeError(
            f"{fn} launch failed: {lib.pt_cuda_error_string(rc).decode()} "
            f"(cudaError {rc})")


def _check_qkv(fn, q, k, v):
    """Validate what the kernels take; returns the (batch, time) element
    strides of q, k, v."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: dtype {q.dtype} (kernel takes float32 or "
                        f"bfloat16)")
    if dh > 128:
        raise NotImplementedError(f"{fn}: dh={dh} > 128")
    for name, t, shape in (("k", k, (b, tk, h, dh)), ("v", v, (b, tk, h, dh))):
        if t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{fn}: {name} is {t.dtype} {tuple(t.shape)}, expected "
                f"{q.dtype} {shape}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        # (h, dh) rows contiguous; batch and time strides are free
        if t.stride(3) != 1 or t.stride(2) != dh:
            raise ValueError(
                f"{fn}: {name} strides {t.stride()} need contiguous "
                f"[h, dh] rows")
    return (ctypes.c_longlong * 6)(q.stride(0), q.stride(1), k.stride(0),
                                   k.stride(1), v.stride(0), v.stride(1))


def _bias_args(bias, q, b, h, tq, tk):
    if bias is None:
        return None, 0, 0, 0
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    return (bias, *_bias_strides(bias, b, h, tq, tk))


def _drop_args(seed, p_drop):
    if p_drop <= 0.0:
        return [0, 0, 0, 0.0]
    return [1, *_dropout_params(seed, p_drop)]


def _launch_fwd(q, k, v, bias, scale, seed, p_drop):
    """Check and launch the forward kernel on the current stream."""
    global launches
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    strides = _check_qkv("flash_attention_bthd_fwd", q, k, v)
    bias, sb, sh, sq = _bias_args(bias, q, b, h, tq, tk)
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h, 1), dtype=torch.float32, device=q.device)
    lib = _load(_FWD_SOURCE)
    rc = lib.pt_flash_attention_bthd_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, tq, tk, h, dh, strides, sb, sh, sq, float(scale),
        1 if q.dtype == torch.bfloat16 else 0, *_drop_args(seed, p_drop),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(lib, rc, "flash_attention_bthd_fwd")
    launches += 1
    return out, lse


def _launch_bwd(q, k, v, bias, seed, out, lse, g, scale, p_drop):
    """Check and launch the backward kernel (its two passes) on the
    current stream."""
    global bwd_launches
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    strides = _check_qkv("flash_attention_bthd_bwd", q, k, v)
    for name, t in (("out", out), ("g", g)):
        if tuple(t.shape) != (b, tq, h, dh) or t.device != q.device:
            raise ValueError(f"flash_attention_bthd_bwd: {name} is "
                             f"{tuple(t.shape)} on {t.device}")
    if tuple(lse.shape) != (b, tq, h, 1):
        raise ValueError(f"flash_attention_bthd_bwd: lse is "
                         f"{tuple(lse.shape)}, expected {(b, tq, h, 1)}")
    bias, sb, sh, sq = _bias_args(bias, q, b, h, tq, tk)
    g = g.to(q.dtype).contiguous()
    lse = lse.to(torch.float32).contiguous()
    delta = (g.float() * out.float()).sum(-1).contiguous()   # [b, tq, h]
    dq = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, tk, h, dh), dtype=q.dtype, device=q.device)
    lib = _load(_BWD_SOURCE)
    rc = lib.pt_flash_attention_bthd_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, tk, h, dh, strides, sb, sh, sq, float(scale),
        1 if q.dtype == torch.bfloat16 else 0, *_drop_args(seed, p_drop),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(lib, rc, "flash_attention_bthd_bwd")
    bwd_launches += 1
    return dq, dk, dv
