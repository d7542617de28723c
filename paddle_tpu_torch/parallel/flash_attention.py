"""Scaled dot-product attention: the port of the JAX package's
paddle_tpu/parallel/flash_attention.py, in its two layouts.

- BTHD ([b, t, h, dh], the layout of the model's attention):
  ``flash_attention_bthd_fwd`` / ``flash_attention_bthd_bwd`` and the
  autograd wrapper ``flash_attention_bthd_with_lse``.
- BHTD ([b, h, t, dh]): ``flash_attention_fwd`` / ``flash_attention_bwd``
  (the backward takes an lse cotangent ``g_lse``), ``flash_attention`` and
  ``flash_attention_with_lse``.

``attention_route`` names the route of a shape. It is a pure function of
the shape and names the route the JAX package takes, shape for shape:

- ``small`` (BTHD, ``_use_bthd_small``: 8 <= tq, tk <= 512, tq at most
  128 or a multiple of it): the TPU's ``_fwd_small_kernel`` /
  ``_dqdkv_small_kernel``. Causal attention is folded into the additive
  bias (``_combined_causal_bias``) first, as there.
- ``kblock`` (BTHD, ``_use_bthd_kblock``: 512 < tk <= 1024 with a
  k-block that divides tk): ``_fwd_kb_kernel`` / ``_dqdkv_kb_kernel``.
- ``bhtd`` (BTHD with tk > 512 outside ``kblock``, and BHTD inputs whose
  tq and tk divide the blocks of ``_pick_blocks``): ``_fwd_kernel``,
  ``_dq_kernel`` and ``_dkv_kernel``.
- ``dense``: everything else (tq < 8, or tq = 200 at tk = 256, or tk >
  512 that does not divide the blocks). The JAX package leaves it to XLA;
  here it is the plain composition on any device, and each such call adds
  one to ``dense_calls``.

On Hopper the three kernel routes share one kernel family,
``csrc/flash_attention_bthd_fwd.cu`` and ``csrc/flash_attention_bthd_bwd.cu``
(pass A: dk and dv; pass B: dq). It takes (batch, time, head) element
strides for every tensor, so BHTD tensors run with no transpose. On the
``kblock`` and ``bhtd`` routes causal attention is a template flag: the
kernels mask ``q_pos >= k_pos`` themselves and skip every tile with no
live score, and no [tq, tk] tensor is built. Nothing in them bounds tk.

A CPU tensor always takes the plain versions (``attention_bthd_plain``,
``attention_bthd_bwd_plain`` and their BHTD twins ``attention_plain``,
``attention_bwd_plain``), which are also the references the kernels are
checked against on the card. On a CUDA tensor a kernel route launches
its kernel or raises.

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

from paddle_tpu_torch import kernels

_NEG_INF = -1e30

# --- routing (the JAX package's predicates, without its backend test) ---

DEFAULT_Q_BLOCK = 256
DEFAULT_K_BLOCK = 256
# the TPU kernels' cap on one f32 score block (h * bq * bk * 4 bytes);
# it picks the BHTD blocks, and so which shapes divide them
_SCORE_VMEM_BYTES = 3 * 2**19
_SMALL_T_MAX = 512
# tq is walked in 128-row chunks by the TPU kernels; the routing
# predicates keep that constraint so both packages route every shape alike
_CQ = 128
_BK_CHOICES = (512, 256)
_KB_T_MAX = 1024

KERNEL_ROUTES = ("small", "kblock", "bhtd")

# Kernel launches made by the wrappers (each adds one per launch of its
# CUDA kernel and nowhere else). chip_smoke.py resets them before driving
# a path and reads them after.
launches = 0        # forward kernel, every route
bwd_launches = 0    # backward kernel (a launch runs both passes), every route
mask_launches = 0   # dropout_keep_mask
launch_counts = {(r, d): 0 for r in KERNEL_ROUTES for d in ("fwd", "bwd")}
dense_calls = 0     # calls on the dense route (plain composition)

_FWD_SOURCE = "flash_attention_bthd_fwd"
_BWD_SOURCE = "flash_attention_bthd_bwd"

_U32 = 0xFFFFFFFF


def reset_counts():
    """Set every launch count and ``dense_calls`` to 0."""
    global launches, bwd_launches, mask_launches, dense_calls
    launches = bwd_launches = mask_launches = dense_calls = 0
    for key in launch_counts:
        launch_counts[key] = 0


def _use_bthd_small(tq, tk):
    return (
        8 <= tq <= _SMALL_T_MAX
        and 8 <= tk <= _SMALL_T_MAX
        and (tq <= _CQ or tq % _CQ == 0)
    )


def _pick_bk(tk, h, dh):
    for bk in _BK_CHOICES:
        if tk % bk == 0 and h * _CQ * bk <= 8 * 256 * 256:
            return bk
    return None


def _use_bthd_kblock(tq, tk, h, dh):
    return (
        _SMALL_T_MAX < tk <= _KB_T_MAX
        and _pick_bk(tk, h, dh) is not None
        and tq >= 8
        and (tq <= _CQ or tq % _CQ == 0)
        and tk * h * dh <= 2 * 1024 * 512
    )


def _pick_blocks(h, tq, tk, q_block=DEFAULT_Q_BLOCK, k_block=DEFAULT_K_BLOCK):
    bq = min(q_block, tq)
    bk = min(k_block, tk)
    while h * bq * bk * 4 > _SCORE_VMEM_BYTES and bq > 64:
        bq //= 2
    while h * bq * bk * 4 > _SCORE_VMEM_BYTES and bk > 128:
        bk //= 2
    return bq, bk


def _blocks_divide(tq, tk, bq, bk):
    """The divisibility half of the JAX package's ``_use_pallas``."""
    return tq % bq == 0 and tk % bk == 0


def attention_route(tq, tk, h, dh, layout="bthd", q_block=DEFAULT_Q_BLOCK,
                    k_block=DEFAULT_K_BLOCK):
    """``small``, ``kblock``, ``bhtd`` or ``dense``: the route the JAX
    package's ``flash_attention_bthd_fwd/bwd`` (``layout="bthd"``) or
    ``flash_attention_fwd/bwd`` (``layout="bhtd"``) takes for this shape."""
    if layout == "bhtd":
        bq, bk = _pick_blocks(h, tq, tk, q_block, k_block)
        return "bhtd" if _blocks_divide(tq, tk, bq, bk) else "dense"
    if layout != "bthd":
        raise ValueError(f"attention layout {layout!r}")
    if _use_bthd_small(tq, tk):
        return "small"
    if _use_bthd_kblock(tq, tk, h, dh):
        return "kblock"
    if tk > _SMALL_T_MAX:
        return attention_route(tq, tk, h, dh, "bhtd")
    return "dense"


def _combined_causal_bias(bias, tq, tk, device):
    """Fold the causal future-mask into an additive f32 bias
    ([1, 1, tq, tk], plus ``bias`` broadcast when given): the ``small``
    and ``dense`` routes of the BTHD functions, as in the JAX package."""
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
    entry = kernels.function(_FWD_SOURCE, "pt_dropout_keep_mask", _MASK_ARGS)
    rc = entry(out.data_ptr(), b, tq, h, tk, key, thresh, keep_scale,
               torch.cuda.current_stream(device).cuda_stream)
    kernels.check(_FWD_SOURCE, rc, "dropout_keep_mask")
    mask_launches += 1
    return out


# --- plain versions ---


def _check_dropout(seed, p_drop):
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"attention dropout p_drop={p_drop}, expected "
                         f"0 <= p_drop < 1")
    if p_drop > 0.0 and seed is None:
        raise ValueError("flash_attention: p_drop > 0 requires `seed`")


def _scores(qf, kf, bias, scale, causal):
    """f32 scores [b, h, tq, tk] of BTHD q, k: scaled products plus the
    additive bias; with ``causal``, scores with k_pos > q_pos set to
    _NEG_INF (a where, as the TPU kernels mask, not an addition)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)
    if causal:
        tq, tk = s.shape[-2:]
        live = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = torch.where(live, s, _NEG_INF)
    return s


def attention_bthd_plain(q, k, v, bias=None, scale=None, seed=None,
                         p_drop=0.0, causal=False):
    """The plain PyTorch version: scores in f32 from an einsum, an
    additive f32 bias, the causal mask (``causal``), softmax and
    logsumexp in f32, the normalized probabilities times the dropout keep
    mask (``p_drop > 0``), the context einsum in f32, output cast to q's
    dtype. Returns (out [b, tq, h, dh], lse [b, tq, h, 1] f32, of the
    undropped softmax)."""
    _check_dropout(seed, p_drop)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    s = _scores(q.float(), k.float(), bias, scale, causal)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)          # [b, h, tq, 1]
    p = torch.exp(s - lse)
    if p_drop > 0.0:
        p = p * dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop, q.device)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse.permute(0, 2, 1, 3).contiguous()


def attention_bthd_bwd_plain(q, k, v, bias, seed, out, lse, g, scale=None,
                             p_drop=0.0, causal=False, g_lse=None):
    """The plain backward, the formula written out (all f32): s and p =
    exp(s - lse) recomputed (causal mask included), dP = g v^T, M the
    scaled keep mask (1 without dropout), delta = rowsum(g o out) - g_lse
    (``g_lse``: the lse cotangent [b, tq, h, 1], 0 when None), dS = p o
    (dP o M - delta) * scale, dq = dS k, dk = dS^T q, dv = (p o M)^T g.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    _check_dropout(seed, p_drop)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = _scores(qf, kf, bias, scale, causal)
    p = torch.exp(s - lse.permute(0, 2, 1, 3))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * out.float()).sum(-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.permute(0, 2, 1, 3)
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


def _bthd(*xs):
    """BTHD views of BHTD tensors (and back): dims 1 and 2 swapped."""
    return [None if x is None else x.transpose(1, 2) for x in xs]


def attention_plain(q, k, v, bias=None, scale=None, seed=None, p_drop=0.0,
                    causal=False):
    """BHTD twin of ``attention_bthd_plain``: q [b, h, tq, dh], k/v [b, h,
    tk, dh] -> (out [b, h, tq, dh], lse [b, h, tq, 1] f32)."""
    out, lse = attention_bthd_plain(*_bthd(q, k, v), bias, scale, seed,
                                    p_drop, causal)
    return out.transpose(1, 2).contiguous(), lse.transpose(1, 2).contiguous()


def attention_bwd_plain(q, k, v, bias, seed, out, lse, g, scale=None,
                        p_drop=0.0, causal=False, g_lse=None):
    """BHTD twin of ``attention_bthd_bwd_plain`` (``g_lse`` [b, h, tq, 1]):
    -> (dq, dk, dv) in [b, h, t, dh]."""
    grads = attention_bthd_bwd_plain(*_bthd(q, k, v), bias, seed,
                                     *_bthd(out, lse, g), scale, p_drop,
                                     causal, *_bthd(g_lse))
    return tuple(x.transpose(1, 2).contiguous() for x in grads)


# --- routing wrappers ---


def _count_dense():
    global dense_calls
    dense_calls += 1


def _takes_plain(fn, q, route):
    """Count a dense-route call; True when the plain version runs (a CPU
    or meta tensor, or the dense route). Shape inference (meta tensors)
    counts nothing."""
    kind = q.device.type
    if kind not in ("cpu", "meta", "cuda"):
        raise NotImplementedError(f"{fn}: no path for device {q.device}")
    if kind == "meta":
        return True
    if route == "dense":
        _count_dense()
        return True
    return kind != "cuda"


def _bthd_route(q, k, causal, bias):
    """(route, bias, in-kernel causal) of a BTHD call: the small and dense
    routes fold causal into the bias, as the JAX package does."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    route = attention_route(tq, tk, h, dh)
    if causal and route in ("small", "dense"):
        return route, _combined_causal_bias(bias, tq, tk, q.device), False
    return route, bias, causal


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
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    route, bias, causal = _bthd_route(q, k, causal, bias)
    if _takes_plain("flash_attention_bthd_fwd", q, route):
        return attention_bthd_plain(q, k, v, bias, scale, seed, p_drop,
                                    causal)
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h, 1), dtype=torch.float32, device=q.device)
    _launch_fwd(route, q, k, v, bias, scale, seed, p_drop, causal, out, lse)
    return out, lse


def flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, g,
                             scale: Optional[float] = None,
                             p_drop: float = 0.0, causal: bool = False):
    """-> (dq, dk, dv) in [b, t, h, dh], from the forward's saved (out,
    lse) and the output gradient ``g``, with the forward's ``bias``,
    ``seed``, ``p_drop`` and ``causal``: it routes exactly as the forward
    did, so the recomputed probabilities and the keep mask match."""
    _check_dropout(seed, p_drop)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    route, bias, causal = _bthd_route(q, k, causal, bias)
    if _takes_plain("flash_attention_bthd_bwd", q, route):
        return attention_bthd_bwd_plain(q, k, v, bias, seed, out, lse, g,
                                        scale, p_drop, causal)
    dq, dk, dv = (torch.empty(x.shape, dtype=q.dtype, device=q.device)
                  for x in (q, k, v))
    _launch_bwd(route, q, k, v, bias, seed, out, lse, g, None, scale,
                p_drop, causal, dq, dk, dv)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, bias=None, seed=None, scale=None,
                        p_drop: float = 0.0, q_block: int = DEFAULT_Q_BLOCK,
                        k_block: int = DEFAULT_K_BLOCK, causal: bool = False):
    """BHTD: q [b, h, tq, dh], k/v [b, h, tk, dh] -> (out [b, h, tq, dh]
    in q's dtype, lse [b, h, tq, 1] f32, real logsumexp rows on every
    route). ``causal`` is the in-kernel mask on the ``bhtd`` route (no
    [tq, tk] tensor); ``q_block``/``k_block`` only pick the route."""
    _check_dropout(seed, p_drop)
    b, h, tq, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    route = attention_route(tq, k.shape[2], h, dh, "bhtd", q_block, k_block)
    if _takes_plain("flash_attention_fwd", q, route):
        return attention_plain(q, k, v, bias, scale, seed, p_drop, causal)
    out = torch.empty((b, h, tq, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq, 1), dtype=torch.float32, device=q.device)
    _launch_fwd(route, *_bthd(q, k, v), bias, scale, seed, p_drop, causal,
                *_bthd(out, lse))
    return out, lse


def flash_attention_bwd(q, k, v, bias, seed, out, lse, g, scale=None,
                        p_drop: float = 0.0, q_block: int = DEFAULT_Q_BLOCK,
                        k_block: int = DEFAULT_K_BLOCK, causal: bool = False,
                        g_lse=None):
    """BHTD backward -> (dq, dk, dv) [b, h, t, dh] from the forward's saved
    (out, lse). ``g_lse``: the cotangent of the lse output ([b, h, tq,
    1]); d lse / d s = p, so it folds into the per-row delta as delta -
    g_lse."""
    _check_dropout(seed, p_drop)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, tq, dh = q.shape
    route = attention_route(tq, k.shape[2], h, dh, "bhtd", q_block, k_block)
    if _takes_plain("flash_attention_bwd", q, route):
        return attention_bwd_plain(q, k, v, bias, seed, out, lse, g, scale,
                                   p_drop, causal, g_lse)
    dq, dk, dv = (torch.empty(x.shape, dtype=q.dtype, device=q.device)
                  for x in (q, k, v))
    _launch_bwd(route, *_bthd(q, k, v), bias, seed, *_bthd(out, lse, g),
                _bthd(g_lse)[0], scale, p_drop, causal, *_bthd(dq, dk, dv))
    return dq, dk, dv


# --- autograd ---


def _plain_vjp(fn, inputs, grads):
    """Cotangents of the plain composition ``fn(*inputs)`` (a tuple of
    outputs) for the output cotangents ``grads``; None inputs get None."""
    with torch.enable_grad():
        xs = [None if x is None else x.detach().requires_grad_()
              for x in inputs]
        outs = fn(*xs)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        live = [x for x in xs if x is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], live,
                                       [g for _, g in pairs]))
    return [None if x is None else next(got) for x in xs]


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
        g = g.to(q.dtype)
        tq, tk = q.shape[1], k.shape[1]
        if _use_bthd_small(tq, tk) or tk > _SMALL_T_MAX:
            dq, dk, dv = flash_attention_bthd_bwd(
                q, k, v, bias, ctx.seed, out, lse, g, ctx.scale, ctx.p_drop,
                ctx.causal)
            # the kernel routes: the bias is mask plumbing, its cotangent
            # zeros (a real one would be a [tq, tk] gradient per head)
            dbias = None if bias is None else torch.zeros_like(bias)
        else:
            # the dense route: the real dbias, with the causal fold inside
            # the differentiated function so it reflects the caller's bias
            _count_dense()
            causal, scale = ctx.causal, ctx.scale

            def fn(a, b_, c, bb):
                if causal:
                    bb = _combined_causal_bias(bb, tq, tk, a.device)
                return attention_bthd_plain(a, b_, c, bb, scale, ctx.seed,
                                            ctx.p_drop)[:1]

            dq, dk, dv, dbias = _plain_vjp(fn, (q, k, v, bias), (g,))
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention_bthd_with_lse(q, k, v, bias=None, seed=None,
                                  scale: Optional[float] = None,
                                  p_drop: float = 0.0, causal: bool = False):
    """(out, lse) as ``flash_attention_bthd_fwd`` gives them, differentiable
    through autograd by the JAX package's rule: on the kernel routes (the
    small regime, or tk > 512) the backward runs
    ``flash_attention_bthd_bwd`` from the saved (out, lse) and the bias
    cotangent is zeros; on the dense route the cotangents, the bias's
    included, are those of the plain composition."""
    return _BthdWithLse.apply(q, k, v, bias, seed, scale, p_drop, causal)


class _BhtdWithLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, p_drop, q_block, k_block,
                causal):
        out, lse = flash_attention_fwd(q, k, v, bias, seed, scale, p_drop,
                                       q_block, k_block, causal)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (seed, scale, p_drop, q_block, k_block, causal)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        seed, scale, p_drop, q_block, k_block, causal = ctx.args
        g = g.to(q.dtype)
        b, h, tq, dh = q.shape
        if attention_route(tq, k.shape[2], h, dh, "bhtd", q_block,
                           k_block) == "bhtd":
            dq, dk, dv = flash_attention_bwd(q, k, v, bias, seed, out, lse,
                                             g, scale, p_drop, q_block,
                                             k_block, causal, g_lse)
            dbias = None if bias is None else torch.zeros_like(bias)
        else:
            _count_dense()
            dq, dk, dv, dbias = _plain_vjp(
                lambda a, b_, c, bb: attention_plain(a, b_, c, bb, scale,
                                                     seed, p_drop, causal),
                (q, k, v, bias), (g, g_lse))
        return dq, dk, dv, dbias, None, None, None, None, None, None


def flash_attention_with_lse(q, k, v, bias=None, seed=None,
                             scale: Optional[float] = None,
                             p_drop: float = 0.0,
                             q_block: int = DEFAULT_Q_BLOCK,
                             k_block: int = DEFAULT_K_BLOCK,
                             causal: bool = False):
    """BHTD (out, lse), differentiable in both through autograd by the
    JAX package's rule (``_vjp_bwd``): on the ``bhtd`` route the backward
    kernel with the lse cotangent folded in and a zero bias cotangent; on
    the dense route the plain composition's cotangents, the bias's
    included."""
    return _BhtdWithLse.apply(q, k, v, bias, seed, scale, p_drop, q_block,
                              k_block, causal)


def flash_attention(q, k, v, bias=None, seed=None,
                    scale: Optional[float] = None, p_drop: float = 0.0,
                    q_block: int = DEFAULT_Q_BLOCK,
                    k_block: int = DEFAULT_K_BLOCK, causal: bool = False):
    """BHTD o = dropout(softmax(q k^T * scale + bias)) v, differentiable
    as ``flash_attention_with_lse``."""
    return flash_attention_with_lse(q, k, v, bias, seed, scale, p_drop,
                                    q_block, k_block, causal)[0]


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


# ctypes signatures of the C entries (``kernels.function`` binds them)
_ARGS_TAIL = ([ctypes.c_longlong] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2
              + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float])
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong)] + _ARGS_TAIL
             + [ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong)] + _ARGS_TAIL
             + [ctypes.c_int, ctypes.c_void_p])
_MASK_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 4
              + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                 ctypes.c_void_p])


def _check_qkv(fn, q, k, v):
    """Validate the BTHD views the kernels take."""
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
        # dh contiguous; batch, time and head strides are free
        if t.stride(3) != 1:
            raise ValueError(f"{fn}: {name} strides {t.stride()} need a "
                             f"contiguous head dim")


def _strides(*xs):
    """(batch, time, head) element strides of BTHD views, as one ctypes
    array; a None tensor gives zeros."""
    flat = []
    for x in xs:
        flat += [0, 0, 0] if x is None else list(x.stride()[:3])
    return (ctypes.c_longlong * len(flat))(*flat)


def _rows(t, dtype, device):
    """``t`` in ``dtype`` on ``device`` with its last dim contiguous."""
    t = t.to(device=device, dtype=dtype)
    return t if t.shape[-1] == 1 or t.stride(-1) == 1 else t.contiguous()


def _common_args(q, k, bias, scale, seed, p_drop, causal):
    """The launch arguments after the stride array: bias strides, scale,
    dtype, causal and dropout."""
    b, tq, h, _ = q.shape
    sb = sh = sq = 0
    if bias is not None:
        sb, sh, sq = _bias_strides(bias, b, h, tq, k.shape[1])
    drop = [0, 0, 0, 0.0] if p_drop <= 0.0 else [
        1, *_dropout_params(seed, p_drop)]
    return [sb, sh, sq, float(scale), 1 if q.dtype == torch.bfloat16 else 0,
            1 if causal else 0, *drop]


def _bias_tensor(bias, q):
    if bias is None:
        return None
    return bias.to(device=q.device, dtype=torch.float32).contiguous()


def _launch_fwd(route, q, k, v, bias, scale, seed, p_drop, causal, out, lse):
    """Check and launch the forward kernel on the current stream. q, k,
    v, out [b, t, h, dh] and lse [b, tq, h, 1] are BTHD views with any
    (batch, time, head) strides."""
    global launches
    fn = "flash_attention_bthd_fwd"
    _check_qkv(fn, q, k, v)
    b, tq, h, dh = q.shape
    bias = _bias_tensor(bias, q)
    entry = kernels.function(_FWD_SOURCE, "pt_flash_attention_bthd_fwd",
                             _FWD_ARGS)
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, tq, k.shape[1], h, dh, _strides(q, k, v, out, lse),
        *_common_args(q, k, bias, scale, seed, p_drop, causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(_FWD_SOURCE, rc, fn)
    launches += 1
    launch_counts[(route, "fwd")] += 1


def _launch_bwd(route, q, k, v, bias, seed, out, lse, g, g_lse, scale,
                p_drop, causal, dq, dk, dv, passes=3):
    """Check and launch the backward kernel on the current stream: the
    delta pre-pass (rowsum(g o out) - g_lse), then pass A (dk, dv; bit 1
    of ``passes``) and pass B (dq; bit 2). Every tensor is a BTHD view
    with any (batch, time, head) strides; lse and g_lse are [b, tq, h,
    1]."""
    global bwd_launches
    fn = "flash_attention_bthd_bwd"
    _check_qkv(fn, q, k, v)
    b, tq, h, dh = q.shape
    for name, t in (("out", out), ("g", g)):
        if tuple(t.shape) != (b, tq, h, dh) or t.device != q.device:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)} on "
                             f"{t.device}")
    for name, t in (("lse", lse), ("g_lse", g_lse)):
        if t is not None and tuple(t.shape) != (b, tq, h, 1):
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)}, expected "
                             f"{(b, tq, h, 1)}")
    bias = _bias_tensor(bias, q)
    out, g = _rows(out, q.dtype, q.device), _rows(g, q.dtype, q.device)
    lse = _rows(lse, torch.float32, q.device)
    if g_lse is not None:
        g_lse = _rows(g_lse, torch.float32, q.device)
    delta = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    entry = kernels.function(_BWD_SOURCE, "pt_flash_attention_bthd_bwd",
                             _BWD_ARGS)
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), g.data_ptr(), lse.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, k.shape[1], h, dh,
        _strides(q, k, v, out, g, lse, g_lse, dq, dk, dv),
        *_common_args(q, k, bias, scale, seed, p_drop, causal), passes,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(_BWD_SOURCE, rc, fn)
    bwd_launches += 1
    launch_counts[(route, "bwd")] += 1
