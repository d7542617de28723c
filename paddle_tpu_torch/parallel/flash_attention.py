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
  one to ``kernels.launch_counts["attention_dense"]``. The kernels take heads up to ``KERNEL_MAX_DH``
  (256) wide; on the card a wider head on a kernel route raises (the JAX
  package's kernels have no such bound).

On Hopper the three kernel routes share one forward,
``csrc/flash_attention_bthd_fwd.cu``, and one backward,
``csrc/flash_attention_bthd_bwd.cu`` (pass A: dk and dv; pass B: dq),
whose kernels are chosen by dtype: bf16 runs them on the tensor cores
(``wgmma``: ``fwd_wgmma_kernel``, ``bwd_dkdv_wgmma_kernel``,
``bwd_dq_wgmma_kernel``); f32 runs its forward on the CUDA cores
(``fwd_kernel``, ``fwd_decode_kernel`` and ``fwd_merge_kernel`` as
``f32_fwd_plan`` splits the keys) and its backward on the tensor cores in
3xTF32, f32-accurate (``bwd_dkdv_tf32_kernel``, ``bwd_dq_tf32_kernel``:
``mma.sync`` TF32 products of operands split into two TF32 terms). Both
take (batch, time, head) element
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
hash of (seed, batch, head, query row, key column) (csrc/
attention_common.cuh) that ``dropout_keep_mask_plain`` rebuilds bit for
bit in PyTorch integer ops and ``dropout_keep_mask`` dumps from the
device (csrc/dropout_mask.cu). Its bits differ from the TPU's. A
``seed`` is an int (made a device scalar with ``torch.full``), a 0-d
int64 device tensor holding the op seed, or a ``core.rng.SeedHandle``
(the run's seed buffer and the op's index, as the op passes it): the
kernels read it from device memory and mix the key in their prologue, so
a CUDA graph replays a new mask each step (core/rng.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng

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
# the widest head the kernels take; a wider one raises on the card
KERNEL_MAX_DH = 256

# The wrappers' counts in kernels.launch_counts: ("attention", route,
# "fwd" | "bwd") a launch of the forward or backward kernel (a backward
# launch runs both passes), "attention_mask" a launch of
# dropout_keep_mask, "attention_dense" a call on the dense route (plain
# composition).

_FWD_SOURCE = "flash_attention_bthd_fwd"
_BWD_SOURCE = "flash_attention_bthd_bwd"
_MASK_SOURCE = "dropout_mask"


def route_counts():
    """{(route, "fwd" | "bwd"): kernel launches} of every kernel route."""
    return {(r, d): kernels.launch_counts["attention", r, d]
            for r in KERNEL_ROUTES for d in ("fwd", "bwd")}


def launched(direction: str) -> int:
    """The forward ("fwd") or backward ("bwd") kernel's launches on every
    route."""
    return sum(n for (_, d), n in route_counts().items() if d == direction)


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


def dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop, device="cpu"):
    """The kernels' scaled keep mask, [b, h, tq, tk] f32: keep_scale
    (1/(1 - p_drop) in f32) where a score is kept, else 0. Bit for bit
    what the device hash gives (csrc/attention_common.cuh). ``seed``: an
    int, a 0-d int64 tensor (the op seed) or a ``rng.SeedHandle``; the
    key is mixed from it with tensor ops (no host read)."""
    dev = torch.device(device)
    key = rng.stream_key_tensor(rng.op_seed_tensor(seed, dev))
    bh = (torch.arange(b, device=dev)[:, None] * h
          + torch.arange(h, device=dev)[None, :])            # [b, h]
    hrow = rng.row_hash(key, bh[:, :, None],
                        torch.arange(tq, device=dev))        # [b, h, tq]
    cols = torch.arange(tk, device=dev)
    bits = rng.fmix32(hrow[..., None] ^ cols)                # [b, h, tq, tk]
    return torch.where(bits < rng.keep_threshold(p_drop),
                       rng.keep_scale(p_drop), 0.0).to(torch.float32)


def mask_run_split(start: int, tk: int):
    """How the dump kernel (csrc/dropout_mask.cu) writes one (b, q, h)
    run of tk floats that starts at element ``start`` of the output:
    (head, nvec, tail): ``head`` floats one by one up to the first 16-byte
    boundary, ``nvec`` aligned float4 stores, ``tail`` floats one by
    one."""
    head = min(tk, -start % 4)
    nvec = (tk - head) // 4
    return head, nvec, tk - head - 4 * nvec


def dropout_keep_mask(seed, b, h, tq, tk, p_drop, device):
    """The scaled keep mask as the attention kernels apply it, [b, tq,
    h, tk] f32 (the layout of the JAX package's mask dump). On a CUDA
    device it is written by the dump kernel of csrc/dropout_mask.cu; on
    the CPU it is the plain version."""
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop,
                                       device).permute(0, 2, 1, 3)
    if device.type != "cuda":
        raise NotImplementedError(f"dropout_keep_mask: device {device}")
    if not 0.0 < p_drop < 1.0:
        raise ValueError(f"dropout_keep_mask: p_drop={p_drop}")
    if b > 65535:
        raise NotImplementedError(f"dropout_keep_mask: b={b}; the kernel "
                                  f"takes b <= 65535")
    seed_t, op_idx = rng.kernel_seed(seed, device)
    out = torch.empty((b, tq, h, tk), dtype=torch.float32, device=device)
    entry = kernels.function(_MASK_SOURCE, "pt_dropout_keep_mask",
                             _MASK_ARGS)
    rc = entry(out.data_ptr(), b, tq, h, tk, seed_t.data_ptr(), op_idx,
               rng.keep_threshold(p_drop), rng.keep_scale(p_drop),
               torch.cuda.current_stream(device).cuda_stream)
    kernels.check(_MASK_SOURCE, rc, "dropout_keep_mask")
    kernels.count("attention_mask")
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
        s = s + bias.to(s.dtype)
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
    mask (``p_drop > 0``) cast to v's dtype, as the JAX package's
    reference and kernels cast them, the context einsum summed in f32,
    output cast to q's dtype. Returns (out [b, tq, h, dh], lse [b, tq, h,
    1] f32, of the undropped softmax)."""
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
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    return out, lse.permute(0, 2, 1, 3).contiguous()


def attention_bthd_bwd_plain(q, k, v, bias, seed, out, lse, g, scale=None,
                             p_drop=0.0, causal=False, g_lse=None):
    """The plain backward, the formula written out (all f32, or all f64
    for f64 inputs, a reference for the kernels' rounding): s and p =
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
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf, gf = (x.to(wide) for x in (q, k, v, g))
    s = _scores(qf, kf, bias, scale, causal)
    p = torch.exp(s - lse.permute(0, 2, 1, 3).to(wide))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * out.to(wide)).sum(-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.to(wide)
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
    kernels.count("attention_dense")


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


def flash_attention_bthd_fwd(q, k, v, bias=None, seed: Optional[int] = None,
                             scale: Optional[float] = None,
                             p_drop: float = 0.0, causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b, tq, h, dh], k/v [b, tk, h, dh] -> (out [b, tq, h, dh] in q's
    dtype, lse [b, tq, h, 1] f32), taking the JAX package's arguments in
    its order. ``bias``: additive f32 mask broadcastable to [b, h, tq, tk]
    ([b|1, 1|h, 1|tq, tk]). ``p_drop``: attention dropout keyed by
    ``seed`` (required when > 0)."""
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
        out, lse = flash_attention_bthd_fwd(q, k, v, bias, seed, scale,
                                            p_drop, causal)
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


# --- the f32 forward's work split (csrc/flash_attention_bthd_fwd.cu) ---

# tq up to this runs the split-KV decode kernel (fwd_decode_kernel, all
# rows in one block), longer queries the tiled one (fwd_kernel, 64 rows a
# block)
F32_DECODE_MAX_TQ = 8
_F32_BQ = 64
# shared memory the decode kernel's K and V rows may take (bytes)
_F32_DECODE_KV_BYTES = 64 * 1024
# blocks per SM the decode split aims at, and the fewest keys a split
# takes (fixed costs a block weigh past that)
_F32_DECODE_BLOCKS_PER_SM = 4
_F32_DECODE_MIN_KEYS = 32


def f32_row_floats(dh: int) -> int:
    """Row stride (floats) of K, V and Q in the f32 kernels' shared
    memory: dh padded to 4, plus 4 when that leaves an even number of
    16-byte chunks (``f32_ld`` in the source)."""
    pad = -(-dh // 4) * 4
    return pad if (pad // 4) % 2 else pad + 4


def f32_key_tile(dh: int) -> int:
    """Keys of one shared-memory tile of the tiled f32 kernel."""
    return 64 if dh <= 64 else 32


def f32_fwd_plan(b: int, h: int, tq: int, tk: int, dh: int, causal: bool,
                 sms: int):
    """(kernel, splits, split_keys) of an f32 forward on a card with
    ``sms`` SMs: the keys each (batch, head, query tile) block walks are
    cut into ``splits`` ranges of ``split_keys`` keys, the last one
    ragged, that cover the live keys once (with more than one,
    ``fwd_merge_kernel`` combines them in their order).

    - ``fwd_decode_kernel`` (tq <= 8, the serving decode step): one block
      a (batch, head, split); about four blocks an SM, 32 keys a split at
      least, each split's K and V rows within 64 KB of shared memory.
      Under the causal mask only keys below tq are live.
    - ``fwd_kernel`` (tq > 8): one block a 64-row query tile; when those
      blocks leave the SMs idle (fewer than one an SM) and the mask is not
      causal, the keys split in whole tiles, two tiles a split at least."""
    def cdiv(x, y):
        return -(-x // y)

    if tq <= F32_DECODE_MAX_TQ:
        live = min(tk, tq) if causal else tk
        splits = cdiv(_F32_DECODE_BLOCKS_PER_SM * sms, b * h)
        # keys a split: a multiple of 8, at least the minimum, at most what
        # 64 KB of K and V rows hold (8 bytes a head-dim element)
        cap = max(8, _F32_DECODE_KV_BYTES // (8 * f32_row_floats(dh)) // 8
                  * 8)
        split_keys = min(cap, max(_F32_DECODE_MIN_KEYS,
                                  cdiv(cdiv(live, splits), 8) * 8))
        return "fwd_decode_kernel", cdiv(live, split_keys), split_keys
    bk = f32_key_tile(dh)
    blocks = cdiv(tq, _F32_BQ) * b * h
    n_tiles = cdiv(tk, bk)
    splits = 1
    if not causal and blocks < sms:
        splits = max(1, min(cdiv(sms, blocks), n_tiles // 2))
    split_keys = cdiv(n_tiles, splits) * bk
    return "fwd_kernel", cdiv(tk, split_keys), split_keys


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
              + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                 ctypes.c_float])
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong)] + _ARGS_TAIL
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong)] + _ARGS_TAIL
             + [ctypes.c_int, ctypes.c_void_p])
_MASK_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 4
              + [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                 ctypes.c_void_p])


def _check_qkv(fn, q, k, v):
    """Validate the BTHD views the kernels take."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: dtype {q.dtype} (kernel takes float32 or "
                        f"bfloat16)")
    if dh > KERNEL_MAX_DH:
        raise NotImplementedError(f"{fn}: dh={dh} > {KERNEL_MAX_DH}")
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
    """(the launch arguments after the stride array: bias strides, scale,
    dtype, causal and dropout; the seed tensor they point to, which the
    caller keeps alive over the launch)."""
    b, tq, h, _ = q.shape
    sb = sh = sq = 0
    if bias is not None:
        sb, sh, sq = _bias_strides(bias, b, h, tq, k.shape[1])
    seed_t = None
    if p_drop <= 0.0:
        drop = [0, None, -1, 0, 0.0]
    else:
        # the kernels read the seed from device memory and mix the op
        # seed and stream key in their prologue
        seed_t, op_idx = rng.kernel_seed(seed, q.device)
        drop = [1, seed_t.data_ptr(), op_idx, rng.keep_threshold(p_drop),
                rng.keep_scale(p_drop)]
    return [sb, sh, sq, float(scale), 1 if q.dtype == torch.bfloat16 else 0,
            1 if causal else 0, *drop], seed_t


def _bias_tensor(bias, q):
    if bias is None:
        return None
    return bias.to(device=q.device, dtype=torch.float32).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    """SMs of CUDA device ``index`` (asked once: the query costs more
    host time than a decode step's kernel)."""
    return torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device()
    ).multi_processor_count


def _launch_fwd(route, q, k, v, bias, scale, seed, p_drop, causal, out, lse):
    """Check and launch the forward kernel on the current stream. q, k,
    v, out [b, t, h, dh] and lse [b, tq, h, 1] are BTHD views with any
    (batch, time, head) strides. f32 takes the key split of
    ``f32_fwd_plan``, with scratch for the splits' partials when there is
    more than one."""
    fn = "flash_attention_bthd_fwd"
    _check_qkv(fn, q, k, v)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    bias = _bias_tensor(bias, q)
    splits, split_keys, part = 1, tk, None
    if q.dtype == torch.float32:
        _, splits, split_keys = f32_fwd_plan(b, h, tq, tk, dh, causal,
                                             _sm_count(q.device.index))
        if splits > 1:
            part = torch.empty(splits * b * h * tq * (dh + 2),
                               dtype=torch.float32, device=q.device)
    common, _seed_t = _common_args(q, k, bias, scale, seed, p_drop, causal)
    entry = kernels.function(_FWD_SOURCE, "pt_flash_attention_bthd_fwd",
                             _FWD_ARGS)
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, tq, tk, h, dh, _strides(q, k, v, out, lse), *common,
        splits, split_keys, None if part is None else part.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(_FWD_SOURCE, rc, fn)
    kernels.count(("attention", route, "fwd"))


def _launch_bwd(route, q, k, v, bias, seed, out, lse, g, g_lse, scale,
                p_drop, causal, dq, dk, dv, passes=3):
    """Check and launch the backward kernel on the current stream: the
    delta pre-pass (rowsum(g o out) - g_lse), then pass A (dk, dv; bit 1
    of ``passes``) and pass B (dq; bit 2). Every tensor is a BTHD view
    with any (batch, time, head) strides; lse and g_lse are [b, tq, h,
    1]."""
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
    common, _seed_t = _common_args(q, k, bias, scale, seed, p_drop, causal)
    entry = kernels.function(_BWD_SOURCE, "pt_flash_attention_bthd_bwd",
                             _BWD_ARGS)
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), g.data_ptr(), lse.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, k.shape[1], h, dh,
        _strides(q, k, v, out, g, lse, g_lse, dq, dk, dv), *common, passes,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(_BWD_SOURCE, rc, fn)
    kernels.count(("attention", route, "bwd"))
