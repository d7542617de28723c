"""Combined backward of a 1x1 convolution: dx and dW from one pass over
(x, dy). The counterpart of the JAX package's
``benchmarks/conv_bwd_pallas.py``: the study of ResNet-50's expand
convolutions (x [n, ci] bf16, dy [n, co] bf16, W [ci, co] bf16 with
n = batch * H * W), whose two backward products read dy twice when they
run as two matrix products.

``combined_conv1x1_bwd`` launches the hand-written kernel
(``csrc/conv1x1_bwd.cu``) on CUDA tensors and takes the plain version on
CPU tensors; ``matmul_pair`` is the two-product library baseline it
races (the JAX script's ``xla_pair``). No model's op calls the kernel:
``conv2d_grad`` stays a derived grad op, as in the JAX package.

    python3 -m paddle_tpu_torch.benchmarks.conv_bwd
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch import kernels

SOURCE = "conv1x1_bwd"

# Kernel launches made by ``combined_conv1x1_bwd`` (one per call on a CUDA
# tensor: the main kernel and its reduction are one launch of the wrapper).
launches = 0

# ResNet-50's expand convolutions at batch 128: (n, ci, co)
SHAPES = ((128 * 56 * 56, 64, 256),
          (128 * 28 * 28, 128, 512),
          (128 * 14 * 14, 256, 1024))

_MAX_SLICE_TILES = 64   # 16x16 dW tiles a block keeps in registers
_MAX_TN = 64            # rows of an n-tile, at most
# shared memory a block may take so that two fit an SM (227 KB)
_SMEM_PER_BLOCK = 113 * 1024
_PAD = 8                # the kernel's padding per shared-memory row


def _smem_bytes(cs: int, tn: int, co: int) -> int:
    """The kernel's shared memory: W slice, dy tile and x tile in bf16,
    the dx tile in f32 (``smem_bytes`` in the source)."""
    return (2 * (cs * (co + _PAD) + tn * (co + _PAD) + tn * (cs + _PAD))
            + 4 * tn * (cs + _PAD))


def plan(n: int, ci: int, co: int, sms: int):
    """How the kernel splits the work: ``cs`` input channels a slice (the
    widest multiple of 16 dividing ci whose dW slice fits a block's
    accumulators), ``tn`` rows an n-tile (the most, up to 64, that leave
    room for two blocks an SM), and ``parts`` n-ranges of
    ``tiles_per_part`` n-tiles, about two blocks an SM in all."""
    cs = max(c for c in range(16, ci + 1, 16)
             if ci % c == 0 and (c // 16) * (co // 16) <= _MAX_SLICE_TILES)
    tn = max([16] + [t for t in range(16, _MAX_TN + 1, 16)
                     if _smem_bytes(cs, t, co) <= _SMEM_PER_BLOCK])
    ntiles = -(-n // tn)
    parts = max(1, min(ntiles, 2 * sms // (ci // cs)))
    tiles_per_part = -(-ntiles // parts)
    parts = -(-ntiles // tiles_per_part)
    return cs, tn, parts, tiles_per_part


def _check(x, dy, w):
    fn = "combined_conv1x1_bwd"
    if x.dim() != 2 or dy.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{fn}: x, dy, w must be 2-D, got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(w.shape)}")
    n, ci = x.shape
    co = dy.shape[1]
    if dy.shape[0] != n or tuple(w.shape) != (ci, co):
        raise ValueError(f"{fn}: x {tuple(x.shape)}, dy {tuple(dy.shape)}, "
                         f"w {tuple(w.shape)} do not agree")
    for name, t in (("x", x), ("dy", dy), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected bfloat16")
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on "
                             f"{x.device}")
    return n, ci, co


def combined_conv1x1_bwd_plain(x, dy, w):
    """The same two products written out: dx = dy . W^T rounded to bf16,
    dW = x^T . dy accumulated and kept in f32."""
    dyf = dy.float()
    dx = torch.matmul(dyf, w.float().t()).to(x.dtype)
    dw = torch.matmul(x.float().t(), dyf)
    return dx, dw


def combined_conv1x1_bwd(x, dy, w):
    """dx = dy @ W^T and dW = x^T @ dy in one pass over (x, dy).

    x [n, ci] bf16, dy [n, co] bf16, w [ci, co] bf16 -> (dx [n, ci] bf16,
    dW [ci, co] f32). CUDA tensors launch the kernel (contiguous inputs,
    ci and co multiples of 16, co <= 1024; any n, the ragged last tile is
    masked) or raise; CPU tensors take the plain version."""
    global launches
    n, ci, co = _check(x, dy, w)
    if not x.is_cuda:
        return combined_conv1x1_bwd_plain(x, dy, w)
    fn = "combined_conv1x1_bwd"
    if ci % 16 or co % 16 or co > 1024:
        raise NotImplementedError(
            f"{fn}: ci={ci}, co={co}; the kernel takes multiples of 16 and "
            f"co <= 1024")
    for name, t in (("x", x), ("dy", dy), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} strides {t.stride()} are not "
                             f"contiguous")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cs, tn, parts, tiles_per_part = plan(n, ci, co, sms)
    dx = torch.empty_like(x)
    dw = torch.empty((ci, co), dtype=torch.float32, device=x.device)
    partial = torch.empty((parts, ci, co), dtype=torch.float32,
                          device=x.device)
    entry = kernels.function(
        SOURCE, "pt_conv1x1_bwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    rc = entry(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
               dw.data_ptr(), partial.data_ptr(), n, ci, co, cs, tn, parts,
               tiles_per_part,
               torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(SOURCE, rc, fn)
    launches += 1
    return dx, dw


def matmul_pair(x, dy, w):
    """The two-product baseline the combined kernel races: one library
    matrix product for dx, one for dW with an f32 result."""
    dx = torch.matmul(dy, w.t())
    if x.is_cuda:
        dw = torch.mm(x.t(), dy, out_dtype=torch.float32)
    else:
        dw = torch.matmul(x.float().t(), dy.float())
    return dx, dw


def make_inputs(n, ci, co, seed=0, device="cpu"):
    """Standard-normal x, dy, w in bf16, made on the host from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(torch.bfloat16)
                 .to(device) for shape in ((n, ci), (n, co), (ci, co)))


def main():
    from paddle_tpu_torch.benchmarks import timing

    device = timing.require_card()
    print(f"card: {timing.card_line()}")
    for n, ci, co in SHAPES:
        x, dy, w = make_inputs(n, ci, co, device=device)
        dxk, dwk = combined_conv1x1_bwd(x, dy, w)
        dxp, dwp = combined_conv1x1_bwd_plain(x, dy, w)
        dx_err = float((dxk.float() - dxp.float()).abs().max())
        dw_rel = float((dwk - dwp).abs().max() / dwp.abs().max())
        assert dx_err <= 2.0 ** -7 * float(dxp.float().abs().max()), dx_err
        assert dw_rel < 1e-3, dw_rel
        tk = timing.device_us(lambda: combined_conv1x1_bwd(x, dy, w), 10)
        tm = timing.device_us(lambda: matmul_pair(x, dy, w), 10)
        print(f"n={n} ci={ci} co={co}: kernel {tk:.0f} us, "
              f"matmul pair {tm:.0f} us (dx err {dx_err:.3g}, "
              f"dW rel err {dw_rel:.3g})")


if __name__ == "__main__":
    main()
