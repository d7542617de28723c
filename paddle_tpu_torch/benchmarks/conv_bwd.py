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

# Kernel launches made by ``combined_conv1x1_bwd``:
# kernels.launch_counts[SOURCE], one per call on a CUDA tensor (the main
# kernel and its reduction are one launch of the wrapper).

# ResNet-50's expand convolutions at batch 128: (n, ci, co)
SHAPES = ((128 * 56 * 56, 64, 256),
          (128 * 28 * 28, 128, 512),
          (128 * 14 * 14, 256, 1024))

TN = 128            # rows of an n-tile (the kernel's kTN)
CHUNK = 128         # co columns of a streamed dy chunk (kChunk)
_SLICES = (64, 32, 16)   # input channels a slice, widest first
_MAX_ACCUM = 128    # dW^T accumulators a thread keeps in registers


def plan(n: int, ci: int, co: int, sms: int):
    """How the kernel splits the work: ``cs`` input channels a slice (the
    widest of 64, 32, 16 that divides ci and whose dW^T [co_pad, cs] fits
    the 128 accumulator registers a thread of its two warpgroups may
    keep), ``chunks`` 128-column dy chunks a block (co padded to 128, 256,
    512 or 1024), ``co_split`` 2 when co > 512 and ci takes slices of 32
    channels or more: a cluster pair then splits co (512 each), so a
    slice can be twice as wide and half as many slices re-read dy (else
    1; the 16-channel slices keep all of co in one block), and
    ``parts`` n-ranges of ``tiles_per_part`` 128-row n-tiles: one block
    an SM in all (the kernel takes up to 225 KB of shared memory), the
    blocks of one n-range side by side."""
    chunks = 1
    while chunks * CHUNK < co:
        chunks *= 2
    co_split = 1
    if chunks == 8 and ci % 32 == 0:
        chunks, co_split = 4, 2
    cs = max(c for c in _SLICES
             if ci % c == 0 and chunks * c // 2 <= _MAX_ACCUM)
    ntiles = -(-n // TN)
    blocks = ci // cs * co_split  # blocks of one n-range
    parts = max(1, min(ntiles, sms // blocks))
    tiles_per_part = -(-ntiles // parts)
    parts = -(-ntiles // tiles_per_part)
    return cs, chunks, co_split, parts, tiles_per_part


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
    cs, chunks, co_split, parts, tiles_per_part = plan(n, ci, co, sms)
    dx = torch.empty_like(x)
    dw = torch.empty((ci, co), dtype=torch.float32, device=x.device)
    partial = torch.empty((parts, ci, co), dtype=torch.float32,
                          device=x.device)
    entry = kernels.function(
        SOURCE, "pt_conv1x1_bwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    rc = entry(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
               dw.data_ptr(), partial.data_ptr(), n, ci, co, cs, chunks,
               co_split, parts, tiles_per_part,
               torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(SOURCE, rc, fn)
    kernels.count(SOURCE)
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
