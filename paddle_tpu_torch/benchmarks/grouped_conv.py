"""Grouped 3x3 convolution kernel study. The counterpart of the JAX
package's ``benchmarks/grouped_conv_pallas.py``: SE-ResNeXt-50's grouped
``c1`` convolutions (32 groups, stride 1, SAME padding) in NHWC, x
[N, H, W, C] bf16 with grouped weights wg [3, 3, cg, C] bf16 (HWIO; cg =
C / groups input channels a group).

The JAX script expands the weights to block-diagonal 128 x 128 matrices
(``make_blockdiag``) to fill the TPU's matrix unit; that is no part of
the function, so it has no counterpart here: ``grouped_conv`` takes the
grouped weights as they are and launches the hand-written kernel
(``csrc/grouped_conv.cu``) on CUDA tensors, or takes the plain version on
CPU tensors. ``conv_ref`` is the library call it races. No model's op
calls the kernel: ``conv2d`` stays ``F.conv2d``, as the JAX package
leaves it to ``lax.conv_general_dilated``.

    python3 -m paddle_tpu_torch.benchmarks.grouped_conv
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from paddle_tpu_torch import kernels

SOURCE = "grouped_conv"

# Kernel launches made by ``grouped_conv`` (one per call on a CUDA tensor).
launches = 0

GROUPS = 32
# SE-ResNeXt-50's c1 convolutions of stages 0 and 1 at batch 128:
# (tag, N, H, W, C); 4 and 8 channels a group
SHAPES = (("s0", 128, 56, 56, 128), ("s1", 128, 28, 28, 256))


def _check(x, wg, groups):
    fn = "grouped_conv"
    if x.dim() != 4:
        raise ValueError(f"{fn}: x must be [N, H, W, C], got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if groups < 1 or c % groups:
        raise ValueError(f"{fn}: {c} channels do not split into {groups} "
                         f"groups")
    cg = c // groups
    if tuple(wg.shape) != (3, 3, cg, c):
        raise ValueError(f"{fn}: wg is {tuple(wg.shape)}, expected "
                         f"{(3, 3, cg, c)}")
    for name, t in (("x", x), ("wg", wg)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected bfloat16")
    if wg.device != x.device:
        raise ValueError(f"{fn}: wg is on {wg.device}, x on {x.device}")
    return cg


def grouped_conv_plain(x, wg, groups):
    """Nine shifted slices of the zero-padded input times the per-group
    weights (an einsum over the group's input channels), summed in f32,
    rounded to bf16 once."""
    n, h, w, c = x.shape
    cg = c // groups
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = wg.float().reshape(3, 3, cg, groups, cg)  # [ky, kx, in, group, out]
    acc = torch.zeros((n, h, w, groups, cg), dtype=torch.float32,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            xs = xp[:, ky:ky + h, kx:kx + w, :].reshape(n, h, w, groups, cg)
            acc += torch.einsum("nhwgi,igo->nhwgo", xs, wf[ky, kx])
    return acc.reshape(n, h, w, c).to(x.dtype)


def grouped_conv(x, wg, groups=GROUPS):
    """Grouped 3x3 convolution, stride 1, SAME padding, f32 accumulation.

    x [N, H, W, C] bf16, wg [3, 3, C / groups, C] bf16 -> [N, H, W, C]
    bf16. CUDA tensors launch the kernel (contiguous inputs, 4 or 8
    channels a group, C a multiple of 8; any H and W) or raise; CPU
    tensors take the plain version."""
    global launches
    cg = _check(x, wg, groups)
    if not x.is_cuda:
        return grouped_conv_plain(x, wg, groups)
    fn = "grouped_conv"
    n, h, w, c = x.shape
    if cg not in (4, 8) or c % 8 or n > 65535:
        raise NotImplementedError(
            f"{fn}: {cg} channels a group, C={c}, N={n}; the kernel takes 4 "
            f"or 8 channels a group, C a multiple of 8 and N <= 65535")
    for name, t in (("x", x), ("wg", wg)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} strides {t.stride()} are not "
                             f"contiguous")
    y = torch.empty_like(x)
    entry = kernels.function(
        SOURCE, "pt_grouped_conv",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = entry(x.data_ptr(), wg.data_ptr(), y.data_ptr(), n, h, w, c, cg,
               torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(SOURCE, rc, fn)
    launches += 1
    return y


def conv_ref(x, wg, groups=GROUPS):
    """The library's grouped convolution on the same NHWC / HWIO data
    (viewed as NCHW / OIHW, channels last in memory)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), wg.permute(3, 2, 0, 1), None,
                 stride=1, padding=1, groups=groups)
    return y.permute(0, 2, 3, 1)


def make_inputs(n, h, w, c, groups=GROUPS, seed=0, device="cpu"):
    """x ~ 0.5 N(0, 1) and wg ~ N(0, 1) / sqrt(9 cg) in bf16, made on the
    host from ``seed``."""
    cg = c // groups
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((n, h, w, c), generator=gen) * 0.5).to(torch.bfloat16)
    wg = (torch.randn((3, 3, cg, c), generator=gen)
          / (9 * cg) ** 0.5).to(torch.bfloat16)
    return x.to(device), wg.to(device)


def main():
    from paddle_tpu_torch.benchmarks import timing

    device = timing.require_card()
    print(f"card: {timing.card_line()}")
    for tag, n, h, w, c in SHAPES:
        x, wg = make_inputs(n, h, w, c, device=device)
        y_k = grouped_conv(x, wg, GROUPS)
        y_ref = conv_ref(x, wg, GROUPS)
        err = float((y_k.float() - y_ref.float()).abs().max())
        print(f"{tag}: max abs err kernel vs library grouped = {err:.4f}")
        t_ref = timing.device_us(lambda: conv_ref(x, wg, GROUPS), 12)
        t_k = timing.device_us(lambda: grouped_conv(x, wg, GROUPS), 12)
        print(f"{tag}: library grouped {t_ref:8.1f} us | kernel "
              f"{t_k:8.1f} us ({t_ref / t_k:.2f}x)")


if __name__ == "__main__":
    main()
