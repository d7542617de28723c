"""Grouped 3x3 convolution kernel study. The counterpart of the JAX
package's ``benchmarks/grouped_conv_pallas.py``: SE-ResNeXt-50's grouped
``c1`` convolutions (32 groups, stride 1, SAME padding) in NHWC, x
[N, H, W, C] bf16 with grouped weights wg [3, 3, cg, C] bf16 (HWIO; cg =
C / groups input channels a group).

The JAX script expands the weights to block-diagonal 128 x 128 matrices
(``make_blockdiag``) to fill the TPU's matrix unit. ``grouped_conv``
takes the grouped weights as they are and launches the hand-written
tensor-core kernel (``csrc/grouped_conv.cu``) on CUDA tensors, which
builds its own 16 x 16 block-diagonal tiles, or takes the plain version
on CPU tensors. ``plan`` gives the kernel's tile geometry. ``conv_ref``
is the library call it races. No model's op calls the kernel: ``conv2d``
stays ``F.conv2d``, as the JAX package leaves it to
``lax.conv_general_dilated``.

    python3 -m paddle_tpu_torch.benchmarks.grouped_conv
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch import kernels

SOURCE = "grouped_conv"

# Kernel launches made by ``grouped_conv``: kernels.launch_counts[SOURCE],
# one per call on a CUDA tensor.

GROUPS = 32
# SE-ResNeXt-50's stride-1 c1 convolutions of its four stages at batch
# 128: (tag, N, H, W, C); 4, 8, 16 and 32 channels a group
SHAPES = (("s0", 128, 56, 56, 128), ("s1", 128, 28, 28, 256),
          ("s2", 128, 14, 14, 512), ("s3", 128, 7, 7, 1024))

# The kernel's fixed geometry (csrc/grouped_conv.cu): 8 warps a block; a
# warp stages one 16 x 16 output tile at a time (16 pixel rows of 48
# bytes); a ring of 2 to 4 input tiles (the next bands in flight).
THREADS = 256
STRIP_ROWS = 4              # output rows of a warp's strip (of 16 columns)
MAX_STAGES = 4
STAGE_BYTES = (THREADS // 32) * 16 * 48
SMEM_MAX = 232448           # shared memory a block may take on an H100
SMEM_RESERVED = 1024        # the system's share of each resident block
BAND_PIXELS = 256           # a band's output pixels, at most (one row at least)
# input bytes a block keeps in flight, at least, where its ring allows
IN_FLIGHT = 24576


class Plan(NamedTuple):
    """How ``csrc/grouped_conv.cu`` splits a convolution: blocks of
    ``chunks`` (grid y) compute ``co`` output channels each from an input
    window of ``cw`` channels; every block walks (image, band) items,
    ``rows`` image rows a band (``bands`` an image), from item blockIdx.x
    in steps of ``blocks`` (grid x). ``cws`` input channels feed a
    16-channel output slice (its K is 9 cws); ``smem`` bytes of shared
    memory a block; ``stages`` input tiles in its ring (``stages`` - 1 in
    flight while one computes)."""

    rows: int
    bands: int
    co: int
    cw: int
    cws: int
    chunks: int
    blocks: int
    smem: int
    stages: int


def geometry(cg):
    """(cws, co, cw) for cg channels a group. A 16-channel output slice
    reads cws = max(16, cg) input channels: for cg < 16 its own 16
    channels (16 / cg groups: the kernel's B tiles are block-diagonal),
    else its group's cg channels (dense). A block computes co = 64 output
    channels (fewer where a group is wider than 32, so its copy of the
    weights, 9 cg co bf16, stays at 36 KB) from a window of cw = max(co,
    cws) channels: its own co, or its group's."""
    cws = max(16, cg)
    co = 64 if cws <= 32 else 2048 // cws
    return cws, co, max(co, cws)


def tile_bytes(rows, w, cg):
    """An input tile: (rows + 2) x (w + 2) cells, each the window's cw
    bf16 channels padded by 16 bytes."""
    return (rows + 2) * (w + 2) * (2 * geometry(cg)[2] + 16)


def smem_bytes(rows, w, cg, stages):
    """Shared memory of a block: its copy of the weights (9 cg rows of co
    bf16, padded by 16 bytes), the warps' output staging, and ``stages``
    input tiles."""
    _, co, _ = geometry(cg)
    return (9 * cg * (2 * co + 16) + STAGE_BYTES
            + stages * tile_bytes(rows, w, cg))


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, cg: int, sms: int) -> Plan:
    """The kernel's split of [n, h, w, c] with cg channels a group on a
    card of ``sms`` SMs: the most rows a band (whole image rows, up to
    ``BAND_PIXELS`` pixels) for which two blocks of two stages fit an SM,
    then spread evenly over that many bands (no short last band); the
    fewest stages (up to ``MAX_STAGES``) that keep ``IN_FLIGHT``
    bytes of input in flight while still fitting; and enough persistent
    blocks of each channel chunk for two an SM in all (at least one a
    chunk)."""
    _, co, cw = geometry(cg)
    two = SMEM_MAX // 2 - SMEM_RESERVED
    rows = 1
    while (rows < h and (rows + 1) * w <= BAND_PIXELS
           and smem_bytes(rows + 1, w, cg, 2) <= two):
        rows += 1
    rows = -(-h // -(-h // rows))
    stages = 2
    while (stages < MAX_STAGES
           and (stages - 1) * tile_bytes(rows, w, cg) < IN_FLIGHT
           and smem_bytes(rows, w, cg, stages + 1) <= two):
        stages += 1
    smem = smem_bytes(rows, w, cg, stages)
    bands = -(-h // rows)
    chunks = -(-c // co)
    per_sm = 2 if smem <= two else 1
    blocks = max(1, min(n * bands, sms * per_sm // chunks))
    return Plan(rows, bands, co, cw, geometry(cg)[0], chunks, blocks, smem,
                stages)


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


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def grouped_conv(x, wg, groups=GROUPS):
    """Grouped 3x3 convolution, stride 1, SAME padding, f32 accumulation.

    x [N, H, W, C] bf16, wg [3, 3, C / groups, C] bf16 -> [N, H, W, C]
    bf16. CUDA tensors launch the kernel (contiguous inputs, cg = C /
    groups dividing 128, C a multiple of 8; any N, H and W whose band
    fits shared memory) or raise; CPU tensors take the plain version."""
    cg = _check(x, wg, groups)
    if not x.is_cuda:
        return grouped_conv_plain(x, wg, groups)
    fn = "grouped_conv"
    n, h, w, c = x.shape
    if 128 % cg or c % 8:
        raise NotImplementedError(
            f"{fn}: {cg} channels a group, C={c}; the kernel takes a cg "
            f"that divides 128 and C a multiple of 8")
    for name, t in (("x", x), ("wg", wg)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} strides {t.stride()} are not "
                             f"contiguous")
    p = plan(n, h, w, c, cg, _sm_count(x.device.index))
    if p.smem > SMEM_MAX:
        raise NotImplementedError(
            f"{fn}: W={w} needs {p.smem} bytes of shared memory a block "
            f"(at most {SMEM_MAX})")
    y = torch.empty_like(x)
    entry = kernels.function(
        SOURCE, "pt_grouped_conv",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    rc = entry(x.data_ptr(), wg.data_ptr(), y.data_ptr(), n, h, w, c, cg,
               p.rows, p.blocks, p.stages,
               torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(SOURCE, rc, fn)
    kernels.count(SOURCE)
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
