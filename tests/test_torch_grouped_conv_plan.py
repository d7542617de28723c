"""The tensor-core grouped 3x3 convolution (csrc/grouped_conv.cu) and the
dropout-mask dump (csrc/dropout_mask.cu) as the CPU can hold them: the
kernels run only on the card (tests/test_torch_cuda.py), so here

- ``grouped_conv.plan``'s bands x channel chunks cover every output pixel
  and channel once, and each block's input tile (its band with a one-cell
  halo, its channel window) holds every input its taps read;
- a PyTorch model of the kernel's arithmetic (bf16 inputs; per 16-channel
  output slice and tap, a B tile built from wg as the kernel packs it:
  block-diagonal for cg < 16, dense over the group for cg >= 16; f32
  sums; one bf16 rounding) agrees with ``grouped_conv_plain`` and with the
  JAX package's ``grouped_conv_pallas`` (in interpret mode) within one
  bf16 ulp (2^-7) of the largest output: all sum the same bf16 products
  in f32, in other orders, and round once;
- the kernel's loads of its B fragments (ldmatrix.trans from its copy of
  the weights, masked to the block diagonal) give each lane what
  mma.sync reads of those B tiles;
- the dump kernel's split of each (b, q, h) run into a scalar head,
  16-byte vectors and a scalar tail covers [b, tq, h, tk] once."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch.benchmarks import grouped_conv as gc
from paddle_tpu_torch.parallel import flash_attention as fa
from tests.test_torch_bench_kernels import (  # noqa: F401 (a fixture)
    _bf, _close_bf16, _load_script, _tbf, interpret_pallas)

ULP = 2.0 ** -7

# (n, h, w, c, cg): SE-ResNeXt-50's four stride-1 c1 shapes at batch 128,
# and ragged ones
_PLAN_SHAPES = [
    (128, 56, 56, 128, 4), (128, 28, 28, 256, 8), (128, 14, 14, 512, 16),
    (128, 7, 7, 1024, 32),
    (3, 13, 17, 96, 8), (2, 5, 30, 64, 4), (1, 1, 1, 8, 4),
    (2, 30, 5, 96, 16), (4, 17, 13, 64, 32), (1, 1, 30, 8, 8),
    (2, 5, 13, 256, 64), (1, 13, 1, 256, 128), (2, 30, 30, 8, 2),
    (1, 17, 5, 96, 1),
]


def _chunk(p, c, k):
    """(first output channel, outputs, window start, window channels) of
    channel chunk k, as the kernel derives them."""
    c0 = k * p.co
    w0 = c0 // p.cw * p.cw
    return c0, min(p.co, c - c0), w0, min(p.cw, c - w0)


def _slice_window(p, cg, cs):
    """The first input channel of the window of the 16-channel output
    slice starting at channel cs: its own channels for cg < 16, else its
    group's."""
    return cs if p.cws == 16 else cs // cg * cg


@pytest.mark.parametrize("n,h,w,c,cg", _PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_plan_covers_every_output_once_and_its_inputs(n, h, w, c, cg, sms):
    p = gc.plan(n, h, w, c, cg, sms)
    assert p.cws == max(16, cg) and p.co % 16 == 0
    assert p.cw % p.co == 0 and p.cw % p.cws == 0
    # a block's copy of its weights (9 cg co bf16) at 36 KB or less
    assert 9 * cg * p.co * 2 <= 36864
    assert 1 <= p.rows <= h and p.bands == -(-h // p.rows)
    # rows spread evenly over the bands: the last band is short of the
    # others by fewer rows than there are bands
    last = h - (p.bands - 1) * p.rows
    assert 0 < last and p.rows - last < p.bands
    assert p.rows == 1 or p.rows * w <= gc.BAND_PIXELS
    assert p.smem == gc.smem_bytes(p.rows, w, cg, p.stages) <= gc.SMEM_MAX
    assert p.chunks == -(-c // p.co) and 2 <= p.stages <= gc.MAX_STAGES
    # more stages only where fewer keep too few bytes in flight
    assert p.stages == 2 or ((p.stages - 2) * gc.tile_bytes(p.rows, w, cg)
                             < gc.IN_FLIGHT)
    assert 1 <= p.blocks <= n * p.bands
    # two blocks an SM in all (one where a band's tile is too wide)
    per_sm = 2 if p.smem <= gc.SMEM_MAX // 2 - gc.SMEM_RESERVED else 1
    assert p.blocks * p.chunks <= max(per_sm * sms, p.chunks)

    out = np.zeros((h, c), np.int64)   # (output row, channel): images alike
    slices = p.co // 16
    wps = gc.THREADS // 32 // slices    # warps of a slice
    for k in range(p.chunks):
        c0, co, w0, cwv = _chunk(p, c, k)
        assert co > 0 and cwv > 0 and w0 <= c0 and c0 + co <= w0 + p.cw
        # every output channel's group lies in its slice's window, which
        # lies in the tile's real channels
        for oc in range(c0, c0 + co):
            ws = _slice_window(p, cg, c0 + (oc - c0) // 16 * 16)
            g0 = oc // cg * cg
            assert w0 <= ws and ws + p.cws <= w0 + p.cw
            assert ws <= g0 and g0 + cg <= min(ws + p.cws, w0 + cwv)
        for band in range(p.bands):
            y0 = band * p.rows
            rh = min(p.rows, h - y0)
            out[y0:y0 + rh, c0:c0 + co] += 1
            # the tile: image rows y0 - 1 .. y0 + rows and columns -1 .. w
            # (cells outside the image are zeros); the taps of the band's
            # outputs read rows y0 - 1 .. y0 + rh, columns -1 .. w
            held = np.zeros((h + 2, w + 2), bool)
            held[y0:y0 + p.rows + 2, :] = True
            need = np.zeros((h + 2, w + 2), bool)
            for ky in range(3):
                for kx in range(3):
                    need[y0 + ky:y0 + ky + rh, kx:kx + w] = True
            assert not (need & ~held).any()
            # the slice's warps take its strips (up to STRIP_ROWS rows of
            # a 16-column segment) once, and the strips cover the band
            nseg = -(-w // 16)
            units = nseg * -(-rh // gc.STRIP_ROWS)
            taken = np.zeros((rh, nseg * 16), np.int64)
            for j in range(wps):
                for u in range(j, units, wps):
                    xs, r0 = u % nseg, u // nseg * gc.STRIP_ROWS
                    nr = min(gc.STRIP_ROWS, rh - r0)
                    assert nr > 0
                    taken[r0:r0 + nr, xs * 16:xs * 16 + 16] += 1
            assert (taken == 1).all()
    assert (out == 1).all()
    # every (image, band) item is one block's: item i goes to block i %
    # blocks, which walks i, i + blocks, ...
    walked = np.zeros(n * p.bands, np.int64)
    for blk in range(p.blocks):
        walked[blk::p.blocks] += 1
    assert (walked == 1).all()


def _b_tile(wg, c, cg, p, cs):
    """[9, cws, 16] f32: the B tiles of the 16-channel output slice at cs,
    as the kernel packs them: B[t, k, j] = wg[t, ci % cg, co] for input ci
    = window start + k and output co = cs + j of the same group, zeros
    off the groups and past C."""
    ws = _slice_window(p, cg, cs)
    wf = wg.float().reshape(9, cg, c)
    b = torch.zeros(9, p.cws, 16)
    for k in range(p.cws):
        ci = ws + k
        for j in range(16):
            co = cs + j
            if co < c and ci < c and ci // cg == co // cg:
                b[:, k, j] = wf[:, ci % cg, co]
    return b


def _model(x, wg, groups):
    """The kernel's arithmetic: per chunk and 16-channel slice, the nine
    taps' [pixels, cws] windows of the zero-padded input times the
    slice's B tiles, summed in f32, rounded to bf16 once."""
    n, h, w, c = x.shape
    cg = c // groups
    p = gc.plan(n, h, w, c, cg, 132)
    # the tiles: a one-cell halo of zeros, channels past C zeros
    xp = F.pad(x.float(), (0, p.cw, 1, 1, 1, 1))
    y = torch.zeros(n, h, w, c)
    for k in range(p.chunks):
        c0, co, _, _ = _chunk(p, c, k)
        for cs in range(c0, c0 + co, 16):
            ws = _slice_window(p, cg, cs)
            b = _b_tile(wg, c, cg, p, cs)
            acc = torch.zeros(n, h, w, 16)
            for t in range(9):
                ky, kx = divmod(t, 3)
                acc += xp[:, ky:ky + h, kx:kx + w, ws:ws + p.cws] @ b[t]
            y[..., cs:min(cs + 16, c)] = acc[..., :min(16, c - cs)]
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("n,h,w,c,cg", [
    (2, 5, 7, 128, 1), (2, 5, 7, 128, 2), (2, 6, 9, 128, 4),
    (1, 9, 6, 128, 8), (2, 5, 7, 128, 16), (2, 4, 5, 128, 32),
    (1, 5, 7, 128, 64), (1, 4, 5, 256, 128),
    # ragged: H, W of 1, 5, 13, 17, 30; C = 8, 64, 96
    (3, 13, 17, 96, 8), (2, 5, 30, 64, 4), (1, 1, 1, 8, 4),
    (1, 17, 5, 96, 16), (2, 1, 13, 64, 32),
])
def test_model_of_the_kernel_matches_the_plain_version(n, h, w, c, cg):
    x, wg = gc.make_inputs(n, h, w, c, groups=c // cg, seed=3)
    got = _model(x, wg, c // cg)
    ref = gc.grouped_conv_plain(x, wg, c // cg)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max() <= \
        ULP * ref.float().abs().max()


@pytest.mark.parametrize("cg,c", [(1, 128), (2, 128), (4, 128), (8, 128),
                                  (16, 128), (32, 128), (64, 128),
                                  (128, 256)])
def test_model_of_the_kernel_matches_pallas(interpret_pallas, cg, c):
    jmod = _load_script("grouped_conv_pallas")
    n, h, w = 1, 5, 6
    r = np.random.RandomState(cg)
    x = r.randn(n, h, w, c) * 0.5
    wg = r.randn(3, 3, cg, c) / np.sqrt(9 * cg)
    got = _model(_tbf(x), _tbf(wg), c // cg)
    y_pl = jmod.grouped_conv_pallas(_bf(x), jmod.make_blockdiag(_bf(wg), c,
                                                                cg))
    _close_bf16(got, y_pl)


@pytest.mark.parametrize("cg", [1, 2, 4, 8])
def test_b_tiles_are_zero_off_their_groups(cg):
    c = 64
    _, wg = gc.make_inputs(1, 1, 1, c, groups=c // cg, seed=5)
    p = gc.plan(1, 1, 1, c, cg, 132)
    for cs in range(0, c, 16):
        b = _b_tile(wg, c, cg, p, cs)
        assert b.shape == (9, 16, 16)
        same = (torch.arange(16)[:, None] // cg
                == torch.arange(16)[None, :] // cg)
        assert (b[:, ~same] == 0).all()
        # on the diagonal blocks, wg as it is
        wf = wg.float().reshape(9, cg, c)
        for j in range(16):
            g0 = j // cg * cg
            assert torch.equal(b[:, g0:g0 + cg, j], wf[:, :, cs + j])


def _ldmatrix_trans(rows):
    """ldmatrix .trans of one 8 x 8 bf16 matrix whose row i is ``rows[i]``
    (8 values): lane 4 g + t receives M[2 t][g], M[2 t + 1][g]."""
    return [(rows[2 * (lane % 4)][lane // 4],
             rows[2 * (lane % 4) + 1][lane // 4]) for lane in range(32)]


def _kernel_b_fragments(wg, c, cg, p, c0, s, tap, kk):
    """The B registers a warp of slice s holds for (tap, k-step kk), as
    csrc/grouped_conv.cu loads them: ldmatrix.trans from the block's copy
    of its chunk's weights (row (tap, i) = wg[tap, i, c0 .. c0 + co),
    zeros past C), row k of a matrix from copy row (tap, k % cg) (k within
    the k-step) and the slice's columns; at cg < 16 each value kept where
    input k and output n share a group. A list of 32 lanes of register
    (lo, hi) pairs: 2 registers at cg <= 8, else 4."""
    copy = torch.zeros(9, cg, p.co)
    cols = min(p.co, c - c0)
    copy[:, :, :cols] = wg.float().reshape(9, cg, c)[:, :, c0:c0 + cols]
    k8 = cg <= 8
    # (k rows, n columns) of each matrix: x2 at cg <= 8 (one per channel
    # half), x4 at cg >= 16 (k halves, then n halves)
    mats = ([(8 * h, 8 * h) for h in range(2)] if k8 else
            [(8 * (j & 1), 8 * (j >> 1)) for j in range(4)])
    regs = []
    for k0, n0 in mats:
        rows = [[float(copy[tap, (kk * 16 + k0 + i) % cg, 16 * s + n0 + j])
                 for j in range(8)] for i in range(8)]
        frag = _ldmatrix_trans(rows)
        if cg < 16:
            frag = [tuple(v if (2 * (lane % 4) + hh) // cg
                          == (lane // 4) // cg else 0.0
                          for hh, v in enumerate(pair))
                    for lane, pair in enumerate(frag)]
        regs.append(frag)
    return [[regs[r][lane] for r in range(len(regs))] for lane in range(32)]


def _mma_b_fragments(b, kk, k8):
    """The B fragments mma.sync reads from the slice's B tiles b [9 taps,
    cws, 16] for one tap (b[tap]) and k-step kk: m16n8k8, register h of
    lane 4 g + t holds (k, n) = (8 h + 2 t, 8 h + g), (8 h + 2 t + 1, 8 h +
    g); m16n8k16, register r holds k = 16 kk + 2 t + 8 (r % 2) (and + 1), n
    = g + 8 (r / 2)."""
    out = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        if k8:
            out.append([(float(b[8 * h + 2 * t, 8 * h + g]),
                         float(b[8 * h + 2 * t + 1, 8 * h + g]))
                        for h in range(2)])
        else:
            k = 16 * kk + 2 * t
            out.append([(float(b[k + 8 * (r & 1), g + 8 * (r >> 1)]),
                         float(b[k + 8 * (r & 1) + 1, g + 8 * (r >> 1)]))
                        for r in range(4)])
    return out


@pytest.mark.parametrize("cg,c", [(1, 64), (2, 64), (4, 128), (8, 96),
                                  (16, 128), (32, 128), (64, 128),
                                  (128, 256)])
def test_b_fragments_as_the_kernel_loads_them(cg, c):
    """The kernel's ldmatrix.trans addressing and block-diagonal mask give
    each lane the B tile values mma.sync expects, for every slice, tap and
    k-step of the first and the last chunk (ragged at C = 96)."""
    _, wg = gc.make_inputs(1, 1, 1, c, groups=c // cg, seed=7)
    p = gc.plan(1, 1, 1, c, cg, 132)
    for k in sorted({0, p.chunks - 1}):
        c0, co, _, _ = _chunk(p, c, k)
        for s in range(-(-co // 16)):
            b = _b_tile(wg, c, cg, p, c0 + 16 * s)
            for tap in range(9):
                for kk in range(p.cws // 16):
                    assert (_kernel_b_fragments(wg, c, cg, p, c0, s, tap, kk)
                            == _mma_b_fragments(b[tap], kk, cg <= 8)), (
                                cg, k, s, tap, kk)


@pytest.mark.parametrize("tk", [1, 3, 77, 256])
@pytest.mark.parametrize("h", [1, 5, 8])
def test_mask_dump_runs_cover_the_mask_once(tk, h):
    b, tq = 2, 3
    seen = np.zeros(b * tq * h * tk, np.int64)
    for bb in range(b):
        for q in range(tq):           # one block a (b, q) row
            for hh in range(h):       # a warp a run
                start = ((bb * tq + q) * h + hh) * tk
                head, nvec, tail = fa.mask_run_split(start, tk)
                assert 0 <= head < 4 and 0 <= tail < 4 and nvec >= 0
                seen[start:start + head] += 1
                for v in range(nvec):
                    at = start + head + 4 * v
                    assert at % 4 == 0          # a 16-byte store
                    seen[at:at + 4] += 1
                end = start + head + 4 * nvec
                assert end + tail == start + tk
                seen[end:end + tail] += 1
    assert (seen == 1).all()
