"""The two plain stages of the port's NMS sweep on the CPU:
``nms_mask_words_plain`` (the pairwise tests packed into int64 words as
``nms_sweep_mask_kernel`` packs them) and ``nms_scan_plain`` (the chunked
scan as ``nms_sweep_scan_kernel`` walks it). Their composition equals
``nms_sweep_plain`` and the JAX package's ``_nms_keep`` (vision_ops'
IoU) and ``_nms_mask`` (box_util's IoU, at thresholds >= 0, where the
two IoUs give the same mask) exactly, on score-sorted sets with ties,
zero-width, inverted, NaN and infinite boxes and a keep0 with holes, at
candidate counts around the 64-bit word (1, 63, 64, 65, 130, 200); the
word layout (bit 63, a last partial word, the diagonal block, the zero
words below it) is checked bit by bit."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from paddle_tpu.ops import detection_ops as jdet
from paddle_tpu.ops import vision_ops as jvis
from paddle_tpu_torch.ops import detection_ops as tdet
from paddle_tpu_torch.ops import vision_ops as tvis
from test_torch_vision_ops2 import _nms_sets

COUNTS = (1, 63, 64, 65, 130, 200)
THRESHOLDS = (0.45, 0.0, -0.1)


def _sorted_sets(b, m, seed, holes=0.0):
    """Score-sorted boxes [b, m, 4] and scores [b, m] (numpy, f32) from
    ``_nms_sets``, and keep0 = score > 0 with a share ``holes`` of the
    candidates also dropped (their scores made 0)."""
    boxes, scores = _nms_sets(b, m, seed)
    if holes:
        r = np.random.RandomState(seed + 1)
        scores = np.where(r.uniform(0, 1, scores.shape) < holes, 0.0,
                          scores).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1),
            np.take_along_axis(scores, order, 1))


def _stages(boxes, keep0, thr):
    words = tvis.nms_mask_words_plain(boxes, thr)
    return tvis.nms_scan_plain(words, keep0)


@pytest.mark.parametrize("m", COUNTS)
def test_stages_equal_the_plain_sweep_and_the_jax_sweeps(m):
    """At every count and threshold: the composition equals
    ``nms_sweep_plain`` and the JAX ``_nms_keep`` set by set; at the
    thresholds >= 0 also the JAX ``_nms_mask`` (box_util's IoU) and the
    port's ``_nms_mask``."""
    sb, ss = _sorted_sets(2, m, 40 + m, holes=0.2)
    boxes = torch.from_numpy(sb)
    keep0 = torch.from_numpy(ss > 0)
    rpn_scores = np.where(ss > 0, ss, -1e9).astype(np.float32)
    for thr in THRESHOLDS:
        got = _stages(boxes, keep0, thr)
        assert torch.equal(got, tvis.nms_sweep_plain(boxes, keep0, thr)), thr
        for i in range(2):
            _, want = jvis._nms_keep(jnp.asarray(sb[i]), jnp.asarray(ss[i]),
                                     thr, m)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want),
                                          err_msg=f"_nms_keep at {thr}")
            if thr >= 0:
                want = jdet._nms_mask(jnp.asarray(sb[i]),
                                      jnp.asarray(rpn_scores[i]), thr, 0)
                np.testing.assert_array_equal(
                    got[i].numpy(), np.asarray(want),
                    err_msg=f"_nms_mask at {thr}")
        if thr >= 0:
            assert torch.equal(got, tdet._nms_mask(boxes, keep0, thr))


@settings(max_examples=40, deadline=None)
@given(m=st.sampled_from(COUNTS), thr=st.sampled_from(THRESHOLDS),
       seed=st.integers(0, 10_000), holes=st.sampled_from((0.0, 0.3, 0.9)),
       sets=st.integers(1, 3))
def test_stages_equal_the_plain_sweep_on_drawn_sets(m, thr, seed, holes,
                                                    sets):
    """Drawn sets, thresholds and holes in keep0: the composition equals
    ``nms_sweep_plain``."""
    sb, ss = _sorted_sets(sets, m, seed, holes)
    boxes, keep0 = torch.from_numpy(sb), torch.from_numpy(ss > 0)
    assert torch.equal(_stages(boxes, keep0, thr),
                       tvis.nms_sweep_plain(boxes, keep0, thr))


@pytest.mark.parametrize("m", COUNTS)
def test_words_hold_each_later_candidates_test_in_its_bit(m):
    """Word (i, cb) bit jj is IoU(j, i) > thr for j = 64 cb + jj > i, and
    every other bit is 0: those of j <= i (the diagonal block's lower
    part and the words below it) and those past m in the last word."""
    sb, _ = _sorted_sets(2, m, 7 + m)
    boxes = torch.from_numpy(sb)
    over = (tvis._iou_matrix(boxes) > 0.45).numpy()          # [B, j, i]
    words = tvis.nms_mask_words_plain(boxes, 0.45).numpy()
    w = -(-m // 64)
    assert words.shape == (2, m, w) and words.dtype == np.int64
    bits = (words.view(np.uint64)[..., None]
            >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    bits = bits.reshape(2, m, 64 * w).astype(bool)
    j = np.arange(64 * w)
    want = np.zeros_like(bits)
    want[..., :m] = over.transpose(0, 2, 1)
    want &= j[None, None, :] > np.arange(m)[None, :, None]
    np.testing.assert_array_equal(bits, want)


def test_word_layout_of_equal_boxes():
    """130 equal boxes (every IoU 1): row 0's words are all ones but bit
    0, then all ones (bit 63 set: the word is -1 as an int64), then the
    two bits of the last partial word; row 64's first word, below its
    diagonal block, is 0; row 126's middle word holds bit 63 alone; the
    last row's words are all 0. The scan keeps the first candidate alone,
    or the first of keep0."""
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]]).expand(1, 130, 4)
    words = tvis.nms_mask_words_plain(boxes, 0.5)[0]
    assert words[0].tolist() == [-2, -1, 3]
    assert words[63].tolist() == [0, -1, 3]
    assert words[64].tolist() == [0, -2, 3]
    assert words[126].tolist() == [0, -(1 << 63), 3]
    assert words[127].tolist() == [0, 0, 3]
    assert words[128].tolist() == [0, 0, 2]
    assert words[129].tolist() == [0, 0, 0]
    keep0 = torch.ones(1, 130, dtype=torch.bool)
    want = torch.zeros(1, 130, dtype=torch.bool)
    want[0, 0] = True
    assert torch.equal(tvis.nms_scan_plain(words[None], keep0), want)
    keep0[0, :70] = False
    want = torch.zeros(1, 130, dtype=torch.bool)
    want[0, 70] = True
    assert torch.equal(tvis.nms_scan_plain(words[None], keep0), want)


def test_a_dropped_candidate_suppresses_nothing():
    """Three boxes in a chain (0 overlaps 1, 1 overlaps 2, 0 and 2 apart):
    with candidate 1 out of keep0, 0 and 2 both stay; with it in, 1 goes
    and 2 stays (1 was removed, so it removes nothing)."""
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [5.0, 0.0, 15.0, 10.0],
                           [10.0, 0.0, 20.0, 10.0]]])
    words = tvis.nms_mask_words_plain(boxes, 0.2)
    assert words[0, :, 0].tolist() == [2, 4, 0]
    for k0, want in (([True, False, True], [True, False, True]),
                     ([True, True, True], [True, False, True]),
                     ([False, True, True], [False, True, False])):
        keep0 = torch.tensor([k0])
        assert tvis.nms_scan_plain(words, keep0)[0].tolist() == want


def test_mask_words_on_the_cpu_are_the_plain_words():
    """``nms_mask_words`` on CPU tensors is the plain version; it refuses
    boxes that are not [B, m, 4]."""
    sb, _ = _sorted_sets(2, 65, 3)
    boxes = torch.from_numpy(sb)
    assert torch.equal(tvis.nms_mask_words(boxes, 0.3),
                       tvis.nms_mask_words_plain(boxes, 0.3))
    with pytest.raises(ValueError):
        tvis.nms_mask_words(torch.zeros(4, 4), 0.3)
