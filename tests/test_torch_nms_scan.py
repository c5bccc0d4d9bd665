"""The algorithm of the port's NMS kernel (csrc/nms.cu), emulated on the CPU
and held bit for bit against the JAX package.

The kernel runs only on the card. This file repeats its two phases in numpy,
operation for operation. Phase 1 builds the suppression bitmask as uint64
words, with the IoU rounded as ops/nms.py `iou_matrix` and the kernel's test
that decides most pairs without the division: word c of row i has bit u set
when candidate 64 c + u > i has i's class and IoU > threshold, except on the
diagonal (c = i // 64), where the word is i's column: the ranks u < i of its
tile that remove it. Phase 2 scans word by word: inside a word, rounds from
kept = alive drop each rank that a kept rank removes until nothing changes;
then each kept row is ORed into the later words. The keep masks must equal
the JAX package's Pallas kernel (interpret mode) and `nms_fixed`, as
tests/test_torch_ops.py holds the plain version. The card runs the kernel
against the plain version in test_torch_kernels.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eioku_tpu.models.yolo.postprocess import nms_fixed as jax_nms_fixed
from eioku_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from test_torch_ops import _nms_workload

WORD = 64
NO_CLASS = np.iinfo(np.int32).min  # an invalid column's class in the kernel
THR = 0.45


def _bits(x: int):
    while x:
        yield (x & -x).bit_length() - 1
        x &= x - 1


def _suppresses(inter, uni, thr):
    """The kernel's `suppresses`: a rounded product against thr (1 -+ 2^-21)
    decides, and only pairs in the band between divide."""
    f32 = np.float32
    u = np.maximum(uni, f32(1e-9))
    lo, hi = f32(thr) * f32(1 - 2.0 ** -21), f32(thr) * f32(1 + 2.0 ** -21)
    above, below = inter > u * hi, inter < u * lo
    band = ~above & ~below
    with np.errstate(divide="ignore", invalid="ignore"):
        return above | (band & (inter / u > f32(thr))), band


def emulate_mask(boxes, scores, classes, thr=THR):
    """Phase 1 for one image: mask [W, 64 W] uint64 (word-major, as the
    kernel stores it), validity words [W], and how many same-class pairs
    fell in the division band."""
    k = len(scores)
    words = -(-k // WORD)
    kp = WORD * words
    bx = np.zeros((kp, 4), np.float32)
    bx[:k] = boxes
    valid = np.zeros(kp, bool)
    valid[:k] = scores > 0
    cls = np.full(kp, NO_CLASS, np.int32)
    cls[:k] = classes
    col_cls = np.where(valid, cls, NO_CLASS)
    x1, y1, x2, y2 = bx.T
    area = np.maximum(x2 - x1, np.float32(0)) * np.maximum(y2 - y1, np.float32(0))
    iw = np.maximum(np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None]),
                    np.float32(0))
    ih = np.maximum(np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None]),
                    np.float32(0))
    inter = iw * ih
    uni = (area[:, None] + area[None]) - inter
    sup, band = _suppresses(inter, uni, thr)
    tile = np.arange(kp) // WORD
    tile_has_valid = valid.reshape(words, WORD).any(1)[tile]
    # pairs[i, j]: the kernel's thread for candidate i tests j, a valid
    # candidate of its class
    pairs = valid[:, None] & tile_has_valid[None] & (cls[:, None] == col_cls[None])
    later_tile = tile[None] > tile[:, None]
    same_tile_before = (tile[None] == tile[:, None]) & (np.arange(kp)[None] <
                                                        np.arange(kp)[:, None])
    bits = (pairs & sup & (later_tile | same_tile_before)).reshape(kp, words, WORD)
    weights = np.uint64(1) << np.arange(WORD, dtype=np.uint64)
    mask = (bits.astype(np.uint64) * weights).sum(-1, dtype=np.uint64).T  # [W, kp]
    valid_words = (valid.reshape(words, WORD).astype(np.uint64) * weights).sum(
        -1, dtype=np.uint64)
    upper = np.triu(np.ones((kp, kp), bool), 1)
    return mask, valid_words, int((pairs & upper & band).sum())


def emulate_scan(mask, valid_words, k):
    """Phase 2 for one image: the one-warp greedy scan, word by word."""
    words = len(valid_words)
    removed = [0] * words
    valid = [int(v) for v in valid_words]
    nonzero = [w for w in range(words) if valid[w]]
    last = nonzero[-1] if nonzero else -1
    keep = np.zeros(WORD * words, bool)
    for w in range(last + 1):
        alive = valid[w] & ~removed[w]
        removed_by = [int(d) for d in mask[w, WORD * w:WORD * (w + 1)]]
        kept = alive
        while True:
            settled = sum(1 << t for t in _bits(alive) if not removed_by[t] & kept)
            if settled == kept:
                break
            kept = settled
        for v in range(w + 1, last + 1):
            for t in _bits(kept):
                removed[v] |= int(mask[v, WORD * w + t])
        keep[WORD * w:WORD * (w + 1)] = [(kept >> t) & 1 for t in range(WORD)]
    return keep[:k]


def emulate(boxes, scores, classes, thr=THR):
    """Both phases over a batch: keep [B, K] bool and the band's pair count."""
    keeps, band = [], 0
    for bx, sc, cl in zip(boxes, scores, classes):
        mask, valid_words, n_band = emulate_mask(bx, sc, cl, thr)
        keeps.append(emulate_scan(mask, valid_words, len(sc)))
        band += n_band
    return np.stack(keeps), band


def _assert_equals_jax(boxes, scores, classes):
    got, band = emulate(boxes, scores, classes)
    k = boxes.shape[1]
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    pallas = np.asarray(jax_nms_keep_mask(*args, THR, force_pallas=True))
    fixed = np.asarray(jax.vmap(lambda b, s, c: jax_nms_fixed(b, s, c, THR, k)["valid"])(
        *args))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, fixed)
    assert not (got & (scores <= 0)).any()  # padding is never kept
    return got, band


# the bitmask's word edges (one rank, one short of a word, a word, one past
# it, two words), the main path's K = 256 region, 1024 (object_detection's
# top_k), at 3 classes (dense conflicts) and the main path's 80
@pytest.mark.parametrize("n_classes", [3, 80])
@pytest.mark.parametrize("b,k,pad_from", [(2, 1, None), (2, 63, 50), (2, 64, None),
                                          (2, 65, 60), (2, 128, None), (2, 300, 240),
                                          (1, 1024, 820)])
def test_scan_equals_jax(b, k, pad_from, n_classes):
    _assert_equals_jax(*_nms_workload(b, k, n_classes, seed=k + n_classes, pad_from=pad_from))


def test_all_padding_keeps_nothing():
    boxes, _, classes = _nms_workload(2, 130, 3, seed=1)
    got, _ = _assert_equals_jax(boxes, np.zeros((2, 130), np.float32), classes)
    assert not got.any()


def test_identical_boxes_keep_the_first_of_each_class():
    boxes = np.tile(np.float32([10, 20, 50, 60]), (2, 200, 1))
    scores = np.linspace(1.0, 0.1, 200, dtype=np.float32)[None].repeat(2, 0)
    classes = np.zeros((2, 200), np.int32)
    classes[1] = np.arange(200) % 3
    got, _ = _assert_equals_jax(boxes, scores, classes)
    assert got[0].sum() == 1 and got[1].sum() == 3
    assert got[1, :3].all()


def test_zero_area_and_inverted_boxes():
    # zero-width, zero-height, points and inverted (x2 < x1, y2 < y1) boxes
    # among ordinary ones: their area clamps to 0, so their IoU is 0 and
    # they suppress nothing and are suppressed by nothing
    boxes, scores, classes = _nms_workload(2, 150, 3, seed=9, pad_from=140)
    boxes[:, 0::5, 2] = boxes[:, 0::5, 0]  # zero width
    boxes[:, 1::5, 3] = boxes[:, 1::5, 1]  # zero height
    boxes[:, 2::5] = boxes[:, 2::5][..., [2, 3, 0, 1]]  # inverted
    boxes[:, 3::10, 2:] = boxes[:, 3::10, :2]  # a point
    got, _ = _assert_equals_jax(boxes, scores, classes)
    assert got[:, 2:140:5].all()  # inverted boxes are all kept


def test_iou_at_the_threshold_takes_the_division():
    # A = [0, 0, W, 1] and B = [0, 0, w, 1] overlap in w, so IoU(A, B) =
    # w / ((W + w) - w). For 256 widths W, w lies 4 ulps below to 4 ulps
    # above 0.45 W: every IoU is within a few ulps of the threshold, inside
    # the band where the kernel divides. Each pair has a class of its own
    f32 = np.float32
    n = 256
    big = f32(1) + np.arange(n, dtype=f32) * f32(2.0 ** -8)
    small = big * f32(THR)
    for i, steps in enumerate(np.arange(n) % 9 - 4):
        for _ in range(abs(steps)):
            small[i] = np.nextafter(small[i], f32(np.inf if steps > 0 else 0))
    boxes = np.zeros((1, 2 * n, 4), f32)
    boxes[0, :, 3] = 1
    boxes[0, 0::2, 2], boxes[0, 1::2, 2] = big, small
    scores = np.linspace(1.0, 0.1, 2 * n, dtype=f32)[None]
    classes = (np.arange(2 * n) // 2).astype(np.int32)[None]
    got, band = _assert_equals_jax(boxes, scores, classes)
    assert band == n  # every pair was decided by the IEEE quotient
    second = got[0, 1::2]
    assert second.any() and not second.all()  # both sides of the threshold
