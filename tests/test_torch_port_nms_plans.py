"""The arithmetic of the NMS kernels in csrc/nms.cu, written as small numpy
mirrors of the kernels and held against the port's twins and the JAX
package on the CPU.

* The axis-aligned mask's division-free test (`exact_over`, after the host's
  `threshold_test`, mirrored by `threshold_plan`): inter > mid * union in
  double, or == with the tie flag, equals `float32(inter) / float32(union) > float32(t)` on 10^6
  random pairs in each decade from 1e-6 to 1e6, on pairs whose quotient
  lies next to mid (the float32 pairs nearest it, and exact ties where mid
  has few bits: subnormal thresholds), and at the rule's level on
  quotients mid and one double ulp either side; for t in 0, 0.3, 0.5, 0.6,
  0.7, 1.0.  A mirror of the tiled mask (`nms_mask_kernel`: the upper
  triangle of 64 x 64 tiles without empty blocks, two threads a row, each
  every other column) gives the words of `pairwise_iou(...) > t` bit for
  bit.
* The sort kernel's keys (`desc_key`, `nms_sort_kernel`): the score's
  order bits above the lane; each of a problem's 8 blocks sorts its chunk
  by the bitonic network whose comparators all put the smaller key first,
  and a key's place is the count of keys below it in all chunks.  That
  gives `_sort_lanes`'s order, boxes and validity on ties, +-0.0, NaN,
  -1e30 and -6e29 scores and all-invalid problems.
* The rotated mask's intersection (`clip_stage`, `rot_intersection`: a
  Sutherland-Hodgman clip in a fixed number of slots, 4 -> 8, selects
  only) within 2e-5 of JAX on row-centered pairs, 5e-4 of JAX across the
  raster (JAX's own error there, F4), 5e-5 of the twin, and 1e-6 of the
  float64 oracle on the edge cases; its bounding-circle early out
  (`circles_apart`) skips no pair whose twin IoU is above 0, on the random,
  dense and touching-corner sets.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.ops.rotated_iou import (  # noqa: E402
    rotated_iou_matrix as j_riou,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (  # noqa: E402
    rotated_bev_intersection,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import (  # noqa: E402
    NEG_INF,
    _sort_lanes,
    nms_plain,
    pairwise_iou,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import (  # noqa: E402
    rotated_iou_matrix_plain,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

f32, f64 = np.float32, np.float64
THRESHOLDS = (0.0, 0.3, 0.5, 0.6, 0.7, 1.0)


# ------------------------------------------------------------ K1: the test

def threshold_plan(iou_threshold):
    """csrc/nms.cu `threshold_test` for t = float32(iou_threshold) (the twin
    compares its float32 IoU with the threshold in float32).

    With s the float32 after t and mid = (t + s) / 2 (exact in double),
    RN(q) > t exactly when q > mid, or q == mid and s has an even
    significand; with float32 inter and union > 0, q > mid is
    inter > mid * union in double, the product exact (25 x 24 bits).
    Returns (mid, tie, zero_over): mid, whether q == mid counts, and the
    answer when union <= 0 (IoU 0): 0 > t."""
    t = f32(iou_threshold)
    s = np.nextafter(t, f32(np.inf))
    return (float(t) + float(s)) / 2, int(s.view(np.uint32)) & 1 == 0, bool(f32(0) > t)


def over_mirror(inter, uni, plan):
    """csrc/nms.cu `exact_over` after inter and union (float32 arrays): the
    test in double."""
    mid, tie, zero_over = plan
    lhs = inter.astype(f64)
    rhs = mid * uni.astype(f64)
    return np.where(uni > 0, (lhs > rhs) | (tie & (lhs == rhs)), zero_over)


def over_divided(inter, uni, t):
    """The twin's test: the float32 IoU (0 where union <= 0) > float32(t)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(uni > 0, inter / uni, f32(0))
    return q > f32(t)


def nudge(x, ulps):
    """x moved by `ulps` float32 steps (x >= 0), not below 0."""
    bits = x.astype(f32).view(np.int32).astype(np.int64) + ulps
    return np.maximum(bits, 0).astype(np.int32).view(f32)


def decade_pairs(rng, k, count, t):
    """count pairs with union in [1e k, 1e k+1): a third with IoU uniform
    in [0, 1.2), a third within a few ulps of t * union, a third with the
    intersection in the same decade."""
    third = count // 3
    uni = (10.0 ** rng.uniform(k, k + 1, count)).astype(f32)
    inter = np.empty(count, f32)
    inter[:third] = (uni[:third].astype(f64) * rng.uniform(0, 1.2, third)).astype(f32)
    near = (uni[third:2 * third].astype(f64) * t).astype(f32)
    inter[third:2 * third] = nudge(near, rng.randint(-3, 4, third))
    inter[2 * third:] = (10.0 ** rng.uniform(k, k + 1, count - 2 * third)).astype(f32)
    return inter, uni


@pytest.mark.parametrize("t", THRESHOLDS)
def test_division_free_test_on_random_pairs(t):
    rng = np.random.RandomState(int(t * 10) + 1)
    plan = threshold_plan(t)
    for k in range(-6, 6):
        inter, uni = decade_pairs(rng, k, 1_000_000, t)
        want = over_divided(inter, uni, t)
        got = over_mirror(inter, uni, plan)
        assert np.array_equal(got, want), (k, int((got != want).sum()))
        assert 0 < int(want.sum()) < len(want)  # both answers occur
    # unions <= 0 and zero intersections
    z = np.array([0, 0, 1, 0, -1], f32), np.array([0, -1, -1, 5, 2], f32)
    assert np.array_equal(over_mirror(*z, plan), over_divided(*z, t))


@pytest.mark.parametrize("t", THRESHOLDS)
def test_division_free_test_next_to_mid(t):
    """The float32 pairs whose quotients lie nearest mid on either side,
    and the rule itself on quotients mid and one double ulp either side."""
    rng = np.random.RandomState(11)
    plan = threshold_plan(t)
    mid = plan[0]
    uni = (10.0 ** rng.uniform(-6, 6, 200_000)).astype(f32)
    base = (mid * uni.astype(f64)).astype(f32)
    for ulps in (-2, -1, 0, 1, 2):
        inter = nudge(base, ulps)
        assert np.array_equal(over_mirror(inter, uni, plan), over_divided(inter, uni, t)), ulps
    q = np.array([np.nextafter(mid, -np.inf), mid, np.nextafter(mid, np.inf)])
    rule = (q > mid) | (plan[1] & (q == mid))
    assert np.array_equal(rule, q.astype(f32) > f32(t))
    assert list(rule) == [False, plan[1], True]


@pytest.mark.parametrize("k", [0, 1, 2, 5, 100, 2 ** 20])
def test_division_free_test_on_exact_ties(k):
    """A subnormal threshold t = k * 2^-149: mid = (2k + 1) * 2^-150 has few
    bits, so inter / union == mid exactly for union = 2^j: the tie goes to
    the even neighbour, as RN does."""
    t = f32(k * 2.0 ** -149)
    plan = threshold_plan(float(t))
    assert plan[0] == (2 * k + 1) * 2.0 ** -150
    j = np.arange(1, 120)
    uni = (2.0 ** j).astype(f32)
    inter = ((2 * k + 1) * 2.0 ** (j - 150)).astype(f32)
    assert np.array_equal(inter.astype(f64) / uni.astype(f64), np.full(len(j), plan[0]))
    for ulps in (-1, 0, 1):
        x = nudge(inter, ulps)
        assert np.array_equal(over_mirror(x, uni, plan), over_divided(x, uni, float(t))), ulps


def upper_tile(t, c):
    """csrc/nms.cu `upper_tile`: float32 square root, then the fix-ups."""
    h = f32(c + 0.5)
    r = int(h - np.sqrt(max(h * h - f32(2 * t), f32(0)), dtype=f32))
    r = min(max(r, 0), c - 1)
    while r > 0 and r * c - r * (r - 1) // 2 > t:
        r -= 1
    while r + 1 < c and (r + 1) * c - (r + 1) * r // 2 <= t:
        r += 1
    return r, r + t - (r * c - r * (r - 1) // 2)


def test_upper_tiles_cover_the_triangle_once():
    for c in list(range(1, 70)) + [94, 188, 313, 434]:
        tiles = [upper_tile(t, c) for t in range(c * (c + 1) // 2)]
        assert tiles == [(r, q) for r in range(c) for q in range(r, c)], c


def mask_words_mirror(boxes, plan):
    """The words `nms_mask_kernel` writes for (G, N, 4) score-sorted boxes:
    {(g, row, column block): word} over the upper triangle of tiles.  In a
    tile, thread (r, q) of Q = 2 (`kRowThreads`) tests row r against
    columns q, q + Q, ... (float32 op for op as the kernel), packs bit j Q
    for column j Q + q, shifts by q and keeps the live columns; the row's Q
    words are OR-ed."""
    g, n, _ = boxes.shape
    c = (n + 63) // 64
    q_count = 2
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    words = {}
    for p in range(g):
        for t in range(c * (c + 1) // 2):
            rb, cb = upper_tile(t, c)
            col_size = min(n - cb * 64, 64)
            cols = np.zeros((64, 4), f32)
            cols[:col_size] = boxes[p, cb * 64:cb * 64 + col_size]
            col_area = (cols[:, 2] - cols[:, 0]) * (cols[:, 3] - cols[:, 1])
            for r in range(min(n - rb * 64, 64)):
                a, area_a = boxes[p, rb * 64 + r], area[p, rb * 64 + r]
                live = (1 << col_size) - 1
                if rb == cb:
                    live &= ~((1 << (r + 1)) - 1)
                word = 0
                for q in range(q_count):
                    b = cols[q::q_count]
                    iw = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), f32(0))
                    ih = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), f32(0))
                    inter = iw * ih
                    uni = (area_a + col_area[q::q_count]) - inter
                    over = over_mirror(inter, uni, plan)
                    packed = sum(1 << (int(j) * q_count) for j in np.nonzero(over)[0])
                    word |= (packed << q) & live
                words[(p, rb * 64 + r, cb)] = word
    return words


@pytest.mark.parametrize("t,g,n", [(0.0, 4, 150), (0.5, 4, 150), (0.7, 4, 600)])
def test_mask_mirror_equals_the_twin_words(t, g, n):
    """Partial tiles at 150 lanes (3 row blocks) and 600 (10)."""
    rng = np.random.RandomState(int(t * 10) + 20)
    boxes, _, _ = chip_smoke.nms_problems(rng, g, n)
    boxes[0, :40] = chip_smoke.near_mid_pairs(rng, t, 20).reshape(40, 4)
    plan = threshold_plan(t)
    words = mask_words_mirror(boxes, plan)
    over = (pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)) > t).numpy()
    for (p, i, cb), word in words.items():
        cols = np.arange(cb * 64, min(n, cb * 64 + 64))
        want = over[p, i, cols] & (cols > i)
        assert word == sum(1 << int(j) for j in np.nonzero(want)[0]), (p, i, cb)
    c = (n + 63) // 64
    assert len(words) == g * sum((min(n, rb * 64 + 64) - rb * 64) * (c - rb) for rb in range(c))


@pytest.mark.parametrize("t", [0.3, 0.5, 0.6, 0.7])
def test_near_mid_pairs_split_as_the_twin(t):
    """The pairs the card tests use: nested boxes whose IoU straddles t by
    a float32 step; the twin's keeps and the mirror's bits agree, and both
    answers occur."""
    pairs = chip_smoke.near_mid_pairs(np.random.RandomState(5), t, 400)
    tp = torch.from_numpy(pairs)
    over = (pairwise_iou(tp, tp) > t)[:, 0, 1].numpy()
    words = mask_words_mirror(pairs, threshold_plan(t))
    assert np.array_equal(over, [words[(p, 0, 0)] == 2 for p in range(len(pairs))])
    assert 0 < over.sum() < len(over)
    _, ok = nms_plain(tp, torch.tensor([[1.0, 0.5]]).expand(len(pairs), 2), t, 2)
    assert np.array_equal(ok[:, 1].numpy(), ~over)


# ------------------------------------------------------------ the sort

def desc_key(s):
    """csrc/nms.cu `desc_key` on float32 scores -> uint32 keys."""
    u = np.where(s == 0, np.uint32(0), s.view(np.uint32))
    order = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(s), np.uint32(0), ~order).astype(np.uint32)


def bitonic_mirror(keys):
    """`nms_sort_kernel`'s network on one block's chunk of keys (uint64, a
    power of two long, +inf pads stored): for each merge size k, i against
    i ^ (k - 1), then i against i ^ j for j = k / 4 .. 1, the smaller key to
    the lower index."""
    keys = keys.copy()
    chunk = len(keys)
    p = np.arange(chunk // 2)
    k = 2
    while k <= chunk:
        j = k // 2
        while j > 0:
            partner = k - 1 if j == k // 2 else j
            b = j.bit_length() - 1
            lo = ((p >> b) << (b + 1)) | (p & (j - 1))
            hi = lo ^ partner
            x, y = keys[lo], keys[hi]
            keys[lo], keys[hi] = np.minimum(x, y), np.maximum(x, y)
            j //= 2
        k *= 2
    return keys


def sort_chunk(n, cluster=8):
    """csrc/nms.cu `sort_chunk`: a power of two >= 32 with 8 chunks >= n."""
    chunk = 32
    while chunk * cluster < n:
        chunk *= 2
    return chunk


def sort_mirror(boxes, scores, valid):
    """(G, N, E), (G, N), (G, N) or None -> what `nms_sort_kernel` writes:
    each of a problem's 8 blocks sorts its chunk of keys, and a key's place
    is the count of keys below it in all 8 chunks (binary searches)."""
    g, n = scores.shape
    eff = scores if valid is None else np.where(valid, scores, f32(NEG_INF))
    chunk = sort_chunk(n)
    pad = np.uint64(2 ** 64 - 1)
    order = np.full((g, n), -1, np.int64)
    for p in range(g):
        keys = np.full(8 * chunk, pad, np.uint64)
        keys[:n] = (desc_key(eff[p]).astype(np.uint64) << np.uint64(32)) | np.arange(
            n, dtype=np.uint64)
        chunks = [bitonic_mirror(keys[r * chunk:(r + 1) * chunk]) for r in range(8)]
        for ch in chunks:
            for x in ch[ch != pad]:
                place = sum(int(np.searchsorted(other, x, side="left")) for other in chunks)
                order[p, place] = int(x & np.uint64(0xFFFFFFFF))
    assert (order >= 0).all()
    ok = np.take_along_axis(eff, order, 1) > f32(NEG_INF / 2)
    return np.take_along_axis(boxes, order[..., None], 1), ok, order


def sort_problems(rng, g, n, e=4):
    """Random scores with ties, +-0.0, NaN, -1e30, -6e29 and -inf lanes, an
    all-invalid problem and a presorted one."""
    boxes = rng.uniform(0, 100, (g, n, e)).astype(f32)
    scores = rng.uniform(-1, 1, (g, n)).astype(f32)
    scores[0] = np.round(scores[0] * 3) / 3
    special = np.array([0.0, -0.0, np.nan, -1e30, -6e29, -4e29, -np.inf, np.inf], f32)
    scores[1] = special[rng.randint(0, len(special), n)]
    valid = rng.uniform(size=(g, n)) < 0.8
    valid[2 % g] = False
    scores[3 % g] = np.sort(scores[3 % g])[::-1]
    return boxes, scores, valid


@pytest.mark.parametrize("n", [1, 2, 3, 7, 63, 64, 65, 130, 300, 1100, 2048])
@pytest.mark.parametrize("with_valid", [True, False])
def test_sort_mirror_equals_sort_lanes(n, with_valid):
    rng = np.random.RandomState(n)
    boxes, scores, valid = sort_problems(rng, 4, n, 5 if n % 2 else 4)
    v = valid if with_valid else None
    got_boxes, got_ok, got_order = sort_mirror(boxes, scores, v)
    want_boxes, want_ok, want_order = _sort_lanes(
        torch.from_numpy(boxes), torch.from_numpy(scores), None if v is None else torch.from_numpy(v))
    assert np.array_equal(got_order, want_order.numpy())
    assert np.array_equal(got_ok, want_ok.numpy())
    assert np.array_equal(got_boxes, want_boxes.numpy())
    if with_valid:
        assert not got_ok[2].any()


def test_sort_keys_order_scores_as_torch():
    """Each key pair orders as torch's descending stable sort orders the two
    scores: NaN first, +-0.0 equal, -inf last."""
    s = np.array([np.nan, np.inf, 3.0, 1e-45, 0.0, -0.0, -1e-45, -2.0, -1e30, -np.inf], f32)
    k = desc_key(s)
    assert k[4] == k[5] and (np.diff(k.astype(np.int64))[[0, 1, 2, 3, 5, 6, 7, 8]] > 0).all()


# ------------------------------------------------------------ K4: the clip

def rot_boxes_mirror(b5):
    """`load_rot_box`: (..., 5) -> center, half axes u, v, area, radius."""
    x, y, l, w, ry = (b5[..., i] for i in range(5))
    s, c = np.sin(ry), np.cos(ry)
    hl, hw = f32(0.5) * l, f32(0.5) * w
    return dict(cx=x, cy=y, ux=hl * c, uy=hl * s, vx=-hw * s, vy=hw * c, area=l * w,
                r=f32(0.5) * np.sqrt(l * l + w * w))


def circles_apart(a, b):
    dx, dy = b["cx"] - a["cx"], b["cy"] - a["cy"]
    reach = a["r"] + b["r"]
    lim = reach + f32(1e-5) * (np.abs(dx) + np.abs(dy) + reach)
    return dx * dx + dy * dy > lim * lim


def clip_stage(px, py, ox, oy, ex, ey):
    """`clip_stage`: N slots -> N + 1, selects only."""
    n = len(px)
    d = [ex * (py[i] - oy) - ey * (px[i] - ox) for i in range(n)]
    inside = [di >= 0 for di in d]
    xs = ys = xe = ye = ixs = iys = ixe = iye = None
    ds = de = ids = ide = None
    zero_d, one_d = np.zeros_like(d[0]), np.ones_like(d[0])
    xs, ys, xe, ye, ds, de = px[0], py[0], px[0], py[0], one_d, zero_d
    ixs, iys, ixe, iye, ids, ide = px[0], py[0], px[0], py[0], one_d, zero_d
    leaves = np.zeros(d[0].shape, bool)
    enters = np.zeros(d[0].shape, bool)
    at = np.full(d[0].shape, n)
    for i in range(n):
        h = (i + n - 1) % n
        lv = inside[h] & ~inside[i]
        xs, ys, ds = np.where(lv, px[h], xs), np.where(lv, py[h], ys), np.where(lv, d[h], ds)
        xe, ye, de = np.where(lv, px[i], xe), np.where(lv, py[i], ye), np.where(lv, d[i], de)
        leaves |= lv
        en = ~inside[h] & inside[i] & ~enters
        at = np.where(en, i, at)
        ixs, iys, ids = np.where(en, px[h], ixs), np.where(en, py[h], iys), np.where(en, d[h], ids)
        ixe, iye, ide = np.where(en, px[i], ixe), np.where(en, py[i], iye), np.where(en, d[i], ide)
        enters |= en
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ds / (ds - de)
        ti = ids / (ids - ide)
    ox_ = np.where(leaves, xs + t * (xe - xs), px[0])
    oy_ = np.where(leaves, ys + t * (ye - ys), py[0])
    bx = [np.where(inside[i], px[i], ox_) for i in range(n)]
    by = [np.where(inside[i], py[i], oy_) for i in range(n)]
    nx = np.where(enters, ixs + ti * (ixe - ixs), bx[n - 1])
    ny = np.where(enters, iys + ti * (iye - iys), by[n - 1])
    qx, qy = [], []
    for j in range(n + 1):
        cur_x, cur_y = (bx[j], by[j]) if j < n else (nx, ny)
        prev_x, prev_y = (bx[j - 1], by[j - 1]) if j > 0 else (nx, ny)
        qx.append(np.where(j < at, cur_x, np.where(j == at, nx, prev_x)))
        qy.append(np.where(j < at, cur_y, np.where(j == at, ny, prev_y)))
    return qx, qy


def rot_intersection_mirror(a, b):
    """`rot_intersection` on dicts of float32 arrays (one pair an element)."""
    dx, dy = b["cx"] - a["cx"], b["cy"] - a["cy"]
    bx = [dx + b["ux"] - b["vx"], dx + b["ux"] + b["vx"], dx - b["ux"] + b["vx"],
          dx - b["ux"] - b["vx"]]
    by = [dy + b["uy"] - b["vy"], dy + b["uy"] + b["vy"], dy - b["uy"] + b["vy"],
          dy - b["uy"] - b["vy"]]
    px = [a["ux"] - a["vx"], a["ux"] + a["vx"], -a["ux"] + a["vx"], -a["ux"] - a["vx"]]
    py = [a["uy"] - a["vy"], a["uy"] + a["vy"], -a["uy"] + a["vy"], -a["uy"] - a["vy"]]
    for k in range(4):
        o = (k + 1) % 4
        px, py = clip_stage(px, py, bx[k], by[k], bx[o] - bx[k], by[o] - by[k])
    twice = np.zeros_like(dx)
    for i in range(8):
        j = (i + 1) % 8
        twice = twice + (px[i] * py[j] - px[j] * py[i])
    return f32(0.5) * np.abs(twice)


def rot_iou_mirror(a5, b5, early_out=True):
    """`rot_iou` for every pair of (N, 5) x (M, 5) float32 boxes -> (N, M)."""
    a = rot_boxes_mirror(a5[:, None, :])
    b = rot_boxes_mirror(b5[None, :, :])
    a = {k: np.broadcast_to(v, (len(a5), len(b5))).astype(f32) for k, v in a.items()}
    b = {k: np.broadcast_to(v, (len(a5), len(b5))).astype(f32) for k, v in b.items()}
    inter = rot_intersection_mirror(a, b)
    if early_out:
        inter = np.where(circles_apart(a, b), f32(0), inter)
    uni = a["area"] + b["area"] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(uni > f32(1e-9), inter / uni, f32(0)), circles_apart(a, b)


def oracle(a, b):
    """float64 Sutherland-Hodgman IoU of every pair (eval_utils)."""
    out = np.zeros((len(a), len(b)))
    for i, p in enumerate(a.astype(f64)):
        for j, q in enumerate(b.astype(f64)):
            inter = rotated_bev_intersection(np.array([p[0], p[1], 0, p[2], p[3], 1, p[4]]),
                                             np.array([q[0], q[1], 0, q[2], q[3], 1, q[4]]))
            union = p[2] * p[3] + q[2] * q[3] - inter
            out[i, j] = inter / union if union > 1e-9 else 0.0
    return out


def test_clip_mirror_on_the_edge_cases():
    """Identical 1, inside 0.25, shared edge 0, 90 degrees 0.25, zero width
    0, disjoint 0: within 1e-6 of the float64 oracle.  The early out parts
    only pairs whose twin IoU is 0; it changes the clip's result only for
    the zero-width box, whose caps have no length to clip with (the clip
    then leaves a chord of rounding-sized area, 2.4e-8 here)."""
    e = chip_smoke.ROTATED_EDGE_CASES
    got, apart = rot_iou_mirror(e, e)
    full, _ = rot_iou_mirror(e, e, early_out=False)
    twin = rotated_iou_matrix_plain(torch.from_numpy(e), torch.from_numpy(e)).numpy()
    assert np.abs(got - oracle(e, e)).max() <= 1e-6
    assert not (twin[apart] > 0).any() and apart.sum() > 10
    assert np.abs(full - got).max() <= 1e-6
    assert np.array_equal(got[:, [0, 1, 2, 3, 4, 6, 7, 8]], full[:, [0, 1, 2, 3, 4, 6, 7, 8]])
    assert abs(got[0, 1] - 1) <= 1e-6 and abs(got[0, 2] - 0.25) <= 1e-6
    assert got[3, 8] <= 1e-6 and abs(got[4, 8] - 0.25) <= 1e-6
    assert np.abs(got[5]).max() <= 1e-6 and np.delete(got[6], 6).max() == 0


def jax_row_centered(b):
    """JAX `rotated_iou_matrix` of every pair taken relative to its row
    box's center, as the kernel and the twin take them."""
    rows = []
    for i in range(len(b)):
        rel = b.copy()
        rel[:, :2] -= b[i, :2]
        rows.append(np.asarray(j_riou(jnp.asarray(rel[i:i + 1]), jnp.asarray(rel)))[0])
    return np.stack(rows)


@pytest.mark.parametrize("scale", ["raster", "metre", "voxel"])
def test_clip_mirror_against_jax_and_the_oracle(scale):
    """The raster set of tests/test_torch_port_rotated.py (centers over
    0-400 voxels, 80 boxes, 40 clustered, seed 2), and clustered sets at
    metre scale and on a 100-voxel patch: within 2e-5 of JAX on
    row-centered pairs, 5e-5 of the oracle and of the twin; across the
    raster within 5e-4 of JAX on absolute coordinates (F4)."""
    (c0, c1), ls, ws, jit, n, seed = {
        "raster": ((0, 400), (8, 25), (4, 10), 6, 80, 2),
        "metre": ((-40, 40), (1, 8), (1, 4), 2, 60, 3),
        "voxel": ((0, 100), (8, 25), (4, 10), 6, 60, 4)}[scale]
    rng = np.random.default_rng(seed)
    b = np.stack([rng.uniform(c0, c1, n), rng.uniform(c0, c1, n), rng.uniform(*ls, n),
                  rng.uniform(*ws, n), rng.uniform(-np.pi, np.pi, n)], 1)
    b[:n // 2, :2] = b[-(n // 2):, :2] + rng.uniform(-jit, jit, (n // 2, 2))
    b = b.astype(f32)
    got, _ = rot_iou_mirror(b, b)
    twin = rotated_iou_matrix_plain(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    assert np.abs(got - jax_row_centered(b)).max() <= 2e-5
    assert np.abs(got - oracle(b, b)).max() <= 5e-5
    assert np.abs(got - twin).max() <= 5e-5
    assert (twin > 0.05).sum() - n >= 20  # overlaps beside the diagonal were compared
    if scale == "raster":
        assert np.abs(got - np.asarray(j_riou(jnp.asarray(b), jnp.asarray(b)))).max() <= 5e-4


def collinear_boxes(rng, count):
    """(2 * count, 5) pairs of boxes with one heading: slid along the length
    (both long sides collinear), slid across so that one long side lies on
    the other's, or side by side touching along a long side."""
    out = []
    for _ in range(count):
        ry, l, w = rng.uniform(-np.pi, np.pi), rng.uniform(8, 25), rng.uniform(4, 10)
        x, y = rng.uniform(50, 350, 2)
        c, s = np.cos(ry), np.sin(ry)
        kind = rng.randint(3)
        if kind == 0:
            d = rng.uniform(-l, l)
            out += [[x, y, l, w, ry], [x + d * c, y + d * s, l, w, ry]]
        elif kind == 1:
            d = rng.uniform(0, w)
            out += [[x, y, l, w, ry], [x - d / 2 * s, y + d / 2 * c, l, w - d, ry]]
        else:
            out += [[x, y, l, w, ry], [x - w * s, y + w * c, l, w, ry]]
    return np.array(out, f32)


def test_clip_mirror_on_collinear_edges():
    """Pairs whose sides lie on one line within rounding: the clip stays
    within 1e-6 of the float64 oracle.  (JAX's candidate formulation, and
    the twin that copies it, is up to 0.11 off on such pairs: F5.)"""
    b = collinear_boxes(np.random.RandomState(0), 300)
    got, _ = rot_iou_mirror(b, b)
    pairs = np.arange(0, len(b), 2)
    want = np.array([oracle(b[[i]], b[[i + 1]])[0, 0] for i in pairs])
    twin = rotated_iou_matrix_plain(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    first, second = b[pairs].copy(), b[pairs + 1].copy()
    second[:, :2] -= first[:, :2]
    first[:, :2] = 0
    jax_pairs = np.diag(np.asarray(j_riou(jnp.asarray(first), jnp.asarray(second))))
    print(f"collinear pairs: max |clip - oracle| {np.abs(got[pairs, pairs + 1] - want).max()}, "
          f"|twin - oracle| {np.abs(twin[pairs, pairs + 1] - want).max()}, |JAX row-centered - "
          f"oracle| {np.abs(jax_pairs - want).max()}")
    assert np.abs(got[pairs, pairs + 1] - want).max() <= 1e-6
    # a box against itself: the shoelace of its corners against l * w
    assert np.abs(np.diag(got) - 1).max() <= 1e-5


@pytest.mark.parametrize("seed", [0, 6])
def test_clip_mirror_self_iou_within_the_limit(seed):
    """A box against itself on chip_smoke's collinear draws (seed 6 is
    check_collinear's): the clip returns the box, and |IoU - 1| is the
    shoelace's float32 rounding, within chip_smoke.self_iou_limit per box.
    Seed 6 holds a sliver (w / l 0.0029) 1.14e-5 off 1."""
    b = chip_smoke.collinear_boxes(np.random.RandomState(seed), 300)
    got, _ = rot_iou_mirror(b, b)
    dev = np.abs(np.diag(got).astype(np.float64) - 1)
    assert (dev <= chip_smoke.self_iou_limit(b)).all()


def touching_corner_boxes(rng, count):
    """(2 * count, 5) pairs of boxes that touch at one corner: b's corner
    c - u - v on a's corner c + u + v, both turned by one random angle
    about the shared point."""
    out = []
    for _ in range(count):
        ry = rng.uniform(-np.pi, np.pi)
        la, wa, lb, wb = rng.uniform(4, 25, 4)
        p = rng.uniform(50, 350, 2)
        c, s = np.cos(ry), np.sin(ry)
        u_a, v_a = np.array([c, s]) * la / 2, np.array([-s, c]) * wa / 2
        u_b, v_b = np.array([c, s]) * lb / 2, np.array([-s, c]) * wb / 2
        out += [[*(p - u_a - v_a), la, wa, ry], [*(p + u_b + v_b), lb, wb, ry]]
    return np.array(out, f32)


@pytest.mark.parametrize("case", ["random", "dense", "touching"])
def test_early_out_skips_no_overlap(case):
    """A pair the bounding circles part has twin IoU 0 and mirror IoU 0;
    the random set is mostly parted pairs, the dense set none.  At
    threshold 0, the touching corners (IoU 0 in exact arithmetic) stay
    within 1e-6 of 0."""
    rng = np.random.RandomState({"random": 30, "dense": 31, "touching": 32}[case])
    if case == "touching":
        boxes = touching_corner_boxes(rng, 40)
    else:
        make = chip_smoke.rotated_boxes if case == "random" else chip_smoke.dense_rotated_boxes
        boxes = make(rng, 1, 160)[0]
    twin = rotated_iou_matrix_plain(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    got, apart = rot_iou_mirror(boxes, boxes)
    full, _ = rot_iou_mirror(boxes, boxes, early_out=False)
    assert not (twin[apart] > 0).any()
    assert not (full[apart] != 0).any()
    assert np.abs(got - twin).max() <= 5e-5
    share = apart.mean()
    if case == "random":
        assert share > 0.9
    elif case == "dense":
        assert share == 0
    else:
        pairs = np.arange(0, len(boxes), 2)
        assert not apart[pairs, pairs + 1].any()
        assert np.abs(got[pairs, pairs + 1]).max() <= 1e-6
        assert np.abs(twin[pairs, pairs + 1]).max() <= 1e-6


# ------------------------------------------------------------ chip_smoke's K4 counts

def test_greedy_pairs_are_the_pairs_nms_pairs_counts():
    """The pairs K4's bound charges (chip_smoke.greedy_pairs): each kept
    lane against every lane after it in score order, as many as K1's bound
    counts (chip_smoke.nms_pairs), ties and invalid lanes included."""
    rng = np.random.RandomState(40)
    boxes = chip_smoke.rotated_boxes(rng, 4, 120)
    scores = rng.uniform(size=(4, 120)).astype(f32)
    scores[1] = np.round(scores[1] * 8) / 8
    valid = rng.uniform(size=(4, 120)) < 0.8
    idx, ok = (t.numpy() for t in nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                            0.3, 50, torch.from_numpy(valid), rotated=True))
    pairs = chip_smoke.greedy_pairs(scores, valid, idx, ok)
    assert int(pairs.sum()) == chip_smoke.nms_pairs(scores, valid, idx, ok)
    for p in range(4):
        rows = np.nonzero(pairs[p].any(1))[0]
        assert set(rows) <= set(idx[p][ok[p]])
        assert not pairs[p].diagonal().any()


def test_filter_nms_inputs_records_the_final_filter():
    """chip_smoke.filter_nms_inputs hands the rotated final filter's NMS
    input over unchanged, records it, and restores the filter's NMS."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import filter as filter_mod

    rng = np.random.RandomState(41)
    b, s, k = 2, 40, 3
    cls_prob = torch.from_numpy(rng.dirichlet(np.ones(k), (b, s)).astype(f32))
    box7 = np.stack([rng.uniform(0, 100, (b, s, k)), rng.uniform(0, 100, (b, s, k)),
                     rng.uniform(-1, 1, (b, s, k)), rng.uniform(8, 25, (b, s, k)),
                     rng.uniform(4, 10, (b, s, k)), rng.uniform(1, 2, (b, s, k)),
                     rng.uniform(-np.pi, np.pi, (b, s, k))], -1).astype(f32)
    pred = torch.from_numpy(box7.reshape(b, s, 7 * k))
    roi_valid = torch.from_numpy(rng.uniform(size=(b, s)) < 0.9)
    kwargs = dict(num_classes=k, bbox_elem=7, max_dets=10, thresh=0.2, nms_thresh=0.3,
                  is_lidar=True, rotated_nms=True)
    nms = filter_mod.nms
    want = filter_mod.filter_detections(cls_prob, pred, roi_valid, **kwargs)
    with chip_smoke.filter_nms_inputs() as seen:
        got = filter_mod.filter_detections(cls_prob, pred, roi_valid, **kwargs)
    assert filter_mod.nms is nms
    for key in want:
        assert torch.equal(got[key], want[key]), key
    (rec,) = seen
    assert rec["boxes"].shape == (b * k, s, 5) and rec["scores"].shape == (b * k, s)
    assert rec["valid"].shape == (b * k, s) and rec["valid"].dtype == bool
    assert (rec["thr"], rec["max_out"]) == (0.3, 10)
    assert np.array_equal(rec["boxes"], box7[..., [0, 1, 3, 4, 6]].transpose(0, 2, 1, 3)
                          .reshape(b * k, s, 5))
    idx, ok = nms_plain(*(torch.from_numpy(rec[x]) for x in ("boxes", "scores")), 0.3, 10,
                        torch.from_numpy(rec["valid"]), rotated=True)
    assert torch.equal(ok.reshape(b, k, 10), got["valid"])
    assert torch.equal(idx.reshape(b, k, 10).long(), got["src_idx"])
