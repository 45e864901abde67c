"""K2, the NMS kernel's plain version, and the port's postprocessing against
the JAX package's.

Keep masks are compared bit for bit with `nms_fixed` / `batched_nms_fixed`
(the XLA fixpoint `_greedy_suppress`) and with the Pallas kernel
`nms_pallas` in interpret mode, on random boxes and on the edge cases
where the two IoU forms could part ways. The postprocess paths are held to
JAX row for row on inputs full of tied scores and tied class maxima, where
only the tie-break order decides: exactly for the undecoded columns, at
rtol 1e-6 for columns that pass through exp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import nms_edge_cases, random_boxes
from yolox_tpu.ops import nms as jnms
from yolox_tpu.ops.pallas_nms import nms_pallas
from yolox_tpu_torch.ops import nms as tnms
from yolox_tpu_torch.ops.boxes import (
    cxcywh2xyxy,
    pairwise_iou_xyxy,
    xyxy2cxcywh,
)
from yolox_tpu_torch.ops.nms_kernel import (
    launch_plan,
    nms_keep,
    nms_keep_plain,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)


def _cases():
    rng = np.random.default_rng(0)
    boxes = random_boxes(rng, 3, 256)
    valid = rng.random((3, 256)) > 0.15
    eb, ev = nms_edge_cases()
    return [("random", boxes, valid), ("edge", eb, ev)]


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.65])
@pytest.mark.parametrize("case", ["random", "edge"])
def test_plain_keep_bit_equal_to_jax_and_pallas(case, thr):
    _, boxes, valid = dict((c[0], c) for c in _cases())[case]
    got = nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    assert got.dtype == torch.bool
    for i in range(len(boxes)):
        jb, jv = jnp.asarray(boxes[i]), jnp.asarray(valid[i])
        want = np.asarray(jnms.nms_fixed(jb, None, thr, jv))
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=str(i))
        pallas = np.asarray(nms_pallas(jb, None, thr, jv, interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), pallas, err_msg=str(i))


@pytest.mark.smoke
def test_edge_cases_keep_what_greedy_nms_keeps():
    """Spot checks of the edge cases' meaning at thr 0.5."""
    boxes, valid = nms_edge_cases()
    keep = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                          0.5).numpy()
    assert keep[0].sum() == 1 and keep[0, 0]          # identical boxes
    np.testing.assert_array_equal(keep[1], valid[1])  # zero area: no overlap
    assert keep[2].all()                              # touching: IoU 0
    assert keep[4].all()                              # IoU == thr survives
    assert not keep[5].any()                          # all invalid


@pytest.mark.smoke
@pytest.mark.parametrize("thr", [0.45, 0.65])
def test_class_offset_path_bit_equal_to_jax(thr):
    rng = np.random.default_rng(1)
    boxes = random_boxes(rng, 2, 384)
    valid = rng.random((2, 384)) > 0.1
    classes = rng.integers(0, 5, (2, 384))
    scores = np.ones((2, 384), np.float32)
    got = tnms.batched_nms_fixed(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(classes), thr,
                                 torch.from_numpy(valid))
    for i in range(2):
        want = jnms.batched_nms_fixed(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(classes[i]), thr, jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    # unbatched (K, 4) form, and the class-agnostic path
    one = tnms.nms_fixed(torch.from_numpy(boxes[0]), None, thr,
                         torch.from_numpy(valid[0]))
    want = jnms.nms_fixed(jnp.asarray(boxes[0]), None, thr,
                          jnp.asarray(valid[0]))
    np.testing.assert_array_equal(one.numpy(), np.asarray(want))


def test_iou_bit_equal_to_jax():
    boxes, _ = nms_edge_cases()
    b = np.concatenate([boxes[1], boxes[3], random_boxes(
        np.random.default_rng(2), 1, 128)[0]])
    from yolox_tpu.ops.boxes import pairwise_iou_xyxy as jiou

    got = pairwise_iou_xyxy(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    want = np.asarray(jiou(jnp.asarray(b), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)  # NaN positions included


def test_box_conversions():
    from yolox_tpu.ops import boxes as jboxes

    b = random_boxes(np.random.default_rng(3), 2, 16)
    np.testing.assert_array_equal(
        xyxy2cxcywh(torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.xyxy2cxcywh(jnp.asarray(b))))
    np.testing.assert_array_equal(
        cxcywh2xyxy(torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.cxcywh2xyxy(jnp.asarray(b))))


def _tied_prediction(seed, b=2, a=300, c=6):
    """Decoded rows with few distinct values: scores tie across anchors and
    class maxima tie across classes."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((b, a, 5 + c), np.float32)
    pred[..., 0:2] = rng.integers(0, 40, (b, a, 2)) * 8.0
    pred[..., 2:4] = rng.choice([16.0, 32.0, 48.0], (b, a, 2))
    pred[..., 4] = rng.choice([0.5, 0.75, 1.0], (b, a))
    pred[..., 5:] = rng.choice([0.25, 0.5, 1.0], (b, a, c))
    pred[:, :10, 5:] = 0.5           # every class tied at the max
    return pred


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("max_det", [64, 512])
def test_postprocess_device_tie_order_matches_jax(max_det, agnostic):
    pred = _tied_prediction(4)
    want_d, want_v = jnms.postprocess_device(
        jnp.asarray(pred), 6, 0.3, 0.45, agnostic, max_det)
    got_d, got_v = tnms.postprocess_device(
        torch.from_numpy(pred), 6, 0.3, 0.45, agnostic, max_det)
    assert got_d.shape == (2, max_det, 7)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_argmax_ties_pick_the_first_class():
    pred = _tied_prediction(5)
    _, cls = torch.from_numpy(pred[..., 5:]).max(dim=-1)
    np.testing.assert_array_equal(
        cls.numpy(), np.asarray(jnp.argmax(jnp.asarray(pred[..., 5:]), -1)))
    assert (cls[:, :10] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_levels_tie_order_matches_jax(dtype):
    """`postprocess_fused_levels` on raw per-level outputs with ties, in the
    head's dtype (bf16 serving makes ties common)."""
    rng = np.random.default_rng(6)
    sizes, strides = ((8, 8), (4, 4), (2, 2)), (8, 16, 32)
    c = 6
    outs, grids, strs = [], [], []
    for (h, w), s in zip(sizes, strides):
        o = np.zeros((2, h * w, 5 + c), np.float32)
        o[..., 0:2] = rng.choice([0.25, 0.5], (2, h * w, 2))
        o[..., 2:4] = rng.choice([0.0, 0.5, 1.0], (2, h * w, 2))
        o[..., 4] = rng.choice([0.5, 1.0], (2, h * w))
        o[..., 5:] = rng.choice([0.25, 0.5, 1.0], (2, h * w, c))
        outs.append(o)
        xv, yv = np.meshgrid(np.arange(w), np.arange(h))
        grids.append(np.stack([xv, yv], 2).reshape(-1, 2).astype(np.float32))
        strs.append(np.full((h * w, 1), s, np.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_d, want_v = jnms.postprocess_fused_levels(
        [jnp.asarray(o, jdt) for o in outs],
        [jnp.asarray(g, jdt) for g in grids],
        [jnp.asarray(s, jdt) for s in strs], c, 0.2, 0.45, False, 32)
    got_d, got_v = tnms.postprocess_fused_levels(
        [torch.from_numpy(o).to(tdt) for o in outs],
        [torch.from_numpy(g).to(tdt) for g in grids],
        [torch.from_numpy(s).to(tdt) for s in strs], c, 0.2, 0.45, False, 32)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_payload_promotes_to_f32_past_256_classes():
    """bf16 holds class ids only up to 256: the payload table goes to f32."""
    c = 300
    out = torch.zeros((1, 4, 5 + c), dtype=torch.bfloat16)
    out[..., 5 + 299] = 1.0
    grid = torch.zeros((4, 2), dtype=torch.bfloat16)
    stride = torch.full((4, 1), 8.0, dtype=torch.bfloat16)
    _, tbl = tnms._score_and_payload(out, grid, stride, c, 0.1)
    assert tbl.dtype == torch.float32
    assert (tbl[..., 6] == 299).all()
    _, tbl = tnms._score_and_payload(out[..., :5 + 200], grid, stride, 200,
                                     0.1)
    assert tbl.dtype == torch.bfloat16


def test_wrapper_runs_plain_only_on_cpu_and_checks_inputs():
    boxes, valid = nms_edge_cases()
    before = nms_keep.launches
    nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert nms_keep.launches == before
    meta = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nms_keep(meta, torch.ones((1, 8), dtype=torch.bool, device="meta"),
                 0.5)


# ------------------------------------------------ K2's launch arithmetic

def test_launch_plan_fits_every_k():
    """Dynamic shared memory within 56 KB (4 blocks an SM) for K up to
    8400 and within the kernel's 219 KB for K to 20000, the ring staged
    (R >= 1), the scratch as stated; R only shrinks with K."""
    last_r = 64
    for k in range(1, 20001):
        p = launch_plan(3, k)
        w = -(-k // 64)
        q = -(-w // 4)
        assert p.words == w and p.row_words % 2 == 0
        assert w <= p.row_words <= w + 1
        assert p.group == 1 and launch_plan(8, k).group == 4
        assert p.tiles == 2 * (q - 1) * q + w and p.grid == (p.tiles, 3)
        assert p.chunk_rows in (1, 2, 4, 8, 16, 32, 64)
        assert p.chunk_rows <= last_r
        last_r = p.chunk_rows
        assert p.smem_bytes == 8 * p.row_words + 48 \
            + 3 * p.chunk_rows * p.row_words * 8
        assert p.smem_bytes <= (57344 if k <= 8400 else 232448 - 8192)
        assert p.scratch_bytes == 8 * 3 * p.row_words * (k + 1)
    assert launch_plan(1, 1024).chunk_rows == 64    # 24.2 KB
    assert launch_plan(1, 2048).chunk_rows == 64    # 48.3 KB
    assert launch_plan(1, 8400).chunk_rows == 16    # 50.6 KB
    assert launch_plan(1, 20000).chunk_rows == 4
    assert launch_plan(1, 448_000).chunk_rows == 1
    # past ~448k not even one ring row fits (the mask is 25 GB an image)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        launch_plan(1, 449_000)
    for bad in (0, 3, 128):         # R divides a 64-row group
        with pytest.raises(ValueError, match="rows a chunk"):
            launch_plan(1, 1025, rows=bad)
    assert launch_plan(1, 1025, rows=8).smem_bytes == 8 * 18 + 48 + 24 * 18 * 8
    assert launch_plan(70_000, 10).grid[1] == 65535


def _block_of(t, g=1):
    """The kernel's block index -> (first row tile of its group, column
    quad) for G = g, in float32 as the kernel computes it."""
    t = np.asarray(t, np.int64)
    q = ((np.sqrt(np.float32(2.0 * g) * t.astype(np.float32)
                  + np.float32(1)) - np.float32(1))
         * np.float32(0.5)).astype(np.int64)
    for _ in range(4):
        q = np.where(2 * (q + 1) * (q + 2) // g <= t, q + 1, q)
        q = np.where(2 * q * (q + 1) // g > t, q - 1, q)
    return (t - 2 * q * (q + 1) // g) * g, q


@pytest.mark.parametrize("g", [1, 2, 4])
def test_grid_covers_the_upper_triangle_once(g):
    """Every (row tile, column tile) pair on or right of the diagonal is
    one thread's word of one block, once, for G row tiles a block; every
    row tile has one diagonal block."""
    for k in (64, 200, 1024, 1300, 8400, 20000):
        p = launch_plan(1, k, group=g)
        w = p.words
        ry0, q = _block_of(np.arange(p.tiles), g)
        assert (ry0 >= 0).all() and (ry0 < w).all() and (ry0 % g == 0).all()
        ry = (ry0[:, None] + np.arange(g)[None]).repeat(4, 1)
        cx = np.tile(4 * q[:, None] + np.arange(4)[None], (1, g))
        ok = (cx >= ry) & (cx < w) & (ry < w)
        pairs = np.stack([ry[ok], cx[ok]], 1)
        assert len(pairs) == w * (w + 1) // 2
        assert len(np.unique(pairs, axis=0)) == len(pairs)
        diag = ry0 // 4 == q
        rows = (ry0[diag][:, None] + np.arange(g)[None]).ravel()
        np.testing.assert_array_equal(np.sort(rows[rows < w]), np.arange(w))
    # the float32 square root stays within the fix-ups up to K ~ 1.8 M
    qs = np.arange(1, 7100)
    for dt in (-1, 0, 1):
        t = 2 * qs * (qs + 1) // g + dt
        _, got = _block_of(t, g)
        np.testing.assert_array_equal(got, qs - (dt < 0))


def kept_rows(cand, words, span, rounds=8):
    """`csrc/nms.cu::kept_rows`: the fixpoint kept = cand & ~OR(kept rows'
    words) for `rounds` rounds, then the rows one by one."""
    kept = cand
    for _ in range(rounds):
        sup = 0
        for r, w in enumerate(words):
            if (kept >> r) & 1:
                sup |= w
        nxt = cand & ~(sup & span)
        if nxt == kept:
            return kept
        kept = nxt
    removed, kept = ~cand & span, 0
    for r, w in enumerate(words):
        if not (removed >> r) & 1:
            kept |= 1 << r
            removed |= w & span
    return kept


def emulate_nms_kernel(boxes, valid, thr, rows=None, seed=0, rounds=8,
                       group=None):
    """numpy emulation of `csrc/nms.cu` with `launch_plan`'s arithmetic:
    the blocks' words (a row tile against a column quad, the diagonal
    block's valid word), the last block's walk: chunks of R rows through
    the ring (the stored rows, words from the chunk's even diagonal word
    to the last valid box's), the group's word in a register, the kept
    rows' words right of the diagonal OR-ed into `removed`. Mask words
    and ring slots the kernel never writes hold random garbage, so a read
    of one shows."""
    b, k = valid.shape
    p = launch_plan(b, k, rows, group)
    w, w2, tile = p.words, p.row_words, 64
    rng = np.random.default_rng(seed)
    garbage = lambda *shape: rng.integers(  # noqa: E731
        0, 2 ** 63, shape, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    over = (pairwise_iou_xyxy(torch.from_numpy(boxes),
                              torch.from_numpy(boxes)) > thr).numpy()
    bitw = np.uint64(1) << np.arange(64, dtype=np.uint64)
    mask = garbage(b, k, w2)
    vwords = garbage(b, w2)
    pad = np.zeros((b, (w2 + 4) * tile), bool)
    pad[:, :k] = valid
    for t in range(p.tiles):                                # the blocks
        ry0, q = (int(v) for v in _block_of(t, p.group))
        for i in range(b):
            rvs = [pad[i, (ry0 + j) * tile + np.arange(tile)]
                   if ry0 + j < w else np.zeros(tile, bool)
                   for j in range(p.group)]
            if ry0 // 4 == q:
                for j, rv in enumerate(rvs):
                    if ry0 + j < w:
                        vwords[i, ry0 + j] = (rv.astype(np.uint64)
                                              * bitw).sum(dtype=np.uint64)
            if not any(rv.any() for rv in rvs):
                continue
            cols_q = q * 256 + np.arange(256)
            cv_q = pad[i, cols_q]
            for j, rv in enumerate(rvs):
                ry = ry0 + j
                rows_i = ry * tile + np.arange(tile)
                for sub in range(4):
                    cx = 4 * q + sub
                    if cx < ry or cx >= w or not rv.any():
                        continue
                    cols = cx * tile + np.arange(tile)
                    cv = cv_q[sub * tile:(sub + 1) * tile]
                    m = np.zeros((tile, tile), bool)
                    r_in, c_in = rows_i[rows_i < k], cols[cols < k]
                    m[:len(r_in), :len(c_in)] = over[i][np.ix_(r_in, c_in)]
                    m &= cv[None, :] & (cols[None, :] > rows_i[:, None])
                    words = (m.astype(np.uint64) * bitw).sum(
                        1, dtype=np.uint64)
                    mask[i, rows_i[rv], cx] = words[rv]

    keep = np.zeros((b, k), bool)
    for i in range(b):                                      # the walk
        vw = np.where(np.arange(w2) < w, vwords[i], np.uint64(0))
        removed = ~vw
        n = max((int(j) * tile + 64 - (64 - int(v).bit_length())
                 for j, v in enumerate(vw) if v), default=0)
        nw = -(-n // tile)
        nw2 = nw + (nw & 1)
        chunk = p.chunk_rows
        ring = [garbage(chunk * w2) for _ in range(3)]

        def stage(c):
            r0 = c * chunk
            w0e = (r0 // tile) & ~1
            ld = nw2 - w0e
            for r in range(min(chunk, n - r0)):
                ring[c % 3][r * ld:(r + 1) * ld] = mask[i, r0 + r, w0e:nw2]

        nchunks = -(-n // chunk)
        # chunk 0 at full width before n is known, then chunk 1
        for r in range(min(chunk, k)):
            ring[0][r * w2:(r + 1) * w2] = mask[i, r]
        if nchunks > 1:
            stage(1)
        cur = 0
        for c in range(nchunks):
            if c + 2 < nchunks:  # two ahead, before chunk c
                stage(c + 2)
            r0 = c * chunk
            rows_c = min(chunk, n - r0)
            d, g0 = r0 // tile, r0 % tile
            w0e = d & ~1
            ld = w2 if c == 0 else nw2 - w0e

            def word(r, ws, c=c, ld=ld, w0e=w0e):
                return ring[c % 3][r * ld + np.asarray(ws) - w0e]

            if g0 == 0:
                cur = int(removed[d])
            span = (1 << rows_c) - 1
            dgs = [int(word(r, d)) for r in range(rows_c)]
            kept = kept_rows((~cur >> g0) & span, [g >> g0 for g in dgs],
                             span, rounds)
            for r in range(rows_c):
                if (kept >> r) & 1:
                    cur |= dgs[r]
            if g0 + rows_c == tile or r0 + rows_c == n:
                removed[d] = np.uint64(cur & (2 ** 64 - 1))
            right = np.arange(d + 1, nw)
            for r in range(rows_c):
                if (kept >> r) & 1 and len(right):
                    removed[right] |= word(r, right)
        bits = (removed[:, None] & bitw[None, :]) != 0
        keep[i] = ~bits.reshape(-1)[:k]
    return keep


def _kernel_cases(k, seed):
    """Random boxes dense enough to suppress (centres in 100 x 100 px),
    a scattered and a prefix valid mask."""
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, 2, k, 50.0, 150.0)
    valid = np.stack([rng.random(k) > 0.2, np.arange(k) < k - 7])
    return boxes, valid


@pytest.mark.parametrize("k,group", [(1025, 1), (2048, 2), (4096, 4),
                                     (1300, 4)])
def test_emulated_kernel_equals_plain(k, group):
    boxes, valid = _kernel_cases(k, k)
    for thr in (0.3, 0.65):
        want = nms_keep_plain(torch.from_numpy(boxes),
                              torch.from_numpy(valid), thr).numpy()
        np.testing.assert_array_equal(
            emulate_nms_kernel(boxes, valid, thr, group=group), want)


def test_emulated_kernel_edge_cases_and_forced_rings():
    """The edge cases at K 128; K 1025 with the ring forced down to 1, 2
    and 8 rows a chunk (what larger K gets)."""
    eb, ev = nms_edge_cases()
    for thr in (0.0, 0.5, 0.65, 1.0):
        np.testing.assert_array_equal(
            emulate_nms_kernel(eb, ev, thr),
            nms_keep_plain(torch.from_numpy(eb), torch.from_numpy(ev),
                           thr).numpy())
    boxes, valid = _kernel_cases(1025, 3)
    want = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                          0.5).numpy()
    for r in (1, 2, 8):
        np.testing.assert_array_equal(
            emulate_nms_kernel(boxes, valid, 0.5, rows=r), want)
    # the rows one by one only (no fixpoint round), on the edge cases
    for thr in (0.0, 0.3):
        np.testing.assert_array_equal(
            emulate_nms_kernel(eb, ev, thr, rounds=0),
            nms_keep_plain(torch.from_numpy(eb), torch.from_numpy(ev),
                           thr).numpy())


def test_chain_needs_the_one_by_one_walk():
    """The chain of `nms_edge_cases` (row 6) keeps every other box at thr
    0.3, and its fixpoint takes more than the kernel's 8 rounds, so the
    kernel's fallback decides it."""
    eb, ev = nms_edge_cases()
    keep = nms_keep_plain(torch.from_numpy(eb), torch.from_numpy(ev),
                          0.3).numpy()[6]
    np.testing.assert_array_equal(keep, np.arange(128) % 2 == 0)
    iou = (pairwise_iou_xyxy(torch.from_numpy(eb[6, :64]),
                             torch.from_numpy(eb[6, :64])) > 0.3).numpy()
    words = [int((np.triu(iou, 1)[r].astype(np.uint64)
                  << np.arange(64, dtype=np.uint64)).sum(dtype=np.uint64))
             for r in range(64)]
    full = 2 ** 64 - 1
    assert kept_rows(full, words, full, rounds=8) == \
        kept_rows(full, words, full, rounds=0)
    cand, kept = full, full
    for n in range(1, 64):    # rounds the fixpoint needs
        sup = 0
        for r, w in enumerate(words):
            if (kept >> r) & 1:
                sup |= w
        nxt = cand & ~sup
        if nxt == kept:
            break
        kept = nxt
    assert n > 8


def test_zero_overlap_shortcut_decides_like_the_divide():
    """`csrc/nms.cu::overlaps` decides a pair with area_i = +-0 without the
    divide: (uni == uni and uni != 0 and 0 > thr). In float32 that is
    area_i / uni > thr, for uni of every sign, zero, infinite and NaN and
    thresholds of both signs."""
    uni = np.array([1.0, -1.0, 0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                    3e38], np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for area_i in (np.float32(0.0), np.float32(-0.0)):
            for thr in (-0.5, -0.0, 0.0, 0.3, 1.0):
                want = (area_i / uni) > np.float32(thr)
                got = (uni == uni) & (uni != 0) & (np.float32(0) > thr)
                np.testing.assert_array_equal(got, want)


def test_counters_never_reuse_scratch():
    """The arrival counters live apart from the grown scratch: a call with
    more images than before gets zeroed counters, not words an earlier
    call left in the scratch."""
    from yolox_tpu_torch.ops import nms_kernel as nk

    dev = torch.device("cpu")
    saved = dict(nk._counters), dict(nk._scratch)
    nk._prepared[("stale",)] = ()
    try:
        c1, s1 = nk._buffers_for(dev, 7, 4, 1024)
        nk._scratch[(None, 7)].fill_(-1)          # an earlier call's words
        c2, s2 = nk._buffers_for(dev, 7, 64, 4096)
        assert (nk._counters[(None, 7)][:64] == 0).all()
        assert c2 != s2 and c1 != s1
        assert ("stale",) not in nk._prepared   # grown: prepared cleared
    finally:
        nk._counters.clear(), nk._scratch.clear()
        nk._counters.update(saved[0]), nk._scratch.update(saved[1])
