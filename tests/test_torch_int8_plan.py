"""Q1 / Q2 launch plans on the CPU (`ops/int8_conv.py::q1_plan`,
`q2_plan`): the choices the wrappers hand the kernels of
`csrc/int8_conv.cu`, at every conv shape that yolox-s, yolov3 (640 px)
and nano (416 px) launch at B 1, 8 and 32, and at `chip_smoke`'s edge
cases. Each plan must cover the output exactly once, within the 227 KB of
shared memory a block may have, with an N tile that `wgmma` takes for s8
and a K padded to whole k tiles that `pack_weight` matches.

A numpy emulation of each kernel's tiles (Q1: the cp.async rows and the
window patch, each k tile's A and B tiles and the store of the staged
tile; Q2: the halo and the 16-channel taps) holds the index arithmetic to
`plain_sums` at small shapes, as the card cannot be reached from here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.ops.int8_conv import (
    MAX_SMEM,
    Q1_N,
    Q1_PATCH_N,
    WGMMA_S8_N,
    k_tile,
    pack_dw_weight,
    pack_weight,
    plain_sums,
    q1_plan,
    q1_smem,
    q2_plan,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

MODELS = (("yolox_s", cs.INT8_SIZE), ("yolov3", cs.INT8_SIZE),
          ("yolox_nano", cs.NANO_SIZE))
_SHAPES = {}


def model_shapes(name, size):
    """(Cin, Cout, H, W, k, stride, groups) of every int8 conv of `name`
    at `size` px, read once a process by `chip_smoke.int8_conv_shapes`."""
    if name not in _SHAPES:
        module = YoloxModule.from_config(YoloxConfig.get_named_config(name),
                                         rng_seed=1, device="cpu")
        with torch.no_grad():
            _SHAPES[name] = sorted({s[1:] for s in
                                    cs.int8_conv_shapes(module, size, 1)})
    return _SHAPES[name]


def out_hw(h, w, k, stride):
    pad = (k - 1) // 2
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def cdiv(a, b):
    return -(-a // b)


def patch_coverage(ho, wo, tr, tc):
    """How often each output pixel of one image falls in a tr x tc patch
    of the kernel's patch grid (blockIdx.x = (img, ty, tx))."""
    cover = np.zeros((ho, wo), np.int64)
    r = np.arange(tr * tc)
    for ty in range(cdiv(ho, tr)):
        for tx in range(cdiv(wo, tc)):
            oy, ox = ty * tr + r // tc, tx * tc + r % tc
            ok = (oy < ho) & (ox < wo)
            np.add.at(cover, (oy[ok], ox[ok]), 1)
    return cover


def check_q1_plan(b, cin, cout, h, w, k, stride, aligned=True):
    p = q1_plan(b, h, w, cin, cout, k, stride, aligned)
    ho, wo = out_hw(h, w, k, stride)
    m = b * ho * wo
    kk = k * k * cin
    # the tile widths the kernels are built for, and wgmma takes for s8
    assert p.bn in WGMMA_S8_N and p.bn in (Q1_PATCH_N if p.patch else Q1_N)
    assert p.bm in (64, 128) and p.threads == 2 * p.bm
    assert p.patch == (cin % 16 != 0 or not aligned)
    # K padded to whole k tiles, and the packed weights match
    assert p.bk == k_tile(k, cin) and p.bk in (32, 64, 128)
    assert p.kp % p.bk == 0 and p.kp - p.bk < kk <= p.kp
    assert pack_weight(torch.zeros(1, cin, k, k, dtype=torch.int8)
                       ).shape == (1, p.kp)
    # shared memory: the layout the launcher checks, within 227 KB
    window = p.wr * p.wc * cin if p.patch else 0
    assert p.smem == q1_smem(p.bm, p.bn, p.bk, p.stages, window,
                             p.kp // p.bk)
    assert p.smem <= MAX_SMEM and p.stages in (3, 4)
    # the grid covers M x Cout exactly once
    assert p.grid[1] == p.n_tiles == cdiv(cout, p.bn)
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    if p.patch:
        assert p.tr * p.tc == p.bm and p.tc & (p.tc - 1) == 0
        assert (p.wr, p.wc) == ((p.tr - 1) * stride + k,
                                (p.tc - 1) * stride + k)
        assert p.grid[0] == b * cdiv(ho, p.tr) * cdiv(wo, p.tc)
        assert (patch_coverage(ho, wo, p.tr, p.tc) == 1).all()
    else:
        assert (p.grid[0] - 1) * p.bm < m <= p.grid[0] * p.bm
    return p


def check_q2_plan(b, c, h, w, k, stride, aligned=True):
    p = q2_plan(b, h, w, c, k, stride, aligned)
    ho, wo = out_hw(h, w, k, stride)
    assert p.cg in (16, 32, 64) and p.vec == (c % 16 == 0 and aligned)
    assert p.th * p.tw * (p.cg // 16) == 256 and p.tw & (p.tw - 1) == 0
    assert (p.hr, p.hc) == ((p.th - 1) * stride + k, (p.tw - 1) * stride + k)
    assert p.smem == p.hr * p.hc * p.cg + k * k * p.cg + 12 * p.cg <= MAX_SMEM
    assert p.grid == (b * cdiv(ho, p.th) * cdiv(wo, p.tw), cdiv(c, p.cg))
    assert (p.grid[1] - 1) * p.cg < c <= p.grid[1] * p.cg
    assert (patch_coverage(ho, wo, p.th, p.tw) == 1).all()
    assert pack_dw_weight(torch.zeros(c, 1, k, k, dtype=torch.int8)
                          ).shape == (k * k, c)
    return p


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("name,size", MODELS)
def test_plans_at_every_model_shape(name, size, batch):
    shapes = model_shapes(name, size)
    assert shapes
    for cin, cout, h, w, k, stride, groups in shapes:
        if groups == 1:
            p = check_q1_plan(batch, cin, cout, h, w, k, stride)
            # every dense shape of the three models but the 3-channel
            # first conv takes the cp.async rows, N all of Cout up to the
            # width its BM allows
            assert p.patch == (cin == 3)
            assert p.n_tiles == 1 or p.bn >= 64
        else:
            assert groups == cin == cout
            check_q2_plan(batch, cin, h, w, k, stride)


def test_plans_at_the_edge_cases():
    for b, cin, cout, h, w, k, stride, groups, offset in \
            cs.Q1_EDGE + cs.Q2_EDGE:
        if groups == 1:
            check_q1_plan(b, cin, cout, h, w, k, stride, offset % 16 == 0)
        else:
            check_q2_plan(b, cin, h, w, k, stride, offset % 16 == 0)


def test_plans_refuse_what_the_kernels_cannot_take():
    # an input window larger than shared memory (Cin % 16 != 0)
    with pytest.raises(ValueError, match="shared memory"):
        q1_plan(1, 64, 64, 1000, 64, 7, 2)
    # no output at all
    with pytest.raises(ValueError, match="no output"):
        q1_plan(1, 1, 1, 16, 16, 6, 2)
    with pytest.raises(ValueError, match="no output"):
        q2_plan(0, 8, 8, 16, 3, 1)
    # a 1x1 conv of fewer than 8 channels that are not a multiple of 16
    with pytest.raises(ValueError, match="runs"):
        q1_plan(1, 8, 8, 3, 16, 1, 1)
    # a halo larger than shared memory
    with pytest.raises(ValueError, match="shared memory"):
        q2_plan(1, 512, 512, 64, 21, 8)


def test_plans_pick_tiles_by_k_tiles_and_grid():
    # one or two k tiles, or N <= 32: BM 64
    p = q1_plan(32, 80, 80, 64, 64, 1, 1)
    assert (p.bm, p.bn, p.n_tiles, p.stages) == (64, 64, 1, 4)
    p = q1_plan(32, 40, 40, 256, 256, 1, 1)
    assert (p.bm, p.bn, p.n_tiles) == (64, 128, 2)
    p = q1_plan(32, 160, 160, 32, 32, 3, 1)
    assert (p.bm, p.bn, p.n_tiles, p.stages) == (64, 32, 1, 4)
    # more k tiles: 128 x 128, 3 stages: two blocks fit on an SM (228 KB)
    p = q1_plan(32, 40, 40, 128, 128, 3, 1)
    assert (p.bm, p.bn, p.n_tiles, p.stages) == (128, 128, 1, 3)
    assert 2 * (p.smem + 1024) <= 228 * 1024
    p = q1_plan(32, 20, 20, 1024, 512, 1, 1)
    assert (p.bm, p.bn, p.n_tiles) == (128, 128, 4)
    # B 1 at 20x20: N halves, then BM drops, while the grid is small
    p = q1_plan(1, 20, 20, 512, 256, 1, 1)
    assert (p.bm, p.bn, p.n_tiles) == (64, 64, 4)
    p = q1_plan(32, 20, 20, 128, 128, 3, 1)
    assert (p.bm, p.bn, p.n_tiles) == (128, 64, 2)


# --------------------------------------------------- kernel emulation

def emulate_q1(x, wpk, k, stride, aligned=True, sms=132):
    """Q1's int32 sums (M, Cout) as the kernel forms them: per block and
    k tile, the A tile from the cp.async rows (each thread's chunk column
    and rows, the (tap, channel) of its chunk once a k tile) or from the
    input window of a patch (runs of k Cin bytes), the B tile of the N
    tile, their product, and the staged rows stored at the pixels they
    map to. Asserts every output is written once."""
    b, cin, h, w = x.shape
    cout = wpk.shape[0]
    p = q1_plan(b, h, w, cin, cout, k, stride, aligned, sms)
    pad = (k - 1) // 2
    ho, wo = out_hw(h, w, k, stride)
    m_total, kk = b * ho * wo, k * k * cin
    xn = x.permute(0, 2, 3, 1).reshape(-1).numpy().astype(np.int64)
    wn = wpk.numpy().astype(np.int64)
    out = np.zeros((m_total, cout), np.int64)
    count = np.zeros((m_total, cout), np.int64)
    cpr = p.bk // 16
    for bx in range(p.grid[0]):
        if p.patch:
            tx = bx % cdiv(wo, p.tc)
            ty = bx // cdiv(wo, p.tc) % cdiv(ho, p.tr)
            img = bx // cdiv(wo, p.tc) // cdiv(ho, p.tr)
            oy0, ox0 = ty * p.tr, tx * p.tc
            wcb = p.wc * cin
            win = np.zeros((p.wr, wcb), np.int64)
            iy0, ix0 = oy0 * stride - pad, ox0 * stride - pad
            lo, hi = max(0, -ix0) * cin, min(p.wc, w - ix0) * cin
            for r in range(p.wr):
                if 0 <= iy0 + r < h and hi > lo:
                    row0 = ((img * h + iy0 + r) * w + ix0) * cin
                    win[r, lo:hi] = xn[row0 + lo:row0 + hi]
            win = win.reshape(-1)
            rows = [(img * ho + oy0 + r // p.tc) * wo + ox0 + r % p.tc
                    if oy0 + r // p.tc < ho and ox0 + r % p.tc < wo else -1
                    for r in range(p.bm)]
        else:
            rows = [bx * p.bm + r if bx * p.bm + r < m_total else -1
                    for r in range(p.bm)]
        a = np.zeros((p.bm, p.kp), np.int64)
        for kt in range(p.kp // p.bk):
            if not p.patch:
                rstep = p.threads // cpr
                for tid in range(p.threads):
                    col = tid % cpr
                    k0 = kt * p.bk + col * 16
                    if k0 >= kk:
                        continue
                    tap, ci = divmod(k0, cin)
                    ky, kx = divmod(tap, k)
                    for j in range(p.bm // rstep):
                        r = tid // cpr + j * rstep
                        if rows[r] < 0:
                            continue
                        ox = rows[r] % wo
                        oy = rows[r] // wo % ho
                        bi = rows[r] // wo // ho
                        iy = oy * stride - pad + ky
                        ix = ox * stride - pad + kx
                        if 0 <= iy < h and 0 <= ix < w:
                            at = ((bi * h + iy) * w + ix) * cin + ci
                            a[r, k0:k0 + 16] = xn[at:at + 16]
            else:
                # pieces of runs of k cin window bytes, found once a chunk
                # column, read at each row's window offset
                run = k * cin
                slack = np.concatenate([np.zeros(32, np.int64), win,
                                        np.zeros(32, np.int64)])
                for c in range(cpr):
                    k0 = kt * p.bk + c * 16
                    end = min(16, kk - k0)
                    pieces, pos, ky = [], 0, k0 // run
                    while pos < end:
                        j = k0 + pos - ky * run
                        n = min(end - pos, run - j)
                        pieces.append((ky * wcb + j - pos, pos, pos + n))
                        pos, ky = pos + n, ky + 1
                    assert len(pieces) <= 3
                    for r in range(p.bm):
                        px = (r // p.tc) * stride * wcb + \
                            (r % p.tc) * stride * cin
                        for off, lo, hi in pieces:
                            d = px + off + 32
                            a[r, k0 + lo:k0 + hi] = slack[d + lo:d + hi]
        for by in range(p.grid[1]):
            n0 = by * p.bn
            bt = np.zeros((p.bn, p.kp), np.int64)
            bt[:min(p.bn, cout - n0)] = wn[n0:n0 + p.bn]
            d = a @ bt.T
            for r, m in enumerate(rows):
                if m >= 0:
                    ncols = min(p.bn, cout - n0)
                    out[m, n0:n0 + ncols] = d[r, :ncols]
                    count[m, n0:n0 + ncols] += 1
    assert (count == 1).all()
    return out


def emulate_q2(x, wpk, k, stride, aligned=True):
    """Q2's int32 sums (M, C) as the kernel forms them: per block, the
    halo of its tile and channel group in 16-channel chunks (zeros
    outside the image and past C), then each thread's 16 channels over
    the k^2 taps."""
    b, c, h, w = x.shape
    p = q2_plan(b, h, w, c, k, stride, aligned)
    pad = (k - 1) // 2
    ho, wo = out_hw(h, w, k, stride)
    tpp = p.cg // 16
    xn = x.permute(0, 2, 3, 1).numpy().astype(np.int64)
    wn = wpk.numpy().astype(np.int64)
    out = np.zeros((b, ho, wo, c), np.int64)
    count = np.zeros((b, ho, wo, c), np.int64)
    for bx in range(p.grid[0]):
        tx = bx % cdiv(wo, p.tw)
        ty = bx // cdiv(wo, p.tw) % cdiv(ho, p.th)
        img = bx // cdiv(wo, p.tw) // cdiv(ho, p.th)
        for by in range(p.grid[1]):
            c0 = by * p.cg
            halo = np.zeros((p.hr, p.hc, p.cg), np.int64)
            wts = np.zeros((k * k, p.cg), np.int64)
            cn = min(p.cg, c - c0)
            for hy in range(p.hr):
                for hx in range(p.hc):
                    iy = ty * p.th * stride - pad + hy
                    ix = tx * p.tw * stride - pad + hx
                    if 0 <= iy < h and 0 <= ix < w:
                        halo[hy, hx, :cn] = xn[img, iy, ix, c0:c0 + cn]
            wts[:, :cn] = wn[:, c0:c0 + cn]
            for tid in range(256):
                sub, px = tid % tpp, tid // tpp
                py, px = px // p.tw, px % p.tw
                oy, ox = ty * p.th + py, tx * p.tw + px
                cc = c0 + 16 * sub
                if oy >= ho or ox >= wo or cc >= c:
                    continue
                acc = np.zeros(16, np.int64)
                for ky in range(k):
                    for kx in range(k):
                        acc += halo[py * stride + ky, px * stride + kx,
                                    16 * sub:16 * sub + 16] * \
                            wts[ky * k + kx, 16 * sub:16 * sub + 16]
                n = min(16, c - cc)
                out[img, oy, ox, cc:cc + n] = acc[:n]
                count[img, oy, ox, cc:cc + n] += 1
    assert (count == 1).all()
    return out.reshape(-1, c)


def _codes(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


@pytest.mark.parametrize("case", [
    # (B, Cin, Cout, H, W, k, stride, aligned, sms)
    (1, 3, 32, 13, 15, 6, 2, True, 132),     # the stem, odd W
    (2, 3, 32, 9, 11, 3, 1, True, 132),      # yolov3's first conv, K 27
    (1, 24, 40, 7, 5, 3, 2, True, 132),      # Cin 24: patch, N 64
    (1, 64, 128, 7, 5, 3, 2, False, 132),    # unaligned codes: patch
    (1, 16, 32, 5, 6, 1, 1, True, 132),      # K 16 in a 32-byte tile
    (1, 48, 24, 12, 13, 1, 1, True, 1),      # K 48 in a 64-byte tile
    (1, 16, 128, 12, 13, 3, 2, True, 1),     # N 64 x 2, K 144 (2 k tiles)
    (1, 32, 128, 12, 13, 3, 1, True, 1),     # BM 128, N 128, 3 k tiles
    (1, 128, 264, 3, 4, 1, 1, True, 132),    # two N tiles, a ragged one
    (2, 32, 72, 6, 5, 3, 1, True, 132),      # N 128 for Cout 72
])
def test_q1_emulated_tiles_match_plain_sums(case):
    b, cin, cout, h, w, k, stride, aligned, sms = case
    gen = torch.Generator().manual_seed(sum(case[:7]))
    x = _codes(gen, b, cin, h, w)
    wpk = pack_weight(_codes(gen, cout, cin, k, k))
    want = plain_sums(x, wpk, k, stride).permute(0, 2, 3, 1)
    got = emulate_q1(x, wpk, k, stride, aligned, sms)
    np.testing.assert_array_equal(got, want.reshape(-1, cout).long().numpy())


@pytest.mark.parametrize("case", [
    # (B, C, H, W, stride, aligned)
    (1, 16, 9, 11, 1, True), (2, 24, 15, 17, 2, True),
    (1, 40, 9, 11, 1, True), (1, 64, 27, 25, 2, False),
    (1, 128, 5, 7, 1, True),
])
def test_q2_emulated_tiles_match_plain_sums(case):
    b, c, h, w, stride, aligned = case
    gen = torch.Generator().manual_seed(sum(case[:5]))
    x = _codes(gen, b, c, h, w)
    wpk = pack_dw_weight(_codes(gen, c, 1, 3, 3))
    want = plain_sums(x, wpk, 3, stride, True).permute(0, 2, 3, 1)
    got = emulate_q2(x, wpk, 3, stride, aligned)
    np.testing.assert_array_equal(got, want.reshape(-1, c).long().numpy())
