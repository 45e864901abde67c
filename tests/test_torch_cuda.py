"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`; each test skips when no CUDA device is present. Imports no
JAX, so on a machine without it run them past the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 float32 at 1e-4 + 1e-6 |ref| (108-term sums reassociated),
bf16 within one bf16 ulp, plus for the tensor-core path (uint8 and bf16
images) 2^-19 of |scale| sum |x w| (`chip_smoke.stem_limit`: the tensor
core truncates the sums it forms); K2 bit-equal keep masks at any K; K3 and K4 as
`chip_smoke.check_conv_bwd` states them (relative to each output's sum
of |terms|); K5, fused and single-pass, bit-equal to its plain versions;
Q1 and Q2 (`-k int8`) as `chip_smoke.check_int8_conv` states them (sums
exact, float32 within 4 ulp, bf16 one ulp, requantized codes off by 1 on at
most 1e-4 of them); the card's
augmentation
against the CPU's on the same draws as `chip_smoke.augment_card_vs_cpu`
states them.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    INT8_MAX_TOL,
    INT8_RMS_TOL,
    affine_shifts,
    augment_card_vs_cpu,
    anchor_scores,
    assert_detections_match,
    check_conv_bwd,
    check_int8_conv,
    conv_bwd_case,
    gap_threshold,
    int8_conv_shapes,
    int8_raw,
    nms_edge_cases,
    q_inputs,
    raw_close,
    random_boxes,
    shear_edge_shifts,
    spread_scores,
    stem_limit,
    synthetic_tiles,
    warp_grid,
    xy_shifts,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stem_inputs(rng, c, cuda):
    wb = torch.from_numpy(rng.uniform(-0.1, 0.1, (c, 3, 6, 6)).astype(
        np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).to(cuda)
    return wb, scale, bias


def _check_stem(x, wb, scale, bias, act):
    from yolox_tpu_torch.ops.stem import (
        stem_conv_bn_act,
        stem_conv_bn_act_plain,
    )

    b, h, w, _ = x.shape
    for out_dtype in (torch.float32, torch.bfloat16):
        before = stem_conv_bn_act.launches
        got = stem_conv_bn_act(x, wb, scale, bias, act, out_dtype)
        assert stem_conv_bn_act.launches == before + 1
        ref = stem_conv_bn_act_plain(x, wb, scale, bias, act, out_dtype)
        torch.cuda.synchronize()
        assert got.shape == (b, wb.shape[0], h // 2, w // 2)
        assert got.dtype == out_dtype
        err = (got.float() - ref.float()).abs()
        assert (err <= stem_limit(x, wb, scale, ref.float(), out_dtype)).all()


@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
@pytest.mark.parametrize("c,h,w", [(32, 64, 96), (48, 34, 70), (8, 2, 2),
                                   (16, 64, 96), (24, 34, 70), (80, 64, 96),
                                   (20, 416, 416), (200, 34, 70)])
@pytest.mark.parametrize("in_dtype", ["uint8", "float32", "bfloat16"])
def test_stem_kernel_matches_plain(cuda, in_dtype, c, h, w, act):
    """uint8 and bf16 images take the tensor-core path, float32 ones (here
    with fractional pixels) the CUDA-core loop; C 20 masks a partial n
    tile, C 200 takes a second weight slab of 72 channels, 35 x 17 and
    208 x 208 outputs ragged tiles."""
    rng = np.random.default_rng(c + h)
    img = rng.integers(0, 256, (2, h, w, 3)).astype(np.float32)
    if in_dtype == "float32":
        img += rng.uniform(0, 1, img.shape).astype(np.float32)
    x = torch.from_numpy(img).to(cuda, getattr(torch, in_dtype))
    _check_stem(x, *_stem_inputs(rng, c, cuda), act)


@pytest.mark.parametrize("in_dtype", ["uint8", "bfloat16"])
@pytest.mark.parametrize("c", [16, 32, 64, 80, 200])
def test_stem_kernel_bf16_weights(cuda, in_dtype, c):
    """bf16-exact weights (a bf16 model's): one product a tap instead of
    three, the same result."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.integers(0, 256, (2, 130, 258, 3),
                                      dtype=np.uint8)).to(
        cuda, getattr(torch, in_dtype))
    wb, scale, bias = _stem_inputs(rng, c, cuda)
    _check_stem(x, wb.bfloat16().float(), scale, bias, "silu")


@pytest.mark.parametrize("k,b", [(1, 4), (37, 4), (128, 4), (1000, 4),
                                 (1024, 4), (1024, 64), (1025, 16),
                                 (2048, 8), (4096, 4), (8400, 2)])
def test_nms_kernel_matches_plain(cuda, k, b):
    """Any K: past 1024 the mask leaves shared memory (pass A writes it to
    global memory, pass B stages it through the shared ring)."""
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(random_boxes(rng, b, k)).to(cuda)
    scattered = torch.from_numpy(rng.random((b, k)) > 0.2).to(cuda)
    cut = np.resize(np.array([0, 1, k // 2, k]), (b, 1))
    prefix = torch.arange(k, device=cuda)[None] < torch.from_numpy(cut).to(
        cuda)
    for valid in (scattered, prefix):
        for thr in (0.3, 0.65):
            got = nms_keep(boxes, valid, thr)
            assert torch.equal(got, nms_keep_plain(boxes, valid, thr))


@pytest.mark.parametrize("k,rows,group", [
    (1025, 1, None), (1025, 8, 4), (1025, 32, 2), (8400, 16, 4),
    (8400, 1, 1), (1024, None, 2), (2048, None, 4), (1300, 2, 2)])
def test_nms_kernel_forced_ring_sizes(cuda, k, rows, group):
    """The smaller rings that large K gets and each number G of row tiles
    a block, forced at sizes the plain version can check."""
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    rng = np.random.default_rng(k + (rows or 0))
    boxes = torch.from_numpy(random_boxes(rng, 2, k)).to(cuda)
    valid = torch.from_numpy(rng.random((2, k)) > 0.1).to(cuda)
    assert torch.equal(nms_keep(boxes, valid, 0.5, rows, group),
                       nms_keep_plain(boxes, valid, 0.5))


def test_nms_kernel_is_deterministic(cuda):
    from yolox_tpu_torch.ops.nms_kernel import nms_keep

    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(random_boxes(rng, 32, 1024)).to(cuda)
    valid = torch.ones((32, 1024), dtype=torch.bool, device=cuda)
    first = nms_keep(boxes, valid, 0.65)
    for _ in range(5):
        assert torch.equal(nms_keep(boxes, valid, 0.65), first)


def test_nms_kernel_edge_cases(cuda):
    from yolox_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    boxes, valid = (torch.from_numpy(a).to(cuda) for a in nms_edge_cases())
    for thr in (0.0, 0.5, 0.65, 1.0):
        assert torch.equal(nms_keep(boxes, valid, thr),
                           nms_keep_plain(boxes, valid, thr))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from yolox_tpu_torch.ops.nms_kernel import nms_keep
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act

    boxes = torch.zeros((1, 1025, 4), device=cuda)
    ones = torch.ones((1, 1025), dtype=torch.bool, device=cuda)
    # K = 1025 is taken (the old kernel's 1024 limit is gone): all-zero
    # boxes have IoU 0, so every valid box is kept
    assert torch.equal(nms_keep(boxes, ones, 0.5), ones)
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(torch.zeros((1, 8, 8), device=cuda)[..., ::2], ones[:, :8],
                 0.5)
    with pytest.raises(ValueError, match="float32"):
        nms_keep(boxes[:, :8].double(), torch.ones((1, 8), dtype=torch.bool,
                                                   device=cuda), 0.5)
    x = torch.zeros((1, 64, 64, 3), dtype=torch.uint8, device=cuda)
    wb = torch.zeros((32, 3, 6, 6), device=cuda)
    sb = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="even"):
        stem_conv_bn_act(x[:, :63], wb, sb, sb)
    with pytest.raises(ValueError, match="float32"):
        stem_conv_bn_act(x, wb.double(), sb, sb)
    with pytest.raises(ValueError, match="contiguous"):
        stem_conv_bn_act(x.transpose(1, 2), wb, sb, sb)


# (Ci, Co, H, W) of yolox-s 1x1 convs at 640 px (dark2 CspLayer conv1,
# a head stem, dark5 SPP conv2), one with ragged tile edges, and shapes
# whose HW is no multiple of 8 (16-byte loads off): multiscale steps at
# 480 px (15x15, 30x30) and 800 px (25x25), and 416 px (13x13)
CONV_BWD_SHAPES = [(64, 32, 160, 160), (256, 128, 40, 40),
                   (1024, 512, 20, 20), (24, 40, 7, 9),
                   (1024, 512, 15, 15), (256, 128, 30, 30),
                   (512, 256, 25, 25), (64, 32, 13, 13)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci,co,h,w", CONV_BWD_SHAPES)
def test_conv_bwd_kernels_match_plain(cuda, ci, co, h, w, dtype):
    from yolox_tpu_torch.ops import conv_bwd as cb

    case = conv_bwd_case(ci + co, 2, ci, co, h, w, getattr(torch, dtype), cuda)
    before = (cb.reduce_sums.launches, cb.main_1x1.launches)
    check_conv_bwd(case)
    assert (cb.reduce_sums.launches, cb.main_1x1.launches) == (
        before[0] + 1, before[1] + 1)


def test_conv_bwd_kernels_read_channel_slices(cuda):
    """g_y as a channel slice of a concatenation's gradient (a batch
    stride larger than C*H*W) is read in place, with the same result."""
    from yolox_tpu_torch.ops import conv_bwd as cb

    case = conv_bwd_case(5, 3, 32, 16, 12, 12, torch.float32, cuda)
    wide = torch.randn((3, 48, 12, 12), device=cuda)
    wide[:, 16:32] = case["g_y"]
    case["g_y"] = wide[:, 16:32]
    assert not case["g_y"].is_contiguous()
    check_conv_bwd(case)
    with pytest.raises(ValueError, match="dtype"):
        cb.reduce_sums(case["z"].double(), case["g_y"].double(),
                       case["gamma"], case["beta"], case["mean"],
                       case["inv"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bwd_kernels_single_image(cuda, dtype):
    check_conv_bwd(conv_bwd_case(7, 1, 512, 256, 20, 20, getattr(torch, dtype),
                                 cuda))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bwd_kernels_read_unaligned_views(cuda, dtype):
    """z a channel slice starting at channel 3 of HW = 100 (an offset of
    300 elements), g_y and x views one element into their storage: the
    kernels take their masked element loads, with the same result."""
    from yolox_tpu_torch.ops import conv_bwd as cb

    dt = getattr(torch, dtype)
    case = conv_bwd_case(11, 3, 64, 32, 10, 10, dt, cuda)
    wide = torch.zeros((3, 40, 10, 10), dtype=dt, device=cuda)
    wide[:, 3:35] = case["z"]
    case["z"] = wide[:, 3:35]
    for k in ("g_y", "x"):
        t = case[k]
        flat = torch.zeros(1 + t.numel(), dtype=dt, device=cuda)
        flat[1:] = t.reshape(-1)
        case[k] = flat[1:].view(t.shape)
        assert case[k].data_ptr() % 16 != 0
    assert cb.vector_width(case["x"].element_size(), (100,),
                           (case["g_y"].data_ptr(),)) == 1
    check_conv_bwd(case)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bwd_kernels_are_deterministic(cuda, dtype):
    """Two calls give bit-equal S1/S2, coefficient table, g_x and g_W, and
    the table equals the torch expressions on the kernel's sums."""
    from yolox_tpu_torch.ops import conv_bwd as cb

    c = conv_bwd_case(3, 8, 1024, 512, 20, 20, getattr(torch, dtype), cuda)
    args = (c["z"], c["g_y"], c["gamma"], c["beta"], c["mean"], c["inv"])
    runs = []
    for _ in range(2):
        s, coeff = cb.reduce_sums(*args, coeff=True)
        runs.append((s.clone(), coeff.clone())
                    + cb.main_1x1(c["x"], c["z"], c["g_y"], c["w"], coeff))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    s, coeff = runs[0][:2]
    assert torch.equal(s, cb.reduce_sums(*args))
    assert torch.equal(coeff, cb.coeff_table(s, 8 * 400, c["gamma"],
                                             c["beta"], c["mean"], c["inv"]))


def test_serve_on_cuda_matches_cpu(cuda):
    from yolox_tpu_torch import Yolox, YoloxConfig, YoloxModule, YoloxProcessor

    cfg = YoloxConfig.get_named_config("yolox_nano")
    cfg.test_size = (256, 256)
    cpu_mod = spread_scores(
        YoloxModule.from_config(cfg, rng_seed=3, device="cpu"),
        np.random.default_rng(4).integers(0, 256, (2, 256, 256, 3),
                                          dtype=np.uint8))
    gpu_mod = YoloxModule.from_config(cfg, rng_seed=3)
    gpu_mod.load_params(cpu_mod.state_dict())
    frames = [np.random.default_rng(5 + i).integers(
        0, 256, (256, 256, 3), dtype=np.uint8) for i in range(3)]
    thr, gap = gap_threshold(anchor_scores(cpu_mod, np.stack(frames)), 0.1,
                             0.3)
    assert gap > 1e-3
    got = Yolox(gpu_mod, YoloxProcessor(cfg))(frames, threshold=thr)
    want = Yolox(cpu_mod, YoloxProcessor(cfg))(frames, threshold=thr)
    assert sum(len(d["labels"]) for d in want) > 10
    assert_detections_match(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("px", [1, 3])
@pytest.mark.parametrize("shifts", ["affine", "random", "edge"])
def test_shear_kernel_matches_plain(cuda, shifts, px, dtype):
    from yolox_tpu_torch.ops.shear_kernel import shear_x, shear_x_plain

    rng = np.random.default_rng(px)
    b, h, w, out_w = 3, 200, 333, 250       # ragged against 256 threads
    k_max = w - out_w - 2
    img = torch.from_numpy(rng.uniform(0, 255, (b, h, w * px)).astype(
        np.float32)).to(cuda, getattr(torch, dtype))
    s = {"affine": lambda: affine_shifts(rng, b, h, k_max / 2),
         "random": lambda: rng.uniform(-3, k_max + 4, (b, h)),
         "edge": lambda: shear_edge_shifts(b, h, k_max)}[shifts]()
    s = torch.from_numpy(np.asarray(s, np.float32)).to(cuda)
    before = shear_x.launches
    got = shear_x(img, s, out_w, px)
    assert shear_x.launches == before + 1
    ref = shear_x_plain(img, s, out_w, px)
    torch.cuda.synchronize()
    assert got.dtype == img.dtype and got.shape == (b, h, out_w * px)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [416, 640])
@pytest.mark.parametrize("shifts", ["affine", "random", "edge"])
def test_shear_xy_kernel_matches_plain(cuda, shifts, size, dtype):
    """The fused K5 at the warp's shapes (B 2): one launch, bit-equal to
    the two single-pass shears with a transpose between them."""
    from yolox_tpu_torch.ops.shear_kernel import shear_xy, shear_xy_plain

    rng = np.random.default_rng(size)
    margin, wr = warp_grid(size)
    h1t = torch.from_numpy(rng.uniform(0, 255, (2, wr, wr * 3)).astype(
        np.float32)).to(cuda, getattr(torch, dtype))
    sy, sx = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
              for a in xy_shifts(rng, shifts, 2, wr, wr, size, margin))
    before = shear_xy.launches
    got = shear_xy(h1t, sy, sx, size, 3)
    assert shear_xy.launches == before + 1
    ref = shear_xy_plain(h1t, sy, sx, size, 3)
    torch.cuda.synchronize()
    assert got.dtype == h1t.dtype and got.shape == (2, size, size * 3)
    assert torch.equal(got, ref)


def test_shear_xy_kernel_raises_on_what_it_does_not_take(cuda):
    from yolox_tpu_torch.ops.shear_kernel import shear_xy

    h1t = torch.zeros((2, 12, 24), device=cuda)
    sy, sx = torch.zeros((2, 12), device=cuda), torch.zeros((2, 8),
                                                            device=cuda)
    with pytest.raises(ValueError, match="px must be 1 or 3"):
        shear_xy(h1t, sy, sx, 8, px=2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        shear_xy(h1t.double(), sy, sx, 8, px=2)
    with pytest.raises(ValueError, match="shifts must be float32"):
        shear_xy(h1t[..., :12].contiguous(), sy.double(), sx, 8, px=1)
    with pytest.raises(ValueError, match="contiguous"):
        shear_xy(h1t[..., :12], sy, sx, 8, px=1)


def test_shear_kernel_raises_on_what_it_does_not_take(cuda):
    from yolox_tpu_torch.ops.shear_kernel import shear_x

    img = torch.zeros((2, 8, 60), device=cuda)
    s = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError, match="out_w"):
        shear_x(img, s, 19, px=3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        shear_x(img.double(), s, 10, px=3)
    with pytest.raises(ValueError, match="shifts must be float32"):
        shear_x(img, s.double(), 10, px=3)
    with pytest.raises(ValueError, match="contiguous"):
        shear_x(img.transpose(0, 1), s.t(), 10, px=3)


def test_augmented_step_on_cuda(cuda):
    """The card's augmentation against the CPU's on one set of draws, and
    one augmented step of a small model on the card: the fused K5 once,
    the single-pass one never."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.core import (
        init_train_state,
        make_augmented_train_step,
    )
    from yolox_tpu_torch.data import sample_augment_draws
    from yolox_tpu_torch.ops.shear_kernel import shear_x, shear_xy

    s = 128
    tiles, hw, labels = (torch.from_numpy(a) for a in synthetic_tiles(
        np.random.default_rng(0), 2, size=s, max_labels=8, num_classes=8))
    draws = sample_augment_draws(2, torch.Generator().manual_seed(1), (s, s))
    augment_card_vs_cpu(tiles, hw, labels, draws, s)

    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.depth, cfg.width, cfg.num_classes = 0.33, 0.125, 8
    module = YoloxModule.from_config(cfg, rng_seed=0, device=cuda)
    state = init_train_state(module)
    step = make_augmented_train_step(module, 8, compute_dtype=torch.bfloat16,
                                     fused_bwd=True)
    before = (shear_xy.launches, shear_x.launches)
    state, losses = step(state, tiles, hw, labels,
                         torch.Generator(device=cuda).manual_seed(2), 0.01,
                         (s, s), (96, 96))
    torch.cuda.synchronize()
    assert (shear_xy.launches, shear_x.launches) == (before[0] + 1,
                                                     before[1])
    assert all(torch.isfinite(v).all() for v in losses.values())


def test_prefetcher_copies_pinned_batches(cuda):
    """With `pin_memory` the training loader hands over pinned batches
    (pinned in the torch loader's thread), and `DevicePrefetcher` copies
    them to the card unchanged."""
    from yolox_tpu_torch.data import DataLoader, DevicePrefetcher

    rng = np.random.default_rng(3)
    items = [(rng.integers(0, 256, (32, 32, 3)).astype(np.float32),
              rng.uniform(0, 32, (6, 5)).astype(np.float32), (32, 32), i)
             for i in range(8)]
    loader = DataLoader(items, batch_sampler=[[0, 1, 2, 3], [4, 5, 6, 7]],
                        num_workers=0, pin_memory=True)
    host = list(loader)
    assert all(b[0].is_pinned() and b[1].is_pinned() for b in host)
    got = list(DevicePrefetcher(loader, cuda))
    torch.cuda.synchronize()
    assert len(got) == 2
    for (gi, gt, ginfo, gid), (hi, ht, hinfo, hid) in zip(got, host):
        assert gi.device.type == "cuda" and gt.device.type == "cuda"
        assert torch.equal(gi.cpu(), hi) and torch.equal(gt.cpu(), ht)
        assert ginfo == hinfo and gid == hid


@pytest.mark.parametrize("case", [
    (2, 64, 128, 40, 40, 3, 1, 0), (2, 64, 128, 41, 39, 3, 2, 0),
    (1, 3, 32, 64, 62, 6, 2, 0), (2, 3, 32, 33, 35, 3, 1, 0),
    (2, 16, 32, 21, 19, 1, 1, 0), (2, 48, 96, 17, 19, 3, 2, 0),
    (1, 256, 512, 20, 20, 1, 1, 0), (1, 24, 40, 13, 11, 3, 1, 0),
    (2, 64, 72, 9, 7, 3, 2, 1), (1, 32, 24, 5, 3, 3, 2, 7),
    (3, 32, 64, 11, 13, 3, 1, 0), (2, 32, 24, 9, 9, 1, 1, 0),
    (2, 64, 40, 9, 11, 3, 1, 0), (2, 32, 72, 10, 10, 3, 2, 0),
    (2, 128, 264, 10, 9, 1, 1, 0), (1, 256, 264, 20, 20, 3, 1, 0),
    (2, 112, 64, 9, 9, 1, 1, 0), (2, 16, 64, 9, 9, 3, 1, 0),
    (2, 80, 32, 7, 9, 1, 1, 0), (2, 48, 24, 15, 13, 1, 1, 0),
    (1, 3, 32, 63, 65, 6, 2, 0), (2, 3, 16, 31, 45, 6, 2, 0),
    (1, 128, 128, 20, 20, 3, 1, 0), (2, 64, 128, 17, 15, 3, 1, 5),
    (2, 32, 5, 9, 7, 1, 1, 0)])
def test_int8_conv_q1_matches_plain(cuda, case):
    """Q1 on odd and unaligned shapes (the last field is the codes' byte
    offset: no 16-byte rows): M a multiple of neither BM (429), Cout 24 /
    40 / 72 padded to an N tile and 264 in two, K just under and over a
    k tile (112, 144; 48, 80), the 3-channel stem at odd W, B 1 at
    20x20, unaligned codes (the window patch) and Cout 5 (stores of one
    output); float32, bf16 and requantized outputs and the unit-scale
    sums against the plain version, at `chip_smoke.check_int8_conv`'s
    tolerances, each launch repeated bit-equal; the launch counter moves
    once per call."""
    from yolox_tpu_torch.ops.int8_conv import int8_conv

    b, cin, cout, h, w, k, stride, offset = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    x, w8, scale, bias, out_scale = q_inputs(gen, b, cin, cout, h, w, k,
                                             offset=offset)
    before = int8_conv.launches
    for act in ("silu", "lrelu"):
        check_int8_conv(x, w8, scale, bias, k, stride, out_scale, False, act)
    assert int8_conv.launches == before + 16


@pytest.mark.parametrize("case", [(2, 16, 52, 52, 1, 0), (2, 64, 27, 25, 2, 0),
                                  (8, 128, 13, 13, 1, 0), (1, 24, 9, 7, 2, 3),
                                  (3, 64, 11, 13, 1, 0), (1, 40, 9, 11, 1, 0),
                                  (2, 72, 7, 9, 1, 0), (1, 64, 20, 20, 1, 0),
                                  (1, 128, 13, 13, 2, 9),
                                  (2, 16, 208, 208, 2, 0)])
def test_int8_dwconv_q2_matches_plain(cuda, case):
    """Q2 (depthwise 3x3) likewise: channel groups cut by C (24, 40, 72),
    M odd, B 1 at 20x20, unaligned codes, nano's widest stride-2 conv."""
    from yolox_tpu_torch.ops.int8_conv import int8_dwconv

    b, c, h, w, stride, offset = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    x, w8, scale, bias, out_scale = q_inputs(gen, b, c, c, h, w, 3, True,
                                             offset)
    before = int8_dwconv.launches
    check_int8_conv(x, w8, scale, bias, 3, stride, out_scale, True)
    assert int8_dwconv.launches == before + 8


def test_int8_epilogue_is_its_defining_arithmetic(cuda):
    """The kernels' branch-free SiLU equals y / (1 + exp(-y)) in float64
    rounded once, and their branch-free requant clamp(rint(__fdiv_rn(y,
    s)), -127, 127) at eight scales s, on every float input (NaN equal to
    NaN)."""
    from yolox_tpu_torch.ops.int8_conv import epilogue_mismatches

    assert epilogue_mismatches(cuda) == 0


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from yolox_tpu_torch.ops.int8_conv import int8_conv, pack_weight

    x = torch.zeros(1, 16, 8, 8, dtype=torch.int8, device=cuda)
    w = pack_weight(torch.zeros(8, 16, 3, 3, dtype=torch.int8, device=cuda))
    one, zero = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        int8_conv(x.float(), w, one, zero, 3, 1, "silu")
    with pytest.raises(ValueError, match="weights"):
        int8_conv(x, w, one, zero, 1, 1, "silu")  # packed for k 3
    with pytest.raises(ValueError, match="scale"):
        int8_conv(x, w, one.double(), zero, 3, 1, "silu")
    with pytest.raises(ValueError, match="output dtype"):
        int8_conv(x, w, one, zero, 3, 1, "silu", torch.float16)
    with pytest.raises(AttributeError):
        int8_conv(x, w, one, zero, 3, 1, "gelu")
    # a shape Q1's plan refuses: 1x1 on 3 channels (window runs < 8 bytes)
    x3 = torch.zeros(1, 3, 8, 8, dtype=torch.int8, device=cuda)
    w3 = pack_weight(torch.zeros(8, 3, 1, 1, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="runs"):
        int8_conv(x3, w3, one, zero, 1, 1, "silu")


def test_int8_serve_on_cuda_matches_cpu(cuda):
    """A narrow yolox-s (width 0.125) served int8 on the card, both modes,
    against the CPU port at `chip_smoke`'s card-against-CPU tolerances;
    Q1 runs once per dense BaseConv (the ladder's stem included), K1 in
    the HBM mode only."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.ops.int8_conv import int8_conv
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act

    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.width = 0.125
    x = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3),
                                          dtype=np.uint8)
    cpu_mod = spread_scores(YoloxModule.from_config(cfg, device="cpu"), x)
    table = cpu_mod.calibrate_int8(x)
    gpu_mod = YoloxModule.from_config(cfg, device=cuda)
    gpu_mod.load_params(cpu_mod.state_dict())
    n_q1 = sum(int8_conv_shapes(cpu_mod, 128, 2).values())
    for mode in ("ladder", "hbm"):
        rms, mx = raw_close(int8_raw(gpu_mod, x, mode, table),
                            int8_raw(cpu_mod, x, mode, table))
        assert rms <= INT8_RMS_TOL and mx <= INT8_MAX_TOL, (mode, rms, mx)
        before = (int8_conv.launches, stem_conv_bn_act.launches)
        kw = {"int8_qtab" if mode == "ladder" else "int8_hbm_qtab": table}
        dets, valid = gpu_mod.serve(x, conf_thre=0.3, **kw)
        torch.cuda.synchronize()
        hbm = mode == "hbm"
        assert (int8_conv.launches - before[0],
                stem_conv_bn_act.launches - before[1]) == (n_q1 - hbm, hbm)
        assert torch.isfinite(dets[valid]).all()


class _OneOp(torch.nn.Module):
    """One kernel wrapper as a module, for `torch.export`."""

    def __init__(self, fn, *consts):
        super().__init__()
        self.fn, self.consts = fn, consts

    def forward(self, x, *rest):
        return self.fn(x, *rest, *self.consts)


@pytest.mark.parametrize("kernel", ["stem", "nms", "int8_conv",
                                    "int8_dwconv"])
def test_exported_operator_equals_direct_launch(cuda, kernel):
    """K1, K2, Q1 and Q2 exported alone: the program holds the operator,
    runs the kernel (its counter advances by one a call) and returns what
    the direct launch does, bit for bit."""
    from yolox_tpu_torch.ops import int8_conv as q
    from yolox_tpu_torch.ops import nms_kernel, stem
    from yolox_tpu_torch.ops.library import exported_ops

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=cuda).manual_seed(3)
    if kernel == "stem":
        wb, scale, bias = _stem_inputs(rng, 32, cuda)
        args = (torch.randint(0, 256, (2, 64, 96, 3), generator=gen,
                              device=cuda, dtype=torch.uint8),)
        mod = _OneOp(stem.stem_conv_bn_act, wb, scale, bias)
        counter, direct = stem.stem_conv_bn_act, \
            lambda x: stem.stem_conv_bn_act.direct(x, wb, scale, bias)
    elif kernel == "nms":
        boxes = torch.from_numpy(random_boxes(rng, 2, 300)).to(cuda)
        args = (boxes, torch.ones(2, 300, dtype=torch.bool, device=cuda))
        mod = _OneOp(nms_kernel.nms_keep, 0.5)
        counter, direct = nms_kernel.nms_keep, \
            lambda b, v: nms_kernel.nms_keep.direct(b, v, 0.5)
    else:
        dw = kernel == "int8_dwconv"
        x, w, scale, bias, out_scale = q_inputs(gen, 2, 64, 64, 20, 24, 3,
                                                dw)
        fn = q.int8_dwconv if dw else q.int8_conv
        args = (x,)
        mod = _OneOp(fn, w, scale, bias, 3, 1, "silu", torch.float32,
                     out_scale)
        counter = fn
        direct = lambda x: fn.direct(x, w, scale, bias, 3, 1, "silu",  # noqa
                                     torch.float32, out_scale)
    with torch.no_grad():
        program = torch.export.export(mod, args, strict=False)
    name = {"stem": "stem_conv_bn_act", "nms": "nms_keep"}.get(kernel, kernel)
    assert exported_ops(program)[name] == 1
    want = direct(*args)
    before = counter.launches
    got = program.module()(*args)
    assert counter.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


def test_spans_share_the_kernels_clock(cuda, tmp_path):
    """torch.profiler stamps the port's spans (`utils/trace.py`) on the
    clock of the device's kernels: over a few yolox-s B 8 serve calls,
    matched in order, every K1 kernel starts at or after the start of the
    `yolox.k1` span that launched it, and every K2 kernel after its
    `yolox.k2`."""
    import json
    import re

    from torch.profiler import ProfilerActivity, profile

    from yolox_tpu_torch import YoloxConfig, YoloxModule

    module = YoloxModule.from_config(YoloxConfig.get_named_config("yolox_s"),
                                     rng_seed=3, dtype=torch.bfloat16)
    x = np.random.default_rng(6).integers(0, 256, (8, 640, 640, 3),
                                          dtype=np.uint8)
    calls = 4
    module.serve(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            module.serve(x)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data

    def starts(cat, match):
        return sorted(float(e["ts"]) for e in events
                      if e.get("ph") == "X" and e.get("cat") == cat
                      and match(e.get("name", "")))

    for span, kernel in (("yolox.k1", r"stem_\w+_kernel"),
                         ("yolox.k2", r"nms_kernel")):
        spans = starts("user_annotation", lambda n, s=span: n == s)
        kernels = starts("kernel", re.compile(kernel).search)
        assert len(spans) == len(kernels) == calls, (span, spans, kernels)
        for s, k in zip(spans, kernels):
            assert k >= s, (span, s, k)


def _serve_module(name, x):
    """A seeded bfloat16 `name` with decisive scores on the batch x."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule

    cfg = YoloxConfig.get_named_config(name)
    cfg.test_size = x.shape[1:3]
    module = spread_scores(YoloxModule.from_config(cfg, rng_seed=3), x[:4])
    return module.cast_params(torch.bfloat16)


def test_queued_serve_calls_match_synced_ones(cuda):
    """Serve calls dispatched back to back, each batch staged
    (`utils/h2d.py`) while the calls before it still run, give the
    detections of the same calls each followed by a synchronize: the
    staging and device buffers are not reused under a queued call."""
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 256, (32, 640, 640, 3), dtype=np.uint8)
               for _ in range(2)]
    module = _serve_module("yolox_s", batches[0])
    order = [0, 1, 0, 1, 1, 0]

    def run(sync):
        out = []
        for i in order:
            out.append(module.serve(batches[i], conf_thre=0.1,
                                    max_det=256))
            if sync:
                torch.cuda.synchronize()
        return [(d.cpu(), v.cpu()) for d, v in out]

    run(True)
    synced, queued = run(True), run(False)
    assert sum(int(v.sum()) for _, v in synced) > 100
    for (sd, sv), (qd, qv) in zip(synced, queued):
        assert torch.equal(sv, qv) and torch.equal(sd, qd)
    for j, i in enumerate(order):
        assert torch.equal(synced[j][0], synced[order.index(i)][0])


def test_staged_copy_equals_its_source(cuda):
    """The staged route (`utils/h2d.to_device`) on a B 256 letterboxed
    uint8 batch and a float32 NCHW batch: bit-equal, contiguous NHWC,
    counted once each with its bytes."""
    from yolox_tpu_torch.models.yolox import _nhwc
    from yolox_tpu_torch.utils import h2d, trace

    rng = np.random.default_rng(12)
    u8 = rng.integers(0, 256, (256, 640, 640, 3), dtype=np.uint8)
    f32 = rng.uniform(0, 255, (8, 3, 640, 640)).astype(np.float32)
    for x, want in ((u8, u8), (f32, f32.transpose(0, 2, 3, 1))):
        before = trace.copy_counts()
        got = h2d.to_device(_nhwc(x), cuda)
        after = trace.copy_counts()
        assert got.device.type == "cuda" and got.is_contiguous()
        assert np.array_equal(got.cpu().numpy(), want)
        assert after["staged"] == before["staged"] + 1
        assert after["staged_bytes"] == before["staged_bytes"] + x.nbytes
        assert after["pinned_direct"] == before["pinned_direct"]


def test_serve_routes_are_counted(cuda):
    """A pageable batch of more than one chunk is staged, one of a single
    chunk copied by the driver, a pinned one copied directly, one on the
    device not copied; each serve call launches K1 and K2 once, and the
    routes of one batch give the same detections."""
    from yolox_tpu_torch.utils import h2d, trace

    x = np.random.default_rng(13).integers(0, 256, (16, 640, 640, 3),
                                           dtype=np.uint8)
    assert x.nbytes > h2d.CHUNK_BYTES >= x[:1].nbytes
    module = _serve_module("yolox_nano", x)
    module.serve(x)
    routes = {"staged": x, "pageable": x[:1],
              "pinned_direct": torch.from_numpy(x).pin_memory(),
              "device": torch.from_numpy(x).to(cuda)}
    outs = {}
    for route, src in routes.items():
        copies, launches = trace.copy_counts(), trace.launch_counts()
        outs[route] = module.serve(src, conf_thre=0.1)
        torch.cuda.synchronize()
        moved = {k: v - copies[k] for k, v in trace.copy_counts().items()
                 if v != copies[k]}
        want = {} if route == "device" else {route: 1}
        if route == "staged":
            want["staged_bytes"] = x.nbytes
        assert moved == want, route
        ran = {k: v - launches[k] for k, v in trace.launch_counts().items()}
        assert ran["stem_conv_bn_act"] == ran["nms_keep"] == 1, route
    del outs["pageable"]  # B 1: the convs may take other algorithms
    assert int(outs["staged"][1].sum()) > 100
    for route, (od, ov) in outs.items():
        assert torch.equal(od, outs["staged"][0]), route
        assert torch.equal(ov, outs["staged"][1]), route
