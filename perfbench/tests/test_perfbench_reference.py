"""The plain reference against the port's plain CPU path on a seeded small
yolox config (as `archs/yolox.py::small` cuts it, 64 px, float32), both
built through the architecture (`reference`, `program`): the forward, the
served detections and the letterbox. The comparison lives here, never in
the reference."""

import numpy as np
import pytest
import torch

from perfbench import cells, compare, images, serving
from perfbench.reference import postprocess
from perfbench_small import small_config

SIZE = 64


@pytest.fixture(scope="module")
def small():
    cfg = small_config("yolox_s", size=SIZE)
    arch = cells.arch(cfg)
    state = serving.make_state(cfg, 2 ** 31 + 99, "cpu")
    module, pcfg = arch.program(cfg, state, "cpu", torch.float32)
    ref = arch.reference(cfg)
    ref.load_state_dict(state)
    x = torch.from_numpy(np.stack(images.frames([(SIZE, SIZE)] * 3, 5,
                                                "cpu")))
    return cfg, state, module, pcfg, ref, x


def test_forward_matches_port(small):
    _, _, module, _, ref, x = small
    with torch.no_grad():
        got, want = module(x), ref.decoded(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_serve_detections_match_port(small):
    _, _, module, _, ref, x = small
    dets, valid = module.serve(x, conf_thre=0.3, nms_thre=0.65, max_det=64)
    prog = serving.rows_from_serve(dets.numpy(), valid.numpy())
    with torch.no_grad():
        dec = ref.decoded(x)
    for p, d in zip(prog, dec):
        gap_sum, box_off = compare.pair_gaps(p, d)
        assert gap_sum <= 1e-4 * max(len(p), 1) and box_off == 0
        required, lost = compare.missing(
            p, compare.candidate_rows(d, 0.3, 0.05), 0.3, 0.65, 64, 0.05,
            0.05)
        assert lost == 0
        want = postprocess.detect(d[None], 0.3, 0.65, 64)[0]
        assert len(want) == len(p)


@pytest.mark.parametrize("shape", [(480, 640), (375, 500), (500, 333),
                                   (640, 640)])
def test_letterbox_matches_port(shape):
    from yolox_tpu_torch.ops.preproc import preproc

    frame = images.frames([shape], 11, "cpu")[0]
    want, r_want = preproc(frame, (640, 640), dtype=np.uint8)
    got, r_got = postprocess.letterbox(frame, (640, 640))
    assert r_got == r_want
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
