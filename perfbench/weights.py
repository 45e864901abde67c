"""Seeded weights of a configuration, made on the device.

One `torch.Generator` on the device draws every floating tensor of the
state dict from one standard normal in one call; each tensor then takes
its slice at its own scale (`scales`), in the order of the reference
network's state dict, and the whole state is cast to the dtype the
configuration serves in. The same seed gives the same weights on either
side of a comparison: the program loads them, and the reference reads the
same tensors in float32.

`calibrate` then sets what a trained network has and a normal draw does
not, on a few calibration frames of the seed (CALIBRATION_SHAPES, each
letterboxed onto the input canvas), with the reference network
in float32: each BatchNorm's running statistics from the batch statistics
its input shows (jittered by BN_JITTER), so that every layer's output is
normalised down the published depth as in a trained network; and the
class bias so that the frames yield CANDIDATES_PER_IMAGE anchors over
the serving threshold on average, as an image of COCO holds some tens of
objects. Both sides of a comparison get the calibrated state; the
program takes no part in making it.

The scales (module constants; a configuration's `init` sets only its
`residual_gain`; which keys are stem and residual convs is the
architecture's, `perfbench/archs/<arch>.py`'s `STEM` and `RESIDUAL`):
  CONV_GAIN       every BaseConv weight ~ N(0, (gain / sqrt(fan_in))^2)
  STEM_GAIN       the stem convs', which read pixel values 0..255
  residual_gain   the second conv of each residual block
  (every k x k kernel (k > 1) but the stem's has taps summing to zero, so
  that no layer passes a frame's mean level on: a seeded network that did
  would score whole frames by how much letterbox padding they hold; the
  stem keeps its draw: on raw 0..255 pixels a zero-sum stem leaves a
  small difference of large sums)
  BN_JITTER, BN_GAMMA
                  BN weight gamma (1 + j z), bias gamma j z, running mean
                  j z, running variance exp(j z)
  REG_GAIN, REG_BIAS
                  the box conv (tx, ty, tw, th), calibrated like the
                  objectness and class convs: tw, th above 0 make boxes a
                  few strides wide, so that neighbouring anchors' boxes
                  overlap, as around an object
  OBJ_GAIN, OBJ_BIAS, CLS_GAIN
                  the head's objectness and class convs (the class bias
                  is calibrated to CANDIDATES_PER_IMAGE over
                  CALIBRATION_THRESHOLD)
"""

from __future__ import annotations

import math

import torch


CONV_GAIN = 1.414
STEM_GAIN = 0.02
BN_JITTER = 0.1
BN_GAMMA = 0.15
REG_GAIN, REG_BIAS = 0.3, (0.0, 0.0, 1.8, 1.8)
OBJ_GAIN, OBJ_BIAS = 1.0, 2.0
CLS_GAIN = 1.0
CANDIDATES_PER_IMAGE = 40
CALIBRATION_THRESHOLD = 0.5
# a BN channel's calibrated running variance is at least this share of
# its layer's median channel's
VAR_FLOOR = 0.01
# (h, w) of the calibration frames at a 640 px input (scaled to others)
CALIBRATION_SHAPES = ((480, 640), (640, 480), (427, 640), (640, 640)) * 4


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _scale(key: str, shape, init: dict, arch):
    """(multiplier, offset, kind, zero_sum) of the normal draw for one
    tensor; `arch.STEM` and `arch.RESIDUAL` name the stem and residual
    keys."""
    stem = arch.STEM.search(key) is not None
    # each k x k kernel (k > 1) but a stem's sums to zero over its taps:
    # the conv sees edges and texture, not a frame's mean level
    zero_sum = len(shape) == 4 and shape[2] * shape[3] > 1 and not stem
    return _draw(key, shape, init, arch, stem) + (zero_sum,)


def _draw(key: str, shape, init: dict, arch, stem: bool):
    fan = math.prod(shape[1:]) if len(shape) > 1 else 1
    for part in ("cls", "obj", "reg"):
        if f"head.{part}_preds." in key:  # scaled again by `calibrate`
            if key.endswith(".weight"):
                return 1.0 / math.sqrt(fan), 0.0, "plain"
            return 0.0, 0.0, "plain"
    j = BN_JITTER
    if key.endswith("conv.weight"):
        if stem:
            gain = STEM_GAIN
        elif arch.RESIDUAL.search(key):
            gain = init["residual_gain"]
        else:
            gain = CONV_GAIN
        return gain / math.sqrt(fan), 0.0, "plain"
    gamma = BN_GAMMA
    if key.endswith("bn.weight"):
        return j * gamma, gamma, "plain"
    if key.endswith("bn.bias"):
        return j * gamma, 0.0, "plain"
    if key.endswith("running_mean"):
        return j, 0.0, "plain"
    if key.endswith("running_var"):
        return j, 0.0, "exp"
    raise KeyError(f"no initialisation rule for {key}")


def seeded_state(shapes: dict, init: dict, seed: int, device,
                 dtype, arch) -> dict:
    """{key: tensor} for a reference state dict's `shapes` ({key: (shape,
    dtype)}) of the architecture `arch` (its STEM and RESIDUAL rules),
    made on `device` from `seed`."""
    floats = [(k, s) for k, (s, dt) in shapes.items() if dt.is_floating_point]
    total = sum(math.prod(s) for _, s in floats)
    z = torch.randn(total, generator=seed_generator(seed, device),
                    device=device, dtype=torch.float32)
    state, at = {}, 0
    for key, shape in floats:
        n = math.prod(shape)
        mul, off, kind, zero_sum = _scale(key, shape, init, arch)
        t = z[at:at + n].view(shape)
        if zero_sum:
            t = t - t.mean((2, 3), keepdim=True)
        t = t * mul + torch.as_tensor(off, dtype=torch.float32,
                                      device=device)
        state[key] = (t.exp() if kind == "exp" else t).to(dtype)
        at += n
    for key, (shape, dt) in shapes.items():
        if not dt.is_floating_point:  # num_batches_tracked
            state[key] = torch.zeros(shape, dtype=dt, device=device)
    return state


def state_shapes(module: torch.nn.Module) -> dict:
    return {k: (tuple(v.shape), v.dtype)
            for k, v in module.state_dict().items()}


@torch.no_grad()
def calibrate(ref: torch.nn.Module, state: dict, frames_nhwc: torch.Tensor,
              seed: int, dtype=torch.bfloat16) -> dict:
    """The state of `seeded_state` with its BN statistics and class bias
    calibrated on `frames_nhwc` through the float32 reference `ref` (see
    the module's docstring), cast to `dtype`. The gains of the box,
    objectness and class convs become the z-score scales of their outputs
    over the frames' anchors, and their biases the outputs' means."""
    ref.load_state_dict({k: v.float() for k, v in state.items()})
    g = seed_generator(seed + 1, frames_nhwc.device)
    j = BN_JITTER

    def set_stats(bn, args):
        x = args[0]
        mean = x.mean((0, 2, 3))
        # a channel the frames barely move (the padding's) would otherwise
        # blow up on a frame that does move it
        var = x.var((0, 2, 3))
        var = torch.maximum(var, VAR_FLOOR * var.median())
        z = torch.randn((2,) + mean.shape, generator=g, device=x.device)
        bn.running_mean.copy_(mean + j * z[0] * var.sqrt())
        bn.running_var.copy_(var * torch.exp(j * z[1]))

    hooks = [m.register_forward_pre_hook(set_stats) for m in ref.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        levels = ref.head.levels(ref.backbone(
            frames_nhwc.permute(0, 3, 1, 2).float()))
    finally:
        for h in hooks:
            h.remove()
    # each level's box, objectness and class logits as z-scores over the
    # frames' anchors, times the gain, plus the bias
    head = ref.head
    objs, clss = [], []
    for k, (reg, obj, cls, _) in enumerate(levels):
        for pred, logit, gain, bias, out in (
                (head.reg_preds[k], reg, REG_GAIN, REG_BIAS, None),
                (head.obj_preds[k], obj, OBJ_GAIN, OBJ_BIAS, objs),
                (head.cls_preds[k], cls, CLS_GAIN, 0.0, clss)):
            mean = logit.mean((0, 2, 3))
            mul = gain / logit.std((0, 2, 3)).clamp_min(1e-12)
            bias = torch.as_tensor(bias, dtype=mean.dtype, device=mean.device)
            pred.weight.mul_(mul[:, None, None, None])
            pred.bias.copy_((pred.bias - mean) * mul + bias)
            if out is not None:
                out.append(((logit - mean[:, None, None]) * mul[:, None, None]
                            + bias.reshape(-1, 1, 1)).flatten(2))
    obj_p = torch.cat(objs, 2)[:, 0].sigmoid()
    cls_max = torch.cat(clss, 2).amax(1)
    # one class bias b for all: the mean count of anchors with
    # sigmoid(obj) * max sigmoid(cls + b) >= conf_thr at the target
    target, conf_thr = CANDIDATES_PER_IMAGE, CALIBRATION_THRESHOLD
    lo, hi = -60.0, 60.0
    for _ in range(60):
        b = (lo + hi) / 2
        n = ((obj_p * (cls_max + b).sigmoid()) >= conf_thr).sum(1).float()
        lo, hi = (b, hi) if n.mean() < target else (lo, b)
    for pred in head.cls_preds:
        pred.bias.add_((lo + hi) / 2)
    return {k: v.to(dtype) if v.is_floating_point() else v.clone()
            for k, v in ref.state_dict().items()}
