"""The plain reference of YOLOX-Darknet53 (`yolov3`): upstream Megvii YOLOX
(`exps/default/yolov3.py`; `yolox/models/{network_blocks,darknet,
yolo_fpn,yolo_head}.py`) written out in plain PyTorch, NCHW, float32,
eval-mode BatchNorm, with the same state-dict keys as the upstream
checkpoint (`yolox_darknet.pth`).

- Darknet-53: a 3x3 stride-1 conv on the pixels (`stem.0`), then groups of
  a 3x3 stride-2 conv and `ResLayer`s (1x1 to half the channels, 3x3 back,
  plus the input): 1 in the stem, 2 / 8 / 8 / 4 in dark2-dark5; dark5
  ends in the SPP block (1x1, 3x3, SPP at k 5 / 9 / 13, 3x3, 1x1).
- The YOLOv3 FPN: dark5 through a 1x1, upsampled, joined to dark4, five
  convs; again to dark3. Its outputs are (out_dark3, out_dark4, dark5).
- The decoupled YOLOX head at `in_channels` (128, 256, 512), width 1.0.

Every activation is LeakyReLU at slope 0.1; BatchNorm eps 1e-3. Departures
from upstream: none in the arithmetic. The upsample is `F.interpolate`
(upstream's `nn.Upsample` module, no state); the head keeps only what the
forward of an eval-mode network needs (no loss, no training branch); the
decode is the upstream inference decode (`yolo_head.py:244-262`) on the
level outputs. Every convolution passes its input and weight through
`quant` first: the identity for the reference, a rounding to a lower
precision for the control (`perfbench/reference/precision.py`).

It imports nothing of the program and no other architecture's reference:
what it shares with `reference/yolox.py` (the conv block, the SPP, the
head and the decode) is copied. Callers that compare float32 results on a
GPU turn TF32 off (`precision.strict_float32`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3  # upstream `yolov3.py::init_yolo`: eps 1e-3, momentum 0.03
BN_MOMENTUM = 0.03
SLOPE = 0.1  # upstream `get_activation("lrelu")`: nn.LeakyReLU(0.1)
DEPTH_BLOCKS = (2, 8, 8, 4)  # Darknet-53's ResLayers in dark2..dark5


def identity(t):
    return t


class Conv(nn.Module):
    """Conv2d (no bias) -> BatchNorm -> LeakyReLU (upstream `BaseConv` with
    act "lrelu")."""

    def __init__(self, cin, cout, ksize, stride, quant):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ksize, stride, (ksize - 1) // 2,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.quant = quant

    def forward(self, x):
        c = self.conv
        y = F.conv2d(self.quant(x), self.quant(c.weight), None, c.stride,
                     c.padding)
        return F.leaky_relu(self.bn(y), SLOPE)


class ResLayer(nn.Module):
    def __init__(self, cin, quant):
        super().__init__()
        self.layer1 = Conv(cin, cin // 2, 1, 1, quant)
        self.layer2 = Conv(cin // 2, cin, 3, 1, quant)

    def forward(self, x):
        return x + self.layer2(self.layer1(x))


class SPPBottleneck(nn.Module):
    def __init__(self, cin, cout, quant):
        super().__init__()
        hidden = cin // 2
        self.conv1 = Conv(cin, hidden, 1, 1, quant)
        self.conv2 = Conv(hidden * 4, cout, 1, 1, quant)

    def forward(self, x):
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)]
        return self.conv2(torch.cat([x] + pools, dim=1))


def _group(cin, blocks, quant):
    """A 3x3 stride-2 conv to 2 cin channels, then `blocks` ResLayers."""
    return [Conv(cin, 2 * cin, 3, 2, quant)] + \
        [ResLayer(2 * cin, quant) for _ in range(blocks)]


class Darknet53(nn.Module):
    def __init__(self, quant):
        super().__init__()
        self.stem = nn.Sequential(Conv(3, 32, 3, 1, quant),
                                  *_group(32, 1, quant))
        c = 64
        self.dark2 = nn.Sequential(*_group(c, DEPTH_BLOCKS[0], quant))
        self.dark3 = nn.Sequential(*_group(2 * c, DEPTH_BLOCKS[1], quant))
        self.dark4 = nn.Sequential(*_group(4 * c, DEPTH_BLOCKS[2], quant))
        c5 = 8 * c  # 512 in, 1024 out of the stride-2 conv
        self.dark5 = nn.Sequential(
            *_group(c5, DEPTH_BLOCKS[3], quant),
            Conv(2 * c5, c5, 1, 1, quant), Conv(c5, 2 * c5, 3, 1, quant),
            SPPBottleneck(2 * c5, c5, quant),
            Conv(c5, 2 * c5, 3, 1, quant), Conv(2 * c5, c5, 1, 1, quant))

    def forward(self, x):
        x = self.dark2(self.stem(x))
        x3 = self.dark3(x)
        x4 = self.dark4(x3)
        return x3, x4, self.dark5(x4)


def _embedding(cin, a, b, quant):
    """Five convs: 1x1 to a, 3x3 to b, 1x1 to a, 3x3 to b, 1x1 to a."""
    return nn.Sequential(Conv(cin, a, 1, 1, quant), Conv(a, b, 3, 1, quant),
                         Conv(b, a, 1, 1, quant), Conv(a, b, 3, 1, quant),
                         Conv(b, a, 1, 1, quant))


class YOLOFPN(nn.Module):
    def __init__(self, quant):
        super().__init__()
        self.backbone = Darknet53(quant)
        self.out1_cbl = Conv(512, 256, 1, 1, quant)
        self.out1 = _embedding(512 + 256, 256, 512, quant)
        self.out2_cbl = Conv(256, 128, 1, 1, quant)
        self.out2 = _embedding(256 + 128, 128, 256, quant)

    def forward(self, x):
        x2, x1, x0 = self.backbone(x)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        out_dark4 = self.out1(torch.cat([up(self.out1_cbl(x0)), x1], 1))
        out_dark3 = self.out2(torch.cat([up(self.out2_cbl(out_dark4)), x2],
                                        1))
        return out_dark3, out_dark4, x0


class PredConv(nn.Conv2d):
    def __init__(self, cin, cout, quant):
        super().__init__(cin, cout, 1, 1, 0, bias=True)
        self.quant = quant

    def forward(self, x):
        return F.conv2d(self.quant(x), self.quant(self.weight), self.bias)


class YOLOXHead(nn.Module):
    strides = (8, 16, 32)

    def __init__(self, num_classes, in_channels, quant):
        super().__init__()
        self.num_classes = num_classes
        mid = 256
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for c in in_channels:
            self.stems.append(Conv(c, mid, 1, 1, quant))
            self.cls_convs.append(nn.Sequential(Conv(mid, mid, 3, 1, quant),
                                                Conv(mid, mid, 3, 1, quant)))
            self.reg_convs.append(nn.Sequential(Conv(mid, mid, 3, 1, quant),
                                                Conv(mid, mid, 3, 1, quant)))
            self.cls_preds.append(PredConv(mid, num_classes, quant))
            self.reg_preds.append(PredConv(mid, 4, quant))
            self.obj_preds.append(PredConv(mid, 1, quant))

    def levels(self, feats):
        """Per level: (reg (B,4,h,w), obj logit (B,1,h,w), cls logits
        (B,C,h,w), stride)."""
        out = []
        for k, x in enumerate(feats):
            x = self.stems[k](x)
            cls_feat = self.cls_convs[k](x)
            reg_feat = self.reg_convs[k](x)
            out.append((self.reg_preds[k](reg_feat),
                        self.obj_preds[k](reg_feat),
                        self.cls_preds[k](cls_feat), self.strides[k]))
        return out


class YOLOv3(nn.Module):
    """The network, eval mode. `decoded(x)` is the upstream inference
    output (B, A, 5 + C): (cx, cy, w, h) in input pixels, sigmoid(obj),
    sigmoid(cls); anchors row-major per level, levels at strides 8, 16,
    32."""

    def __init__(self, num_classes=80, quant=identity):
        super().__init__()
        self.backbone = YOLOFPN(quant)
        self.head = YOLOXHead(num_classes, (128, 256, 512), quant)
        self.eval()

    def decoded(self, images_nhwc):
        """images (B, H, W, 3), any dtype holding pixel values."""
        x = images_nhwc.permute(0, 3, 1, 2).float()
        rows = []
        for reg, obj, cls, stride in self.head.levels(self.backbone(x)):
            b, _, h, w = reg.shape
            yv, xv = torch.meshgrid(torch.arange(h, device=x.device),
                                    torch.arange(w, device=x.device),
                                    indexing="ij")
            grid = torch.stack((xv, yv), 2).reshape(1, h * w, 2).float()
            out = torch.cat([reg, obj.sigmoid(), cls.sigmoid()], 1)
            out = out.flatten(2).transpose(1, 2)
            rows.append(torch.cat([(out[..., :2] + grid) * stride,
                                   torch.exp(out[..., 2:4]) * stride,
                                   out[..., 4:]], -1))
        return torch.cat(rows, 1)


def build(config: dict, quant=identity, device="cpu") -> YOLOv3:
    """The reference network of a benchmark configuration file's dict
    (Darknet-53 has no depth or width multiplier: only `num_classes`)."""
    with torch.device(device):
        return YOLOv3(config["num_classes"], quant)
