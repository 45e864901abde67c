"""The plain reference of the YOLOX network: upstream Megvii YOLOX
(`yolox/models/{network_blocks,darknet,yolo_pafpn,yolo_head}.py`) written
out in plain PyTorch, NCHW, float32, eval-mode BatchNorm, and the same
state-dict keys as the upstream checkpoints.

No kernel, no fused stem, no cache: Focus is the space-to-depth of
`network_blocks.py:186-208` (quadrants TL, BL, TR, BR) then a conv. Every
convolution passes its input and weight through `quant` first, which is
the identity for the reference and a rounding to a lower precision for
the control (`perfbench/reference/precision.py`).

Callers that compare float32 results on a GPU turn TF32 off
(`precision.strict_float32`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3  # upstream `BaseConv`: nn.BatchNorm2d(eps=1e-3, momentum=0.03)
BN_MOMENTUM = 0.03


def identity(t):
    return t


class Conv(nn.Module):
    """Conv2d (no bias) -> BatchNorm -> SiLU (upstream `BaseConv`)."""

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
        return F.silu(self.bn(y))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut, quant):
        super().__init__()
        self.conv1 = Conv(cin, cout, 1, 1, quant)
        self.conv2 = Conv(cout, cout, 3, 1, quant)
        self.use_add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    def __init__(self, cin, cout, n, shortcut, quant):
        super().__init__()
        hidden = int(cout * 0.5)
        self.conv1 = Conv(cin, hidden, 1, 1, quant)
        self.conv2 = Conv(cin, hidden, 1, 1, quant)
        self.conv3 = Conv(2 * hidden, cout, 1, 1, quant)
        self.m = nn.Sequential(*[Bottleneck(hidden, hidden, shortcut, quant)
                                 for _ in range(n)])

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)],
                                    dim=1))


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


class Focus(nn.Module):
    def __init__(self, cout, quant):
        super().__init__()
        self.conv = Conv(12, cout, 3, 1, quant)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   dim=1))


class CSPDarknet(nn.Module):
    def __init__(self, depth, width, quant):
        super().__init__()
        c = int(width * 64)
        d = max(round(depth * 3), 1)
        self.stem = Focus(c, quant)
        self.dark2 = nn.Sequential(Conv(c, 2 * c, 3, 2, quant),
                                   CSPLayer(2 * c, 2 * c, d, True, quant))
        self.dark3 = nn.Sequential(Conv(2 * c, 4 * c, 3, 2, quant),
                                   CSPLayer(4 * c, 4 * c, 3 * d, True, quant))
        self.dark4 = nn.Sequential(Conv(4 * c, 8 * c, 3, 2, quant),
                                   CSPLayer(8 * c, 8 * c, 3 * d, True, quant))
        self.dark5 = nn.Sequential(Conv(8 * c, 16 * c, 3, 2, quant),
                                   SPPBottleneck(16 * c, 16 * c, quant),
                                   CSPLayer(16 * c, 16 * c, d, False, quant))

    def forward(self, x):
        x = self.dark2(self.stem(x))
        x3 = self.dark3(x)
        x4 = self.dark4(x3)
        return x3, x4, self.dark5(x4)


class YOLOPAFPN(nn.Module):
    def __init__(self, depth, width, quant):
        super().__init__()
        self.backbone = CSPDarknet(depth, width, quant)
        c0, c1, c2 = (int(c * width) for c in (256, 512, 1024))
        n = round(3 * depth)
        self.lateral_conv0 = Conv(c2, c1, 1, 1, quant)
        self.C3_p4 = CSPLayer(2 * c1, c1, n, False, quant)
        self.reduce_conv1 = Conv(c1, c0, 1, 1, quant)
        self.C3_p3 = CSPLayer(2 * c0, c0, n, False, quant)
        self.bu_conv2 = Conv(c0, c0, 3, 2, quant)
        self.C3_n3 = CSPLayer(2 * c0, c1, n, False, quant)
        self.bu_conv1 = Conv(c1, c1, 3, 2, quant)
        self.C3_n4 = CSPLayer(2 * c1, c2, n, False, quant)

    def forward(self, x):
        x2, x1, x0 = self.backbone(x)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4(torch.cat([up(fpn_out0), x1], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([up(fpn_out1), x2], 1))
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2), fpn_out1],
                                        1))
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1), fpn_out0],
                                        1))
        return pan_out2, pan_out1, pan_out0


class PredConv(nn.Conv2d):
    def __init__(self, cin, cout, quant):
        super().__init__(cin, cout, 1, 1, 0, bias=True)
        self.quant = quant

    def forward(self, x):
        return F.conv2d(self.quant(x), self.quant(self.weight), self.bias)


class YOLOXHead(nn.Module):
    strides = (8, 16, 32)

    def __init__(self, num_classes, width, quant):
        super().__init__()
        self.num_classes = num_classes
        mid = int(256 * width)
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for c in (256, 512, 1024):
            self.stems.append(Conv(int(c * width), mid, 1, 1, quant))
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


class YOLOX(nn.Module):
    """The network, eval mode. `decoded(x)` is the upstream inference
    output (B, A, 5 + C): (cx, cy, w, h) in input pixels, sigmoid(obj),
    sigmoid(cls); anchors row-major per level, levels at strides 8, 16,
    32 (`yolo_head.py:244-262`)."""

    def __init__(self, depth, width, num_classes=80, quant=identity):
        super().__init__()
        self.backbone = YOLOPAFPN(depth, width, quant)
        self.head = YOLOXHead(num_classes, width, quant)
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


def build(config: dict, quant=identity, device="cpu") -> YOLOX:
    """The reference network of a benchmark configuration file's dict."""
    with torch.device(device):
        return YOLOX(config["depth"], config["width"],
                     config["num_classes"], quant)
