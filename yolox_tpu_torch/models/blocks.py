"""Convolutional building blocks as PyTorch modules (NCHW / OIHW).

The PyTorch counterpart of the JAX package's `yolox_tpu/models/blocks.py`.
Module attribute names follow the upstream state-dict keys
(`conv.weight`, `bn.running_mean`, ...), so an upstream `.pth` loads with
`load_state_dict(strict=True)`.

BatchNorm uses eps 1e-3 and momentum 0.03 (the values the pretrained
checkpoints were trained with). In eval mode it normalizes with its running
statistics. In train mode (`BaseConv._forward_train`) it follows the JAX
package's `batch_norm` exactly: two-pass batch mean and biased variance in
f32 (f64 for f64 activations), the running variance updated with the
unbiased estimate, `num_batches_tracked` incremented; a BatchNorm put in
eval mode inside a training module (a frozen prefix) normalizes with its
running statistics and leaves them as they are. Train mode keeps f32
master weights: each conv casts its weight to the activation's dtype.

Every block has an `init_params(rng)` that draws its random weights from a
numpy Generator in the same order and with the same formulas as the JAX
package's `init`, so a seed gives the same weights in both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolox_tpu_torch.ops import conv_bwd
from yolox_tpu_torch.ops.stem import stem_conv_bn_act

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


class SiLU(nn.Module):
    def forward(self, x):
        return F.silu(x)


class LReLU(nn.Module):
    """where(x >= 0, x, 0.1 x), as the JAX package's `lrelu`."""

    def forward(self, x):
        return torch.where(x >= 0, x, 0.1 * x)


_ACTS = {"silu": SiLU, "relu": nn.ReLU, "lrelu": LReLU}


def get_activation(name: str) -> nn.Module:
    if name not in _ACTS:
        raise AttributeError(f"Unsupported act type: {name}")
    return _ACTS[name]()


def init_conv_kernel(rng: np.random.Generator, k: int, cin: int, cout: int,
                     groups: int = 1) -> np.ndarray:
    """torch Conv2d default init (kaiming_uniform_(a=sqrt(5))), drawn in
    the JAX package's HWIO order and returned as OIHW."""
    fan_in = (cin // groups) * k * k
    bound = math.sqrt(1.0 / fan_in)
    w = rng.uniform(-bound, bound, (k, k, cin // groups, cout))
    return w.astype(np.float32).transpose(3, 2, 0, 1)


def init_conv_bias(rng: np.random.Generator, k: int, cin: int, cout: int,
                   groups: int = 1) -> np.ndarray:
    fan_in = (cin // groups) * k * k
    bound = math.sqrt(1.0 / fan_in)
    return rng.uniform(-bound, bound, (cout,)).astype(np.float32)


def _set(param: torch.Tensor, value: np.ndarray) -> None:
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def _reset_bn(bn: nn.BatchNorm2d) -> None:
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
        bn.num_batches_tracked.zero_()


def init_children(rng: np.random.Generator, *mods: nn.Module) -> None:
    for m in mods:
        m.init_params(rng)


def batch_norm_train(z, gamma, beta):
    """Train-mode BN of NCHW `z` with the JAX package's formulas
    (`conv_bwd.batch_stats`), then z * scale + bias with scale and bias
    cast to z's dtype. Returns (y, mean, var)."""
    mean, var, _ = conv_bwd.batch_stats(z)
    return _affine(z, gamma, beta, mean, var), mean, var


def _affine(z, gamma, beta, mean, var):
    inv = torch.rsqrt(var.to(conv_bwd.stat_dtype(z.dtype)) + BN_EPS)
    scale = (gamma * inv).to(z.dtype)
    bias = (beta - mean * gamma * inv).to(z.dtype)
    return z * conv_bwd.per_channel(scale) + conv_bwd.per_channel(bias)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean, var, n: int) -> None:
    """torch's train-mode update: momentum 0.03, unbiased running variance."""
    m = BN_MOMENTUM
    unbiased = var * (n / max(n - 1, 1))
    bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
    bn.running_var.copy_((1 - m) * bn.running_var + m * unbiased)
    bn.num_batches_tracked.add_(1)


class BaseConv(nn.Module):
    """Conv2d -> BatchNorm -> activation (`network_blocks.py:27-52`)."""

    def __init__(self, cin, cout, ksize, stride, groups=1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ksize, stride, (ksize - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)
        self.act_name = act
        # train mode: route through the fused-backward Function
        # (`ops/conv_bwd.py`); set by `YoloxModule.forward_train`
        self.fused_bwd = False

    def init_params(self, rng):
        c = self.conv
        _set(c.weight, init_conv_kernel(rng, c.kernel_size[0], c.in_channels,
                                        c.out_channels, c.groups))
        _reset_bn(self.bn)

    def forward(self, x):
        if self.training:
            return self._forward_train(x)
        return self.act(self.bn(self.conv(x)))

    def _forward_train(self, x):
        c, bn = self.conv, self.bn
        if not bn.training:  # frozen: running statistics, no update
            z = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding,
                         1, c.groups)
            return self.act(_affine(z, bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var))
        if self.fused_bwd:
            y, mean, var = conv_bwd.fused_conv_bn_act(
                x, c.weight, bn.weight, bn.bias, c.stride[0], c.groups,
                self.act_name)
        else:
            z = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding,
                         1, c.groups)
            y, mean, var = batch_norm_train(z, bn.weight, bn.bias)
            y = self.act(y)
        update_running_stats(bn, mean, var, y.shape[0] * y.shape[2]
                             * y.shape[3])
        return y

    def bn_fold(self):
        """Eval-mode BN as float32 (scale, bias): y = conv * scale + bias."""
        bn = self.bn
        inv = torch.rsqrt(bn.running_var.float() + bn.eps)
        scale = bn.weight.float() * inv
        bias = bn.bias.float() - bn.running_mean.float() * scale
        return scale, bias


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (`network_blocks.py:55-74`)."""

    def __init__(self, cin, cout, ksize, stride=1, act="silu"):
        super().__init__()
        self.dconv = BaseConv(cin, cin, ksize, stride, groups=cin, act=act)
        self.pconv = BaseConv(cin, cout, 1, 1, groups=1, act=act)

    def init_params(self, rng):
        init_children(rng, self.dconv, self.pconv)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class Bottleneck(nn.Module):
    """Standard bottleneck (`network_blocks.py:77-99`)."""

    def __init__(self, cin, cout, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu"):
        super().__init__()
        hidden = int(cout * expansion)
        Conv = DWConv if depthwise else BaseConv
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv2 = Conv(hidden, cout, 3, stride=1, act=act)
        self.use_add = shortcut and cin == cout

    def init_params(self, rng):
        init_children(rng, self.conv1, self.conv2)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling, kernels (5, 9, 13) (`network_blocks.py:120-142`)."""

    def __init__(self, cin, cout, kernel_sizes=(5, 9, 13), activation="silu"):
        super().__init__()
        hidden = cin // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=activation)
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), cout, 1, 1,
                              act=activation)

    def init_params(self, rng):
        init_children(rng, self.conv1, self.conv2)

    def forward(self, x):
        x = self.conv1(x)
        pools = [max_pool_same(x, k) for k in self.kernel_sizes]
        return self.conv2(torch.cat([x] + pools, dim=1))


class CspLayer(nn.Module):
    """C3: CSP bottleneck with 3 convs (`network_blocks.py:145-183`)."""

    def __init__(self, cin, cout, n=1, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu"):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv2 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv3 = BaseConv(2 * hidden, cout, 1, 1, act=act)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act)
            for _ in range(n)])

    def init_params(self, rng):
        init_children(rng, self.conv1, self.conv2, self.conv3, *self.m)

    def forward(self, x):
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], dim=1))


def fold_focus_weight(w: torch.Tensor) -> torch.Tensor:
    """Focus conv weight (C, 12, k, k) -> the equivalent (C, 3, 2k, 2k)
    kernel of one stride-2 conv on the raw image.

    Input-channel groups of the checkpoint weight are the Focus quadrants in
    the order TL, BL, TR, BR, i.e. (dy, dx) = (0,0), (1,0), (0,1), (1,1):
    wb[o, c, dy + 2u, dx + 2v] = w[o, g * 3 + c, u, v]
    (the JAX package's `Focus._space_to_depth_kernel`).
    """
    cout, c4, k, _ = w.shape
    cin = c4 // 4
    wb = w.new_zeros((cout, cin, 2 * k, 2 * k))
    for g, (dy, dx) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        wb[:, :, dy::2, dx::2] = w[:, g * cin:(g + 1) * cin]
    return wb


class Focus(nn.Module):
    """Space-to-depth 2x2 then conv (`network_blocks.py:186-208`).

    Takes the NHWC image (B, H, W, 3) and returns the NCHW activation
    (B, C, H/2, W/2). In eval mode it runs as the fused stem kernel K1
    (`yolox_tpu_torch/ops/stem.py`) on a uint8 or float image, in the
    module's dtype: the k x k conv on the space-to-depth image is one
    2k x 2k stride-2 conv on the raw image with the folded kernel. K1 folds
    the running statistics and has no gradient, so train mode runs the
    plain differentiable path instead: space-to-depth in the quadrant
    order TL, BL, TR, BR, then the BaseConv with batch statistics, on a
    float image. The checkpoint layout is untouched.
    """

    def __init__(self, cin, cout, ksize=1, stride=1, act="silu"):
        super().__init__()
        if stride != 1:
            raise ValueError("Focus always uses stride 1")
        self.act_name = act
        self.conv = BaseConv(cin * 4, cout, ksize, stride, act=act)

    def init_params(self, rng):
        self.conv.init_params(rng)

    def forward(self, x):
        if self.training:
            x = x.permute(0, 3, 1, 2)
            return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                        x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                       dim=1))
        scale, bias = self.conv.bn_fold()
        wb = fold_focus_weight(self.conv.conv.weight.float()).contiguous()
        return stem_conv_bn_act(x, wb, scale, bias, self.act_name,
                                out_dtype=self.conv.conv.weight.dtype)


def max_pool_same(x, ksize: int):
    """MaxPool2d(kernel_size=k, stride=1, padding=k//2)."""
    return F.max_pool2d(x, ksize, 1, ksize // 2)


def upsample_nearest_2x(x):
    """nn.Upsample(scale_factor=2, mode='nearest') over NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
