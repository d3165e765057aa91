"""Conv building blocks (counterpart of avid_cma_tpu/models/blocks.py).

Activations inside the backbones are NCTHW / NCHW views with
channels-last memory. ``BatchNorm`` is the port's own: flax's
normalization (statistics in f32, the fast variance
``mean(x^2) - mean(x)^2`` clipped at 0, running stats updated with that
same biased variance at retain rate 0.9), which ``nn.BatchNorm`` does
not reproduce (it tracks the unbiased variance).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avid_cma_tpu_torch.ops.conv3d import Conv1x1x1, Conv3D
from avid_cma_tpu_torch.ops.kernels.r2p1d_pair import r2p1d_pair
from avid_cma_tpu_torch.ops.kernels.stem_pool import scale_relu_pool

BN_MOMENTUM = 0.9  # retain rate: new = 0.9 * old + 0.1 * batch
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Per-channel batch norm over dim 1, output in ``dtype``. Parameter
    and buffer names (weight, bias, running_mean, running_var) are the
    reference state-dict names; there is no num_batches_tracked."""

    def __init__(self, num_features: int, dtype=torch.float32,
                 momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def batch_stats(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) to normalize with: batch statistics in training mode
        (updating the running stats in place), running stats otherwise."""
        if not self.training:
            return self.running_mean, self.running_var
        dims = [0, *range(2, x.dim())]
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(
                self.momentum * self.running_mean + (1 - self.momentum) * mean)
            self.running_var.copy_(
                self.momentum * self.running_var + (1 - self.momentum) * var)
        return mean, var

    def fold(self, mean: torch.Tensor, var: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, b), f32 (C,), with normalize(x) = x*a + b per channel:
        a = weight*rsqrt(var + eps), b = bias - mean*a."""
        a = self.weight * torch.rsqrt(var + self.eps)
        return a, self.bias - mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.batch_stats(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class StemBNReLUPool(BatchNorm):
    """BatchNorm -> ReLU -> MaxPool3d((1,3,3), s(1,2,2), p(0,1,1)) with the
    normalize+ReLU+pool in one op (kernels K2/K3 on the card). Takes and
    returns NCTHW; the op runs on the NTHWC view, which is contiguous when
    the stem conv wrote channels-last memory."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.fold(*self.batch_stats(x))
        y = x.permute(0, 2, 3, 4, 1).contiguous()
        return scale_relu_pool(y, a, b).permute(0, 4, 1, 2, 3)


class Conv2DLayer(nn.Module):
    """Bias-free 2-D convolution over NCHW tensors (flax nn.Conv
    counterpart); weight (O, I, kh, kw) in f32, cast per call."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int,
                 stride: Tuple[int, int] = (1, 1), dtype=torch.float32):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = kernel // 2
        self.dtype = dtype
        # initialized by models.av_wrapper.init_params
        self.weight = nn.Parameter(torch.empty((out_planes, in_planes, kernel, kernel)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), w, stride=self.stride, padding=self.padding)


class Basic2DBlock(nn.Module):
    """conv3x3-BN-ReLU twice, no residual."""

    def __init__(self, in_planes: int, out_planes: int,
                 stride: Tuple[int, int] = (1, 1), dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2DLayer(in_planes, out_planes, 3, stride, dtype)
        self.bn1 = BatchNorm(out_planes, dtype)
        self.conv2 = Conv2DLayer(out_planes, out_planes, 3, (1, 1), dtype)
        self.bn2 = BatchNorm(out_planes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class BasicR2P1DBlock(nn.Module):
    """R(2+1)D residual block: (1,3,3) spatial then (3,1,1) temporal conv,
    twice, with a 1x1x1 projection residual when the shape changes.

    In eval mode each pair whose strides are all 1 (spatial conv -> BN ->
    ReLU -> temporal conv, with the BN folded from its running stats) is
    one ``r2p1d_pair`` (kernel K5 on the card), fed the NTHWC view of the
    channels-last activation; strided pairs, and every pair in training
    mode, run the convolutions and the BatchNorm separately."""

    def __init__(self, in_planes: int, out_planes: int,
                 stride: Tuple[int, int, int] = (1, 1, 1), dtype=torch.float32):
        super().__init__()
        st, sh, sw = stride
        self.spt_conv1 = Conv3D(in_planes, out_planes, (1, 3, 3), (1, sh, sw), (0, 1, 1), dtype)
        self.spt_bn1 = BatchNorm(out_planes, dtype)
        self.tmp_conv1 = Conv3D(out_planes, out_planes, (3, 1, 1), (st, 1, 1), (1, 0, 0), dtype)
        self.tmp_bn1 = BatchNorm(out_planes, dtype)
        self.spt_conv2 = Conv3D(out_planes, out_planes, (1, 3, 3), (1, 1, 1), (0, 1, 1), dtype)
        self.spt_bn2 = BatchNorm(out_planes, dtype)
        self.tmp_conv2 = Conv3D(out_planes, out_planes, (3, 1, 1), (1, 1, 1), (1, 0, 0), dtype)
        if in_planes != out_planes or any(s != 1 for s in stride):
            self.res_conv = Conv1x1x1(in_planes, out_planes, stride, dtype)
        else:
            self.res_conv = None
        self.out_bn = BatchNorm(out_planes, dtype)

    def _pair(self, x: torch.Tensor, spt: Conv3D, bn: BatchNorm,
              tmp: Conv3D) -> torch.Tensor:
        if self.training or spt.stride != (1, 1, 1) or tmp.stride != (1, 1, 1):
            return tmp(torch.relu(bn(spt(x))))
        a, b = bn.fold(bn.running_mean, bn.running_var)
        ws, wt = (c.weight.to(c.dtype).permute(2, 3, 4, 1, 0).contiguous()
                  for c in (spt, tmp))
        y = r2p1d_pair(x.to(spt.dtype).permute(0, 2, 3, 4, 1), ws, wt, a, b)
        return y.permute(0, 4, 1, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._pair(x, self.spt_conv1, self.spt_bn1, self.tmp_conv1)
        h = torch.relu(self.tmp_bn1(h))
        h = self._pair(h, self.spt_conv2, self.spt_bn2, self.tmp_conv2)
        res = x if self.res_conv is None else self.res_conv(x)
        return torch.relu(self.out_bn(h + res))
