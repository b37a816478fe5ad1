"""Lip-reading video frontend: 3D conv stem + per-frame ResNet-18.

Counterpart of ``avsr_tpu/models/resnet.py``. Module names follow the
reference checkpoint (``frontend3D.{0,1,2}``, ``trunk.layer{s}.{b}``), so
its state dict loads with ``load_state_dict(strict=True)``.

  frontend3D: Conv3d(1->64, k=(5,7,7), s=(1,2,2), p=(2,3,3), no bias)
              + BN + PReLU + 3x3/s2/p1 max-pool per frame
  trunk: ResNet-18 (BasicBlock [2,2,2,2], PReLU) -> mean over H, W -> 512

The trunk's activation is ``relu_type`` (``"prelu"``, the default and
AV-HuBERT's; ``"relu"``; ``"swish"``, the conformer family's, whose blocks
then hold no activation weights), as in the JAX package.

The JAX package folds the temporal taps of the stem into input channels of
a 2-D conv (a TPU layout workaround, exact since the temporal stride is 1);
here the stem is the plain Conv3d. The stem tail follows the JAX default
``stem_fuse.lean_reference``; with the JAX package's switches
(``AVSR_FUSED_STEM=1`` in training, ``AVSR_FUSED_STEM_EVAL=1`` in eval) it
runs the fused ``bn_prelu_pool`` (``ops/kernels/stem_fuse.py``) instead.
The trunk's BatchNorms follow flax ``nn.BatchNorm`` in training
(``train=True``).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from avsr_tpu_torch.core import dist
from avsr_tpu_torch.models import remat
from avsr_tpu_torch.ops.kernels.stem_fuse import bn_prelu_pool


class BatchNorm(nn.Module):
    """BatchNorm over dim 1. Buffers keep torch's BatchNorm names, without
    ``num_batches_tracked``.

    Eval: rstd in fp32 from the running statistics, read at the activation
    dtype (the JAX package casts batch statistics to the compute dtype);
    the folded scale and shift are applied in the activation dtype
    (``lean_reference``).

    Train: batch statistics in fp32 over (N, H, W) with the biased
    variance mean(x^2) - mean^2, differentiated through; ``folded`` (the
    stem, ``stem_fuse.lean_reference(train=True)``) applies them as a
    scale and shift in the activation dtype, otherwise (the trunk, flax
    ``nn.BatchNorm``) the variance is clipped at 0 and the normalisation
    runs in fp32 before the cast. The running averages are then updated
    without gradient as flax does with momentum 0.9 (torch's 0.1),
    ``0.9 * running + 0.1 * batch``, the variance with the biased batch
    variance (torch's ``nn.BatchNorm`` uses the unbiased one), the old
    statistics read at the activation dtype, the result kept in fp32; not
    in the recompute of a rematerialised frontend. Under data parallelism
    the batch statistics are the global batch's, as under pjit: the fp32
    sums, sums of squares and counts are all-reduced with a differentiable
    sum (``core/dist.all_reduce_sum``).
    """

    momentum = 0.9  # flax convention: weight of the old running average

    def __init__(self, channels: int, eps: float = 1e-5,
                 folded: bool = False):
        super().__init__()
        self.eps = eps
        self.folded = folded
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not train:
            mean = self.running_mean.to(x.dtype).float()
            rstd = torch.rsqrt(self.running_var.to(x.dtype).float() + self.eps)
            scale = rstd * self.weight.float()
            shift = self.bias.float() - mean * scale
            return (x * scale.to(x.dtype).view(shape)
                    + shift.to(x.dtype).view(shape))
        axes = [0] + list(range(2, x.dim()))
        xa = x.float()
        if dist.world_size() > 1:
            count = xa.new_full((xa.shape[1],), xa.numel() // xa.shape[1])
            sums = dist.all_reduce_sum(torch.stack(
                [xa.sum(dim=axes), (xa * xa).sum(dim=axes), count]))
            mean = sums[0] / sums[2]
            var = sums[1] / sums[2] - mean * mean
        else:
            mean = xa.mean(dim=axes)
            var = (xa * xa).mean(dim=axes) - mean * mean
        if not self.folded:
            var = var.clamp_min(0.0)
        self._update(x.dtype, mean.detach(), var.detach())
        rstd = torch.rsqrt(var + self.eps)
        if self.folded:
            scale = self.weight.float()
            w = rstd * scale
            b = self.bias.float() - mean * rstd * scale
            return x * w.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        mul = rstd * self.weight.float()
        y = (xa - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.float().view(shape)).to(x.dtype)

    @torch.no_grad()
    def _update(self, dtype, mean, var):
        if remat.recomputing():
            return
        m = self.momentum
        for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
            buf.copy_((m * buf.to(dtype)).float() + (1.0 - m) * stat)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def activation(relu_type: str, channels: int) -> nn.Module:
    """The block activation of ``relu_type``: per-channel PReLU, ReLU or
    swish (SiLU)."""
    if relu_type == "prelu":
        return nn.PReLU(channels)
    if relu_type == "relu":
        return nn.ReLU()
    if relu_type == "swish":
        return nn.SiLU()
    raise ValueError(f"unknown relu_type {relu_type!r}")


class BasicBlock(nn.Module):
    """ResNet-18 basic block: stride in conv1, 1x1-conv downsample."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, relu_type: str = "prelu"):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, stride)
        self.bn1 = BatchNorm(planes)
        self.relu1 = activation(relu_type, planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes)
        self.relu2 = activation(relu_type, planes)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                BatchNorm(planes),
            )
            if downsample else None
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.relu1(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(conv(x), train)
        return self.relu2(out + residual)


class ResNetTrunk(nn.Module):
    """ResNet-18 over (N, C, H, W) frames -> (N, 512) mean-pooled."""

    def __init__(self, layers=(2, 2, 2, 2), relu_type: str = "prelu"):
        super().__init__()
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                mods.append(BasicBlock(
                    inplanes, planes, s,
                    downsample=b == 0 and (s != 1 or inplanes != planes),
                    relu_type=relu_type,
                ))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for stage in range(1, 5):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, train)
        return x.mean(dim=(2, 3))


class ResEncoder(nn.Module):
    """Video frontend: (B, T, H, W, 1) frames -> (B, T, 512)."""

    def __init__(self):
        super().__init__()
        self.frontend3D = nn.ModuleList([
            nn.Conv3d(1, 64, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3),
                      bias=False),
            BatchNorm(64, folded=True),
            nn.PReLU(64),
        ])
        self.trunk = ResNetTrunk()

    def forward(self, video: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        b, t = video.shape[:2]
        conv, bn, prelu = self.frontend3D
        x = conv(video.permute(0, 4, 1, 2, 3))  # (B, 64, T, H/2, W/2)
        c, h, w = x.shape[1], x.shape[3], x.shape[4]
        # fold time into batch (pure relayout: pooling never mixes frames)
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        # the JAX package's switches of its fused stem tail
        switch = "AVSR_FUSED_STEM" if train else "AVSR_FUSED_STEM_EVAL"
        if os.environ.get(switch, "0") == "1":
            x = self._fused_tail(x, bn, prelu, train)
        else:
            x = nn.functional.max_pool2d(prelu(bn(x, train)), 3, stride=2,
                                         padding=1)
        return self.trunk(x, train).view(b, t, -1)

    @staticmethod
    def _fused_tail(x, bn: BatchNorm, prelu: nn.PReLU, train: bool):
        """BN + PReLU + max-pool as ``bn_prelu_pool`` (the TPU kernel's
        semantics: z in fp32, cast once after the pool); the running
        averages update as in ``BatchNorm``."""
        if not train:
            return bn_prelu_pool(x, bn.weight, bn.bias, prelu.weight,
                                 eps=bn.eps, train=False,
                                 running_mean=bn.running_mean,
                                 running_var=bn.running_var)
        if dist.world_size() > 1:
            # the kernels' channel sums are per rank (ROADMAP A15)
            raise NotImplementedError(
                "AVSR_FUSED_STEM=1 under data parallelism: the fused stem "
                "tail's batch statistics and bwd1's channel reductions are "
                "not all-reduced yet (ROADMAP A15); unset the switch")
        out, mean, var = bn_prelu_pool(x, bn.weight, bn.bias, prelu.weight,
                                       eps=bn.eps, train=True)
        bn._update(x.dtype, mean, var)
        return out
