"""Lip-reading video frontend: 3D conv stem + per-frame ResNet-18 (eval).

Counterpart of ``avsr_tpu/models/resnet.py``. Module names follow the
reference checkpoint (``frontend3D.{0,1,2}``, ``trunk.layer{s}.{b}``), so
its state dict loads with ``load_state_dict(strict=True)``.

  frontend3D: Conv3d(1->64, k=(5,7,7), s=(1,2,2), p=(2,3,3), no bias)
              + BN + PReLU + 3x3/s2/p1 max-pool per frame
  trunk: ResNet-18 (BasicBlock [2,2,2,2], PReLU) -> mean over H, W -> 512

The JAX package folds the temporal taps of the stem into input channels of
a 2-D conv (a TPU layout workaround, exact since the temporal stride is 1);
here the stem is the plain Conv3d. The stem tail follows the JAX default
``stem_fuse.lean_reference``.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 as an explicit scale and shift.

    rstd is computed in fp32 from the running statistics; the folded scale
    and shift are applied in the activation dtype (``lean_reference``).
    Buffers keep torch's BatchNorm names, without ``num_batches_tracked``.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = self.running_mean.float()
        rstd = torch.rsqrt(self.running_var.float() + self.eps)
        scale = rstd * self.weight.float()
        shift = self.bias.float() - mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    """ResNet-18 basic block: stride in conv1, 1x1-conv downsample."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, stride)
        self.bn1 = BatchNorm(planes)
        self.relu1 = nn.PReLU(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes)
        self.relu2 = nn.PReLU(planes)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                BatchNorm(planes),
            )
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu2(out + residual)


class ResNetTrunk(nn.Module):
    """ResNet-18 over (N, C, H, W) frames -> (N, 512) mean-pooled."""

    def __init__(self, layers=(2, 2, 2, 2)):
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
                ))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return x.mean(dim=(2, 3))


class ResEncoder(nn.Module):
    """Video frontend: (B, T, H, W, 1) frames -> (B, T, 512)."""

    def __init__(self):
        super().__init__()
        self.frontend3D = nn.ModuleList([
            nn.Conv3d(1, 64, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3),
                      bias=False),
            BatchNorm(64),
            nn.PReLU(64),
        ])
        self.trunk = ResNetTrunk()

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t = video.shape[:2]
        conv, bn, prelu = self.frontend3D
        x = conv(video.permute(0, 4, 1, 2, 3))  # (B, 64, T, H/2, W/2)
        c, h, w = x.shape[1], x.shape[3], x.shape[4]
        # fold time into batch (pure relayout: pooling never mixes frames)
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        x = nn.functional.max_pool2d(prelu(bn(x)), 3, stride=2, padding=1)
        return self.trunk(x).view(b, t, -1)
