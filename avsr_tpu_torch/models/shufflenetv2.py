"""ShuffleNetV2, the alternate lightweight lip-frontend trunk.

Counterpart of ``avsr_tpu/models/shufflenetv2.py`` (the reference's
backbones/modules/shufflenetv2.py): a stride-2 stem conv and max-pool,
three stages of inverted residuals with channel split and shuffle, a 1x1
conv and a global mean, at the four width multipliers. Inference only (the
BatchNorms read their running statistics), with the JAX module's names. No
loader uses it, in the JAX package or in the reference. Frames come in
channels-last, (B, H, W, C), as in the JAX package; the depthwise 3x3
convs are plain ``groups=`` convs.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.models.resnet import BatchNorm

STAGE_REPEATS = (4, 8, 4)
STAGE_CHANNELS = {
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """(B, C, H, W): channel j * groups + i takes channel i * C/groups + j."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False)


class InvertedResidual(nn.Module):
    """``benchmodel`` 1: the input's second half through branch 2, the first
    half kept; 2 (downsampling): the whole input through both branches."""

    def __init__(self, inp: int, oup: int, stride: int, benchmodel: int):
        super().__init__()
        self.benchmodel = benchmodel
        half = oup // 2
        self.b2_pw1 = _conv(inp - inp // 2 if benchmodel == 1 else inp, half)
        self.b2_bn1 = BatchNorm(half)
        self.b2_dw = _conv(half, half, 3, stride, groups=half)
        self.b2_bn2 = BatchNorm(half)
        self.b2_pw2 = _conv(half, half)
        self.b2_bn3 = BatchNorm(half)
        if benchmodel == 2:
            self.b1_dw = _conv(inp, inp, 3, stride, groups=inp)
            self.b1_bn1 = BatchNorm(inp)
            self.b1_pw = _conv(inp, half)
            self.b1_bn2 = BatchNorm(half)

    def _branch2(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.b2_bn1(self.b2_pw1(x)))
        h = self.b2_bn2(self.b2_dw(h))
        return F.relu(self.b2_bn3(self.b2_pw2(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.benchmodel == 1:
            c = x.shape[1]
            out = torch.cat([x[:, : c // 2], self._branch2(x[:, c // 2:])], 1)
        else:
            h1 = self.b1_pw(self.b1_bn1(self.b1_dw(x)))
            out = torch.cat([F.relu(self.b1_bn2(h1)), self._branch2(x)], 1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """(B, H, W, in_channels) -> pooled (B, C_last) features (the
    classifier head is omitted: the frontend role consumes the pooled trunk
    output)."""

    def __init__(self, width_mult: float = 1.0, in_channels: int = 3):
        super().__init__()
        chans = STAGE_CHANNELS[width_mult]
        self.conv1 = _conv(in_channels, chans[0], 3, 2)
        self.conv1_bn = BatchNorm(chans[0])
        self.stages = []
        inp = chans[0]
        for stage, repeats in enumerate(STAGE_REPEATS):
            oup = chans[stage + 1]
            for i in range(repeats):
                name = f"stage{stage + 2}_{i}"
                setattr(self, name, InvertedResidual(
                    inp, oup, 2 if i == 0 else 1, 2 if i == 0 else 1))
                self.stages.append(name)
                inp = oup
        self.conv_last = _conv(inp, chans[-1])
        self.conv_last_bn = BatchNorm(chans[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1_bn(self.conv1(x.permute(0, 3, 1, 2))))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for name in self.stages:
            h = getattr(self, name)(h)
        h = F.relu(self.conv_last_bn(self.conv_last(h)))
        return h.mean(dim=(2, 3))
