"""Active-speaker detection (TalkNet-style) model for ASD-score generation.

Counterpart of ``avsr_tpu/frontends/asd.py``: a two-branch (3/5-kernel)
3D-CNN visual encoder over 112x112 face crops, a matching 2D-CNN audio
encoder over 13-bin MFCC maps, sum fusion, and a forward GRU -> GELU ->
backward GRU -> GELU, with the lossAV / lossV scoring heads.

Parameter names are the reference ASD wrapper's state dict (``model.*``,
``lossAV.FC.*``, ``lossV.FC.*``), the names ``asd_torch_to_flax`` reads.
Layouts: the visual map is NCDHW (B, 1, T, H, W); the audio map is
(B, 1, F=13, T4), frequency on H and time on W, as JAX's (B, 13, T4, 1),
so the (1, 3) pools act on time. BatchNorm follows flax with momentum 0.99
and eps 1e-3 (the reference's torch momentum 0.01), the batch variance
biased (ROADMAP C4).

The GRUs are ``nn.GRU``, which keeps r and z biases on both the input and
the hidden side where flax's GRUCell keeps one of each; the JAX converter
folds the hidden side's into the input side. ``asd_flax_to_torch`` writes
them folded (zeros on the hidden side) and ``ASDTrainer`` leaves the hidden
side's r and z biases at their loaded values, so both train the same
parameters.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.frontends.weights import state_from_flax
from avsr_tpu_torch.models.resnet import BatchNorm

VIDEO_MEAN = 0.4161
VIDEO_STD = 0.1688


class _BatchNorm(BatchNorm):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)``."""

    momentum = 0.99

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-3)


class _TwoPathBlock(nn.Module):
    """Two paths, a 3- and a 5-kernel one, each a first conv (``s_k`` over
    space or ``m_k`` over frequency) and a temporal conv (``t_k``), each
    conv followed by BN and ReLU; their sum through a 1x1 conv (``last``),
    BN and ReLU."""

    first = ""

    def __init__(self, out: int, convs):
        super().__init__()
        for k in (3, 5):
            c1, ct = convs(k)
            self.add_module(f"{self.first}_{k}", c1)
            self.add_module(f"bn_{self.first}_{k}", _BatchNorm(out))
            self.add_module(f"t_{k}", ct)
            self.add_module(f"bn_t_{k}", _BatchNorm(out))

    def _branch(self, x, k: int, train: bool):
        m = lambda name: getattr(self, f"{name}_{k}")  # noqa: E731
        h = F.relu(m(f"bn_{self.first}")(m(self.first)(x), train))
        return F.relu(m("bn_t")(m("t")(h), train))

    def forward(self, x, train: bool = False):
        h = self._branch(x, 3, train) + self._branch(x, 5, train)
        return F.relu(self.bn_last(self.last(h), train))


class VisualBlock(_TwoPathBlock):
    """Factored spatio-temporal block over (B, C, T, H, W): (1, k, k)
    convs over space (stride 2 when ``is_down``), (k, 1, 1) over time."""

    first = "s"

    def __init__(self, cin: int, out: int, is_down: bool = False):
        stride = (1, 2, 2) if is_down else (1, 1, 1)
        super().__init__(out, lambda k: (
            nn.Conv3d(cin, out, (1, k, k), stride, (0, k // 2, k // 2),
                      bias=False),
            nn.Conv3d(out, out, (k, 1, 1), 1, (k // 2, 0, 0), bias=False)))
        self.last = nn.Conv3d(out, out, 1, bias=False)
        self.bn_last = _BatchNorm(out)


class AudioBlock(_TwoPathBlock):
    """Factored frequency/time block over (B, C, F, T): (k, 1) convs over
    frequency, (1, k) over time."""

    first = "m"

    def __init__(self, cin: int, out: int):
        super().__init__(out, lambda k: (
            nn.Conv2d(cin, out, (k, 1), padding=(k // 2, 0), bias=False),
            nn.Conv2d(out, out, (1, k), padding=(0, k // 2), bias=False)))
        self.last = nn.Conv2d(out, out, 1, bias=False)
        self.bn_last = _BatchNorm(out)


class VisualEncoder(nn.Module):
    """(B, 1, T, 112, 112) face crops -> (B, T, 128)."""

    def __init__(self):
        super().__init__()
        self.block1 = VisualBlock(1, 32, is_down=True)
        self.block2 = VisualBlock(32, 64)
        self.block3 = VisualBlock(64, 128)

    def forward(self, x, train: bool = False):
        x = self.block1(x, train)
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.block2(x, train)
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.block3(x, train)
        return x.amax(dim=(3, 4)).transpose(1, 2)  # max over space


class AudioEncoder(nn.Module):
    """(B, 1, F=13, T4) MFCC map -> (B, T4/4, 128)."""

    def __init__(self):
        super().__init__()
        self.block1 = AudioBlock(1, 32)
        self.block2 = AudioBlock(32, 64)
        self.block3 = AudioBlock(64, 128)

    def forward(self, x, train: bool = False):
        x = self.block1(x, train)
        x = F.max_pool2d(x, (1, 3), (1, 2), (0, 1))
        x = self.block2(x, train)
        x = F.max_pool2d(x, (1, 3), (1, 2), (0, 1))
        x = self.block3(x, train)
        return x.mean(dim=2).transpose(1, 2)  # mean over frequency


class BGRU(nn.Module):
    """Forward GRU -> GELU -> backward GRU -> GELU (Classifier.py:6). The
    backward GRU runs on the whole padded T flipped."""

    def __init__(self, channel: int = 128):
        super().__init__()
        self.gru_forward = nn.GRU(channel, channel, batch_first=True)
        self.gru_backward = nn.GRU(channel, channel, batch_first=True)

    def forward(self, x):  # (B, T, C)
        x = F.gelu(self.gru_forward(x)[0])
        x = torch.flip(self.gru_backward(torch.flip(x, dims=[1]))[0], dims=[1])
        return F.gelu(x)


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.visualEncoder = VisualEncoder()
        self.audioEncoder = AudioEncoder()
        self.GRU = BGRU(128)


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.FC = nn.Linear(128, 2)


class ASDModel(nn.Module):
    """The full ASD network with its lossAV / lossV scoring heads."""

    def __init__(self):
        super().__init__()
        self.model = _Backbone()
        self.lossAV = _Head()
        self.lossV = _Head()

    def _embeds(self, audio_mfcc, visual_frames, train: bool = False):
        """(av_embed, v_embed), each (B, T, 128): the reference's
        forward_audio_visual_backend / forward_visual_backend outputs."""
        m = self.model
        v = (visual_frames[:, None] / 255.0 - VIDEO_MEAN) / VIDEO_STD
        v_embed = m.visualEncoder(v, train)
        a = audio_mfcc.transpose(1, 2)[:, None]  # (B, 1, 13, T4)
        # align audio (100 Hz pooled 4x -> 25 Hz) with video frames
        a_embed = m.audioEncoder(a, train)[:, :v_embed.shape[1]]
        return m.GRU(a_embed + v_embed), v_embed

    def forward(self, audio_mfcc, visual_frames):
        """audio_mfcc (B, T4, 13) raw MFCC frames at 100 Hz; visual_frames
        (B, T, 112, 112) uint8-scale grayscale. Returns per-frame speaking
        scores (B, T): the lossAV logit of class 1 (loss.py:15-18)."""
        av, _ = self._embeds(audio_mfcc, visual_frames)
        return self.lossAV.FC(av)[..., 1]

    def train_logits(self, audio_mfcc, visual_frames, train: bool = True):
        """Both heads' logits, each (B, T, 2): lossAV on the fused GRU
        output, lossV on the visual embedding; ``train`` uses and updates
        the batch statistics."""
        av, v_embed = self._embeds(audio_mfcc, visual_frames, train)
        return self.lossAV.FC(av), self.lossV.FC(v_embed)


def asd_flax_to_torch(variables: dict) -> dict:
    """The JAX ``ASDModel`` variables -> the port's state dict: the inverse
    of ``asd_torch_to_flax``, the GRUs' hidden r and z biases as zeros."""

    def flax_path(name: str):
        parts = name.split(".")
        if parts[0] in ("lossAV", "lossV"):
            return (f"{parts[0]}_FC",)
        return tuple(parts[1:])

    with torch.device("meta"):
        net = ASDModel()
    return state_from_flax(net, variables, flax_path)
