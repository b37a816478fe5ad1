"""FAN (2D stacked-hourglass) facial landmark detector, batched over faces.

Counterpart of ``avsr_tpu/frontends/fan.py``: stem + stacked hourglass
modules (depth 4, 256 features) -> 68 heatmaps, decoded by a
peak-radius-masked soft-argmax (fan_predictor.py:127-164). All face crops
of a frame run as one batch on the card, the decode with them; the crops
are cut on the host with cv2. Parameter names are the reference
checkpoint's (``conv1``, ``m0.b1_4.bn1``, ``top_m_0``, ``l1``...; a
block's ``downsample.0`` BN and ``downsample.2`` conv).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.frontends.weights import released_state, state_from_flax
from avsr_tpu_torch.models.resnet import BatchNorm


class ConvBlock(nn.Module):
    """FAN residual block: 3 BN-ReLU-Conv stages concatenated (fan.py:11)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.bn1 = BatchNorm(in_planes)
        self.conv1 = nn.Conv2d(in_planes, half, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(half)
        self.conv2 = nn.Conv2d(half, quarter, 3, padding=1, bias=False)
        self.bn3 = BatchNorm(quarter)
        self.conv3 = nn.Conv2d(quarter, quarter, 3, padding=1, bias=False)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(
                BatchNorm(in_planes), nn.ReLU(),
                nn.Conv2d(in_planes, out_planes, 1, bias=False))

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([out1, out2, out3], dim=1) + res


class HourGlass(nn.Module):
    """Recursive hourglass (fan.py:56), depth levels named b1_d..b3_d."""

    def __init__(self, depth: int = 4, features: int = 256,
                 use_avg_pool: bool = False):
        super().__init__()
        self.depth = depth
        self.use_avg_pool = use_avg_pool
        for d in range(depth, 0, -1):
            self.add_module(f"b1_{d}", ConvBlock(features, features))
            self.add_module(f"b2_{d}", ConvBlock(features, features))
            if d == 1:
                self.add_module(f"b2_plus_{d}", ConvBlock(features, features))
            self.add_module(f"b3_{d}", ConvBlock(features, features))

    def _level(self, inp, d: int):
        up1 = getattr(self, f"b1_{d}")(inp)
        pool = F.avg_pool2d if self.use_avg_pool else F.max_pool2d
        low = getattr(self, f"b2_{d}")(pool(inp, 2, 2))
        if d > 1:
            low = self._level(low, d - 1)
        else:
            low = getattr(self, f"b2_plus_{d}")(low)
        low = getattr(self, f"b3_{d}")(low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(x, self.depth)


class FAN(nn.Module):
    """Stacked-hourglass landmark network: (B, 3, 256, 256) in [0, 1] ->
    (B, 68, 64, 64) heatmaps."""

    def __init__(self, num_modules: int = 2, depth: int = 4,
                 features: int = 256, num_landmarks: int = 68,
                 use_avg_pool: bool = False, stem_conv_kernel: int = 7,
                 stem_conv_stride: int = 2, stem_pool_kernel: int = 2):
        super().__init__()
        self.num_modules = num_modules
        self.use_avg_pool = use_avg_pool
        self.stem_pool_kernel = stem_pool_kernel
        k = stem_conv_kernel
        self.conv1 = nn.Conv2d(3, 64, k, stem_conv_stride, k // 2)
        self.bn1 = BatchNorm(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, features)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(depth, features, use_avg_pool))
            self.add_module(f"top_m_{i}", ConvBlock(features, features))
            self.add_module(f"conv_last{i}", nn.Conv2d(features, features, 1))
            self.add_module(f"bn_end{i}", BatchNorm(features))
            self.add_module(f"l{i}", nn.Conv2d(features, num_landmarks, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(features, features, 1))
                self.add_module(f"al{i}",
                                nn.Conv2d(num_landmarks, features, 1))

    def forward(self, x):
        x = self.conv2(F.relu(self.bn1(self.conv1(x))))
        p = self.stem_pool_kernel
        if p > 1:
            x = (F.avg_pool2d if self.use_avg_pool else F.max_pool2d)(x, p, p)
        previous = self.conv4(self.conv3(x))
        out = None
        for i in range(self.num_modules):
            m = lambda name: getattr(self, f"{name}{i}")  # noqa: E731
            ll = m("top_m_")(m("m")(previous))
            ll = F.relu(m("bn_end")(m("conv_last")(ll)))
            out = m("l")(ll)
            if i < self.num_modules - 1:
                previous = previous + m("bl")(ll) + m("al")(out)
        return out


def decode_heatmaps(heatmaps: torch.Tensor, radius: float = 0.1,
                    gamma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak-radius-masked soft-argmax decode (fan_predictor.py:127-164).

    heatmaps (B, L, H, W) -> landmarks (B, L, 2) in heatmap coords (pixel
    centres at +0.5), scores (B, L). The argmax takes the first of tied
    peaks; the mass is floored at the dtype's eps.
    """
    b, l, h, w = heatmaps.shape
    hm = heatmaps
    scores = hm.amax(dim=(2, 3))
    if radius**2 * h * w < h**2 + w**2:
        m = hm.reshape(b, l, -1).argmax(dim=-1)
        peak_y = (m // w).float()
        peak_x = (m % w).float()
        yy = torch.arange(h, dtype=torch.float32, device=hm.device)
        xx = torch.arange(w, dtype=torch.float32, device=hm.device)
        dist = torch.sqrt((yy.view(1, 1, h, 1) - peak_y[..., None, None]) ** 2
                          + (xx.view(1, 1, 1, w) - peak_x[..., None, None]) ** 2)
        hm = hm * (dist <= radius * float(np.sqrt(h * w))).to(hm.dtype)
    hm = hm.clamp_min(0.0)
    if gamma != 1.0:
        hm = hm**gamma
    m00 = hm.sum(dim=(2, 3)).clamp_min(torch.finfo(hm.dtype).eps)
    cx = torch.arange(w, dtype=torch.float32, device=hm.device) + 0.5
    cy = torch.arange(h, dtype=torch.float32, device=hm.device) + 0.5
    xs = (hm.sum(dim=2) * cx).sum(-1) / m00
    ys = (hm.sum(dim=3) * cy).sum(-1) / m00
    return torch.stack([xs, ys], dim=-1), scores


@dataclass
class FANPredictor:
    """Landmarks for face boxes in frames; the network pass is batched
    over a frame's faces, on ``device`` (``cuda`` unless the caller asks
    for the CPU). ``state_dict``: the port's ``FAN`` weights.

    Matches the reference predictor (crop_ratio 0.55, input 256, radius 0.1).
    """

    state_dict: dict
    num_modules: int = 2
    use_avg_pool: bool = False
    crop_ratio: float = 0.55
    input_size: int = 256
    radius: float = 0.1
    gamma: float = 1.0
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.net = FAN(num_modules=self.num_modules,
                       use_avg_pool=self.use_avg_pool)
        self.net.load_state_dict(self.state_dict, strict=True)
        self.net.to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kw):
        from avsr_tpu_torch.core.checkpoint import load_torch_state_dict

        return cls(state_dict=released_state(load_torch_state_dict(path)),
                   **kw)

    @torch.no_grad()
    def _network(self, patches: np.ndarray):
        """(N, S, S, 3) uint8 crops -> landmarks (N, 68, 2) in heatmap
        coordinates and scores, as numpy; one upload of the uint8 bytes."""
        x = torch.from_numpy(patches).to(self.device)
        x = (x.float() / 255.0).permute(0, 3, 1, 2)
        lms, scores = decode_heatmaps(self.net(x), self.radius, self.gamma)
        return lms.cpu().numpy(), scores.cpu().numpy()

    def __call__(
        self, image: np.ndarray, face_boxes: np.ndarray, rgb: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Single-frame API matching the reference FANPredictor."""
        if face_boxes.size == 0:
            return (np.empty((0, 68, 2), np.float32), np.empty((0, 68), np.float32))
        if not rgb:
            image = image[..., ::-1]
        if face_boxes.ndim == 1:
            face_boxes = face_boxes[None]
        patches, boxes = self._crop_faces(image, face_boxes)
        lms, scores = self._network(patches)
        hs = self.input_size // 4  # heatmaps are input/4
        for lm, (left, top, right, bottom) in zip(lms, boxes):
            lm[:, 0] = lm[:, 0] * (right - left) / hs + left
            lm[:, 1] = lm[:, 1] * (bottom - top) / hs + top
        return lms, scores

    def _crop_faces(self, image: np.ndarray, face_boxes: np.ndarray):
        """(N, S, S, 3) uint8 crops of the enlarged boxes (the image padded
        with zeros where a box runs past its edge), and the boxes."""
        import cv2

        centres = (face_boxes[:, [0, 1]] + face_boxes[:, [2, 3]]) / 2.0
        sizes = (face_boxes[:, [3, 2]] - face_boxes[:, [1, 0]]).mean(axis=1)
        enlarged = (sizes / self.crop_ratio)[:, None].repeat(2, axis=1)
        boxes = np.zeros_like(face_boxes[:, :4])
        boxes[:, :2] = np.round(centres - enlarged / 2.0)
        boxes[:, 2:] = np.round(boxes[:, :2] + enlarged) + 1
        boxes = boxes.astype(int)
        outer = np.hstack([boxes[:, :2].min(axis=0), boxes[:, 2:].max(axis=0)])
        pad = np.zeros((3, 2), int)
        pad[1][0] = max(0, -outer[0])
        pad[0][0] = max(0, -outer[1])
        pad[1][1] = max(0, outer[2] - image.shape[1])
        pad[0][1] = max(0, outer[3] - image.shape[0])
        if pad.any():
            image = np.pad(image, pad)
        patches = []
        for left, top, right, bottom in boxes:
            left += pad[1][0]
            top += pad[0][0]
            right += pad[1][0]
            bottom += pad[0][0]
            patches.append(
                cv2.resize(
                    image[top:bottom, left:right],
                    (self.input_size, self.input_size),
                )
            )
        return np.stack(patches), boxes


def fan_flax_to_torch(variables: dict, num_modules: int = 2) -> dict:
    """The JAX ``FAN`` variables -> the port's state dict: the inverse of
    ``fan_torch_to_flax`` (a block's ``downsample.<i>`` is flax's
    ``downsample_m<i>``)."""

    def flax_path(name: str):
        return tuple(name.replace("downsample.", "downsample_m").split("."))

    with torch.device("meta"):
        net = FAN(num_modules=num_modules)
    return state_from_flax(net, variables, flax_path)
