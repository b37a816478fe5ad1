"""S3FD single-shot face detector (the reference stack's other detector).

Counterpart of ``avsr_tpu/frontends/s3fd.py``: a VGG16 trunk with dilated
fc-conv layers, L2Norm-scaled source maps, two extra SSD stages and
per-scale loc/conf heads with max-out background scoring on the first
scale. The network runs batched on the card; decode and NMS (the port's
``retinaface.decode_boxes`` and ``nms``) stay on the host. Parameter names
are the reference checkpoint's (``vgg.<idx>``, ``extras.<idx>``,
``loc.<idx>``, ``conf.<idx>``, ``L2Norm3_3.weight``...).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.frontends.retinaface import decode_boxes, nms, upload_frames
from avsr_tpu_torch.frontends.weights import released_state, state_from_flax

RGB_MEAN = np.array([123.0, 117.0, 104.0], np.float32)

PRIOR_MIN_SIZES = (16, 32, 64, 128, 256, 512)
PRIOR_STEPS = (4, 8, 16, 32, 64, 128)
VARIANCE = (0.1, 0.2)

# VGG conv channel plan up to the dilated fc layers; indices follow the torch
# ModuleList so checkpoint keys (vgg.<idx>) map directly.
_VGG_PLAN = [
    (0, 64), (2, 64), ("pool", 2), (5, 128), (7, 128), ("pool", 2),
    (10, 256), (12, 256), (14, 256), ("pool_ceil", 2),
    (17, 512), (19, 512), (21, 512), ("pool", 2),
    (24, 512), (26, 512), (28, 512), ("pool", 2),
]
# the convolutions whose ReLU output is L2-normalised into a source map
_SOURCES = {14: "L2Norm3_3", 21: "L2Norm4_3", 28: "L2Norm5_3"}


class L2Norm(nn.Module):
    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True)) + 1e-10
        return x / norm * self.weight.view(1, -1, 1, 1)


class S3FDNet(nn.Module):
    """(B, 3, H, W) mean-subtracted RGB -> loc (B, A, 4), conf (B, A, 2)
    softmaxed, and the source maps' (H, W)."""

    def __init__(self):
        super().__init__()
        vgg: List[nn.Module] = []
        cin = 3
        for item, arg in _VGG_PLAN:
            if item == "pool":
                vgg.append(nn.MaxPool2d(2, 2))
            elif item == "pool_ceil":
                vgg.append(nn.MaxPool2d(2, 2, ceil_mode=True))
            else:
                vgg += [nn.Conv2d(cin, arg, 3, padding=1), nn.ReLU()]
                cin = arg
        vgg += [nn.Conv2d(512, 1024, 3, padding=6, dilation=6), nn.ReLU(),
                nn.Conv2d(1024, 1024, 1), nn.ReLU()]
        self.vgg = nn.ModuleList(vgg)
        self.L2Norm3_3 = L2Norm(256, 10.0)
        self.L2Norm4_3 = L2Norm(512, 8.0)
        self.L2Norm5_3 = L2Norm(512, 5.0)
        self.extras = nn.ModuleList([
            nn.Conv2d(1024, 256, 1), nn.Conv2d(256, 512, 3, 2, 1),
            nn.Conv2d(512, 128, 1), nn.Conv2d(128, 256, 3, 2, 1)])
        chans = (256, 512, 512, 1024, 512, 256)
        self.loc = nn.ModuleList([nn.Conv2d(c, 4, 3, padding=1) for c in chans])
        self.conf = nn.ModuleList([nn.Conv2d(c, 4 if i == 0 else 2, 3, padding=1)
                                   for i, c in enumerate(chans)])

    def forward(self, x):
        sources = []
        for i, layer in enumerate(self.vgg):
            x = layer(x)
            if i - 1 in _SOURCES:  # after the ReLU of a source conv
                sources.append(getattr(self, _SOURCES[i - 1])(x))
        sources.append(x)
        for i, conv in enumerate(self.extras):
            x = F.relu(conv(x))
            if i % 2:
                sources.append(x)
        b = x.shape[0]
        locs, confs, fmaps = [], [], []
        for i, s in enumerate(sources):
            loc = self.loc[i](s).permute(0, 2, 3, 1)
            conf = self.conf[i](s).permute(0, 2, 3, 1)
            if i == 0:
                # max-out background label (s3fd_net.py:148-149)
                max_bg = conf[..., 0:3].amax(dim=-1, keepdim=True)
                conf = torch.cat([max_bg, conf[..., 3:]], dim=-1)
            fmaps.append((s.shape[2], s.shape[3]))
            locs.append(loc.reshape(b, -1, 4))
            confs.append(conf.reshape(b, -1, 2))
        return (torch.cat(locs, 1), F.softmax(torch.cat(confs, 1), dim=-1),
                tuple(fmaps))


def s3fd_priors(image_size: Tuple[int, int], feature_maps) -> np.ndarray:
    """(A, 4) anchors (s3fd/utils.py:174-205)."""
    imh, imw = image_size
    out = []
    for k, (fh, fw) in enumerate(feature_maps):
        for i, j in product(range(fh), range(fw)):
            f_kw = imw / PRIOR_STEPS[k]
            f_kh = imh / PRIOR_STEPS[k]
            out.append([
                (j + 0.5) / f_kw,
                (i + 0.5) / f_kh,
                PRIOR_MIN_SIZES[k] / imw,
                PRIOR_MIN_SIZES[k] / imh,
            ])
    return np.asarray(out, np.float32)


@dataclass
class S3FDPredictor:
    """Batched S3FD detection (threshold 0.8 default like the reference) on
    ``device`` (``cuda`` unless the caller asks for the CPU);
    ``state_dict``: the port's ``S3FDNet`` weights."""

    state_dict: dict
    threshold: float = 0.8
    conf_thresh: float = 0.05
    nms_thresh: float = 0.3
    nms_top_k: int = 5000
    top_k: int = 750
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.net = S3FDNet()
        self.net.load_state_dict(self.state_dict, strict=True)
        self.net.to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kw):
        from avsr_tpu_torch.core.checkpoint import load_torch_state_dict

        return cls(state_dict=released_state(load_torch_state_dict(path)),
                   **kw)

    @torch.no_grad()
    def outputs(self, frames_rgb: np.ndarray):
        """(B, H, W, 3) uint8 RGB frames -> the network's loc and conf as
        numpy, and the source maps' sizes."""
        x = upload_frames(frames_rgb, RGB_MEAN, self.device)
        loc, conf, fmaps = self.net(x)
        return loc.cpu().numpy(), conf.cpu().numpy(), fmaps

    def detect_batch(self, frames_rgb: np.ndarray) -> List[np.ndarray]:
        return self.decode(frames_rgb.shape[1:3], *self.outputs(frames_rgb))

    def decode(self, image_size: Tuple[int, int], loc, conf,
               fmaps) -> List[np.ndarray]:
        """The host stage: decode, score filter and NMS of each frame."""
        h, w = image_size
        priors = s3fd_priors((h, w), fmaps)
        scale = np.array([w, h, w, h], np.float32)
        out = []
        for i in range(loc.shape[0]):
            boxes = decode_boxes(loc[i], priors, VARIANCE)
            scores = conf[i, :, 1]
            keep = scores > self.conf_thresh
            if not keep.any():
                out.append(np.empty((0, 5), np.float32))
                continue
            dets = np.hstack([boxes[keep] * scale, scores[keep, None]]).astype(
                np.float32
            )
            kept = nms(dets, self.nms_thresh, self.nms_top_k)
            dets = dets[kept][: self.top_k]
            out.append(dets[dets[:, 4] >= self.threshold])
        return out

    def __call__(self, image: np.ndarray, rgb: bool = True) -> np.ndarray:
        if not rgb:
            image = image[..., ::-1]
        return self.detect_batch(image[None])[0]


def s3fd_flax_to_torch(variables: dict) -> dict:
    """The JAX ``S3FDNet`` variables -> the port's state dict: the inverse
    of ``s3fd_torch_to_flax``."""

    def flax_path(name: str):
        parts = name.split(".")
        return (parts[0] if len(parts) == 1 else f"{parts[0]}_{parts[1]}",)

    with torch.device("meta"):
        net = S3FDNet()
    return state_from_flax(net, variables, flax_path)
