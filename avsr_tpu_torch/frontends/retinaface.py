"""RetinaFace face detector, batched over frames, for offline AV preprocessing.

Counterpart of ``avsr_tpu/frontends/retinaface.py``: a MobileNetV1-0.25 or
ResNet-50 backbone -> FPN -> SSH context heads -> box, class and 5-point
landmark anchors (2 per location, strides 8/16/32), then the SSD decode and
greedy NMS in numpy on the host. The network runs batched on the card; the
per-frame decode and NMS stay on the host, as in JAX.

Module and parameter names are the reference checkpoint's (``body.*``,
``fpn.output1.0.weight``, ``ClassHead.0.conv1x1.weight``...), the names
``retinaface_torch_to_flax`` reads. The FPN upsamples with
``mode="nearest-exact"``, which is ``jax.image.resize(..., "nearest")``;
torch's ``"nearest"``, which the original torch detector uses, picks other
rows at non-integer ratios (a 720-row frame's 23-row stride-32 map going to
45 rows). The port follows the JAX package (ROADMAP C37).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import product
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.frontends.weights import released_state, state_from_flax
from avsr_tpu_torch.models.resnet import BatchNorm

CFG_MNET = dict(
    name="mobilenet0.25",
    min_sizes=((16, 32), (64, 128), (256, 512)),
    steps=(8, 16, 32),
    variance=(0.1, 0.2),
    in_channel=32,
    out_channel=64,
)
CFG_RE50 = dict(
    name="resnet50",
    min_sizes=((16, 32), (64, 128), (256, 512)),
    steps=(8, 16, 32),
    variance=(0.1, 0.2),
    in_channel=256,
    out_channel=256,
)

BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1,
            leaky: float = 0.0, relu: bool = True,
            groups: int = 1) -> nn.Sequential:
    """Conv (no bias) + BN (eps 1e-5) [+ LeakyReLU(leaky)]: indices 0, 1."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False,
                        groups=groups), BatchNorm(cout)]
    if relu:
        layers.append(nn.LeakyReLU(leaky))
    return nn.Sequential(*layers)


def conv_dw(cin: int, cout: int, stride: int) -> nn.Sequential:
    """Depthwise separable block, leaky 0.1: indices 0, 1, 3, 4."""
    return nn.Sequential(
        nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
        BatchNorm(cin), nn.LeakyReLU(0.1),
        nn.Conv2d(cin, cout, 1, bias=False), BatchNorm(cout),
        nn.LeakyReLU(0.1))


class MobileNetV1Quarter(nn.Module):
    """MobileNetV1 x0.25 backbone returning stage1/2/3 features."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(
            conv_bn(3, 8, 3, 2, leaky=0.1), conv_dw(8, 16, 1),
            conv_dw(16, 32, 2), conv_dw(32, 32, 1), conv_dw(32, 64, 2),
            conv_dw(64, 64, 1))
        self.stage2 = nn.Sequential(
            conv_dw(64, 128, 2), *[conv_dw(128, 128, 1) for _ in range(5)])
        self.stage3 = nn.Sequential(conv_dw(128, 256, 2),
                                    conv_dw(256, 256, 1))

    def forward(self, x):
        f1 = self.stage1(x)
        f2 = self.stage2(f1)
        return f1, f2, self.stage3(f2)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            BatchNorm(planes * 4)) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(h + res)


class ResNet50Backbone(nn.Module):
    """torchvision-style ResNet-50, returning layer2/3/4 features."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), (3, 4, 6, 3))):
            stride = 1 if stage == 0 else 2
            layer = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes * 4)
                layer.append(Bottleneck(inplanes, planes, s, ds))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer1(x)
        f1 = self.layer2(x)
        f2 = self.layer3(f1)
        return f1, f2, self.layer4(f2)


class SSH(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        leaky = 0.1 if out <= 64 else 0.0
        self.conv3X3 = conv_bn(cin, out // 2, relu=False)
        self.conv5X5_1 = conv_bn(cin, out // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn(out // 4, out // 4, relu=False)
        self.conv7X7_2 = conv_bn(out // 4, out // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn(out // 4, out // 4, relu=False)

    def forward(self, x):
        c3 = self.conv3X3(x)
        c5_1 = self.conv5X5_1(x)
        c5 = self.conv5X5_2(c5_1)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([c3, c5, c7], dim=1))


class FPN(nn.Module):
    def __init__(self, cins: Tuple[int, int, int], out: int):
        super().__init__()
        leaky = 0.1 if out <= 64 else 0.0
        self.output1 = conv_bn(cins[0], out, 1, leaky=leaky)
        self.output2 = conv_bn(cins[1], out, 1, leaky=leaky)
        self.output3 = conv_bn(cins[2], out, 1, leaky=leaky)
        self.merge1 = conv_bn(out, out, 3, leaky=leaky)
        self.merge2 = conv_bn(out, out, 3, leaky=leaky)

    def forward(self, f1, f2, f3):
        o1, o2, o3 = self.output1(f1), self.output2(f2), self.output3(f3)
        up3 = F.interpolate(o3, size=o2.shape[2:], mode="nearest-exact")
        o2 = self.merge2(o2 + up3)
        up2 = F.interpolate(o2, size=o1.shape[2:], mode="nearest-exact")
        o1 = self.merge1(o1 + up2)
        return o1, o2, o3


class _Head(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        # NCHW -> (B, H * W * anchors * k) in JAX's (H, W, anchor) order
        y = self.conv1x1(x).permute(0, 2, 3, 1)
        return y.reshape(y.shape[0], -1)


class RetinaFaceNet(nn.Module):
    """(B, 3, H, W) BGR-mean-subtracted -> loc (B, A, 4), conf (B, A, 2)
    softmaxed, landmarks (B, A, 10)."""

    def __init__(self, backbone: str = "resnet50", out_channel: int = 256,
                 num_anchors: int = 2):
        super().__init__()
        if backbone == "mobilenet0.25":
            self.body, cins = MobileNetV1Quarter(), (64, 128, 256)
        else:
            self.body, cins = ResNet50Backbone(), (512, 1024, 2048)
        self.fpn = FPN(cins, out_channel)
        self.ssh1 = SSH(out_channel, out_channel)
        self.ssh2 = SSH(out_channel, out_channel)
        self.ssh3 = SSH(out_channel, out_channel)
        self.ClassHead = nn.ModuleList(
            [_Head(out_channel, num_anchors * 2) for _ in range(3)])
        self.BboxHead = nn.ModuleList(
            [_Head(out_channel, num_anchors * 4) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList(
            [_Head(out_channel, num_anchors * 10) for _ in range(3)])

    def forward(self, x):
        f1, f2, f3 = self.fpn(*self.body(x))
        feats = (self.ssh1(f1), self.ssh2(f2), self.ssh3(f3))
        b = x.shape[0]
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], 1)
        conf = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], 1)
        ldm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], 1)
        return (loc.view(b, -1, 4), F.softmax(conf.view(b, -1, 2), dim=-1),
                ldm.view(b, -1, 10))


# ---------------------------------------------------------------------------
# anchors / decode / NMS (host side, numpy)
# ---------------------------------------------------------------------------


def prior_boxes(image_size: Tuple[int, int], cfg=CFG_RE50) -> np.ndarray:
    """(A, 4) anchors in (cx, cy, w, h) normalized coords (prior_box.py:6)."""
    h, w = image_size
    anchors = []
    for k, step in enumerate(cfg["steps"]):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i, j in product(range(fh), range(fw)):
            for min_size in cfg["min_sizes"][k]:
                s_kx = min_size / w
                s_ky = min_size / h
                cx = (j + 0.5) * step / w
                cy = (i + 0.5) * step / h
                anchors.append([cx, cy, s_kx, s_ky])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray, variances=(0.1, 0.2)):
    """SSD box decode (box_utils.py:210)."""
    boxes = np.concatenate(
        [
            priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:],
            priors[:, 2:] * np.exp(loc[:, 2:] * variances[1]),
        ],
        axis=1,
    )
    boxes[:, :2] -= boxes[:, 2:] / 2
    boxes[:, 2:] += boxes[:, :2]
    return boxes


def decode_landmarks(pre: np.ndarray, priors: np.ndarray, variances=(0.1, 0.2)):
    """Landmark decode (box_utils.py:231)."""
    out = [
        priors[:, :2] + pre[:, 2 * i : 2 * i + 2] * variances[0] * priors[:, 2:]
        for i in range(5)
    ]
    return np.concatenate(out, axis=1)


def nms(dets: np.ndarray, thresh: float, top_k: Optional[int] = None) -> List[int]:
    """Greedy IoU NMS (py_cpu_nms.py:11)."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    if top_k is not None:
        order = order[:top_k]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return keep


def upload_frames(frames: np.ndarray, mean: np.ndarray,
                  device: torch.device) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, 3, H, W) float32 less ``mean`` on
    ``device``, in one upload of the uint8 bytes."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    x = x.float() - torch.from_numpy(mean).to(device)
    return x.permute(0, 3, 1, 2)


@dataclass
class RetinaFacePredictor:
    """Batched face detection over frames.

    ``state_dict``: the port's ``RetinaFaceNet`` weights
    (``retinaface_flax_to_torch``, or a released checkpoint through
    ``from_torch_checkpoint``). The reference predictor's settings
    (retina_face_predictor.py:57): conf_thresh 0.02, nms_thresh 0.4,
    nms_top_k 5000, top_k 750, and the caller-side score threshold (0.8
    in LandmarksDetector). Runs on ``device`` (``cuda`` unless the caller
    asks for the CPU).
    """

    state_dict: dict
    backbone: str = "resnet50"
    threshold: float = 0.8
    conf_thresh: float = 0.02
    nms_thresh: float = 0.4
    nms_top_k: int = 5000
    top_k: int = 750
    device: str = "cuda"

    def __post_init__(self):
        self.cfg = CFG_RE50 if self.backbone == "resnet50" else CFG_MNET
        self.device = torch.device(self.device)
        self.net = RetinaFaceNet(self.backbone, self.cfg["out_channel"])
        self.net.load_state_dict(self.state_dict, strict=True)
        self.net.to(self.device).eval()
        self._priors: dict = {}

    @classmethod
    def from_torch_checkpoint(cls, path: str, backbone: str = "resnet50", **kw):
        """A released checkpoint; the keys the JAX converter skips
        (``num_batches_tracked``, the backbone's ``fc``/``avg``) are
        dropped."""
        from avsr_tpu_torch.core.checkpoint import load_torch_state_dict

        state = released_state(load_torch_state_dict(path), ("fc", "avg"))
        return cls(state_dict=state, backbone=backbone, **kw)

    @torch.no_grad()
    def outputs(self, frames_bgr: np.ndarray):
        """(B, H, W, 3) uint8 BGR frames -> the network's loc, conf, ldm
        as numpy."""
        x = upload_frames(frames_bgr, BGR_MEAN, self.device)
        return tuple(t.cpu().numpy() for t in self.net(x))

    def detect_batch(self, frames_bgr: np.ndarray) -> List[np.ndarray]:
        """(B, H, W, 3) uint8 BGR frames -> per-frame (N, 15) detections
        [x1 y1 x2 y2 score lmx1 lmy1 ... lmx5 lmy5]."""
        return self.decode(frames_bgr.shape[1:3], *self.outputs(frames_bgr))

    def decode(self, image_size: Tuple[int, int], loc, conf,
               ldm) -> List[np.ndarray]:
        """The host stage: decode, score filter and NMS of each frame's
        network outputs."""
        h, w = image_size
        if (h, w) not in self._priors:
            self._priors[(h, w)] = prior_boxes((h, w), self.cfg)
        priors = self._priors[(h, w)]
        scale = np.array([w, h, w, h], np.float32)
        scale_lm = np.tile([w, h], 5).astype(np.float32)

        out = []
        for i in range(loc.shape[0]):
            boxes = decode_boxes(loc[i], priors, self.cfg["variance"]) * scale
            scores = conf[i, :, 1]
            lms = decode_landmarks(ldm[i], priors, self.cfg["variance"]) * scale_lm
            inds = scores > self.conf_thresh
            if not inds.any():
                out.append(np.empty((0, 15), np.float32))
                continue
            boxes, scores, lms = boxes[inds], scores[inds], lms[inds]
            dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
            keep = nms(dets, self.nms_thresh, self.nms_top_k)
            dets, lms = dets[keep][: self.top_k], lms[keep][: self.top_k]
            final = np.concatenate([dets, lms], axis=1)
            out.append(final[final[:, 4] >= self.threshold])
        return out

    def __call__(self, image: np.ndarray, rgb: bool = True) -> np.ndarray:
        """Single-frame API matching the reference predictor."""
        if rgb:
            image = image[..., ::-1]
        return self.detect_batch(image[None])[0]


def retinaface_flax_to_torch(variables: dict,
                             backbone: str = "resnet50") -> dict:
    """The JAX ``RetinaFaceNet`` variables -> the port's state dict: the
    inverse of ``retinaface_torch_to_flax``."""
    cfg = CFG_RE50 if backbone == "resnet50" else CFG_MNET

    def flax_path(name: str):
        parts = name.split(".")
        if parts[0] in ("ClassHead", "BboxHead", "LandmarkHead"):
            return (f"{parts[0]}_{parts[1]}",)
        return tuple(f"m{s}" if s.isdigit() else s for s in parts)

    with torch.device("meta"):
        net = RetinaFaceNet(backbone, cfg["out_channel"])
    return state_from_flax(net, variables, flax_path)
