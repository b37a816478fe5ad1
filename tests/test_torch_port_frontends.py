"""The port's offline video frontends (``avsr_tpu_torch/frontends/``)
against the JAX package's, on the CPU, in fp32.

Weights are seeded on the JAX side: the flax variable tree's shapes come
from ``jax.eval_shape`` of ``init`` (no compile) and numpy fills them
(fan-in scaled kernels, random BN scales, shifts and statistics); the
port gets them through its ``*_flax_to_torch``, loaded strictly.
Tolerances:

- the weight round trip through the JAX converters: bit-exact;
- ``RetinaFaceNet`` (both backbones) and ``S3FDNet`` on 2 frames of
  100x140 (neither side a multiple of 32, so the FPN resizes at a
  non-integer ratio): within 1e-4 of the largest output;
- the detectors' host stage fed the JAX network's outputs: bit-equal
  detections;
- ``FAN`` (1 and 2 modules, input 64): heatmaps within 1e-4 of the
  largest; ``decode_heatmaps`` on the same heatmaps within 1e-6;
  ``FANPredictor`` landmarks within 1e-3 px, a box past the frame edge;
- ``VideoProcess`` on a synthetic mean face: crops bit-equal; the
  tracker's ids, ``split_asd_transcript`` and ``LandmarksDetector``'s
  host logic equal; ``HeadPoseEstimator`` on a synthetic BFM file within
  1e-9.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.frontends import fan as JF  # noqa: E402
from avsr_tpu.frontends import headpose as JH  # noqa: E402
from avsr_tpu.frontends import retinaface as JR  # noqa: E402
from avsr_tpu.frontends import s3fd as JS  # noqa: E402
from avsr_tpu.frontends import tracker as JT  # noqa: E402
from avsr_tpu.frontends import video_process as JV  # noqa: E402
from avsr_tpu_torch.frontends import fan as PF  # noqa: E402
from avsr_tpu_torch.frontends import headpose as PH  # noqa: E402
from avsr_tpu_torch.frontends import retinaface as PR  # noqa: E402
from avsr_tpu_torch.frontends import s3fd as PS  # noqa: E402
from avsr_tpu_torch.frontends import tracker as PT  # noqa: E402
from avsr_tpu_torch.frontends import video_process as PV  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    assert_same_tree,
    close_to_largest,
    seeded_variables,
    setup_torch,
)

REPO = Path(__file__).resolve().parents[1]
FRAMES = (2, 100, 140)  # detector frames: B, H, W
FAN_INPUT = 64


def _numpy_state(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module", autouse=True)
def _torch():
    setup_torch()


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, FRAMES + (3,)).astype(np.uint8)


DETECTORS = {
    "retinaface_mobilenet": dict(backbone="mobilenet0.25", out=64),
    "retinaface_resnet50": dict(backbone="resnet50", out=256),
    "s3fd": {},
}


@pytest.fixture(scope="module", params=list(DETECTORS))
def detector(request, frames):
    """(name, JAX variables, JAX net outputs on ``frames``, port state)."""
    name, spec = request.param, DETECTORS[request.param]
    x = jnp.zeros((1, 32, 32, 3))
    if name == "s3fd":
        jnet = JS.S3FDNet()
        variables = seeded_variables(jnet, 1, x, stem_gain=1 / 64)
        state = PS.s3fd_flax_to_torch(variables)
        imgs = frames.astype(np.float32) - JS.RGB_MEAN
    else:
        jnet = JR.RetinaFaceNet(spec["backbone"], spec["out"])
        variables = seeded_variables(jnet, 2, x, stem_gain=1 / 64)
        state = PR.retinaface_flax_to_torch(variables, spec["backbone"])
        imgs = frames.astype(np.float32) - JR.BGR_MEAN
    outs = jax.jit(jnet.apply)(variables, jnp.asarray(imgs))
    outs = tuple(np.asarray(o) if isinstance(o, jax.Array) else o
                 for o in outs)
    return name, variables, outs, state


def _port_predictor(name, state, **kw):
    if name == "s3fd":
        return PS.S3FDPredictor(state, device="cpu", **kw)
    return PR.RetinaFacePredictor(
        state, backbone=DETECTORS[name]["backbone"], device="cpu", **kw)


def test_detector_weights_round_trip(detector):
    name, variables, _, state = detector
    _port_predictor(name, state)  # strict load into the port's net
    if name == "s3fd":
        back = JS.s3fd_torch_to_flax(_numpy_state(state))
    else:
        back = JR.retinaface_torch_to_flax(
            _numpy_state(state), DETECTORS[name]["backbone"])
    assert_same_tree(back, variables)


def test_detector_net_matches_jax(detector, frames):
    """The port's network (through the predictor's upload of uint8 frames)
    against the JAX network on the same frames."""
    name, _, want, state = detector
    got = _port_predictor(name, state).outputs(frames)
    for g, w, what in zip(got, want, ("loc", "conf", "ldm")):
        close_to_largest(g, w, 1e-4, f"{name} {what}")
    if name == "s3fd":
        assert got[2] == want[2]


def test_detector_host_stage_matches_jax(detector, frames):
    """Priors, decode, score filter and NMS of both packages on the JAX
    network's outputs: bit-equal detections. The score threshold is
    lowered to 0.5 on both sides, so random weights leave detections to
    compare."""
    name, variables, outs, state = detector
    if name == "s3fd":
        jpred = JS.S3FDPredictor(variables, threshold=0.5)
    else:
        jpred = JR.RetinaFacePredictor(
            variables, backbone=DETECTORS[name]["backbone"], threshold=0.5)
    jpred._fwd = lambda v, x: outs
    want = jpred.detect_batch(frames)
    got = _port_predictor(name, state, threshold=0.5).decode(
        frames.shape[1:3], *outs)
    assert sum(len(w) for w in want) > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_priors_and_nms_match_jax():
    np.testing.assert_array_equal(PR.prior_boxes((100, 140), PR.CFG_MNET),
                                  JR.prior_boxes((100, 140), JR.CFG_MNET))
    fmaps = ((25, 35), (13, 18), (6, 9), (3, 4), (2, 2), (1, 1))
    np.testing.assert_array_equal(PS.s3fd_priors((100, 140), fmaps),
                                  JS.s3fd_priors((100, 140), fmaps))
    rng = np.random.RandomState(3)
    dets = np.hstack([rng.rand(300, 2) * 50, 50 + rng.rand(300, 2) * 50,
                      rng.rand(300, 1)]).astype(np.float32)
    assert PR.nms(dets, 0.4, 200) == JR.nms(dets, 0.4, 200)


# ---------------------------------------------------------------- FAN


@pytest.fixture(scope="module", params=[1, 2])
def fan(request):
    """(num_modules, JAX variables, port state, input patches, JAX
    heatmaps (B, H, W, L))."""
    n = request.param
    jnet = JF.FAN(num_modules=n)
    variables = seeded_variables(jnet, 3 + n,
                                 jnp.zeros((1, FAN_INPUT, FAN_INPUT, 3)))
    x = np.random.RandomState(5).rand(2, FAN_INPUT, FAN_INPUT, 3)
    x = x.astype(np.float32)
    hm = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    return n, variables, PF.fan_flax_to_torch(variables, n), x, hm


def test_fan_weights_round_trip(fan):
    n, variables, state, _, _ = fan
    PF.FAN(num_modules=n).load_state_dict(state, strict=True)
    assert_same_tree(JF.fan_torch_to_flax(_numpy_state(state)), variables)


def test_fan_heatmaps_and_decode_match_jax(fan):
    n, _, state, x, want = fan
    net = PF.FAN(num_modules=n).eval()
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    close_to_largest(got.permute(0, 2, 3, 1).numpy(), want, 1e-4,
                     f"FAN({n}) heatmaps")
    # the decode on the same heatmaps, and on integer heatmaps full of
    # tied peaks (the first index wins on both sides)
    ties = np.random.RandomState(6).randint(0, 3, want.shape)
    for hm in (want, ties.astype(np.float32)):
        lm_j, sc_j = JF.decode_heatmaps(jnp.asarray(hm), 0.1, 1.0)
        lm_p, sc_p = PF.decode_heatmaps(
            torch.tensor(hm).permute(0, 3, 1, 2), 0.1, 1.0)
        np.testing.assert_allclose(lm_p.numpy(), np.asarray(lm_j),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(sc_p.numpy(), np.asarray(sc_j))


@pytest.mark.parametrize("fan", [1], indirect=True)
def test_fan_predictor_matches_jax(fan):
    """Landmarks of two faces, one box past the frame's left and top edge
    (the crop takes the padding path), BGR input. (The JAX predictor
    writes into ``np.asarray`` of its jitted outputs, which JAX makes
    read-only: its outputs are handed over as writable copies.)"""
    _, variables, state, _, _ = fan
    rng = np.random.RandomState(7)
    image = rng.randint(0, 256, (100, 140, 3)).astype(np.uint8)
    boxes = np.array([[-12.3, -8.6, 40.2, 48.9, 0.9],
                      [70.5, 30.1, 118.7, 84.4, 0.95]], np.float32)
    jpred = JF.FANPredictor(variables, num_modules=1, input_size=FAN_INPUT)
    jfwd = jpred._fwd
    jpred._fwd = lambda v, p: tuple(np.array(o) for o in jfwd(v, p))
    ppred = PF.FANPredictor(state, num_modules=1, input_size=FAN_INPUT,
                            device="cpu")
    lm_j, sc_j = jpred(image, boxes[:, :4], rgb=False)
    lm_p, sc_p = ppred(image, boxes[:, :4], rgb=False)
    assert lm_p.shape == (2, 68, 2)
    np.testing.assert_allclose(lm_p, lm_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(sc_p, sc_j, rtol=0,
                               atol=1e-4 * np.abs(sc_j).max())


# ---------------------------------------------------------------- host code


def mean_face_case(tmp_path, t: int = 14, h: int = 200, w: int = 220):
    """(video (T, H, W, 3) uint8, per-frame landmarks with two missing,
    mean-face path): a synthetic 68-point mean face on the 256 grid, its
    mouth near the grid's centre, and landmarks that place it in the frame
    with slight motion, so every crop stays within ``cut_patch``'s
    bounds."""
    rng = np.random.RandomState(3)
    face = np.stack([96 + 64 * rng.rand(68), 88 + 80 * rng.rand(68)], axis=1)
    path = tmp_path / "mean_face.npy"
    np.save(path, face)
    video = (rng.rand(t, h, w, 3) * 255).astype(np.uint8)
    landmarks = []
    for i in range(t):
        lm = 0.7 * face + np.array([20.0, 10.0]) + i * 0.5 + rng.rand(68, 2)
        landmarks.append(None if i in (3, 7) else lm.astype(np.float32))
    return video, landmarks, str(path)


def test_video_process_matches_jax(tmp_path):
    video, landmarks, path = mean_face_case(tmp_path)
    copy = lambda: [None if x is None else x.copy() for x in landmarks]  # noqa: E731
    want = JV.VideoProcess(mean_face_path=path)(video.copy(), copy())
    got = PV.VideoProcess(mean_face_path=path)(video.copy(), copy())
    assert got.shape == want.shape == (len(video), 96, 96)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    lm_p = PV.interpolate_landmarks(copy())
    lm_j = JV.interpolate_landmarks(copy())
    np.testing.assert_array_equal(np.stack(lm_p), np.stack(lm_j))
    np.testing.assert_array_equal(
        PV.smooth_landmarks(np.stack(lm_p), 12),
        JV.smooth_landmarks(np.stack(lm_j), 12))
    assert PV.interpolate_landmarks([None, None]) is None


def test_landmarks_detector_matches_jax():
    """The chain's host logic with stand-in detectors: batches of 4
    frames, frames without a face, the largest face's landmarks kept."""

    class Boxes:
        def detect_batch(self, chunk):
            out = []
            for f in chunk:
                k = int(f[0, 0, 0]) % 3
                out.append(np.array([[10, 10, 10 + 5 * j + 20 * (j == 1),
                                      30 + 3 * j, 0.9] for j in range(k)],
                                    np.float32).reshape(k, 5))
            return out

    class Points:
        def __call__(self, frame, boxes, rgb=True):
            assert rgb is False
            pts = np.stack([np.full((68, 2), b[2] + frame[0, 0, 1])
                            for b in boxes])
            return pts, np.ones((len(boxes), 68))

    frames = np.random.RandomState(8).randint(0, 256, (10, 4, 4, 3))
    got = PV.LandmarksDetector(Boxes(), Points(), batch_size=4)(frames)
    want = JV.LandmarksDetector(Boxes(), Points(), batch_size=4)(frames)
    assert [x is None for x in got] == [x is None for x in want]
    assert any(x is None for x in got) and any(x is not None for x in got)
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g, w)


def test_tracker_and_transcript_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    ours, ref = PT.SimpleFaceTracker(), JT.SimpleFaceTracker()
    boxes = np.array([[10, 10, 50, 50], [100, 100, 150, 160]], float)
    for step in range(8):
        frame_boxes = boxes + rng.randn(*boxes.shape) * 2
        if step == 3:
            frame_boxes = frame_boxes[:1]  # one face disappears
        if step in (4, 5):
            frame_boxes = np.vstack([frame_boxes, [[300, 300, 340, 350]]])
        if step == 6:
            frame_boxes = np.empty((0, 4))
        assert ours(frame_boxes.copy()) == ref(frame_boxes.copy())
    ours.reset(False)
    ref.reset(False)
    assert ours(boxes.copy()) == ref(boxes.copy())

    p = tmp_path / "t.txt"
    lines = ["header stuff", "WORD START END ASDSCORE"]
    start = 0.0
    for i in range(40):
        lines.append(f"w{i} {start:.2f} {start + 0.4:.2f} 1.0")
        start += 0.8
    p.write_text("\n".join(lines))
    got = PT.split_asd_transcript(str(p), max_frames=300)
    assert len(got) >= 2
    assert got == JT.split_asd_transcript(str(p), max_frames=300)


def test_head_pose_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    bfm = tmp_path / "bfm_lms.npy"
    np.save(bfm, rng.rand(68, 3) * 100 - 50)
    ours = PH.HeadPoseEstimator(str(bfm))
    ref = JH.HeadPoseEstimator(str(bfm))
    lm = np.zeros((68, 2))
    lm[17:] = rng.rand(51, 2) * 100 + 100
    for pts, pref in ((lm, 0), (lm[17:], 1), (lm[17:], 3)):
        got = ours(pts.copy(), image_width=640, image_height=480,
                   output_preference=pref)
        want = ref(pts.copy(), image_width=640, image_height=480,
                   output_preference=pref)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_frontends_import_no_jax(tmp_path):
    """Importing every frontend module of the port and running a detector,
    FAN, the crops and the ASD model on the CPU loads nothing of the JAX
    package, JAX, flax or ml_dtypes."""
    video, landmarks, path = mean_face_case(tmp_path)
    np.save(tmp_path / "lms.npy", np.stack(PV.interpolate_landmarks(landmarks)))
    code = f"""
import sys
import numpy as np, torch
from avsr_tpu_torch.frontends import (asd, asd_trainer, cluster, fan,
    headpose, retinaface, s3fd, segmentation, tracker, video_process, weights)
torch.manual_seed(0)
det = retinaface.RetinaFacePredictor(
    retinaface.RetinaFaceNet("mobilenet0.25", 64).state_dict(),
    backbone="mobilenet0.25", device="cpu")
frames = np.zeros((2, 64, 64, 3), np.uint8)
assert len(det.detect_batch(frames)) == 2
lm = fan.FANPredictor(fan.FAN(1).state_dict(), num_modules=1, input_size=64,
                      device="cpu")(frames[0], np.array([[8., 8., 40., 40.]]))
assert lm[0].shape == (1, 68, 2)
video = np.zeros((14, 200, 220, 3), np.uint8)
lms = list(np.load({str(tmp_path / "lms.npy")!r}))
crops = video_process.VideoProcess({path!r})(video, lms)
assert crops.shape == (14, 96, 96), crops.shape
trainer = asd_trainer.ASDTrainer(device="cpu")
scores = trainer.evaluate_network([(np.zeros((1, 16, 13)), np.zeros((1, 4, 32, 32)))])
assert scores.shape == (4,)
bad = [m for m in sys.modules
       if m.split('.')[0] in ('avsr_tpu', 'jax', 'flax', 'ml_dtypes')]
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_predictors_default_to_the_card():
    """No card, no quiet CPU run: the default device is ``cuda``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    state = PR.RetinaFaceNet("mobilenet0.25", 64).state_dict()
    with pytest.raises((RuntimeError, AssertionError)):
        PR.RetinaFacePredictor(state, backbone="mobilenet0.25")


@pytest.mark.parametrize("family", ["retinaface", "s3fd", "fan"])
def test_predictors_load_released_checkpoints(tmp_path, family):
    """``from_torch_checkpoint`` on a reference-format ``.pth``: the BNs'
    ``num_batches_tracked`` (and a RetinaFace backbone's ``fc``) dropped
    as the JAX converters drop them, every other tensor loaded."""
    torch.manual_seed(0)
    net, cls, kw = {
        "retinaface": (PR.RetinaFaceNet("mobilenet0.25", 64),
                       PR.RetinaFacePredictor,
                       dict(backbone="mobilenet0.25")),
        "s3fd": (PS.S3FDNet(), PS.S3FDPredictor, {}),
        "fan": (PF.FAN(num_modules=1), PF.FANPredictor,
                dict(num_modules=1)),
    }[family]
    state = net.state_dict()
    saved = dict(state)
    saved.update({k.replace("running_mean", "num_batches_tracked"):
                  torch.tensor(7) for k in state if "running_mean" in k})
    if family == "retinaface":
        saved["body.fc.weight"] = torch.zeros(10, 256)
    torch.save(saved, tmp_path / "released.pth")
    pred = cls.from_torch_checkpoint(str(tmp_path / "released.pth"),
                                     device="cpu", **kw)
    got = pred.net.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
