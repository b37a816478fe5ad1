"""The port's host plane against the JAX package's: fbank (numpy and
native routes), media decode, transforms, collation, the tokenizer, text
normalisation, WER, WebVTT, ASD segmentation and speaker clustering.

Each of the port's copies (``avsr_tpu_torch/ops/fbank.py``,
``data/{media,transforms,collate,tokenizer,norm_text,wer,vtt}.py``,
``frontends/{segmentation,cluster}.py``) is held equal to its original on
the same seeded inputs; the copies do arithmetic in the same order, so
every comparison is exact. Tests that need cv2 or sklearn skip where they
are missing.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from avsr_tpu.data import collate as jcollate  # noqa: E402
from avsr_tpu.data import media as jmedia  # noqa: E402
from avsr_tpu.data import norm_text as jnorm  # noqa: E402
from avsr_tpu.data import tokenizer as jtok  # noqa: E402
from avsr_tpu.data import transforms as jtr  # noqa: E402
from avsr_tpu.data import vtt as jvtt  # noqa: E402
from avsr_tpu.data import wer as jwer  # noqa: E402
from avsr_tpu.frontends import cluster as jcluster  # noqa: E402
from avsr_tpu.frontends import segmentation as jseg  # noqa: E402
from avsr_tpu.ops import fbank as jfbank  # noqa: E402
from avsr_tpu_torch.data import collate as pcollate  # noqa: E402
from avsr_tpu_torch.data import media as pmedia  # noqa: E402
from avsr_tpu_torch.data import norm_text as pnorm  # noqa: E402
from avsr_tpu_torch.data import tokenizer as ptok  # noqa: E402
from avsr_tpu_torch.data import transforms as ptr  # noqa: E402
from avsr_tpu_torch.data import vtt as pvtt  # noqa: E402
from avsr_tpu_torch.data import wer as pwer  # noqa: E402
from avsr_tpu_torch.frontends import cluster as pcluster  # noqa: E402
from avsr_tpu_torch.frontends import segmentation as pseg  # noqa: E402
from avsr_tpu_torch.ops import fbank as pfbank  # noqa: E402

CORPUS = [
    "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG",
    "HELLO WORLD THIS IS A TEST OF THE TOKENIZER",
    "SPEECH RECOGNITION WITH AUDIO AND VIDEO",
    "THE DOG AND THE FOX ARE FRIENDS IN THE WORLD",
    "A LAZY AFTERNOON WITH A QUICK TEST",
] * 4


def write_toy_tokenizer(directory: str, n_units: int, seed: int = 0):
    """A unigram model trained by the JAX package's trainer on a small
    corpus, and a units file of exactly ``n_units`` lines (``<unk>`` 1,
    the trained pieces from 2, filler pieces after them), so that
    ``TextTransform.token_list`` has ``n_units + 2`` entries: every id of
    a model with that many outputs maps to a piece."""
    from avsr_tpu.data.spm_train import save_model, train_unigram

    pieces = train_unigram(CORPUS, vocab_size=60, max_piece_len=8)
    model = os.path.join(directory, "unigram5000.model")
    save_model(pieces, model)
    names = [p.piece for p in pieces if p.type == 1]
    names += [f"▁FILL{i}" for i in range(n_units)]
    lines = ["<unk> 1"] + [f"{p} {i + 2}" for i, p in
                           enumerate(names[: n_units - 1])]
    units = os.path.join(directory, "unigram5000_units.txt")
    with open(units, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return model, units


def smooth_crops(frames: int, seed: int, size: int = 96) -> np.ndarray:
    """(T, size, size) uint8 frames of smooth gradients that drift, as
    mouth crops do; they survive mp4 coding better than noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    base = rng.uniform(60, 190)
    out = []
    for t in range(frames):
        ph = 0.2 * t + rng.uniform(0, 0.05)
        img = base + 40 * np.sin(xx / 11.0 + ph) * np.cos(yy / 13.0 - ph)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def write_fixture(path: str, frames: int, seed: int) -> np.ndarray:
    """An mp4 of smooth crops (25 fps) and its 16 kHz wav sidecar; returns
    the waveform."""
    pmedia.save_video(path, smooth_crops(frames, seed))
    rng = np.random.RandomState(seed + 100)
    wave = (0.2 * rng.randn(frames * 640)).astype(np.float32)
    pmedia.save_audio(os.path.splitext(path)[0] + ".wav", wave)
    return wave


# ---------------------------------------------------------------- fbank


def _waves():
    rng = np.random.RandomState(5)
    return [rng.randn(n).astype(np.float32) * s
            for n, s in ((16000, 0.3), (399, 1.0), (401, 0.01), (25 * 640, 2.0),
                         (12345, 0.5))]


def test_fbank_numpy_route_equal(monkeypatch):
    monkeypatch.setattr(jfbank, "USE_NATIVE", False)
    monkeypatch.setattr(pfbank, "USE_NATIVE", False)
    assert pfbank.fbank_route() == "numpy"
    np.testing.assert_array_equal(pfbank.mel_filterbank(),
                                  jfbank.mel_filterbank())
    for w in _waves():
        assert pfbank.num_frames(len(w)) == jfbank.num_frames(len(w))
        np.testing.assert_array_equal(pfbank.logfbank_np(w),
                                      jfbank.logfbank_np(w))
        np.testing.assert_array_equal(pfbank.fbank_stack_np(w),
                                      jfbank.fbank_stack_np(w))
        for size in (len(w) - 7, len(w), len(w) + 300):
            np.testing.assert_array_equal(pfbank.cut_or_pad_np(w, size),
                                          jfbank.cut_or_pad_np(w, size))


def test_fbank_native_route_equal():
    """The port's library, built from its copy of the source with the same
    g++ call, gives the JAX package's native features bit for bit; both
    packages take the same route."""
    if jfbank._NATIVE is None:
        pytest.skip("the JAX package's native featurizer is not built")
    assert pfbank.fbank_route() == "native"
    assert pfbank.native_library_path().parent.name == "avsr_tpu_torch"
    for w in _waves():
        np.testing.assert_array_equal(pfbank.fbank_stack_np(w),
                                      jfbank.fbank_stack_np(w))
        np.testing.assert_array_equal(pfbank.fbank_stack_native(w),
                                      jfbank.fbank_stack_native(w))


def test_native_source_is_the_packages():
    """The port's fbank.cpp is the JAX package's, comments aside."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def code(path):
        with open(os.path.join(root, path)) as f:
            return [ln for ln in f.read().splitlines()
                    if not ln.lstrip().startswith("//")]

    assert code("avsr_tpu_torch/native/fbank.cpp") == code(
        "avsr_tpu/native/fbank.cpp")


# ---------------------------------------------------------------- transforms


@pytest.mark.parametrize("subset,device_norm", [("test", False),
                                                ("test", True),
                                                ("train", False),
                                                ("train", True)])
def test_video_transform_equal(subset, device_norm):
    frames = np.random.RandomState(3).randint(
        0, 256, size=(40, 96, 96, 1)).astype(np.float32)
    want = jtr.VideoTransform(subset, device_norm)(
        frames, np.random.RandomState(11))
    got = ptr.VideoTransform(subset, device_norm)(
        frames, np.random.RandomState(11))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subset,extras", [("test", False), ("test", True),
                                           ("train", False), ("train", True)])
def test_audio_transforms_equal(subset, extras):
    """AudioTransform (interferers and noise at train time, a target SNR at
    test time) and RawAudioTransform, from the same RandomState; the test
    subset's noise offset comes from numpy's global state, seeded alike."""
    rng = np.random.RandomState(4)
    wave = (0.3 * rng.randn(3 * 16000)).astype(np.float32)
    noise = (0.1 * rng.randn(5 * 16000)).astype(np.float32)
    pool = [(0.2 * rng.randn(n)).astype(np.float32)
            for n in (40000, 20000, 90000)]

    def sampler(r):
        return pool[r.randint(len(pool))]

    kw = {}
    if extras:
        kw = dict(noise=noise, snr_target=5.0)
        if subset == "train":
            kw["sample_interferer"] = sampler
    outs = []
    for mod in (jtr, ptr):
        np.random.seed(21)
        raw_kw = {k: v for k, v in kw.items() if k != "sample_interferer"}
        outs.append((
            mod.AudioTransform(subset, **kw)(wave, np.random.RandomState(9)),
            mod.RawAudioTransform(subset, **raw_kw)(
                wave, np.random.RandomState(9))))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- media and collate


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("media")
    paths = []
    for i, frames in enumerate((30, 22)):
        p = str(d / f"utt{i}.mp4")
        write_fixture(p, frames, seed=i)
        paths.append(p)
    return paths


@pytest.mark.parametrize("start,end", [(0.0, None), (0.2, 0.8)])
def test_media_decode_equal(fixtures, start, end):
    for p in fixtures:
        np.testing.assert_array_equal(pmedia.load_video(p, start, end),
                                      jmedia.load_video(p, start, end))
        np.testing.assert_array_equal(pmedia.load_audio(p, start, end),
                                      jmedia.load_audio(p, start, end))


@pytest.fixture(scope="module")
def toy_text(tmp_path_factory):
    d = tmp_path_factory.mktemp("spm")
    model, units = write_toy_tokenizer(str(d), n_units=59)
    return (jtok.TextTransform(model, units), ptok.TextTransform(model, units))


@pytest.mark.parametrize("subset", ["test", "train"])
def test_collate_from_media_equal(fixtures, toy_text, subset):
    """Bytes-free paths with start/end times, labels, buckets and a seed;
    the train subset draws its crops and masks from the collator's
    RandomState."""
    jtt, ptt = toy_text
    feats = [{"video": fixtures[0], "label": "HELLO WORLD"},
             {"video": fixtures[1], "start_time": 0.1, "end_time": 0.7,
              "label": "THE LAZY DOG"}]
    kw = dict(t_buckets=(32, 64), l_buckets=(8, 16), seed=5)
    want = jcollate.DataCollator(
        jtt, jtr.VideoTransform(subset, device_norm=True),
        jtr.AudioTransform(subset), **kw)(feats, group_index=3)
    got = pcollate.DataCollator(
        ptt, ptr.VideoTransform(subset, device_norm=True),
        ptr.AudioTransform(subset), **kw)(feats, group_index=3)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_collate_pre_decoded_equal():
    rng = np.random.RandomState(8)
    feats = [{"video_frames": rng.randint(0, 256, size=(n, 96, 96, 1)).astype(
        np.float32), "audio_wave": rng.randn(n * 640 + d).astype(np.float32)}
        for n, d in ((17, 100), (9, -300))]
    want = jcollate.DataCollator()(feats)
    got = pcollate.DataCollator()(feats)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------- text


def test_tokenizer_equal(toy_text):
    jtt, ptt = toy_text
    assert ptt.token_list == jtt.token_list
    assert (ptt.vocab_size, ptt.eos_id) == (jtt.vocab_size, jtt.eos_id) == (
        61, 60)
    for text in CORPUS[:5] + ["  HELLO   LAZY  FOX ", "QXZ UNSEEN WORDS",
                              "ＨELLO", ""]:
        assert ptt.spm.encode_pieces(text) == jtt.spm.encode_pieces(text)
        ids = ptt.tokenize(text)
        np.testing.assert_array_equal(ids, jtt.tokenize(text))
        assert ptt.post_process(ids) == jtt.post_process(ids)
    ids = np.arange(-1, 61)
    assert ptt.post_process(ids) == jtt.post_process(ids)


def test_tokenizer_asset_search(tmp_path, monkeypatch):
    """Without explicit paths the assets come from the asset directories
    (``AVSR_SPM_DIR`` first); without them it raises."""
    write_toy_tokenizer(str(tmp_path), n_units=59)
    monkeypatch.setattr(ptok, "_DEFAULT_ASSET_DIRS", (str(tmp_path),))
    assert ptok.TextTransform().vocab_size == 61
    monkeypatch.setattr(ptok, "_DEFAULT_ASSET_DIRS", ("",))
    with pytest.raises(FileNotFoundError):
        ptok.TextTransform()


def test_parse_model_proto_equal(tmp_path):
    model, _ = write_toy_tokenizer(str(tmp_path), n_units=59)
    assert ptok.parse_model_proto(model) == [
        ptok.SpmPiece(p.piece, p.score, p.type)
        for p in jtok.parse_model_proto(model)]


TEXTS = [
    "Hello, world! It's 5.5% of $10 -- e.g. www.example.com",
    "DON'T STOP-BELIEVING <unk> (laughs) [noise] U.S.A. 3.14",
    "  mixed   CASE\twith\ttabs and numbers 1,000,000 ",
    "",
]


@pytest.mark.parametrize("text", TEXTS)
def test_norm_string_equal(text):
    assert pnorm.norm_string(text) == jnorm.norm_string(text)


def test_wer_equal():
    rng = np.random.RandomState(2)
    words = "A B C D E F G".split()
    refs = [" ".join(rng.choice(words, rng.randint(1, 9))) for _ in range(12)]
    hyps = [" ".join(rng.choice(words, rng.randint(0, 9))) for _ in range(12)]
    assert pwer.wer(reference=refs, hypothesis=hyps) == jwer.wer(
        reference=refs, hypothesis=hyps)
    for r, h in zip(refs, hyps):
        assert pwer.wer(reference=r, hypothesis=h) == jwer.wer(
            reference=r, hypothesis=h)
    calc = dict(char_list=list("-_ABCDEFG"), sym_space="_", sym_blank="-")
    ys = rng.randint(1, 9, size=(3, 10))
    ys[0, 7:] = -1
    hs = rng.randint(0, 9, size=(3, 10))
    jc = jwer.ErrorCalculator(**calc, report_cer=True, report_wer=True)
    pc = pwer.ErrorCalculator(**calc, report_cer=True, report_wer=True)
    assert pc(hs, ys) == jc(hs, ys)
    assert pc(hs, ys, is_ctc=True) == jc(hs, ys, is_ctc=True)


def test_vtt_equal():
    rng = np.random.RandomState(6)
    cues = [jvtt.Cue(float(s), float(s + d), f"LINE {i}")
            for i, (s, d) in enumerate(zip(np.cumsum(rng.rand(5) * 3),
                                           rng.rand(5) * 2 + 0.1))]
    text = jvtt.write(cues)
    assert pvtt.write([pvtt.Cue(c.start, c.end, c.text) for c in cues]) == text
    assert [(c.start, c.end, c.text) for c in pvtt.parse(text)] == [
        (c.start, c.end, c.text) for c in jvtt.parse(text)]


# ---------------------------------------------------------------- segmentation and clustering


def _asd(seed, n=400):
    rng = np.random.RandomState(seed)
    base = int(rng.randint(0, 100))
    level = np.repeat(rng.randn(n // 20) * 2.0, 20)
    return {str(base + i): float(level[i] + 0.3 * rng.randn())
            for i in range(n)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmentation_equal(seed):
    asd = _asd(seed)
    assert pseg.segment_by_asd(asd) == jseg.segment_by_asd(asd)
    assert pseg.segment_by_asd(asd, pseg.EGO_PARAMS) == jseg.segment_by_asd(
        asd, jseg.EGO_PARAMS)
    for max_length in (1.0, 4.0, 15.0):
        assert pseg.asd_chunks(asd, max_length) == jseg.asd_chunks(
            asd, max_length)
        assert pseg.fixed_chunks(7.3 + seed, max_length) == jseg.fixed_chunks(
            7.3 + seed, max_length)


def test_cluster_equal(tmp_path):
    pytest.importorskip("sklearn")
    paths = {}
    for i in range(4):
        p = tmp_path / f"spk{i}.json"
        p.write_text(__import__("json").dumps(_asd(10 + i)))
        paths[f"spk{i}"] = [str(p)]
    segs = {}
    for name, ps in paths.items():
        got = pcluster.get_speaker_activity_segments(ps, 0.5, 14.0)
        assert got == jcluster.get_speaker_activity_segments(ps, 0.5, 14.0)
        segs[name] = got
    scores = pcluster.calculate_conversation_scores(segs)
    np.testing.assert_array_equal(
        scores, jcluster.calculate_conversation_scores(segs))
    for n in (None, 2):
        assert pcluster.cluster_speakers(scores, list(segs), n_clusters=n) == \
            jcluster.cluster_speakers(scores, list(segs), n_clusters=n)
    true, pred = [0, 0, 1, 1, 2], [0, 1, 1, 1, 2]
    assert pcluster.pairwise_f1_score(true, pred) == \
        jcluster.pairwise_f1_score(true, pred)
    assert pcluster.pairwise_f1_score_per_speaker(true, pred) == \
        jcluster.pairwise_f1_score_per_speaker(true, pred)
    assert pcluster.adjusted_rand_index(true, pred) == \
        jcluster.adjusted_rand_index(true, pred)
