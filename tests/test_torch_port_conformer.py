"""The port's conformer family (``avsr_tpu_torch/models/conformer.py``) and
ShuffleNetV2 (``models/shufflenetv2.py``) against the JAX package's, on the
CPU, in fp32 at <= 5e-4 (``PARITY.md``; ShuffleNetV2 2e-4).

The tiny models (2 conformer layers of 64 wide, 4 heads, 128 units, fusion
256, decoder 2 x 64, 40 outputs) get seeded random weights from the port's
``init_weights`` with random BN statistics, cross to the JAX side as a
released checkpoint does (the JAX package's ``convert_state`` over its own
``conformer_*_mapping`` table) and come back into the port through the
port's copied table and ``flax_to_torch``, loaded strictly. (A jitted flax
init of the tiny model costs ~16 s on the CPU; this costs nothing.)
Covered: the weight tables, ``rel_positional_encoding``, the rel-pos
attention with a fully padded row, the conv module in eval and train mode
(its BN statistics update), both frontends, ``encode``, ``ctc_log_probs``,
the loss forward of ``ConformerAVSR`` and of ``ConformerASR`` with each
input layer, the ``Recognizer``'s greedy and beam tokens, the eval CLI's
``auto_avsr`` engine against the JAX engine on mp4 + wav fixtures, the
strict load of a reference-format ``.pth``, and CPU bf16 depthwise
convolution (ROADMAP C12).
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.core import checkpoint as jckpt  # noqa: E402
from avsr_tpu.models import conformer as JC  # noqa: E402
from avsr_tpu_torch.core import checkpoint as pckpt  # noqa: E402
from avsr_tpu_torch.core.weights import init_weights, load_state_file  # noqa: E402
from avsr_tpu_torch.models import conformer as PC  # noqa: E402
from avsr_tpu_torch.models.resnet import BatchNorm  # noqa: E402
from tests.torch_port_common import setup_torch, t  # noqa: E402

TOL = 5e-4
KW = dict(odim=40, adim=64, aheads=4, eunits=128, elayers=2, ddim=64,
          dheads=4, dunits=128, dlayers=2)
T = 8  # video frames of the batch


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _random_bn(model, seed):
    rng = np.random.RandomState(seed)
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            n = mod.running_mean.shape[0]
            mod.running_mean.copy_(t(0.1 * rng.randn(n).astype(np.float32)))
            mod.running_var.copy_(t((0.5 + rng.rand(n)).astype(np.float32)))
            mod.weight.data.copy_(t((0.8 + 0.4 * rng.rand(n)).astype(
                np.float32)))
            mod.bias.data.copy_(t(0.1 * rng.randn(n).astype(np.float32)))


def _pair(model, jax_mapping, port_mapping, seed):
    """(JAX variables, the port model with them): seeded port weights ->
    the JAX package's converter -> the port's ``flax_to_torch``."""
    init_weights(model, torch.Generator().manual_seed(seed))
    _random_bn(model, seed + 1)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jckpt.convert_state(state, jax_mapping)
    back = pckpt.flax_to_torch(variables, port_mapping)
    assert set(back) == set(state)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           back.items()}, strict=True)
    return variables, model.eval()


@pytest.fixture(scope="module")
def avsr():
    """(JAX ConformerAVSR, its variables, the port's model)."""
    setup_torch()
    variables, model = _pair(
        PC.ConformerAVSR(**KW, fusion_hdim=256),
        jckpt.conformer_avsr_mapping(2, 2), pckpt.conformer_avsr_mapping(2, 2),
        seed=0)
    return JC.ConformerAVSR(**KW, fusion_hdim=256), variables, model


@pytest.fixture(scope="module")
def batch():
    """Video frames (2, T, 88, 88, 1), the waveform (2, T*640, 1), video
    lengths (T, 5), labels padded with -1 and their lengths."""
    rng = np.random.RandomState(3)
    video = rng.randn(2, T, 88, 88, 1).astype(np.float32)
    wave = rng.randn(2, T * 640, 1).astype(np.float32)
    lens = np.asarray([T, 5])
    labels = np.asarray([[5, 7, 7, 2], [9, 3, -1, -1]])
    return video, wave, lens, labels, np.asarray([4, 2])


def _sub(tree, *path, layer=None):
    for p in path:
        tree = tree[p]
    if layer is not None:
        tree = jax.tree.map(lambda x: x[layer], tree)
    return tree


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("table", ["avsr", "asr-conv1d", "asr-conv3d"])
def test_conformer_mappings_match_jax(table):
    """The port's copies of the weight tables: the same torch keys, flax
    paths and collections, and transforms that agree on an array."""
    if table == "avsr":
        got, want = (m.conformer_avsr_mapping(3, 2, prefix="x.")
                     for m in (pckpt, jckpt))
    else:
        layer = table.split("-")[1]
        got, want = (m.conformer_asr_mapping(3, 2, layer) for m in
                     (pckpt, jckpt))
    assert len(got) == len(want)
    arrays = {2: np.arange(6.0).reshape(2, 3),
              3: np.arange(24.0).reshape(2, 3, 4),
              4: np.arange(120.0).reshape(2, 3, 4, 5),
              5: np.arange(720.0).reshape(2, 3, 4, 5, 6)}
    for g, w in zip(got, want):
        assert (g[0], g[1], g[3]) == (w[0], w[1], w[3])
        for a in arrays.values():
            try:
                want_a = w[2](a)
            except ValueError:
                continue
            np.testing.assert_array_equal(g[2](a), want_a)


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("t_len,dim", [(1, 8), (5, 64), (8, 24)])
def test_rel_positional_encoding_matches_jax(t_len, dim):
    got = PC.rel_positional_encoding(t_len, dim)
    assert got.shape == (1, 2 * t_len - 1, dim)
    _close(got, JC.rel_positional_encoding(t_len, dim), tol=1e-6)


def test_rel_position_attention_matches_jax(avsr):
    """Layer 0's attention with a padding mask (the second row has 3
    valid keys, the third none): rel_shift, the fp32 masked softmax and
    the zeroed rows."""
    _, variables, model = avsr
    rng = np.random.RandomState(4)
    x = rng.randn(3, T, 64).astype(np.float32)
    mask = np.arange(T)[None, None, :] < np.asarray([T, 3, 0])[:, None, None]
    pos = PC.rel_positional_encoding(T, 64)
    params = _sub(variables["params"], "encoder", "layers", "self_attn",
                  layer=0)
    want = JC.RelPositionAttention(64, 4).apply(
        {"params": params}, x, jnp.asarray(pos.numpy()), mask)
    with torch.no_grad():
        got = model.encoder.encoders[0].self_attn(t(x), pos, t(mask))
    _close(got, want)
    # the fully padded row attends to nothing: linear_out's bias alone
    bias = model.encoder.encoders[0].self_attn.linear_out.bias
    _close(got[2], bias.detach().expand(T, -1), tol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_convolution_module_matches_jax(avsr, train):
    """Layer 0's conv module of the audio encoder; in train mode the batch
    statistics and the running averages' update (flax momentum 0.9, the
    biased variance)."""
    _, variables, model = avsr
    x = np.random.RandomState(5).randn(2, T, 64).astype(np.float32)
    params = _sub(variables["params"], "aux_encoder", "layers",
                  "conv_module", layer=0)
    stats = _sub(variables["batch_stats"], "aux_encoder", "layers",
                 "conv_module", layer=0)
    jmod = JC.ConvolutionModule(64)
    mod = copy.deepcopy(model.aux_encoder.encoders[0].conv_module)
    with torch.no_grad():
        got = mod(t(x), train)
    if not train:
        want = jmod.apply({"params": params, "batch_stats": stats}, x)
        _close(got, want)
        return
    want, upd = jmod.apply({"params": params, "batch_stats": stats}, x,
                           train=True, mutable=["batch_stats"])
    _close(got, want)
    new = upd["batch_stats"]["norm"]
    _close(mod.norm.running_mean, new["mean"], tol=1e-6)
    _close(mod.norm.running_var, new["var"], tol=1e-6)
    assert not np.allclose(new["var"], stats["norm"]["var"])


@pytest.mark.parametrize("layer", ["conv3d", "conv1d"])
def test_frontend_matches_jax(avsr, batch, layer):
    """The Conv3d + swish ResNet-18 video frontend on (2, T, 88, 88, 1);
    the raw-waveform ResNet-1D on a wave 100 samples past T * 640 (the
    trim to a multiple of 640, the pool of 20 steps)."""
    _, variables, model = avsr
    video, wave, *_ = batch
    name = "encoder" if layer == "conv3d" else "aux_encoder"
    sub = {c: _sub(variables[c], name, "frontend")
           for c in ("params", "batch_stats")}
    if layer == "conv3d":
        x, jmod = video, JC.Conv3dResNetFrontend()
    else:
        x = np.concatenate([wave, wave[:, :100]], axis=1)
        jmod = JC.Conv1dResNetFrontend()
    want = jax.jit(jmod.apply)(sub, x)
    with torch.no_grad():
        got = getattr(model, name).frontend(t(x))
    assert got.shape == (2, T, 512)
    _close(got, want)


@pytest.fixture(scope="module")
def jax_avsr_out(avsr, batch):
    """The JAX model's encode, CTC log-probs and loss forward."""
    jmodel, variables, _ = avsr
    video, wave, lens, labels, label_lens = batch

    @jax.jit
    def run(v):
        feats = jmodel.apply(v, wave, video, lens, method="encode")
        logp = jmodel.apply(v, feats, method="ctc_log_probs")
        return feats, logp, jmodel.apply(v, video, wave, labels, lens,
                                         label_lens)

    return run(variables)


def test_encode_and_ctc_match_jax(avsr, batch, jax_avsr_out):
    """Both encoders (the audio one under the video lengths' mask), the
    fusion head and the CTC log-probs."""
    _, _, model = avsr
    video, wave, lens, *_ = batch
    feats, logp, _ = jax_avsr_out
    with torch.no_grad():
        got = model.encode(t(wave), t(video), t(lens))
        _close(got, feats)
        _close(model.ctc_log_probs(got), logp)


def test_loss_forward_matches_jax(avsr, batch, jax_avsr_out):
    _, _, model = avsr
    video, wave, lens, labels, label_lens = batch
    want = jax_avsr_out[2]
    with torch.no_grad():
        got = model(t(video), t(wave), t(labels), t(lens), t(label_lens))
    for name in ("loss", "loss_ctc", "loss_att", "acc"):
        _close(getattr(got, name), getattr(want, name), what=name)


@pytest.mark.parametrize("layer", ["conv1d", "conv3d"])
def test_conformer_asr_matches_jax(batch, layer):
    """auto_asr (the waveform, lengths in samples) and auto_vsr (video
    frames): encode and the loss forward."""
    setup_torch()
    video, wave, lens, labels, label_lens = batch
    variables, model = _pair(
        PC.ConformerASR(**KW, input_layer=layer),
        jckpt.conformer_asr_mapping(2, 2, layer),
        pckpt.conformer_asr_mapping(2, 2, layer), seed=7)
    xs, xl = (wave, lens * 640) if layer == "conv1d" else (video, lens)
    jmodel = JC.ConformerASR(**KW, input_layer=layer)

    @jax.jit
    def run(v):
        return (jmodel.apply(v, xs, xl, method="encode"),
                jmodel.apply(v, xs, labels, xl, label_lens))

    feats, out = run(variables)
    with torch.no_grad():
        _close(model.encode(t(xs), t(xl)), feats)
        got = model(t(xs), t(labels), t(xl), t(label_lens))
    for name in ("loss", "loss_ctc", "loss_att", "acc"):
        _close(getattr(got, name), getattr(out, name), what=name)


def test_depthwise_conv_bf16_cpu_within_rounding():
    """ROADMAP C12 at one channel a group (the conv module's depthwise
    conv, 768 wide, k=31): torch's CPU bf16 conv1d stays within one bf16
    rounding of the float64 result on the same bf16 operands, so the port
    runs it as it is (C12 bites at 4-8 channels a group)."""
    from torch.nn import functional as F

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 768, 60, generator=g).bfloat16()
    w = (0.2 * torch.randn(768, 1, 31, generator=g)).bfloat16()
    b = torch.randn(768, generator=g).bfloat16()
    got = F.conv1d(x, w, b, padding=15, groups=768).double()
    want = F.conv1d(x.double(), w.double(), b.double(), padding=15,
                    groups=768)
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(
        torch.floor(torch.log2(want.abs().clamp_min(1e-30))))
    assert ((got - want).abs() / ulp).max().item() <= 1.0


# ---------------------------------------------------------------- serving


def _utterances(seed, frames=(T, 5)):
    """Host-normalised float32 frames (T_i, 88, 88, 1) and raw waves
    (T_i * 640, 1), as the auto_avsr collator gives them."""
    rng = np.random.RandomState(seed)
    videos = [rng.randn(n, 88, 88, 1).astype(np.float32) for n in frames]
    waves = [rng.randn(n * 640, 1).astype(np.float32) for n in frames]
    return waves, videos


@pytest.fixture(scope="module")
def recognizers(avsr):
    """(JAX, port) Recognizers of the tiny conformer: beam 3,
    ctc_weight 0.1, the waveform 640 x 1 a frame."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    jmodel, variables, model = avsr
    kw = dict(beam_size=3, ctc_weight=0.1, t_buckets=(T,), audio_rate=640,
              audio_dim=1, max_decode_tokens=16)
    return (JaxRecognizer(model=jmodel, variables=variables, cfg=jmodel,
                          **kw),
            Recognizer(model=model, cfg=model, device="cpu", **kw))


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_recognizer_matches_jax(recognizers, mode):
    """Token-exact greedy CTC and joint CTC/attention beam on two
    utterances of 8 and 5 frames, padded to a batch of 3."""
    jrec, prec = recognizers
    waves, videos = _utterances(6)
    want = jrec.transcribe_batch(waves, videos, mode=mode, batch_pad=3)
    got = prec.transcribe_batch(waves, videos, mode=mode, batch_pad=3)
    assert len(got) == 2 and all(len(g) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_bf16_encode_runs_for_conformer(recognizers):
    """``encode_dtype="bfloat16"`` on the conformer family: a bf16 copy of
    the model without its decoder (the model keeps fp32), fp32 features
    and CTC log-probs near the fp32 ones, and a beam that runs."""
    import dataclasses

    _, prec = recognizers
    rec = dataclasses.replace(prec, encode_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in rec._encoder.parameters())
    assert all(b.dtype == torch.bfloat16 for b in rec._encoder.buffers())
    assert all(p.dtype == torch.float32 for p in rec.model.parameters())
    waves, videos = _utterances(6)
    aud, vid, lens, _ = rec._pad_batch(waves, videos)
    assert aud.dtype == torch.bfloat16 and vid.dtype == torch.float32
    feats, ctc = rec.encode(aud, vid, lens)
    want, want_ctc = prec.encode(*prec._pad_batch(waves, videos)[:3])
    assert feats.dtype == ctc.dtype == torch.float32
    assert _rel(feats, want) < 0.1 and _rel(ctc, want_ctc) < 0.1
    assert len(rec.transcribe_batch(waves, videos)) == 2


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.fixture(scope="module")
def auto_avsr_assets(avsr, tmp_path_factory):
    """The tiny model as a reference-format .pth (with BN
    ``num_batches_tracked`` entries, as torch saves them), a toy tokenizer
    of the model's 40 ids, and two mp4 + wav fixtures."""
    pytest.importorskip("cv2")
    from tests.test_torch_port_host import write_fixture, write_toy_tokenizer

    _, _, model = avsr
    root = tmp_path_factory.mktemp("auto_avsr")
    state = dict(model.state_dict())
    for k in list(state):
        if k.endswith("running_var"):
            state[k.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(7))
    ckpt = str(root / "model.pth")
    torch.save(state, ckpt)
    tok = root / "spm"
    tok.mkdir()
    write_toy_tokenizer(str(tok), n_units=KW["odim"] - 2)
    videos = []
    for i, frames in enumerate((14, 9)):
        path = str(root / f"utt{i}.mp4")
        write_fixture(path, frames, seed=20 + i)
        videos.append(path)
    return dict(ckpt=ckpt, tok=str(tok), videos=videos, state=state)


def test_auto_avsr_engine_matches_jax(auto_avsr_assets):
    """``InferenceEngine(model_type="auto_avsr", device="cpu")`` against
    the JAX engine on the same .pth (``odim`` from the tokenizer): the
    transcripts of two mp4 + wav samples, and the loaded model's setup."""
    from avsr_tpu.cli import evaluation as je
    from avsr_tpu.data import tokenizer as jtok
    from avsr_tpu_torch.cli import evaluation as pe
    from avsr_tpu_torch.data import tokenizer as ptok

    a = auto_avsr_assets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtok, "_DEFAULT_ASSET_DIRS", (a["tok"],))
        mp.setattr(ptok, "_DEFAULT_ASSET_DIRS", (a["tok"],))
        # the loaders pop odim (the tokenizer's vocabulary by default),
        # video_wire and encode_dtype from their own copies
        mkw = {k: v for k, v in KW.items() if k != "odim"}
        mkw.update(fusion_hdim=256, video_wire="delta2")
        kw = dict(checkpoint_path=a["ckpt"], batch_size=2)
        jeng = je.InferenceEngine("auto_avsr", model_kwargs=dict(mkw), **kw)
        peng = pe.InferenceEngine("auto_avsr", model_kwargs=dict(mkw),
                                  device="cpu", **kw)
        jeng.load_model()
        peng.load_model()
    rec = peng.recognizer
    assert (rec.audio_rate, rec.audio_dim, rec.device.type) == (640, 1, "cpu")
    assert rec.cfg is rec.model and rec.model.odim == KW["odim"]
    assert "video_wire" not in peng.model_kwargs
    samples = []
    for path in a["videos"]:
        with open(path, "rb") as f, open(path[:-4] + ".wav", "rb") as g:
            samples.append({"video": f.read(), "audio": g.read()})
    got = peng.infer_samples(samples)
    assert got == jeng.infer_samples(samples)
    assert len(got) == 2 and all(isinstance(x, str) for x in got)


def test_reference_pth_loads_strictly(avsr, auto_avsr_assets, tmp_path):
    """A .pth in the reference's names loads into ``ConformerAVSR`` with
    ``load_state_dict(strict=True)`` and every key used (only
    ``num_batches_tracked`` dropped); a stray or a missing key raises."""
    _, _, model = avsr
    state = auto_avsr_assets["state"]
    fresh = PC.ConformerAVSR(**KW, fusion_hdim=256)
    load_state_file(fresh, auto_avsr_assets["ckpt"])
    want = model.state_dict()
    got = fresh.state_dict()
    assert set(got) == set(want) == {
        k for k in state if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(got[k], want[k]) for k in want)
    res = PC.ConformerAVSR(**KW, fusion_hdim=256).load_state_dict(
        {k: v for k, v in state.items()
         if not k.endswith("num_batches_tracked")}, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    for bad in ({**state, "encoder.stray.weight": torch.zeros(1)},
                {k: v for k, v in state.items()
                 if k != "fusion.bn1.running_mean"}):
        path = str(tmp_path / "bad.pth")
        torch.save(bad, path)
        with pytest.raises(RuntimeError):
            load_state_file(PC.ConformerAVSR(**KW, fusion_hdim=256), path)


# ---------------------------------------------------------------- ShuffleNetV2


def test_channel_shuffle_matches_jax():
    from avsr_tpu.models.shufflenetv2 import channel_shuffle as jshuffle
    from avsr_tpu_torch.models.shufflenetv2 import channel_shuffle

    x = np.random.RandomState(8).randn(2, 5, 3, 12).astype(np.float32)
    for groups in (2, 3, 4):
        got = channel_shuffle(t(x).permute(0, 3, 1, 2), groups)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jshuffle(x, groups)))


def _shufflenet_mapping(model):
    """(torch key, flax path, transform, collection) of every entry of the
    port's ShuffleNetV2 (the JAX module's names)."""
    leaf = {"weight": "kernel", "running_mean": "mean", "running_var": "var"}
    out = []
    for key, value in model.state_dict().items():
        *path, name = key.split(".")
        if value.dim() == 4:
            out.append((key, (*path, "kernel"), jckpt._conv2d, "p"))
        else:
            fname = "scale" if name == "weight" else leaf.get(name, name)
            out.append((key, (*path, fname), jckpt._copy,
                        "s" if name.startswith("running") else "p"))
    return out


def test_shufflenet_matches_jax():
    """ShuffleNetV2(width_mult=0.5) on (2, 88, 88, 1) frames: seeded port
    weights with random BN statistics, the same weights in JAX."""
    from avsr_tpu.models.shufflenetv2 import ShuffleNetV2 as JaxNet
    from avsr_tpu_torch.models.shufflenetv2 import ShuffleNetV2

    setup_torch()
    model = ShuffleNetV2(0.5, in_channels=1)
    init_weights(model, torch.Generator().manual_seed(9))
    _random_bn(model, 10)
    model.eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jckpt.convert_state(state, _shufflenet_mapping(model))
    x = np.random.RandomState(11).randn(2, 88, 88, 1).astype(np.float32)
    want = jax.jit(JaxNet(0.5).apply)(variables, x)
    with torch.no_grad():
        got = model(t(x))
    assert got.shape == (2, 1024)
    _close(got, want, tol=2e-4)
