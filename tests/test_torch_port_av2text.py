"""The port's MuAViC family against the JAX package's, on the CPU in fp32.

``avsr_tpu_torch/models/av2text.py``, ``decode/s2t_generate.py``,
``data/s2t_tokenizer.py``, ``core/checkpoint.av2text_mapping`` and the
eval CLI's ``muavic_en`` path, held against their originals at the
tolerance of ``tests/test_av2text_parity.py`` (3e-4): the tiny model of
that file (d_model 32, 2 + 2 layers, vocabulary 51, conv-pos 16/4) gets
weights from a jitted flax init with ``jax.random``, numpy-randomised
biases, LayerNorm scales and BN statistics (and the eos embedding scaled
down, so that hypotheses do not all end at once), and crosses to the port by
``core/weights.av2text_state_from_jax``. Covered: the table, encoder
features, teacher-forced logits, incremental ``step`` log-probs, the
generator's tokens at beam 2 and 3 with ragged lengths (fused
bookkeeping too), the Speech2Text tokenizer, the engine on mp4 + wav
fixtures and a subprocess that runs it without JAX. ROADMAP C35: the
AV-HuBERT encoder with ``relu`` and ``swish`` trunks (the same JAX
variables without their PReLU weights) within the encoder's 2e-4, eval
and train mode, and the fused stem kept to PReLU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.core import checkpoint as jckpt  # noqa: E402
from avsr_tpu.models import av2text as JA  # noqa: E402
from avsr_tpu_torch.core import checkpoint as pckpt  # noqa: E402
from avsr_tpu_torch.core.weights import av2text_state_from_jax  # noqa: E402
from avsr_tpu_torch.models import av2text as PA  # noqa: E402
from tests.torch_port_common import pin_fbank_route, setup_torch, t  # noqa: E402

TOL = 3e-4  # tests/test_av2text_parity.py
ENC_TOL = 2e-4  # the AV-HuBERT encoder's (PARITY.md)
TINY = dict(vocab_size=51, d_model=32, decoder_layers=2, decoder_ffn_dim=64,
            decoder_attention_heads=2, encoder_layers=2, encoder_ffn_dim=64,
            encoder_attention_heads=2, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
T = 8  # frames of the batch
LENS = np.asarray([T, 5, 3])  # ragged
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """(JAX AV2TextModel, its variables, the port's model)."""
    setup_torch()
    jm = JA.AV2TextModel(JA.AV2TextConfig(**TINY))
    variables = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 4, 104)), jnp.zeros((1, 4, 88, 88, 1)),
        jnp.zeros((1, 3), jnp.int32), jnp.asarray([4])))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def randomise(path, leaf):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(0.1 * rng.randn(*leaf.shape), jnp.float32)
        if name == "var":
            return jnp.asarray(0.5 + rng.rand(*leaf.shape), jnp.float32)
        if name == "bias":
            return jnp.asarray(0.1 * rng.randn(*leaf.shape), jnp.float32)
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.randn(*leaf.shape), jnp.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(randomise, dict(variables))
    # the eos row (2, also the start token) scaled down: unscaled, the
    # random decoder ends every hypothesis at its first step
    emb = variables["params"]["decoder"]["embed_tokens"]
    emb["embedding"] = emb["embedding"].at[2].multiply(0.3)
    model = PA.AV2TextModel(PA.AV2TextConfig(**TINY))
    model.load_state_dict(av2text_state_from_jax(variables, model.cfg),
                          strict=True)
    return jm, variables, model.eval()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(3)
    audio = rng.randn(3, T, 104).astype(np.float32)
    video = rng.randn(3, T, 88, 88, 1).astype(np.float32)
    return audio, video, LENS


@pytest.fixture(scope="module")
def memory(pair, batch):
    """(JAX encoder features, the port's)."""
    jm, variables, model = pair
    audio, video, lens = batch
    want = jax.jit(lambda v, a, vi, n: jm.apply(v, a, vi, n, method="encode"))(
        variables, audio, video, lens)
    with torch.no_grad():
        got = model.encode(t(audio), t(video), t(lens))
    return np.asarray(want), got


# ---------------------------------------------------------------- table


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_av2text_mapping_matches_jax(prefix):
    """The port's copy of the table: the same torch keys, flax paths and
    collections, and transforms that agree on an array."""
    got = pckpt.av2text_mapping(3, 2, prefix=prefix)
    want = jckpt.av2text_mapping(3, 2, prefix=prefix)
    assert len(got) == len(want)
    arrays = [np.arange(6.0).reshape(2, 3), np.arange(24.0).reshape(2, 3, 4),
              np.arange(120.0).reshape(2, 3, 4, 5),
              np.arange(720.0).reshape(2, 3, 4, 5, 6)]
    for g, w in zip(got, want):
        assert (g[0], g[1], g[3]) == (w[0], w[1], w[3])
        for a in arrays:
            try:
                want_a = w[2](a)
            except ValueError:
                continue
            np.testing.assert_array_equal(g[2](a), want_a)


def test_non_prelu_mapping_drops_only_the_prelu_weights():
    """Without PReLU the table asks for no ``frontend3D.2`` or trunk
    ``relu{1,2}`` weight, and for everything else as before."""
    full = pckpt.av2text_mapping(2, 2)
    lean = pckpt.av2text_mapping(2, 2, prelu=False)
    dropped = [e[0] for e in full if e not in lean]
    assert "model.encoder.feature_extractor_video.resnet.frontend3D.2.weight" \
        in dropped
    assert len(dropped) == 1 + 2 * 8
    assert all(k.endswith((".frontend3D.2.weight", ".relu1.weight",
                           ".relu2.weight")) for k in dropped)
    assert [e for e in full if e[0] not in dropped] == lean


def test_sinusoidal_table_matches_jax():
    """Exact to 1e-6 over the first 64 positions; over all 1026, torch's
    and XLA's fp32 sin of arguments near 1000 differ by up to 1.5e-5."""
    got = PA.s2t_sinusoidal_table(1026, 32, 1)
    want = np.asarray(JA.s2t_sinusoidal_table(1026, 32, 1))
    _close(got[:64], want[:64], tol=1e-6)
    _close(got, want, tol=3e-5)
    assert not got[1].any()
    _close(PA.s2t_sinusoidal_table(20, 7, 1),
           JA.s2t_sinusoidal_table(20, 7, 1), tol=1e-6)


# ---------------------------------------------------------------- model


def test_encoder_features_match_jax(memory):
    want, got = memory
    assert got.shape == (3, T, TINY["d_model"])
    _close(got, want, what="encoder features")


def test_teacher_forced_logits_match_jax(pair, batch, memory):
    """The decoder's teacher-forced logits over each side's encoder
    features (the JAX model's forward is encode then this), and the port's
    forward equal to its encode and decoder."""
    jm, variables, model = pair
    audio, video, lens = batch
    want_mem, got_mem = memory
    ys = np.asarray([[2, 5, 7, 11], [2, 9, 3, 3], [2, 40, 1, 6]])
    mask = (np.arange(T)[None, :] < lens[:, None])[:, None, :]
    want = jm.apply(variables, ys, want_mem, mask,
                    method=lambda m, *a: m.decoder(*a))
    with torch.no_grad():
        got = model.decoder(t(ys), got_mem, t(mask))
        full = model(t(audio), t(video), t(ys), t(lens))
    assert got.shape == (3, 4, TINY["vocab_size"])
    _close(got, want, what="teacher-forced logits")
    assert torch.equal(full, got)


def test_step_log_probs_match_jax(pair, memory):
    """Four incremental steps over a 64-row self-K/V buffer: the log-probs
    of each, and the cache rows each writes."""
    jm, variables, model = pair
    want_mem, got_mem = memory
    mask = (np.arange(T)[None, :] < LENS[:, None])[:, None, :]
    jcache = jm.apply(variables, want_mem, 64, method="decoder_init")
    with torch.no_grad():
        cache = model.decoder_init(got_mem, 64)
    _close(cache.src_k, jcache.src_k, what="source K")
    for pos, ys in enumerate(([2, 2, 2], [5, 9, 40], [7, 3, 1], [11, 3, 6])):
        y = np.asarray(ys)
        want, jcache = jm.apply(variables, y, pos, jcache, mask,
                                method="decoder_step")
        with torch.no_grad():
            got, cache = model.decoder_step(t(y), pos, cache, t(mask))
        _close(got, want, what=f"step {pos} log-probs")
        _close(cache.self_k[:, :, pos], jcache.self_k[:, :, pos],
               what=f"step {pos} K row")
        _close(cache.self_v[:, :, : pos + 1], jcache.self_v[:, :, : pos + 1],
               what=f"step {pos} V rows")


# ---------------------------------------------------------------- generation


@pytest.fixture(scope="module")
def generated(pair, batch):
    """{beam: (JAX tokens, the port's unfused tokens, its fused tokens,
    the port's unfused and fused raw outputs)}."""
    from avsr_tpu.decode.s2t_generate import S2TGenerator as JG
    from avsr_tpu_torch.decode.s2t_generate import S2TGenerator as PG

    jm, variables, model = pair
    audio, video, lens = batch
    out = {}
    for beam in (2, 3):
        want = JG(jm, variables, beam_size=beam).generate(audio, video, lens)
        got = []
        raw = []
        for fused in (False, True):
            gen = PG(model, beam_size=beam, device="cpu")
            assert not gen.bcfg.shared_src_kv and not gen.bcfg.lazy_reorder
            gen.bcfg = dataclasses.replace(gen.bcfg, fused_bookkeeping=fused)
            got.append(gen.generate(audio, video, lens))
            raw.append(gen.beam(gen.encode(audio, video, lens), lens))
        out[beam] = (want, *got, *raw)
    return out


@pytest.mark.parametrize("beam", [2, 3])
def test_generator_tokens_match_jax(generated, beam):
    want, got = generated[beam][:2]
    assert len(got) == 3
    assert sum(len(x) for x in got) > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("beam", [2, 3])
def test_fused_bookkeeping_equals_unfused_on_the_eager_path(generated, beam):
    _, unfused, fused, raw_u, raw_f = generated[beam]
    for a, b in zip(unfused, fused):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(raw_u, raw_f):
        assert torch.equal(a, b)


def test_eager_reorder_gathers_by_parent():
    """``reorder_cache``: lane (b, k) takes lane (b, prev[b, k])'s self
    K/V; the source K/V stay."""
    from avsr_tpu_torch.decode.beam import reorder_cache

    x = torch.arange(2 * 6 * 4, dtype=torch.float32).view(2, 6, 4, 1, 1)
    cache = PA.S2TDecoderCache(x, -x, x + 1, x + 2)
    prev = torch.tensor([[2, 2, 0], [1, 0, 1]])
    out = reorder_cache(cache, prev)
    lanes = [2, 2, 0, 4, 3, 4]
    assert torch.equal(out.self_k, x[:, lanes])
    assert torch.equal(out.self_v, -x[:, lanes])
    assert out.src_k is cache.src_k and out.src_v is cache.src_v


@pytest.mark.parametrize("shared,lazy", [(True, False), (False, True)])
def test_mixed_beam_switches_raise(shared, lazy):
    """Only both-on (the Recognizer) and both-off (S2TGenerator) exist."""
    from avsr_tpu_torch.decode.beam import BeamSearchConfig, beam_search_batched

    cfg = BeamSearchConfig(beam_size=2, sos=0, eos=2, vocab=8, ctc_weight=0.0,
                           shared_src_kv=shared, lazy_reorder=lazy)

    def never(*a):
        raise AssertionError("decoder called")

    with pytest.raises(ValueError, match="must agree"):
        beam_search_batched(cfg, never, never, torch.zeros(1, 3, 4), None,
                            torch.tensor([3]))


# ---------------------------------------------------------------- text


def _toy_vocab(directory, pieces, n=TINY["vocab_size"]):
    """vocab.json of n pieces: the four specials, the trained pieces, then
    fillers."""
    names = ["<s>", "<pad>", "</s>", "<unk>"] + pieces
    names += [f"▁FILL{i}" for i in range(n - len(names))]
    vocab = {p: i for i, p in enumerate(names[:n])}
    with open(os.path.join(directory, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    return vocab


def _write_tokenizer(directory):
    """A Speech2Text tokenizer directory: a unigram model trained by the JAX
    package's trainer as ``sentencepiece.bpe.model`` and its vocab.json."""
    from avsr_tpu.data.spm_train import save_model, train_unigram
    from tests.test_torch_port_host import CORPUS

    pieces = train_unigram(CORPUS, vocab_size=40, max_piece_len=8)
    save_model(pieces, os.path.join(directory, "sentencepiece.bpe.model"))
    return _toy_vocab(directory, [p.piece for p in pieces if p.type == 1])


def test_s2t_tokenizer_matches_jax(tmp_path):
    from avsr_tpu.data.s2t_tokenizer import Speech2TextTokenizer as JT
    from avsr_tpu_torch.data.s2t_tokenizer import Speech2TextTokenizer as PT

    vocab = _write_tokenizer(str(tmp_path))
    jt, pt = JT.from_pretrained(str(tmp_path)), PT.from_pretrained(str(tmp_path))
    assert pt.vocab == jt.vocab == vocab
    for text in ("THE QUICK BROWN FOX", "HELLO WORLD", "ZEBRA X", ""):
        assert pt.encode(text) == jt.encode(text)
    rng = np.random.RandomState(0)
    batch = [rng.randint(0, 60, n) for n in (0, 3, 12)] + [[2, 0, 1, 3, 7]]
    for skip in (True, False):
        assert pt.batch_decode(batch, skip) == jt.batch_decode(batch, skip)
        for ids in batch:
            assert pt.decode(ids, skip) == jt.decode(ids, skip)
    bare = PT(os.path.join(str(tmp_path), "vocab.json"))
    with pytest.raises(ValueError):
        bare.encode("HELLO")


# ---------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def muavic_assets(pair, tmp_path_factory):
    """The tiny model as a reference-format directory (``model.`` keys,
    with the tied ``lm_head.weight`` and the positions buffer a released
    state dict carries), config.json, the tokenizer, and two mp4 + wav
    fixtures."""
    pytest.importorskip("cv2")
    from tests.test_torch_port_host import write_fixture

    _, _, model = pair
    root = tmp_path_factory.mktemp("muavic")
    state = {f"model.{k}": v for k, v in model.state_dict().items()}
    state["lm_head.weight"] = state["model.decoder.embed_tokens.weight"]
    state["model.decoder.embed_positions.weights"] = model.decoder.pos_table
    torch.save(state, str(root / "pytorch_model.bin"))
    with open(root / "config.json", "w") as f:
        json.dump(dict(TINY, architectures=["AV2TextForConditionalGeneration"]),
                  f)
    _write_tokenizer(str(root))
    videos = []
    for i, frames in enumerate((14, 9)):
        path = str(root / f"utt{i}.mp4")
        write_fixture(path, frames, seed=30 + i)
        videos.append(path)
    return dict(dir=str(root), videos=videos)


def test_muavic_engine_matches_jax(muavic_assets, monkeypatch):
    """``InferenceEngine(model_type="muavic_en", device="cpu")`` against
    the JAX engine on the same directory: the transcripts of two mp4 + wav
    samples in a batch of 3 (one padding row), and the loaded setup."""
    from avsr_tpu.cli import evaluation as je
    from avsr_tpu_torch.cli import evaluation as pe

    pin_fbank_route(monkeypatch)
    a = muavic_assets
    kw = dict(checkpoint_path=a["dir"], batch_size=3)
    jeng = je.InferenceEngine("muavic_en", **kw)
    peng = pe.InferenceEngine("muavic_en", device="cpu", **kw)
    jeng.load_model()
    peng.load_model()
    gen = peng.generator
    assert peng.recognizer is None and gen.device.type == "cpu"
    assert gen.bcfg.beam_size == 3 and gen.bcfg.ctc_weight == 0.0
    assert (gen.bcfg.sos, gen.bcfg.eos, gen.bcfg.vocab) == (2, 2, 51)
    assert dataclasses.asdict(gen.model.cfg) == dict(
        dataclasses.asdict(PA.AV2TextConfig()), **TINY)
    samples = []
    for path in a["videos"]:
        with open(path, "rb") as f, open(path[:-4] + ".wav", "rb") as g:
            samples.append({"video": f.read(), "audio": g.read()})
    got = peng.infer_samples(samples)
    want = jeng.infer_samples(samples)
    assert got == want
    assert len(got) == 2 and all(isinstance(x, str) for x in got)
    assert got[0] == got[0].upper()


def test_muavic_path_imports_no_jax(muavic_assets):
    """Importing the CLI and running the muavic_en engine (media decode,
    fbank, collation, the encoder, the eager beam and the tokenizer) loads
    nothing of the JAX package, JAX, flax or ml_dtypes."""
    a = muavic_assets
    code = f"""
import sys
from avsr_tpu_torch.cli import evaluation as pe
eng = pe.InferenceEngine("muavic_en", checkpoint_path={a['dir']!r},
                         batch_size=2, device="cpu")
eng.load_model()
out = eng.infer_samples([{{"video": {a['videos'][1]!r}}}])
assert len(out) == 1 and isinstance(out[0], str), out
bad = [m for m in sys.modules
       if m.split('.')[0] in ('avsr_tpu', 'jax', 'flax', 'ml_dtypes')]
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# ---------------------------------------------------------------- C35


def _trunk_case(pair, relu_type):
    """(JAX AVHubertModel config, its variables, the port's model) for a
    ``relu_type`` trunk: the tiny model's encoder variables without their
    PReLU weights, every dropout off."""
    from avsr_tpu.models.avhubert import AVHubertModel as JM
    from avsr_tpu_torch.core.config import AVHubertEncoderConfig
    from avsr_tpu_torch.models.avhubert import AVHubertModel as PM

    _, variables, _ = pair
    jcfg = dataclasses.replace(
        JA.AV2TextConfig(**TINY).encoder_config(), resnet_relu_type=relu_type,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        dropout_input=0.0, modality_dropout=0.0)

    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items()
                    if k not in ("frontend_prelu", "relu1", "relu2")}
        return tree

    jvars = {"params": strip(variables["params"]["encoder"]),
             "batch_stats": variables["batch_stats"]["encoder"]}
    pcfg = AVHubertEncoderConfig(**dataclasses.asdict(jcfg))
    state = pckpt.flax_to_torch(jvars, pckpt.avhubert_encoder_entries(
        "m", (), TINY["encoder_layers"], prelu=False))
    model = PM(pcfg)
    model.load_state_dict({k.removeprefix("m."): torch.from_numpy(
        np.array(v)) for k, v in state.items()}, strict=True)
    return JM(jcfg), jvars, model


@pytest.mark.parametrize("relu_type", ["relu", "swish"])
def test_non_prelu_encoder_matches_jax(pair, batch, relu_type):
    """C35: eval features, and one train-mode forward (batch-statistics
    BN, flax ``nn.BatchNorm`` in the stem) with the stem BN's running
    averages after it."""
    from avsr_tpu_torch.ops.dropout import DropoutRng

    jm, jvars, model = _trunk_case(pair, relu_type)
    audio, video, lens = batch
    mask = np.arange(T)[None, :] < lens[:, None]
    assert "frontend3D.2.weight" not in str(list(model.state_dict()))
    want = jax.jit(lambda v: jm.apply(v, audio, video, mask))(jvars)
    with torch.no_grad():
        got = model.eval()(t(audio), t(video), t(mask))
    _close(got, want, tol=ENC_TOL, what=f"{relu_type} eval")
    key = jax.random.PRNGKey(0)
    want, upd = jax.jit(lambda v: jm.apply(
        v, audio, video, mask, train=True, mutable=["batch_stats"],
        rngs={"dropout": key, "modality": key}))(jvars)
    with torch.no_grad():
        got = model.train()(t(audio), t(video), t(mask), train=True,
                            rng=DropoutRng(0))
    _close(got, want, tol=ENC_TOL, what=f"{relu_type} train")
    bn = model.feature_extractor_video.resnet.frontend3D[1]
    stats = upd["batch_stats"]["video_resnet"]["frontend_bn"]
    _close(bn.running_mean, stats["mean"], tol=1e-5)
    _close(bn.running_var, stats["var"], tol=1e-5)


@pytest.mark.parametrize("relu_type", ["prelu", "relu", "swish"])
def test_fused_stem_stays_prelu_only(relu_type, monkeypatch):
    """With ``AVSR_FUSED_STEM_EVAL=1`` only the PReLU stem takes the fused
    tail; another activation runs BN, the activation and the pool."""
    from avsr_tpu_torch.models import resnet

    calls = []
    real = resnet.bn_prelu_pool

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(resnet, "bn_prelu_pool", spy)
    monkeypatch.setenv("AVSR_FUSED_STEM_EVAL", "1")
    enc = resnet.ResEncoder(relu_type).eval()
    assert isinstance(enc.frontend3D[2], {
        "prelu": torch.nn.PReLU, "relu": torch.nn.ReLU,
        "swish": torch.nn.SiLU}[relu_type])
    with torch.no_grad():
        out = enc(torch.randn(1, 2, 88, 88, 1))
    assert out.shape == (1, 2, 512)
    assert len(calls) == (relu_type == "prelu")
