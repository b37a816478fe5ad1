"""The serving slice end to end: JAX Recognizer vs the port's Recognizer.

Same weights (tiny config), decode_fused_attention and flash attention on,
beam 3, a 16-token KV cap, delta2 video wire, uint8 crops, three utterances
of mixed length; the joint CTC/attention beam at the JAX default
ctc_weight=0.1 and the attention-only beam at ctc_weight=0, the port with
its bookkeeping unfused and fused (one beam_update launch a step), always
against the JAX Recognizer's default (unfused). Beam and greedy tokens must
be identical; beam scores agree to 1e-4 in fp32, and to bf16-sized bounds
at the serving precision (bf16 encode, bf16 decoder and K|V cache).
"""

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests.torch_port_common import (  # noqa: E402
    gather_spy,
    jax_tiny_model,
    port_cfg,
    port_model,
    setup_torch,
    tiny_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(beam_size=3, t_buckets=(24,), max_decode_tokens=16,
          video_wire="delta2")


@pytest.fixture(scope="module")
def base():
    setup_torch()
    cfg = tiny_cfg()
    return (cfg, *jax_tiny_model(cfg, seed=1))


@pytest.fixture(scope="module")
def pairs(base):
    """(eos_boost, ctc_weight, fused) -> (JAX, port) recognizers on the same
    weights, built once per module. ``eos_boost`` raises the output bias of
    eos so that hypotheses also end naturally (random weights alone run
    every utterance to its forced final eos). The JAX side keeps its
    default, unfused bookkeeping; ``fused`` sets the port's."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg, jmodel, variables = base
    built = {}

    def get(eos_boost=0.0, ctc_weight=0.0, fused=False):
        key = (eos_boost, ctc_weight)
        if key not in built:
            var = variables
            if eos_boost:
                params = jax.tree.map(lambda x: x, variables["params"])
                head = params["decoder"]["output_layer"]
                head["bias"] = head["bias"].at[cfg.eos].add(eos_boost)
                var = {"params": params,
                       "batch_stats": variables["batch_stats"]}
            built[key] = (
                JaxRecognizer(model=jmodel, variables=var, cfg=cfg,
                              ctc_weight=ctc_weight, **KW),
                Recognizer(model=port_model(cfg, var), cfg=port_cfg(cfg),
                           ctc_weight=ctc_weight, device="cpu", **KW))
        jrec, prec = built[key]
        return jrec, dataclasses.replace(prec, fused_bookkeeping=fused)

    return get


@pytest.fixture(scope="module")
def recognizers(pairs):
    return pairs()


def _batch(seed):
    rng = np.random.RandomState(seed)
    lens = (20, 13, 17)
    audio = [rng.randn(n, 104).astype(np.float32) for n in lens]
    video = [rng.randint(0, 256, size=(n, 88, 88, 1)).astype(np.uint8)
             for n in lens]
    return audio, video


@pytest.fixture(scope="module")
def batch():
    return _batch(7)


# (eos_boost, ctc_weight, port fused_bookkeeping); the ids of the
# ctc_weight=0 cases are the eos_boost alone. The CTC prefix score of eos
# stays low until a prefix explains the whole utterance, so with CTC it
# takes a boost of 3 (not 1) for hypotheses to end on their own eos.
BEAM_CASES = [
    pytest.param(0.0, 0.0, False, id="0.0"),
    pytest.param(1.0, 0.0, False, id="1.0"),
    pytest.param(1.0, 0.0, True, id="1.0-fused"),
    pytest.param(0.0, 0.1, False, id="ctc-0.0"),
    pytest.param(3.0, 0.1, False, id="ctc-3.0"),
    pytest.param(0.0, 0.1, True, id="ctc-0.0-fused"),
    pytest.param(3.0, 0.1, True, id="ctc-3.0-fused"),
]


def _beams(jrec, prec, batch):
    """Both sides' encode outputs and beam results on the batch."""
    aud, vid, lens, _ = jrec._pad_batch(*batch)
    feats, ctc = jrec._encode_fn()(jrec.variables, aud, vid, lens)
    want = tuple(np.asarray(x) for x in jrec._beam_fn()(
        jrec.variables, feats, ctc, lens))
    paud, pvid, plens, _ = prec._pad_batch(*batch)
    pfeats, pctc = prec.encode(paud, pvid, plens)
    got = tuple(x.numpy() for x in prec.beam(pfeats, pctc, plens))
    return np.asarray(ctc), pctc.numpy(), want, got


@pytest.mark.parametrize("eos_boost,ctc_weight,fused", BEAM_CASES)
def test_beam_matches_jax(pairs, batch, eos_boost, ctc_weight, fused,
                          monkeypatch):
    """With CTC the port's steps take their pre-beam through the fused
    top-k and row gather."""
    jrec, prec = pairs(eos_boost, ctc_weight, fused)
    calls = gather_spy(monkeypatch)
    ctc, pctc, (jy, jl, js), (py, pl, ps) = _beams(jrec, prec, batch)
    assert (len(calls) >= pl.max() - 2) if ctc_weight else not calls
    np.testing.assert_allclose(pctc, ctc, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(ps, js, atol=1e-4, rtol=0)
    if eos_boost:  # some hypotheses ended on their own eos
        assert (pl < np.asarray([20, 13, 17]) + 2).any()


@pytest.mark.parametrize("eos_boost,ctc_weight", [(0.0, 0.1), (3.0, 0.1),
                                                  (1.0, 0.0)])
def test_fused_bookkeeping_bit_identical(pairs, batch, eos_boost, ctc_weight):
    """The port's fused step (beam_update) against its unfused step: the
    same tokens and the same fp32 scores bit for bit."""
    _, unfused = pairs(eos_boost, ctc_weight, False)
    _, fused = pairs(eos_boost, ctc_weight, True)
    aud, vid, lens, _ = unfused._pad_batch(*batch)
    feats, ctc = unfused.encode(aud, vid, lens)
    for a, b in zip(unfused.beam(feats, ctc, lens),
                    fused.beam(feats, ctc, lens)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,batch_pad,ctc_weight,fused", [
    pytest.param("beam", None, 0.0, False, id="beam-None"),
    pytest.param("greedy", None, 0.0, False, id="greedy-None"),
    pytest.param("beam", 4, 0.0, False, id="beam-4"),
    pytest.param("beam", None, 0.1, False, id="ctc-beam-None"),
    pytest.param("beam", 4, 0.1, False, id="ctc-beam-4"),
    pytest.param("beam", None, 0.1, True, id="ctc-beam-None-fused"),
    pytest.param("beam", 4, 0.1, True, id="ctc-beam-4-fused"),
])
def test_transcribe_batch_matches_jax(pairs, batch, mode, batch_pad,
                                      ctc_weight, fused):
    """batch_pad=4 adds a padded row, which decodes one dummy frame."""
    jrec, prec = pairs(0.0, ctc_weight, fused)
    want = jrec.transcribe_batch(*batch, mode=mode, batch_pad=batch_pad)
    got = prec.transcribe_batch(*batch, mode=mode, batch_pad=batch_pad)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed,fused", [(8, False), (9, True), (10, False),
                                        (11, True), (12, False)])
def test_ctc_beam_matches_jax_across_inputs(pairs, seed, fused):
    """fp32 joint CTC/attention tokens on more inputs (the bf16 cases
    below do not hold on all of them)."""
    jrec, prec = pairs(0.0, 0.1, fused)
    audio, video = _batch(seed)
    want = jrec.transcribe_batch(audio, video)
    got = prec.transcribe_batch(audio, video)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_recognizer_defaults_match_jax():
    """The port's Recognizer keeps the JAX Recognizer's serving defaults
    and runs on the card unless asked for the CPU."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxRecognizer)}
    port_fields = {f.name: f.default for f in dataclasses.fields(Recognizer)}
    for name in ("beam_size", "ctc_weight", "t_buckets", "max_decode_tokens",
                 "fused_bookkeeping", "encode_dtype", "video_wire"):
        assert port_fields[name] == jax_fields[name], name
    assert port_fields["device"] == "cuda"


def test_port_imports_no_jax():
    """The serving path, the CTC scorer, the kernel wrappers (the fused stem
    and decoder layer included), the trainer, the training loop, CLI,
    pretraining objective, datasets and data parallelism, the conformer
    family and ShuffleNetV2 with what the eval CLI's auto_avsr loader
    imports (the conformer weight tables, the raw-waveform transform),
    bench_train and chip_smoke.py import nothing of the JAX package, JAX,
    flax or ml_dtypes."""
    code = ("import sys, avsr_tpu_torch.decode.recognizer, "
            "avsr_tpu_torch.core.weights, avsr_tpu_torch.decode.ctc_prefix, "
            "avsr_tpu_torch.ops.kernels.scan_logsumexp, "
            "avsr_tpu_torch.ops.kernels.row_gather, "
            "avsr_tpu_torch.ops.kernels.beam_update, "
            "avsr_tpu_torch.ops.kernels.stem_fuse, "
            "avsr_tpu_torch.ops.kernels.decoder_layer, "
            "avsr_tpu_torch.train.trainer, "
            "avsr_tpu_torch.cli.train, avsr_tpu_torch.train.loop, "
            "avsr_tpu_torch.train.pretrain, avsr_tpu_torch.data.dataset, "
            "avsr_tpu_torch.core.dist, "
            "avsr_tpu_torch.models.conformer, avsr_tpu_torch.core.checkpoint, "
            "avsr_tpu_torch.data.transforms, avsr_tpu_torch.cli.evaluation, "
            "avsr_tpu_torch.models.shufflenetv2, "
            "avsr_tpu_torch.tools.bench_train, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('avsr_tpu', 'jax', 'flax', 'ml_dtypes')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_bf16_encode_runs_on_cpu(recognizers, batch):
    """bf16 encode: every encoder weight and BN statistic cast (on a copy
    of the model without its decoder; the model keeps fp32), fp32 out."""
    _, prec = recognizers
    rec = dataclasses.replace(prec, encode_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in rec._encoder.parameters())
    assert all(b.dtype == torch.bfloat16 for b in rec._encoder.buffers())
    assert all(p.dtype == torch.float32 for p in rec.model.parameters())
    aud, vid, lens, _ = rec._pad_batch(*batch)
    assert aud.dtype == torch.bfloat16
    feats, ctc = rec.encode(aud, vid, lens)
    assert feats.dtype == ctc.dtype == torch.float32
    assert torch.isfinite(ctc).all()


@pytest.fixture(scope="module")
def bf16_recognizers(base):
    """ctc_weight -> (JAX, port) recognizers at the serving precision: bf16
    encode (every encoder weight and BN statistic cast), bf16 decoder
    weights and K|V cache."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu.models.e2e import AVSRModel as JaxModel
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg, _, variables = base
    cfg16 = copy.deepcopy(cfg)
    cfg16.decoder_cache_dtype = cfg16.decoder_param_dtype = "bfloat16"
    kw = dict(KW, encode_dtype="bfloat16")
    return lambda ctc_weight: (
        JaxRecognizer(model=JaxModel(cfg16), variables=variables, cfg=cfg16,
                      ctc_weight=ctc_weight, **kw),
        Recognizer(model=port_model(cfg16, variables), cfg=port_cfg(cfg16),
                   ctc_weight=ctc_weight, device="cpu", **kw))


def _bf16_serving_matches(jrec, prec, batch):
    ctc, pctc, (jy, jl, js), (py, pl, ps) = _beams(jrec, prec, batch)
    np.testing.assert_allclose(pctc, ctc, atol=0.06, rtol=0)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(ps, js, rtol=1e-2, atol=0)
    want = jrec.transcribe_batch(*batch, mode="greedy")
    got = prec.transcribe_batch(*batch, mode="greedy")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_bf16_serving_matches_jax(bf16_recognizers, batch):
    """Both sides round at their own points (XLA fuses bf16 elementwise
    chains in fp32, torch rounds after each op), so values agree to a few
    bf16 ulps: CTC log-probs within 0.06 abs (0.027 measured), beam scores
    within 1% (0.35% measured). The tokens must be identical, which the
    fp32 port does not reach on these weights: it checks the cast points.
    Attention-only beam (ctc_weight=0)."""
    _bf16_serving_matches(*bf16_recognizers(0.0), batch)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_ctc_serving_matches_jax(bf16_recognizers, fused):
    """The same at the JAX default ctc_weight=0.1 (the CTC scorer runs in
    fp32 on the fp32 log-probs), the port unfused and fused. These random
    tiny weights leave near-ties that the two sides' bf16 rounding decides
    differently on many inputs: of the batches of seeds 7-30, bf16 beam
    tokens differed on 13 of 24 and greedy tokens (the encoder alone) on 9
    of 24, while fp32 tokens were equal on every batch tried. This batch
    (seed 10) has no such tie; a wrong cast point would move the scores
    past the bounds on any batch."""
    jrec, prec = bf16_recognizers(0.1)
    _bf16_serving_matches(
        jrec, dataclasses.replace(prec, fused_bookkeeping=fused), _batch(10))
