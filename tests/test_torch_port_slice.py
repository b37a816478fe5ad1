"""The serving slice end to end: JAX Recognizer vs the port's Recognizer.

Same weights (tiny config), decode_fused_attention and flash attention on,
ctc_weight=0 (attention-only beam), beam 3, a 16-token KV cap, delta2 video
wire, uint8 crops, three utterances of mixed length. Beam and greedy tokens
must be identical; beam scores agree to 1e-4 in fp32, and to bf16-sized
bounds at the serving precision (bf16 encode, bf16 decoder and K|V cache).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests.torch_port_common import (  # noqa: E402
    jax_tiny_model,
    port_model,
    setup_torch,
    tiny_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(beam_size=3, ctc_weight=0.0, t_buckets=(24,), max_decode_tokens=16,
          video_wire="delta2")


@pytest.fixture(scope="module")
def base():
    setup_torch()
    cfg = tiny_cfg()
    return (cfg, *jax_tiny_model(cfg, seed=1))


def _pair(base, eos_boost=0.0):
    """(JAX, port) recognizers on the same weights; ``eos_boost`` raises
    the output bias of eos so that hypotheses also end naturally (random
    weights alone run every utterance to its forced final eos)."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg, jmodel, variables = base
    if eos_boost:
        params = jax.tree.map(lambda x: x, variables["params"])
        head = params["decoder"]["output_layer"]
        head["bias"] = head["bias"].at[cfg.eos].add(eos_boost)
        variables = {"params": params, "batch_stats": variables["batch_stats"]}
    jrec = JaxRecognizer(model=jmodel, variables=variables, cfg=cfg, **KW)
    prec = Recognizer(model=port_model(cfg, variables), cfg=cfg, **KW)
    return jrec, prec


@pytest.fixture(scope="module")
def recognizers(base):
    return _pair(base)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(7)
    lens = (20, 13, 17)
    audio = [rng.randn(n, 104).astype(np.float32) for n in lens]
    video = [rng.randint(0, 256, size=(n, 88, 88, 1)).astype(np.uint8)
             for n in lens]
    return audio, video


@pytest.mark.parametrize("eos_boost", [0.0, 1.0])
def test_beam_matches_jax(base, recognizers, batch, eos_boost):
    jrec, prec = _pair(base, eos_boost) if eos_boost else recognizers
    aud, vid, lens, _ = jrec._pad_batch(*batch)
    feats, ctc = jrec._encode_fn()(jrec.variables, aud, vid, lens)
    jy, jl, js = (np.asarray(x) for x in jrec._beam_fn()(
        jrec.variables, feats, ctc, lens))

    paud, pvid, plens, _ = prec._pad_batch(*batch)
    pfeats, pctc = prec.encode(paud, pvid, plens)
    np.testing.assert_allclose(pctc.numpy(), np.asarray(ctc), atol=2e-4, rtol=0)
    py, pl, ps = prec.beam(pfeats, plens)
    np.testing.assert_array_equal(pl.numpy(), jl)
    np.testing.assert_array_equal(py.numpy(), jy)
    np.testing.assert_allclose(ps.numpy(), js, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode,batch_pad", [("beam", None), ("greedy", None),
                                            ("beam", 4)])
def test_transcribe_batch_matches_jax(recognizers, batch, mode, batch_pad):
    """batch_pad=4 adds a padded row, which decodes one dummy frame."""
    jrec, prec = recognizers
    want = jrec.transcribe_batch(*batch, mode=mode, batch_pad=batch_pad)
    got = prec.transcribe_batch(*batch, mode=mode, batch_pad=batch_pad)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_ctc_weight_raises(recognizers, batch):
    import dataclasses

    _, prec = recognizers
    rec = dataclasses.replace(prec, ctc_weight=0.1)
    with pytest.raises(NotImplementedError, match="CTC prefix scoring"):
        rec.transcribe_batch(*batch, mode="beam")


def test_port_imports_no_jax():
    """The serving path and chip_smoke.py import none of JAX, flax or
    ml_dtypes (of the JAX package only its stdlib-only config)."""
    code = ("import sys, avsr_tpu_torch.decode.recognizer, "
            "avsr_tpu_torch.core.weights, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'ml_dtypes')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_bf16_encode_runs_on_cpu(recognizers, batch):
    """bf16 encode: every encoder weight and BN statistic cast, fp32 out."""
    import dataclasses

    _, prec = recognizers
    rec = dataclasses.replace(prec, encode_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in rec._enc.parameters())
    assert all(b.dtype == torch.bfloat16 for b in rec._enc.buffers())
    aud, vid, lens, _ = rec._pad_batch(*batch)
    assert aud.dtype == torch.bfloat16
    feats, ctc = rec.encode(aud, vid, lens)
    assert feats.dtype == ctc.dtype == torch.float32
    assert torch.isfinite(ctc).all()


@pytest.fixture(scope="module")
def bf16_recognizers(base):
    """(JAX, port) recognizers at the serving precision: bf16 encode (every
    encoder weight and BN statistic cast), bf16 decoder weights and K|V
    cache."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu.models.e2e import AVSRModel as JaxModel
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg, _, variables = base
    cfg16 = copy.deepcopy(cfg)
    cfg16.decoder_cache_dtype = cfg16.decoder_param_dtype = "bfloat16"
    kw = dict(KW, encode_dtype="bfloat16")
    return (JaxRecognizer(model=JaxModel(cfg16), variables=variables,
                          cfg=cfg16, **kw),
            Recognizer(model=port_model(cfg16, variables), cfg=cfg16, **kw))


def test_bf16_serving_matches_jax(bf16_recognizers, batch):
    """Both sides round at their own points (XLA fuses bf16 elementwise
    chains in fp32, torch rounds after each op), so values agree to a few
    bf16 ulps: CTC log-probs within 0.06 abs (0.027 measured), beam scores
    within 1% (0.35% measured). The tokens must be identical, which the
    fp32 port does not reach on these weights: it checks the cast points."""
    jrec, prec = bf16_recognizers
    aud, vid, lens, _ = jrec._pad_batch(*batch)
    feats, ctc = jrec._encode_fn()(jrec.variables, aud, vid, lens)
    jy, jl, js = (np.asarray(x) for x in jrec._beam_fn()(
        jrec.variables, feats, ctc, lens))

    paud, pvid, plens, _ = prec._pad_batch(*batch)
    pfeats, pctc = prec.encode(paud, pvid, plens)
    np.testing.assert_allclose(pctc.numpy(), np.asarray(ctc), atol=0.06,
                               rtol=0)
    py, pl, ps = prec.beam(pfeats, plens)
    np.testing.assert_array_equal(pl.numpy(), jl)
    np.testing.assert_array_equal(py.numpy(), jy)
    np.testing.assert_allclose(ps.numpy(), js, rtol=1e-2, atol=0)
    want = jrec.transcribe_batch(*batch, mode="greedy")
    got = prec.transcribe_batch(*batch, mode="greedy")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
