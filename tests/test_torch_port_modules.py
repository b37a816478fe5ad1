"""Port modules vs the JAX modules on the same weights (tiny config, fp32).

Tolerance 2e-4 abs: the bound the JAX package held against the original
torch code for the encoder and decoder (PARITY.md:20).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.core.checkpoint import avsr_mapping  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    jax_tiny_model,
    port_cfg,
    port_model,
    setup_torch,
    t,
    tiny_cfg,
)

TOL = 2e-4


@pytest.fixture(scope="module")
def models():
    setup_torch()
    cfg = tiny_cfg()
    jmodel, variables = jax_tiny_model(cfg)
    return cfg, jmodel, variables, port_model(cfg, variables)


def _inputs(seed, b=2, tt=6):
    rng = np.random.RandomState(seed)
    aud = rng.randn(b, tt, 104).astype(np.float32)
    vid = rng.randn(b, tt, 88, 88, 1).astype(np.float32)
    return aud, vid


def test_weight_bridge_strict_and_key_sets(models):
    cfg, _, variables, pmodel = models
    keys = set()
    for tkey, *_ in avsr_mapping(cfg, prefix=""):
        keys.update(tkey if isinstance(tkey, list) else [tkey])
    assert set(pmodel.state_dict()) == keys
    # strict load of the bridged state (port_model) kept every value
    from avsr_tpu_torch.core.weights import torch_state_from_jax

    state = torch_state_from_jax(variables, cfg)
    for k, v in pmodel.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_from_pretrained_loads_released_layout(models, tmp_path):
    """A released-format directory (config.json, ``avsr.``-prefixed
    safetensors) loads strictly into the port's Recognizer."""
    from avsr_tpu.core.checkpoint import save_pretrained
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg, _, variables, pmodel = models
    save_pretrained(str(tmp_path), cfg, variables)
    rec = Recognizer.from_pretrained(str(tmp_path), ctc_weight=0.0,
                                     device="cpu")
    assert rec.cfg == port_cfg(cfg)
    state = rec.model.state_dict()
    for k, v in pmodel.state_dict().items():
        assert torch.equal(state[k], v), k


def test_res_encoder(models):
    from avsr_tpu.models.resnet import ResEncoder

    _, _, variables, pmodel = models
    _, vid = _inputs(1)
    sub = {
        c: variables[c]["encoder"]["video_resnet"]
        for c in ("params", "batch_stats")
    }
    want = ResEncoder().apply(sub, jnp.asarray(vid))
    with torch.no_grad():
        got = pmodel.encoder.feature_extractor_video.resnet(t(vid))
    assert got.shape == (2, 6, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_avhubert_encoder(models, masked):
    from avsr_tpu.models.avhubert import AVHubertModel

    cfg, _, variables, pmodel = models
    aud, vid = _inputs(2, tt=7)
    mask = np.asarray([[True] * 7, [True] * 4 + [False] * 3]) if masked else None
    sub = {c: variables[c]["encoder"] for c in ("params", "batch_stats")}
    want = jax.jit(AVHubertModel(cfg.encoder).apply)(
        sub, jnp.asarray(aud), jnp.asarray(vid),
        None if mask is None else jnp.asarray(mask),
    )
    with torch.no_grad():
        got = pmodel.encoder(t(aud), t(vid), None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_encode_and_ctc_log_probs(models):
    _, jmodel, variables, pmodel = models
    aud, vid = _inputs(3, b=3, tt=9)
    lens = np.asarray([9, 5, 7])
    feats = jax.jit(lambda *a: jmodel.apply(*a, method="encode"))(
        variables, jnp.asarray(aud), jnp.asarray(vid), jnp.asarray(lens))
    logp = jmodel.apply(variables, feats, method="ctc_log_probs")
    with torch.no_grad():
        pf = pmodel.encode(t(aud), t(vid), t(lens))
        pl = pmodel.ctc_log_probs(pf)
    np.testing.assert_allclose(pf.numpy(), np.asarray(feats), atol=TOL, rtol=0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(logp), atol=TOL, rtol=0)


def _lane_bias(rng, b, k, s_max, pos):
    """(B, K, J, S): random ancestry on rows < pos, own lane at pos."""
    anc = rng.randint(0, k, size=(s_max, b, k))
    anc[pos] = np.arange(k)
    valid = (np.arange(s_max) <= pos)[:, None, None, None] & (
        anc[..., None] == np.arange(k))
    return np.where(np.transpose(valid, (1, 2, 3, 0)), 0.0, -1e30).astype(np.float32)


def test_decoder_init_and_steps(models):
    cfg, jmodel, variables, pmodel = models
    rng = np.random.RandomState(4)
    b, k, s_enc, s_max = 3, 3, 10, 64
    memory = rng.randn(b, s_enc, cfg.adim).astype(np.float32)
    lens = np.asarray([10, 6, 8])
    mem_mask = (np.arange(s_enc)[None, :] < lens[:, None])[:, None, :]
    jcache = jmodel.apply(variables, jnp.asarray(memory), s_max, k,
                          method="decoder_init")
    jstep = jax.jit(lambda *a: jmodel.apply(*a, method="decoder_step"))
    with torch.no_grad():
        pcache = pmodel.decoder_init(t(memory), s_max, k)
    for pos in range(3):
        ys = rng.randint(0, cfg.odim, size=b * k)
        bias = _lane_bias(rng, b, k, s_max, pos)
        jlogp, jcache = jstep(
            variables, jnp.asarray(ys), jnp.asarray(pos), jcache,
            jnp.asarray(mem_mask), jnp.asarray(bias))
        with torch.no_grad():
            plogp, pcache = pmodel.decoder_step(
                t(ys), pos, pcache, t(mem_mask), t(bias))
        np.testing.assert_allclose(plogp.numpy(), np.asarray(jlogp),
                                   atol=TOL, rtol=0)
        for pkv, jkv in zip(pcache.self_kv, jcache.self_kv):
            np.testing.assert_allclose(pkv.numpy(), np.asarray(jkv),
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("codec", ["delta", "delta2"])
def test_wire_decoders_match_jax(codec):
    from avsr_tpu.data import wire as jwire
    from avsr_tpu_torch.data import wire

    rng = np.random.RandomState(5)
    vid = rng.randint(0, 256, size=(2, 7, 88, 88, 1)).astype(np.uint8)
    enc = getattr(wire, f"{codec}_encode_video")(vid)
    np.testing.assert_array_equal(enc, getattr(jwire, f"{codec}_encode_video")(vid))
    dec = getattr(wire, f"{codec}_decode_video")(t(enc))
    assert dec.dtype == torch.uint8
    np.testing.assert_array_equal(dec.numpy(), vid)
    np.testing.assert_array_equal(
        dec.numpy(),
        np.asarray(getattr(jwire, f"{codec}_decode_video")(jnp.asarray(enc))))


def test_make_non_pad_mask():
    from avsr_tpu.ops.masks import make_non_pad_mask as jmask
    from avsr_tpu_torch.ops.masks import make_non_pad_mask

    lens = np.asarray([0, 3, 7])
    np.testing.assert_array_equal(
        make_non_pad_mask(t(lens), 7).numpy(),
        np.asarray(jmask(jnp.asarray(lens), 7)))
