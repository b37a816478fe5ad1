"""The port's beam at flagship width and T=375 against the JAX beam
(opt-in: AVSR_SLOW_TESTS=1, as tests/test_flagship_scale.py).

ROADMAP C3: the JAX package found a shortcut in ``cumlogsumexp`` that broke
token-exactness only at T=375, where the tiny tests' short utterances
cannot show it. This anchor holds the port's device-loop beam (on the CPU:
the same step, the stop flag read every ``STOP_EVERY`` steps) at the
flagship's widths: the 6x1024 decoder (16 heads, 3072 units, vocab 5049)
with seeded random weights, fp32 decoder weights and K|V caches, shared
source K/V, lazy reorder, the 192-token cap and the joint CTC/attention
score at ctc_weight=0.1, over two utterances of 375 and 300 frames of
random encoder features and CTC log-probs; tokens, lengths and scores
(1e-4) against the JAX beam on the same inputs (its decoder on XLA's
lazy-reorder path, which the JAX package serves in fp32 as well). Only the
decoder is built: the encoders are held elsewhere.

    AVSR_SLOW_TESTS=1 python -m pytest tests/test_torch_port_flagship_anchor.py
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

pytestmark = pytest.mark.skipif(
    not os.environ.get("AVSR_SLOW_TESTS"),
    reason="flagship-width T=375 beam anchor is opt-in (AVSR_SLOW_TESTS=1)")

FRAMES = (375, 300)
KV_CAP = 192


def test_flagship_beam_t375_token_exact():
    from avsr_tpu.core import checkpoint as jckpt
    from avsr_tpu.core.config import AVHubertAVSRConfig as JaxConfig
    from avsr_tpu.decode import beam as jbeam
    from avsr_tpu.models.e2e import AVSRModel as JaxAVSR
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode import beam as pbeam
    from avsr_tpu_torch.decode.device_loop import STOP_EVERY
    from avsr_tpu_torch.models.decoder import TransformerDecoder
    from tests.torch_port_common import setup_torch

    setup_torch()
    jcfg = JaxConfig(decoder_cache_dtype="float32",
                     decoder_param_dtype="float32",
                     decode_fused_attention=False)
    dec = TransformerDecoder(jcfg.odim, jcfg.ddim, jcfg.dheads, jcfg.dunits,
                             jcfg.dlayers)
    init_weights(dec, torch.Generator().manual_seed(0))
    dec.eval()
    variables = jckpt.convert_state(
        {f"decoder.{k}": v.numpy() for k, v in dec.state_dict().items()},
        jckpt._decoder_entries("decoder", ("decoder",), jcfg.dlayers))
    jm = JaxAVSR(jcfg)

    rng = np.random.RandomState(0)
    b, t = len(FRAMES), max(FRAMES)
    feats = rng.randn(b, t, jcfg.ddim).astype(np.float32)
    ctc = (3.0 * rng.randn(b, t, jcfg.odim)).astype(np.float32)
    ctc = ctc - np.log(np.exp(ctc).sum(-1, keepdims=True))
    xlens = np.asarray(FRAMES)
    kw = dict(beam_size=3, ctc_weight=0.1, sos=jcfg.odim - 1,
              eos=jcfg.odim - 1, blank=0, vocab=jcfg.odim,
              max_decode_tokens=KV_CAP, shared_src_kv=True,
              lazy_reorder=True)

    @jax.jit
    def jax_beam(f, c, n):
        def step(y, pos, cache, mask, lane_bias):
            return jm.apply(variables, y, pos, cache, mask, lane_bias,
                            method="decoder_step")

        def init(m, maxlen, beam):
            return jm.apply(variables, m, maxlen, beam,
                            method="decoder_init")

        return jbeam.beam_search_batched(jbeam.BeamSearchConfig(**kw), step,
                                         init, f, c, n)

    jy, jl, js = (np.asarray(x) for x in jax_beam(feats, ctc, xlens))
    py, pl, ps = pbeam.beam_search_batched(
        pbeam.BeamSearchConfig(**kw), dec.step, dec.init_cache,
        torch.from_numpy(feats), torch.from_numpy(ctc),
        torch.from_numpy(xlens))
    run = pbeam.beam_search_batched.last_run
    assert run["stop_every"] == STOP_EVERY
    assert run["reads"] == -(-run["steps"] // STOP_EVERY)
    np.testing.assert_array_equal(pl.numpy(), jl)
    np.testing.assert_array_equal(py.numpy(), jy)
    np.testing.assert_allclose(ps.numpy(), js, rtol=1e-4, atol=0)
