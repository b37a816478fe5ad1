"""The beam's device loop (``decode/device_loop.py``), as far as the CPU
reaches it.

The port runs the JAX beam's ``lax.while_loop`` as a state of fixed-shape
tensors, its step index among them, and a step (``beam.beam_step``) that
reads the index only on the device; the host reads the stop flag once
every k steps (on the card the k steps are one CUDA graph replay, which
``chip_smoke.py`` runs). Here, at tiny sizes: the k-step loop bit for bit
against k = 1 (the host loop) and token for token against the JAX beam, on
the flagship, conformer and S2T models, with hypotheses ending at
different steps, unequal frame counts, CTC weights 0 and 0.1 and fused and
unfused bookkeeping, also where every lane stops before the last chunk of
k steps ends; the plain twins of the three kernels that read the step
(B2, B8, B9) alike for a tensor and an int; and no host read of a tensor
in the step.
"""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from avsr_tpu_torch.decode import beam as pbeam  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    beam_step_case,
    decode_case,
    port_cfg,
    setup_torch,
    t,
    tiny_cfg,
)

KS = (4, 7)  # against the host loop, k = 1
LENS = (20, 13, 17)  # the flagship batch's frames


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


def _runs(bcfg, model, feats, ctc, lens, ks=KS):
    """{k: ((yseqs, lengths, scores), the run's stats)} of
    ``beam_search_batched`` over the model's decoder: k = 1 the host loop
    (``device_loop=False``), the others the device loop reading the stop
    flag every k steps."""
    out = {}
    for k in (1, *ks):
        with torch.inference_mode():
            got = pbeam.beam_search_batched(
                bcfg, model.decoder_step, model.decoder_init, feats, ctc,
                lens, device_loop=k > 1, stop_every=k)
        out[k] = (got, dict(pbeam.beam_search_batched.last_run))
    return out


def _assert_loops_agree(runs):
    """Every k bit-identical to the host loop; reads ceil(steps / k) and
    steps up to the next multiple of k past the host loop's."""
    base, base_stats = runs[1]
    assert base_stats["reads"] == base_stats["steps"]
    for k, (got, stats) in runs.items():
        for a, b in zip(got, base):
            assert torch.equal(a, b), k
        assert stats["reads"] == math.ceil(stats["steps"] / k), (k, stats)
        assert stats["steps"] >= base_stats["steps"]
        assert stats["steps"] - base_stats["steps"] < k
        assert stats["replays"] == stats["captures"] == 0  # the CPU: no graph


# ------------------------------------------------------------ the flagship
#
# Each family's port model gets seeded weights, which the JAX package's
# converter turns into its variables (no JAX init); the JAX beam takes the
# port's encoder outputs (the encoders are held against each other in the
# families' own tests), so only the beams are compiled.


def _jax_variables(state_dict, mapping):
    from avsr_tpu.core import checkpoint as jckpt

    return jckpt.convert_state({k: v.numpy() for k, v in state_dict.items()},
                               mapping)


def _flagship_pair(eos_boost, ctc_weight):
    """(JAX Recognizer, the port's) of the tiny flagship, eos's output bias
    raised by ``eos_boost`` so that hypotheses end on their own."""
    from avsr_tpu.core import checkpoint as jckpt
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu.models.e2e import AVSRModel as JaxAVSR
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models.e2e import AVSRModel

    cfg = tiny_cfg()
    model = AVSRModel(port_cfg(cfg))
    init_weights(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.decoder.output_layer.bias[cfg.eos] += eos_boost
    variables = _jax_variables(model.state_dict(),
                               jckpt.avsr_mapping(cfg, prefix=""))
    kw = dict(beam_size=3, t_buckets=(24,), max_decode_tokens=16,
              video_wire="delta2", ctc_weight=ctc_weight)
    return (JaxRecognizer(model=JaxAVSR(cfg), variables=variables, cfg=cfg,
                          **kw),
            Recognizer(model=model.eval(), cfg=port_cfg(cfg), device="cpu",
                       **kw))


def _flagship_batch():
    rng = np.random.RandomState(7)
    audio = [rng.randn(n, 104).astype(np.float32) for n in LENS]
    video = [rng.randint(0, 256, size=(n, 88, 88, 1)).astype(np.uint8)
             for n in LENS]
    return audio, video


def _recognizer_runs(prec, jrec, feats, ctc, lens):
    """The JAX beam's (yseqs, lengths), and per fused bookkeeping the port's
    runs of every k."""
    jy, jl, _ = (np.asarray(x) for x in jrec._beam_fn()(
        jrec.variables, feats.numpy(), ctc.numpy(), lens.numpy()))
    out = {}
    for fused in (False, True):
        bcfg = dataclasses.replace(prec.beam_config(),
                                   fused_bookkeeping=fused)
        out[fused] = _runs(bcfg, prec.model, feats, ctc, lens)
        # the Recognizer's own beam: its device loop at the default k
        for a, b in zip(out[fused][1][0], dataclasses.replace(
                prec, fused_bookkeeping=fused).beam(feats, ctc, lens)):
            assert torch.equal(a, b)
        _assert_loops_agree(out[fused])
        for (py, pl, _), _stats in out[fused].values():
            np.testing.assert_array_equal(pl.numpy(), jl)
            np.testing.assert_array_equal(py.numpy(), jy)
    return out


# (eos_boost, ctc_weight): with CTC, hypotheses end on their own eos at
# different steps; the attention-only beam's strong boost ends every lane
# long before its frames run out, inside the last chunk of k steps
@pytest.mark.parametrize("eos_boost,ctc_weight,early", [
    pytest.param(5.0, 0.1, False, id="ctc-5.0"),
    pytest.param(6.0, 0.0, True, id="6.0-all-stop-early"),
])
def test_flagship_loop_matches_host_loop_and_jax(eos_boost, ctc_weight,
                                                 early):
    jrec, prec = _flagship_pair(eos_boost, ctc_weight)
    aud, vid, lens, _ = prec._pad_batch(*_flagship_batch())
    feats, ctc = prec.encode(aud, vid, lens)
    for runs in _recognizer_runs(prec, jrec, feats, ctc, lens).values():
        base_steps = runs[1][1]["steps"]
        ylens = runs[1][0][1]
        if early:  # every lane stopped, then the chunk ran on
            assert base_steps < max(LENS) - 2
            assert runs[7][1]["steps"] > base_steps
        else:  # lanes ended at different steps, some on their own eos
            assert len(set(ylens.tolist())) > 1
            assert (ylens < torch.tensor(LENS) + 2).any()


# --------------------------------------------------- conformer and S2T


def test_conformer_loop_matches_host_loop_and_jax():
    """The tiny conformer (fp32 decoder, ctc_weight 0.1, eos favoured)."""
    from avsr_tpu.core import checkpoint as jckpt
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu.models import conformer as JC
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models import conformer as PC

    kw = dict(odim=40, adim=64, aheads=4, eunits=128, elayers=2, ddim=64,
              dheads=4, dunits=128, dlayers=2, fusion_hdim=256)
    model = PC.ConformerAVSR(**kw)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decoder.output_layer.bias[-1] += 2.0
    variables = _jax_variables(model.state_dict(),
                               jckpt.conformer_avsr_mapping(2, 2))
    rkw = dict(beam_size=3, ctc_weight=0.1, t_buckets=(12,), audio_rate=640,
               audio_dim=1, max_decode_tokens=16)
    jmodel = JC.ConformerAVSR(**kw)
    jrec = JaxRecognizer(model=jmodel, variables=variables, cfg=jmodel, **rkw)
    prec = Recognizer(model=model.eval(), cfg=model, device="cpu", **rkw)
    rng = np.random.RandomState(6)
    frames = (12, 7, 9)
    videos = [rng.randn(n, 88, 88, 1).astype(np.float32) for n in frames]
    waves = [rng.randn(n * 640, 1).astype(np.float32) for n in frames]
    aud, vid, lens, _ = prec._pad_batch(waves, videos)
    feats, ctc = prec.encode(aud, vid, lens)
    _recognizer_runs(prec, jrec, feats, ctc, lens)


def test_s2t_loop_matches_host_loop_and_jax():
    """The tiny AV2Text model on the eager path (the memory repeated to B*K
    lanes, the self caches gathered by parent, which the loop carries as
    state), its eos row (also the start token) scaled down as
    tests/test_torch_port_av2text.py scales it."""
    from avsr_tpu.core import checkpoint as jckpt
    from avsr_tpu.decode import beam as jbeam
    from avsr_tpu.models import av2text as JA
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode.s2t_generate import S2TGenerator
    from avsr_tpu_torch.models import av2text as PA
    from tests.test_torch_port_av2text import TINY

    model = PA.AV2TextModel(PA.AV2TextConfig(**TINY))
    init_weights(model, torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.decoder.embed_tokens.weight[2] *= 0.3
    model.eval()
    variables = _jax_variables(model.state_dict(), jckpt.av2text_mapping(
        TINY["encoder_layers"], TINY["decoder_layers"], prefix=""))
    jm = JA.AV2TextModel(JA.AV2TextConfig(**TINY))
    rng = np.random.RandomState(3)
    lens = np.asarray([8, 5, 3])
    audio = rng.randn(3, 8, 104).astype(np.float32)
    video = rng.randn(3, 8, 88, 88, 1).astype(np.float32)
    gen = S2TGenerator(model, beam_size=3, device="cpu")
    memory = gen.encode(audio, video, lens)

    @jax.jit
    def jax_beam(mem, xlens):
        def step(y, pos, cache, mask):
            return jm.apply(variables, y, pos, cache, mask,
                            method="decoder_step")

        def init(m, maxlen):
            return jm.apply(variables, m, maxlen, method="decoder_init")

        c = gen.bcfg
        jcfg = jbeam.BeamSearchConfig(beam_size=c.beam_size, ctc_weight=0.0,
                                      sos=c.sos, eos=c.eos, blank=c.blank,
                                      vocab=c.vocab)
        return jbeam.beam_search_batched(
            jcfg, step, init, mem,
            jax.numpy.zeros(mem.shape[:2] + (gen.bcfg.vocab,)), xlens)

    jy, jl, _ = (np.asarray(x) for x in jax_beam(memory.numpy(), lens))
    for fused in (False, True):
        gen.bcfg = dataclasses.replace(gen.bcfg, fused_bookkeeping=fused)
        runs = _runs(gen.bcfg, gen.model, memory, None, torch.from_numpy(lens))
        for a, b in zip(runs[1][0], gen.beam(memory, lens)):
            assert torch.equal(a, b)
        _assert_loops_agree(runs)
        for (py, pl, _), _stats in runs.values():
            np.testing.assert_array_equal(pl.numpy(), jl)
            np.testing.assert_array_equal(py.numpy(), jy)
    assert len(set(jl.tolist())) > 1


# ---------------------------------------- the twins take the step as a tensor


def test_twins_take_a_tensor_step_as_an_int():
    """B2, B8 and B9's plain twins give the same outputs (and B2's and B9's
    the same cache) for a one-element int32 or int64 tensor as for the
    int, at steps inside, at the end of and past a 16-row cache."""
    from avsr_tpu_torch.models.decoder import DecoderLayer
    from avsr_tpu_torch.ops.kernels import beam_update as pbu
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl

    layer = DecoderLayer(32, 2, 64).eval()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.2)
    packed = pdl.pack_layer_params(layer, torch.float32)
    kw = dict(w_dec=0.9, w_ctc=0.1, eos=49, neg=-1.0e30, d_end=-10.0,
              m_end=3)
    for pos in (0, 5, 15, 20):
        steps = (pos, torch.tensor([pos], dtype=torch.int32),
                 torch.tensor(pos))
        q, kv, row, bias = (t(x) for x in decode_case(pos, b=2, k=3,
                                                      s_max=16, heads=2,
                                                      dh=16, pos=pos))
        b2 = [pda.decode_attention_plain(s, q, kv.clone(), bias, 3, 2, row)
              for s in steps]
        src = torch.randn(2, 6, 32)
        mem_bias = torch.zeros(2, 6)
        b9 = [pdl.decoder_layer_step_plain(s, q, kv.clone(), src, src,
                                           mem_bias, bias, packed, 3, 2)
              for s in steps]
        for got in (b2, b9):
            for other in got[1:]:
                assert torch.equal(other[0], got[0][0])
                assert torch.equal(other[1], got[0][1])
        i = min(pos + 4, 19)  # beam_step_case's lengths reach 21
        case = {k: (None if v is None else t(v))
                for k, v in beam_step_case(pos, i).items()}
        b8 = [pbu.beam_update_plain(s, *case.values(), **kw)
              for s in (i, torch.tensor([i]), torch.tensor(i,
                                                           dtype=torch.int32))]
        for other in b8[1:]:
            for name, x in b8[0].items():
                assert torch.equal(other[name], x), name


# ------------------------------------------------ no host read in the step


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises on a read of a tensor's value by the host: ``int``,
    ``float``, ``bool`` and ``.item()`` of a tensor reach
    ``aten._local_scalar_dense``; ``.tolist()`` and ``.numpy()``, which
    pass no operator, are refused while the mode is on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            _refuse()
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        self._saved = torch.Tensor.tolist, torch.Tensor.numpy
        torch.Tensor.tolist = torch.Tensor.numpy = _refuse
        return super().__enter__()

    def __exit__(self, *exc):
        torch.Tensor.tolist, torch.Tensor.numpy = self._saved
        return super().__exit__(*exc)


def _refuse(*_):
    raise AssertionError("the step read a tensor on the host")


def _flagship_state(ctc_weight, fused):
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode.beam import BeamSearchConfig, init_search
    from avsr_tpu_torch.models.e2e import AVSRModel

    cfg = port_cfg(tiny_cfg())
    model = AVSRModel(cfg)
    init_weights(model, torch.Generator().manual_seed(1))
    model.eval()
    bcfg = BeamSearchConfig(ctc_weight=ctc_weight, sos=cfg.sos, eos=cfg.eos,
                            vocab=cfg.odim, max_decode_tokens=16,
                            fused_bookkeeping=fused, shared_src_kv=True,
                            lazy_reorder=True)
    rng = np.random.RandomState(0)
    feats = t(rng.randn(2, 10, cfg.encoder.encoder_embed_dim).astype(
        np.float32))
    ctc = torch.log_softmax(t(rng.randn(2, 10, cfg.odim).astype(
        np.float32)), -1)
    with torch.no_grad():
        st, inp = init_search(bcfg, model.decoder_init, feats, ctc,
                              torch.tensor([10, 6]))
    return bcfg, model, st, inp


@pytest.mark.parametrize("ctc_weight,fused", [(0.1, False), (0.1, True),
                                              (0.0, False)])
def test_step_reads_nothing_on_the_host(ctc_weight, fused):
    """Three steps of ``beam_step`` under a dispatch mode that refuses
    every host read of a tensor; the same harness catches a decoder step
    that reads ``int(pos)`` or ``pos.tolist()``. Outside inference mode:
    an inference tensor's operators pass no dispatch mode."""
    bcfg, model, st, inp = _flagship_state(ctc_weight, fused)
    with torch.no_grad(), _NoHostRead():
        for _ in range(3):
            st = pbeam.beam_step(bcfg, model.decoder_step, st, inp)
        done = pbeam.all_done(st, inp)
    assert int(st.i) == 3 and not bool(done)

    for read in (int, lambda x: x.tolist()):
        def reads_pos(y, pos, *a, read=read):
            read(pos)
            return model.decoder_step(y, pos, *a)

        with pytest.raises(AssertionError, match="read a tensor on the host"):
            with torch.no_grad(), _NoHostRead():
                pbeam.beam_step(bcfg, reads_pos, st, inp)
