"""The port's training slice against the JAX package, on the CPU.

Inputs come from numpy seeds; the model is the tiny config of
``tests/torch_port_common.py`` (2 encoder and 2 decoder layers, width 32)
with JAX-initialised weights. The flash-attention wrappers run their plain
twins here (tensors on the CPU); the CUDA kernels are held against the
same twins on the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

Tolerances: fp32 throughout, so losses within 1e-5 relative and gradients
within 1e-4 of each tensor's largest entry. One exception, ROADMAP C16: at
these shapes the video frontend's gradient (train-mode BatchNorm over a few
hundred samples, the stem's sums over ~46k positions) is ill-conditioned in
fp32: both packages' fp32 gradients are percent-level off their own float64
ones. So the frontend's gradient is held against the JAX package in float64
with the port in float64 too, and the multi-step runs against the JAX
package in float64.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.core.checkpoint import avsr_mapping, flax_to_torch  # noqa: E402
from avsr_tpu_torch.ops import ctc as pctc  # noqa: E402
from avsr_tpu_torch.ops import masks as pmasks  # noqa: E402
from avsr_tpu_torch.ops.dropout import DropoutRng  # noqa: E402
from avsr_tpu_torch.ops.kernels import flash_attention as pfa  # noqa: E402
from avsr_tpu_torch.train import trainer as PT  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    jax_tiny_model,
    port_cfg,
    port_model,
    setup_torch,
    t,
    tiny_cfg,
)

NEG = -1.0e30
FRONTEND = "encoder.feature_extractor_video.resnet."
BATCH_KEYS = ("videos", "audios", "labels", "video_lengths", "label_lengths")


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


# ---------------------------------------------------------------- losses


def _ctc_case():
    """Logits (3, 10, 7); labels padded with -1; sample 2 is infeasible
    (T=4 < L + repeats = 3 + 2)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 10, 7).astype(np.float32) * 2
    labels = np.asarray([[1, 2, 2, 3], [4, 5, -1, -1], [6, 6, 6, -1]])
    return logits, np.asarray([10, 7, 4]), labels, np.asarray([4, 2, 3])


def test_ctc_loss_matches_jax():
    """The loss, and d loss / d logits against jax.grad of the JAX
    ctc_loss: finite everywhere, exactly 0 on the infeasible sample,
    within 1e-5 of the largest entry elsewhere."""
    from avsr_tpu.ops.ctc import ctc_loss

    logits, llen, labels, lablen = _ctc_case()
    want = ctc_loss(jnp.asarray(logits), jnp.asarray(llen),
                    jnp.asarray(labels), jnp.asarray(lablen))
    got = pctc.ctc_loss(t(logits), t(llen), t(labels), t(lablen))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # the infeasible sample counts 0 in both: the feasible ones alone
    part = pctc.ctc_loss(t(logits[:2]), t(llen[:2]), t(labels[:2]),
                         t(lablen[:2]))
    np.testing.assert_allclose(got.item() * 3, part.item() * 2, rtol=1e-6)
    want_g = np.asarray(jax.grad(lambda x: ctc_loss(
        x, jnp.asarray(llen), jnp.asarray(labels), jnp.asarray(lablen)))(
        jnp.asarray(logits)))
    x = t(logits).requires_grad_()
    (got_g,) = torch.autograd.grad(
        pctc.ctc_loss(x, t(llen), t(labels), t(lablen)), x)
    got_g = got_g.numpy()
    assert np.isfinite(got_g).all()
    assert not got_g[2].any() and not want_g[2].any()
    _assert_close_rel(got_g, want_g, 1e-5, "dlogits")


def test_label_smoothing_and_accuracy_match_jax():
    from avsr_tpu.ops.ctc import label_smoothing_loss, th_accuracy

    rng = np.random.RandomState(1)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    targets = np.asarray([[1, 4, 4, 2, -1], [3, 3, -1, -1, -1]])
    targets[0, 1] = logits[0, 1].argmax()
    for norm in (False, True):
        want = label_smoothing_loss(jnp.asarray(logits), jnp.asarray(targets),
                                    0.1, -1, norm)
        got = pctc.label_smoothing_loss(t(logits), t(targets), 0.1, -1, norm)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want = th_accuracy(jnp.asarray(logits), jnp.asarray(targets))
    got = pctc.th_accuracy(t(logits), t(targets))
    assert got.item() == pytest.approx(float(want)) and got.item() > 0


def test_add_sos_eos_and_target_mask_match_jax():
    from avsr_tpu.ops.masks import add_sos_eos, target_mask

    ys = np.asarray([[3, 5, 5, 7], [4, 8, -1, -1], [-1, -1, -1, -1]])
    lens = np.asarray([4, 2, 0])
    w_in, w_out = add_sos_eos(jnp.asarray(ys), jnp.asarray(lens), 60, 60)
    g_in, g_out = pmasks.add_sos_eos(t(ys), t(lens), 60, 60)
    np.testing.assert_array_equal(g_in.numpy(), np.asarray(w_in))
    np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(pmasks.target_mask(g_in).numpy(),
                                  np.asarray(target_mask(w_in)))


# ---------------------------------------------------------------- flash


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("n,tt,d", [(2, 128, 16), (2, 256, 32), (1, 640, 16)])
def test_flash_fn_grads_match_jax(n, tt, d, dropout):
    """FlashAttentionFn forward and dQ/dK/dV against jax.vjp of the Pallas
    kernel in interpret mode: T=128 and 256 run the JAX resident kernels,
    T=640 the streaming dq/dkv pair. A padding bias on every case; with
    ``dropout`` the port draws its seeded mask (rate 0.1) and JAX is given
    that same pre-scaled mask explicitly. Each side within 2e-6 of a
    float64 evaluation of the same function, then of each other (fp32,
    |values| ~ 1)."""
    from avsr_tpu.ops.pallas.flash_attention import flash_attention

    rng = np.random.RandomState(tt + d)
    q, k, v, w = (rng.randn(n, tt, d).astype(np.float32) for _ in range(4))
    lens = np.asarray([tt, tt - 37])[:n]
    bias = np.where(np.arange(tt)[None] < lens[:, None], 0.0, NEG)
    bias = bias.astype(np.float32)
    rate, seed = (0.1, (tt, d)) if dropout else (0.0, None)
    mask = None
    if dropout:
        mask = pfa._seeded_mask(rate, seed, n, tt, "cpu").numpy()
    scale = d ** -0.5

    def f(q, k, v):
        return flash_attention(
            q, k, v, jnp.asarray(bias), scale=scale, interpret=True,
            dropout_mask=None if mask is None else jnp.asarray(mask))

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    wants = vjp(jnp.asarray(w))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = pfa.FlashAttentionFn.apply(tq, tk, tv, t(bias), scale, rate, seed)
    out.backward(t(w))
    exact = _attention_f64(q, k, v, bias, scale, mask, w)
    for name, got, ref, f64 in zip(("out", "dq", "dk", "dv"),
                                   (out, tq.grad, tk.grad, tv.grad),
                                   (want, *wants), exact):
        got, ref = got.detach().numpy(), np.asarray(ref)
        # each side against float64 first, so a drift names its side
        # (ROADMAP C21): fp32 sums of <= 640 terms of |x| ~ 1 stay within
        # 4.4e-7 of float64 (measured on both sides); 2e-6 as below
        e_port, e_jax = (float(np.abs(x - f64).max()) for x in (got, ref))
        assert max(e_port, e_jax) <= 2e-6, (
            f"{name}: the port is {e_port:.2e} and JAX {e_jax:.2e} off the "
            f"float64 evaluation; the drifting side is "
            f"{'the port' if e_port > e_jax else 'JAX'}; {_torch_state()}")
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0,
                                   err_msg=f"{name}; {_torch_state()}")


def _torch_state() -> str:
    """The process's torch settings that could move an fp32 CPU result
    (ROADMAP C21), for a failure message."""
    mkldnn = getattr(torch.backends.mkldnn, "fp32_precision", "unknown")
    return (f"torch threads {torch.get_num_threads()}, interop threads "
            f"{torch.get_num_interop_threads()}, fp32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}, oneDNN fp32 "
            f"precision {mkldnn!r}; parallel_info: "
            f"{' | '.join(torch.__config__.parallel_info().split(chr(10)))}")


def _attention_f64(q, k, v, bias, scale, mask, w):
    """out and dQ, dK, dV of softmax(q k^T scale + bias) [* mask] v with
    cotangent w, in float64 (torch autograd on the CPU)."""
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in (q, k, v))
    s = q @ k.transpose(1, 2) * scale + torch.tensor(
        bias, dtype=torch.float64)[:, None, :]
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = p * torch.tensor(mask, dtype=torch.float64)
    out = p @ v
    out.backward(torch.tensor(w, dtype=torch.float64))
    return [x.detach().numpy() for x in (out, q.grad, k.grad, v.grad)]


def test_dropout_keep_mask_plain():
    """Deterministic per seed; keep fraction 1 - rate; other heads and
    other seeds draw other bits; T need not be a multiple of 4."""
    a = pfa.dropout_keep_mask_plain((7, 11), 4, 130, 0.1)
    assert a.shape == (4, 130, 130) and a.dtype == torch.bool
    assert torch.equal(a, pfa.dropout_keep_mask_plain((7, 11), 4, 130, 0.1))
    assert abs(a.float().mean().item() - 0.9) < 0.01
    assert not torch.equal(a[0], a[1])
    other = pfa.dropout_keep_mask_plain((7, 12), 4, 130, 0.1)
    assert not torch.equal(a, other)
    # element (h, i, j) is independent of the shape it is drawn in
    b = pfa.dropout_keep_mask_plain((7, 11), 2, 64, 0.1)
    assert torch.equal(b, a[:2, :64, :64])
    assert abs(pfa.dropout_keep_mask_plain((1, 2), 2, 200, 0.5)
               .float().mean().item() - 0.5) < 0.01


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    def run(ctr, key):
        c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
        return [int(w) for w in pfa.philox4x32_10(c, *key)]

    assert run((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_seeded_dropout_equals_its_explicit_mask():
    """The seeded path (rate, seed) through FlashAttentionFn on the CPU is
    the plain twins' explicit-mask path with the kernels' Philox mask,
    forward and backward; the split backward wrappers run the twins and
    launch nothing."""
    rng = np.random.RandomState(3)
    n, tt, d = 3, 70, 16
    q, k, v, w = (t(rng.randn(n, tt, d).astype(np.float32)) for _ in range(4))
    bias = torch.zeros(n, tt)
    seed, rate = (99, 5), 0.2
    _, inv_keep = pfa.dropout_threshold(rate)
    mask = pfa.dropout_keep_mask_plain(seed, n, tt, rate).float() * inv_keep
    before = (pfa.flash_attention_bwd_dq.launches,
              pfa.flash_attention_bwd_dkv.launches)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = pfa.flash_attention(*xs, bias, 0.25, dropout_rate=rate,
                              dropout_seed=seed)
    out.backward(w)
    ref, lse = pfa.flash_attention_plain(q, k, v, bias, 0.25,
                                         dropout_mask=mask)
    assert torch.equal(out.detach(), ref)
    grads = pfa.flash_attention_bwd_plain(q, k, v, bias, ref, w, lse, 0.25,
                                          dropout_mask=mask)
    for x, g in zip(xs, grads):
        torch.testing.assert_close(x.grad, g, atol=1e-6, rtol=0)
    assert (pfa.flash_attention_bwd_dq.launches,
            pfa.flash_attention_bwd_dkv.launches) == before


# ---------------------------------------------------------------- model


def _no_dropout(cfg):
    cfg.dropout_rate = 0.0
    cfg.transformer_attn_dropout_rate = 0.0
    e = cfg.encoder
    e.hidden_dropout = e.attention_dropout = e.activation_dropout = 0.0
    e.dropout_input = e.modality_dropout = 0.0
    return cfg


def _train_batch(rng, b=2, tt=12):
    """Two utterances, the second 3 frames shorter and with 2 labels of
    padding; ids below the tiny config's eos (60)."""
    from avsr_tpu_torch.data.synthetic import synthetic_train_batch

    return synthetic_train_batch(rng, b, tt, 5, video_lengths=[tt, tt - 3],
                                 label_lengths=[5, 3], vocab=59)


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        tree)


def _jax_batch(batch, dtype=np.float32):
    return {k: jnp.asarray(v.astype(dtype) if v.dtype.kind == "f"
                           else v.astype(np.int32))
            for k, v in batch.items()}


def _keys():
    return {"dropout": jax.random.PRNGKey(0),
            "modality": jax.random.PRNGKey(1)}


@pytest.fixture(scope="module")
def tiny():
    """(JAX config with every dropout 0, flax model, variables, batch)."""
    cfg = _no_dropout(tiny_cfg())
    model, variables = jax_tiny_model(cfg)
    return cfg, model, variables, _train_batch(np.random.RandomState(0))


@pytest.fixture(scope="module")
def jax_grads(tiny):
    """jax.grad(trainer.loss_fn) in fp32 (metrics, new batch stats,
    gradients) and in float64 (gradients)."""
    from avsr_tpu.train import trainer as JT

    cfg, model, variables, batch = tiny

    def f(params, stats, b):
        (_, (m, new_stats)), g = jax.value_and_grad(
            lambda p: JT.loss_fn(model, p, stats, b, _keys()),
            has_aux=True)(params)
        return m, new_stats, g

    metrics, stats, grads = jax.jit(f)(variables["params"],
                                       variables["batch_stats"],
                                       _jax_batch(batch))
    with jax.enable_x64(True):
        _, _, g64 = jax.jit(f)(_to64(variables["params"]),
                               _to64(variables["batch_stats"]),
                               _jax_batch(batch, np.float64))
        g64 = jax.tree.map(np.asarray, g64)
    return metrics, stats, grads, g64


def _torch_tree(cfg, params, stats):
    return flax_to_torch({"params": params, "batch_stats": stats},
                         avsr_mapping(port_cfg(cfg), prefix=""))


def _assert_close_rel(got, want, frac, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= frac * scale + 1e-7, f"{name}: {err:.3e} vs max {scale:.3e}"


def test_train_forward_grads_and_stats_match_jax(tiny, jax_grads):
    """forward(train=True) with every dropout at 0: loss, its parts and
    the accuracy against JAX AVSRModel(train=True) through loss_fn; every
    parameter's gradient against jax.grad(loss_fn) mapped by
    ``flax_to_torch``; the BN running statistics against JAX's mutated
    batch_stats. The video frontend (C16): the port's float64 gradient
    within 1e-3 of JAX's float64 one (the attention twin and the CTC loss
    stay fp32), and its fp32 gradient within 5e-2 (fp32's conditioning
    here: 3.1e-2 measured against float64)."""
    cfg, _, variables, batch = tiny
    metrics, stats, grads, g64 = jax_grads
    want = _torch_tree(cfg, grads, stats)
    want64 = _torch_tree(cfg, g64, stats)
    got = {}
    for dtype in (torch.float32, torch.float64):
        model = port_model(cfg, variables).to(dtype)
        out = model(*(t(batch[k]).to(dtype) if batch[k].dtype.kind == "f"
                      else t(batch[k]) for k in BATCH_KEYS),
                    train=True, rng=DropoutRng(0))
        out.loss.backward()
        got[dtype] = (out, model)
    out, model = got[torch.float32]
    for k in ("loss", "loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(getattr(out, k).item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    params = dict(model.named_parameters())
    params64 = dict(got[torch.float64][1].named_parameters())
    buffers = dict(model.named_buffers())
    assert set(want) == set(params) | set(buffers)
    for name, p in params.items():
        if name.startswith(FRONTEND):
            _assert_close_rel(params64[name].grad.numpy(), want64[name],
                              1e-3, name)
            _assert_close_rel(p.grad.numpy(), want64[name], 5e-2, name)
        else:
            _assert_close_rel(p.grad.numpy(), want[name], 1e-4, name)
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # the running statistics moved: train-mode BN really ran
    assert not np.allclose(buffers[FRONTEND + "frontend3D.1.running_mean"],
                           variables["batch_stats"]["encoder"]["video_resnet"]
                           ["frontend_bn"]["mean"])


def test_train_forward_grads_and_stats_match_jax_fused_stem(
        tiny, jax_grads, monkeypatch):
    """The same with AVSR_FUSED_STEM=1: the port's stem tail runs the
    autograd function of ``bn_prelu_pool`` (its plain twins here, forward
    and backward). In float64, as C16 requires: the loss and its parts
    within 1e-5 of JAX's, every gradient within 1e-3 of JAX's float64
    gradient (the attention twin and the CTC loss stay fp32), the running
    statistics within 1e-5. The JAX package takes its ``lean_reference``
    on the CPU whatever the switch; in float64 the two forms agree."""
    from avsr_tpu_torch.models import resnet

    cfg, _, variables, batch = tiny
    metrics, stats, _, g64 = jax_grads
    want = _torch_tree(cfg, g64, stats)
    calls = []
    real = resnet.bn_prelu_pool

    def counted(*a, **kw):
        calls.append(kw["train"])
        return real(*a, **kw)

    monkeypatch.setenv("AVSR_FUSED_STEM", "1")
    monkeypatch.setattr(resnet, "bn_prelu_pool", counted)
    model = port_model(cfg, variables).double()
    out = model(*(t(batch[k]).double() if batch[k].dtype.kind == "f"
                  else t(batch[k]) for k in BATCH_KEYS),
                train=True, rng=DropoutRng(0))
    out.loss.backward()
    assert calls == [True]
    for k in ("loss", "loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(getattr(out, k).item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    for name, p in model.named_parameters():
        _assert_close_rel(p.grad.numpy(), want[name], 1e-3, name)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_bf16_loss_matches_jax(tiny):
    """compute_dtype=bfloat16 (every float parameter and the inputs cast
    for the forward): loss and its parts within 2% of JAX's bf16 loss_fn
    (bf16 keeps ~3 significant digits; the two frameworks round at other
    places), and within 3% of the fp32 loss."""
    from avsr_tpu.train import trainer as JT

    cfg, jmodel, variables, batch = tiny
    _, (want, _) = jax.jit(lambda p, s, b: JT.loss_fn(
        jmodel, p, s, b, _keys(), compute_dtype="bfloat16"))(
        variables["params"], variables["batch_stats"], _jax_batch(batch))
    model = port_model(cfg, variables)
    pb = PT.to_device(batch, "cpu")
    _, got = PT.loss_fn(model, pb, DropoutRng(0), True, "bfloat16")
    _, fp32 = PT.loss_fn(port_model(cfg, variables), pb, DropoutRng(0), True)
    for k in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-2,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].item(), fp32[k].item(), rtol=3e-2,
                                   err_msg=k)
    # running statistics stay fp32 masters
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_decay_mask_matches_jax(tiny):
    from avsr_tpu.train.trainer import _decay_mask

    cfg, _, variables, _ = tiny
    jmask = _decay_mask(variables["params"])
    got = PT.decay_mask(port_cfg(cfg))
    for tkey, fpath, _, coll in avsr_mapping(port_cfg(cfg), prefix=""):
        if coll != "p":
            continue
        node = jmask
        for p in fpath:
            node = node[p]
        for key in tkey if isinstance(tkey, list) else [tkey]:
            assert got[key] == bool(node), key
    assert got["encoder.encoder.pos_conv_embed.conv.weight_g"]
    assert not got[FRONTEND + "trunk.layer1.0.relu1.weight"]
    assert not got[FRONTEND + "trunk.layer1.0.bn1.weight"]


def test_lr_schedule_matches_optax():
    from avsr_tpu.train import trainer as JT

    jc = JT.TrainConfig(warmup_steps=3, max_steps=10, learning_rate=2e-4)
    pc = PT.TrainConfig(warmup_steps=3, max_steps=10, learning_rate=2e-4)
    js, ps = JT.lr_schedule(jc), PT.lr_schedule(pc)
    for c in range(12):
        assert ps(c) == float(js(c)), c
    assert ps(0) == 0.0


@pytest.mark.parametrize("accum,steps", [(1, 3), (2, 2)])
def test_train_steps_match_jax(tiny, accum, steps):
    """train_steps (lr 0, then 5e-4, then 1e-3) against JAX train_step,
    fp32 on both sides, with the audio-only modality: the video frontend
    and its BatchNorms still run, but its gradient is exactly 0 on both
    sides, which keeps C16's fp32 conditioning out of the comparison (the
    frontend's gradient is held in float64 above). Metrics and grad_norm
    within 1e-5 relative; Adam moments within 1e-3 of each tensor's
    largest entry; BN statistics within 1e-4. Parameters: the attention
    key biases have an exactly-zero gradient (softmax shift invariance), so
    Adam normalises rounding noise of either sign into steps of up to ~lr;
    every element stays within 2 x 1.01 x (the lrs' sum) + decay, and all
    but 0.2% within 1e-5. Accumulation: two micro-batches, gradient their
    mean, BN statistics threaded in order (6-frame clips: XLA's CPU
    backend runs the accumulation scan ~45x slower than one step)."""
    from avsr_tpu.models.e2e import AVSRModel as JaxModel
    from avsr_tpu.train import trainer as JT

    _, _, variables, _ = tiny
    cfg = _no_dropout(tiny_cfg())
    cfg.encoder.modality = "audio"  # same parameter tree as ``tiny``
    jmodel = JaxModel(cfg)
    rng = np.random.RandomState(5)
    mbs = [_train_batch(rng, tt=6) for _ in range(accum)]
    batch = mbs[0] if accum == 1 else {k: np.stack([b[k] for b in mbs])
                                       for k in mbs[0]}
    lrs = [0.0, 5e-4, 1e-3][:steps]
    jcfg = JT.TrainConfig(learning_rate=1e-3, warmup_steps=2, max_steps=10)
    tx = JT.make_optimizer(jcfg)
    pcfg = PT.TrainConfig(learning_rate=1e-3, warmup_steps=2, max_steps=10)
    state = PT.init_state(port_cfg(cfg), pcfg, device="cpu",
                          model=port_model(cfg, variables))
    pbatch = PT.to_device(batch, "cpu")
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    step = jax.jit(lambda s, b, k: JT.train_step(
        jmodel, tx, s, b, k, "float32", "threefry2x32"))
    jb = _jax_batch(batch)
    for i in range(steps):
        assert state.scheduler.get_last_lr()[0] == pytest.approx(lrs[i])
        jstate, jm = step(jstate, jb, jax.random.PRNGKey(i))
        pm = PT.train_step(state, pbatch)
        for k, v in pm.items():
            np.testing.assert_allclose(v.item(), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {i}")
    jstate = jax.tree.map(np.asarray, jstate)
    assert state.step == steps
    want = _torch_tree(cfg, jstate.params, jstate.batch_stats)
    buffers = dict(state.model.named_buffers())
    sd = state.model.state_dict()
    bound = 2 * 1.01 * sum(lrs) + 1e-5
    far = total = 0
    for name, ref in want.items():
        got = sd[name].numpy()
        if name in buffers:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4,
                                       err_msg=name)
            continue
        err = np.abs(got - ref)
        assert err.max() <= bound, name
        far += int((err > 1e-5).sum())
        total += err.size
    assert far <= 2e-3 * total, f"{far} of {total} elements beyond 1e-5"
    adam = jstate.opt_state[1][0]
    mu = _torch_tree(cfg, adam.mu, jstate.batch_stats)
    nu = _torch_tree(cfg, adam.nu, jstate.batch_stats)
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        _assert_close_rel(st["exp_avg"].numpy(), mu[name], 1e-3, name)
        _assert_close_rel(st["exp_avg_sq"].numpy(), nu[name], 1e-3, name)


def test_checkpoint_resume_equals_uninterrupted(tiny, tmp_path):
    """save_checkpoint -> restore_checkpoint into a fresh state -> the next
    step equals the uninterrupted run bit for bit, with every dropout on
    (the tiny config's rates, attention dropout through the kernels'
    Philox twin), so the generators' states are restored too."""
    cfg, _, variables, _ = tiny
    cfg = tiny_cfg()
    pcfg = PT.TrainConfig(learning_rate=1e-3, warmup_steps=1, max_steps=10)
    batch = PT.to_device(_train_batch(np.random.RandomState(7)), "cpu")

    def fresh():
        return PT.init_state(port_cfg(cfg), pcfg, seed=3, device="cpu",
                             model=port_model(cfg, variables))

    a = fresh()
    PT.train_step(a, batch)
    path = str(tmp_path / "state.pt")
    PT.save_checkpoint(path, a)
    m_a = PT.train_step(a, batch)
    b = PT.restore_checkpoint(path, fresh())
    assert b.step == 1
    m_b = PT.train_step(b, batch)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), n
    ev = PT.eval_step(b, batch)
    assert set(ev) == {"loss", "loss_ctc", "loss_att", "acc"}


def test_dropout_changes_the_step(tiny):
    """With the config's dropouts on, two seeds give two losses, one seed
    gives one; modality dropout draws once per forward on the host."""
    _, _, variables, _ = tiny
    cfg = tiny_cfg()  # the config's dropout rates; same parameter tree
    batch = PT.to_device(_train_batch(np.random.RandomState(8)), "cpu")
    pm = port_model(cfg, variables)
    losses = [PT.loss_fn(pm, batch, DropoutRng(s), True)[0].item()
              for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
    rng = DropoutRng(0)
    draws = rng.uniform(2)
    assert len(draws) == 2 and all(0 <= x < 1 for x in draws)


def test_bench_train_runs_on_cpu():
    """bench_train end to end at a tiny size on the CPU: one JSON line
    with the metrics it promises, finite loss."""
    from avsr_tpu_torch.tools import bench_train

    args = bench_train.parse_args(
        ["--device", "cpu", "--batch", "2", "--frames", "8", "--labels", "4",
         "--steps", "2", "--fp32"])
    state, batch = bench_train.setup(args, port_cfg(tiny_cfg()))
    res = bench_train.measure(state, batch, args)
    for k in ("sec_per_step", "samples_per_sec", "step_tflops", "mfu",
              "loss", "grad_norm", "peak_mem_gb"):
        assert k in res
    assert np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"])
    assert res["device"] == "cpu" and res["mfu"] is None
    # the counter saw the CPU twins' attention products (no kernel ran):
    # at least the analytic flash FLOPs of the 2 layers, forward+backward
    fwd, bwd = bench_train.flash_flops(state.model.cfg, args)
    assert res["step_tflops"] * 1e12 > 2 * (fwd + bwd)
    assert set(res["launches_per_step"].values()) == {0.0}
