"""The port's pretraining objective (``train/pretrain.py``,
``ops/span_mask.py``) against the JAX package's, on the CPU.

Masks, gather maps, collated batches and the proxy targets are host numpy
on both sides and must be equal from the same ``RandomState``. The
model's loss, metrics and gradients are compared in float64 with the
JAX weights carried over by ``core/checkpoint.pretrain_mapping`` (the
video frontend's fp32 gradient is ill-conditioned at these shapes,
ROADMAP C16).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.ops import span_mask as jspan  # noqa: E402
from avsr_tpu.train import pretrain as JP  # noqa: E402
from avsr_tpu_torch.core.checkpoint import flax_to_torch, pretrain_mapping  # noqa: E402
from avsr_tpu_torch.ops import span_mask as pspan  # noqa: E402
from avsr_tpu_torch.ops.dropout import DropoutRng  # noqa: E402
from avsr_tpu_torch.train import pretrain as PP  # noqa: E402
from avsr_tpu_torch.train import trainer as PT  # noqa: E402
from tests.torch_port_common import port_cfg, setup_torch, tiny_cfg  # noqa: E402

PCFG = dict(num_classes=11, final_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


@pytest.mark.parametrize("mask_type,padded", [("static", False),
                                              ("static", True),
                                              ("uniform", True)])
def test_compute_mask_indices_matches_jax(mask_type, padded):
    """The same mask from the same RandomState, which both leave in the
    same state."""
    pad = None
    if padded:
        pad = np.arange(40)[None, :] >= np.asarray([40, 27, 33])[:, None]
    out = []
    for mod in (jspan, pspan):
        rng = np.random.RandomState(5)
        m = mod.compute_mask_indices((3, 40), pad, 0.5, 4,
                                     mask_type=mask_type, mask_other=1,
                                     min_masks=2, rng=rng)
        out.append((m, rng.rand()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] and out[0][0].any()
    feats = np.random.RandomState(1).randn(3, 40, 2)
    np.testing.assert_array_equal(
        pspan.apply_span_mask(feats, out[1][0], np.ones(2)),
        jspan.apply_span_mask(feats, out[0][0], np.ones(2)))


def test_sample_pretrain_masks_matches_jax():
    for lengths in (None, np.asarray([30, 17])):
        got = PP.sample_pretrain_masks(PP.PretrainConfig(), 2, 30, lengths,
                                       np.random.RandomState(2))
        want = JP.sample_pretrain_masks(JP.PretrainConfig(), 2, 30, lengths,
                                        np.random.RandomState(2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert PP.PretrainConfig().__dict__ == JP.PretrainConfig().__dict__


@pytest.mark.parametrize("group_index,clusters", [(None, False), (3, False),
                                                  (1, True)])
def test_pretrain_collator_matches_jax(group_index, clusters):
    """The same pretraining batch (the base collation, the masks, the
    gather map, the proxy quantizer's or the dataset's targets)."""
    from avsr_tpu.data import collate as jcollate
    from avsr_tpu.data import transforms as jtr
    from avsr_tpu_torch.data import collate as pcollate
    from avsr_tpu_torch.data import dataset as pds
    from avsr_tpu_torch.data import transforms as ptr

    samples = list(pds.synthetic_samples(3, seed=4, min_frames=6,
                                         max_frames=12))
    if clusters:
        for i, s in enumerate(samples):
            s["cluster_targets"] = np.arange(s["length"]) % 7 + i
    batches = []
    for col, tr, pre in ((jcollate, jtr, JP), (pcollate, ptr, PP)):
        base = col.DataCollator(text_transform=None,
                                video_transform=tr.VideoTransform("train"),
                                audio_transform=tr.AudioTransform("train"),
                                seed=0)
        coll = pre.PretrainCollator(base, pre.PretrainConfig(**PCFG), seed=5)
        batches.append(coll(samples, group_index=group_index))
    want, got = batches
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_grad_multiply():
    x = torch.ones(3, requires_grad=True)
    y = PP.grad_multiply(x, 0.1)
    assert torch.equal(y, x.detach())
    y.pow(2).sum().backward()
    torch.testing.assert_close(x.grad, torch.full((3,), 0.2))


# ---------------------------------------------------------------- the model


def _encoder_cfg():
    cfg = tiny_cfg()
    e = cfg.encoder
    e.hidden_dropout = e.attention_dropout = e.activation_dropout = 0.0
    e.dropout_input = e.modality_dropout = 0.0
    return cfg


def _inputs(b=2, t=6):
    rng = np.random.RandomState(1)
    lengths = np.asarray([t, t - 2])
    a_mask, _, src = JP.sample_pretrain_masks(
        JP.PretrainConfig(**PCFG), b, t, lengths, np.random.RandomState(2))
    return dict(
        audio=rng.randn(b, t, 104), video=rng.randn(b, t, 88, 88, 1),
        audio_mask=a_mask, video_src_index=src.astype(np.int64),
        targets=rng.randint(0, PCFG["num_classes"], (b, t)),
        padding_mask=np.arange(t)[None, :] < lengths[:, None])


def test_pretrain_model_matches_jax():
    """AVHubertPretrainModel's loss, its five metrics and every gradient
    against ``jax.value_and_grad`` of the JAX model in train mode (batch
    statistics, dropouts 0) through ``pretrain_mapping``, float64 on both
    sides: the loss and metrics within 1e-6 relative; each gradient
    within 1e-5 of its largest entry (measured: at most 2.3e-6) plus 1e-7
    of the largest gradient entry of the model (the key bias's gradient
    is exactly 0, softmax's shift invariance); the BN
    running statistics within 1e-5."""
    from avsr_tpu.core.checkpoint import convert_state

    cfg = _encoder_cfg()
    jm = JP.AVHubertPretrainModel(cfg.encoder, JP.PretrainConfig(**PCFG))
    x = _inputs()
    args = [x["audio"], x["video"], x["audio_mask"],
            x["video_src_index"].astype(np.int32),
            x["targets"].astype(np.int32), x["padding_mask"]]
    # seed-0 port weights carried to JAX (a jitted flax init costs ~10 s)
    mapping = pretrain_mapping(port_cfg(cfg).encoder)
    seeded = PP.init_pretrain_weights(
        PP.AVHubertPretrainModel(port_cfg(cfg).encoder,
                                 PP.PretrainConfig(**PCFG)),
        torch.Generator().manual_seed(0))
    variables = convert_state({k: v.numpy() for k, v in
                               seeded.state_dict().items()}, mapping)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           jax.device_get(variables))

        def loss(p):
            (out, metrics), new = jm.apply(
                {"params": p, "batch_stats": v64["batch_stats"]},
                *(jnp.asarray(a) for a in args), train=True,
                mutable=["batch_stats"])
            return out, (metrics, new["batch_stats"])

        (_, (metrics, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v64["params"])
        metrics, stats, grads = jax.device_get((metrics, stats, grads))
    state = flax_to_torch(variables, mapping)
    model = PP.AVHubertPretrainModel(port_cfg(cfg).encoder,
                                     PP.PretrainConfig(**PCFG))
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in state.items()}, strict=True)
    model.double()
    loss, got = model(*(torch.from_numpy(np.asarray(x[k])) for k in (
        "audio", "video", "audio_mask", "video_src_index", "targets",
        "padding_mask")), train=True, rng=DropoutRng(0))
    loss.backward()
    assert set(got) == set(metrics) == set(PP.METRICS)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]),
                                   rtol=1e-6, err_msg=k)
    want = flax_to_torch({"params": grads, "batch_stats": stats}, mapping)
    buffers = dict(model.named_buffers())
    top = max(float(np.abs(want[n]).max()) for n, _ in
              model.named_parameters())
    for name, p in model.named_parameters():
        ref = np.asarray(want[name])
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()) + 1e-7 * top, (
            name, err)
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert abs(float(np.abs(want["mask_emb"]).sum())) > 0


def test_decay_mask_of_the_pretrain_model():
    """The JAX rule over the pretraining model's names: the head's
    mask_emb, label_embs and final_proj kernel decay, biases do not."""
    mask = PT.decay_mask(None, pretrain_mapping(port_cfg(tiny_cfg()).encoder))
    assert mask["mask_emb"] and mask["label_embs"]
    assert mask["final_proj.weight"] and not mask["final_proj.bias"]
    assert not mask["hubert.encoder.layer_norm.weight"]


def test_pretrain_loop_and_finetune_handoff(tmp_path, monkeypatch):
    """``run_training`` with the pretraining objective (the port's
    PretrainCollator over synthetic samples) for 3 steps: finite losses
    and the five metrics logged; then the step-3 checkpoint's ``hubert.*``
    weights (``encoder_state``) load strictly into ``AVSRModel``'s
    encoder, whose loss is then finite."""
    from avsr_tpu_torch.data import collate as pcollate
    from avsr_tpu_torch.data import dataset as pds
    from avsr_tpu_torch.data import transforms as ptr
    from avsr_tpu_torch.data.synthetic import synthetic_train_batch
    from avsr_tpu_torch.models.e2e import AVSRModel
    from avsr_tpu_torch.train import loop as ploop

    monkeypatch.setattr(ploop, "T_BUCKETS", (8, 16))
    logged = []
    monkeypatch.setattr(ploop.MetricsLogger, "log",
                        lambda self, step, m, prefix="train":
                        logged.append((step, m)))
    cfg = port_cfg(tiny_cfg())
    pcfg = PP.PretrainConfig(num_classes=24)
    base = pcollate.DataCollator(
        text_transform=None, video_transform=ptr.VideoTransform("train"),
        audio_transform=ptr.AudioTransform("train"), seed=0)
    state = ploop.run_training(
        cfg, ploop.LoopConfig(output_dir=str(tmp_path), max_steps=3,
                              batch_size=2, grad_accum=1, save_steps=3,
                              eval_steps=100, log_interval=1),
        pds.synthetic_samples(16, seed=0, min_frames=4, max_frames=8),
        PP.PretrainCollator(base, pcfg, seed=0),
        train_cfg=PT.TrainConfig(learning_rate=2e-3, warmup_steps=1,
                                 max_steps=3),
        pretrain_cfg=pcfg, device="cpu")
    assert state.step == 3 and [s for s, _ in logged] == [1, 2, 3]
    for _, m in logged:
        assert set(m) == set(PP.METRICS) | {"grad_norm"}
        assert all(np.isfinite(v) for v in m.values())
    mgr = PT.CheckpointManager(os.path.join(str(tmp_path), "checkpoints"))
    assert mgr.latest_step() == 3
    ck = torch.load(os.path.join(mgr.root, "3", mgr.FILE),
                    weights_only=True)
    enc = PP.encoder_state(ck["model"])
    avsr = AVSRModel(cfg)
    avsr.encoder.load_state_dict(
        {k[len("encoder."):]: v for k, v in enc.items()}, strict=True)
    for k, v in enc.items():
        assert torch.equal(avsr.state_dict()[k], v), k
    batch = PT.to_device(synthetic_train_batch(
        np.random.RandomState(0), 2, 8, 3, vocab=59), "cpu")
    loss, _ = PT.loss_fn(avsr, batch, None, train=False)
    assert torch.isfinite(loss)
