"""Rematerialisation of the port's encoder layers and video frontend
(``models/remat.py``) on the CPU.

Every ``scan_remat`` mode on the layer stack and ``frontend_remat`` on the
whole model against the port without remat, with every dropout of the
tiny config on (attention dropout through the flash wrappers' Philox
twin), so the recompute must replay the ``DropoutRng``'s masks and flash
seeds, and in train mode, so it must not update the BatchNorm running
statistics again; then the layer stack's remat gradients against the JAX
package's with dropout off.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.func import functional_call  # noqa: E402

from avsr_tpu_torch.core.checkpoint import (avhubert_encoder_entries,  # noqa: E402
                                            flax_to_torch)
from avsr_tpu_torch.core.weights import init_weights  # noqa: E402
from avsr_tpu_torch.data.synthetic import synthetic_train_batch  # noqa: E402
from avsr_tpu_torch.models import remat  # noqa: E402
from avsr_tpu_torch.models.avhubert import AVHubertTransformer  # noqa: E402
from avsr_tpu_torch.models.e2e import AVSRModel  # noqa: E402
from avsr_tpu_torch.ops.dropout import DropoutRng  # noqa: E402
from avsr_tpu_torch.train import trainer as PT  # noqa: E402
from tests.torch_port_common import setup_torch, tiny_port_cfg  # noqa: E402

MODES = ("dots", "full", "ffn", "ffn2", "qkv_ffn")
FRONT_BN = "encoder.feature_extractor_video.resnet.frontend3D.1.running_mean"


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


def _stack():
    """The tiny config's layer stack with seed-0 weights and every dropout
    on, including the FFN's activation dropout (0 in the tiny config); x
    (2, 12, 32) with the second row's last 3 frames padded."""
    cfg = tiny_port_cfg().encoder
    cfg.activation_dropout = 0.1
    stack = AVHubertTransformer(cfg)
    init_weights(stack, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 12, 32)
                         .astype(np.float32))
    return stack, x, torch.arange(12)[None, :] < torch.tensor([[12], [9]])


def _stack_step(mode, dtype, seed=3):
    """(loss, gradients, generator states) of sum(stack(x)^2) under
    ``mode``, the parameters and x cast to ``dtype`` through
    ``functional_call`` as the trainer's bf16 step does, drawing from
    DropoutRng(seed)."""
    stack, x, mask = _stack()
    stack.cfg.scan_remat = mode
    dt = getattr(torch, dtype)
    params = {n: p.to(dt) for n, p in stack.named_parameters()}
    rng = DropoutRng(seed)
    out = functional_call(stack, params, (x.to(dt), mask, rng))
    loss = out.float().pow(2).sum()
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in stack.named_parameters()},
            rng.state())


@pytest.fixture(scope="module")
def stack_baseline():
    return {dt: _stack_step("none", dt) for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("mode,dtype", [
    *[(m, "float32") for m in MODES],
    ("full", "bfloat16"),
    ("qkv_ffn", "bfloat16"),
])
def test_layer_remat_equals_no_remat_with_dropout(stack_baseline, mode,
                                                  dtype):
    """Each ``scan_remat`` mode on the layer stack: the loss, every
    gradient and the generators' states after the step bit-equal to the
    step without remat, in fp32 and with bf16 compute (the recompute
    must see the same cast parameters). The recompute repeats the same
    CPU kernels on the same inputs with the same masks and seeds, so
    nothing may differ."""
    loss, grads, rng = _stack_step(mode, dtype)
    loss0, grads0, rng0 = stack_baseline[dtype]
    assert torch.equal(loss, loss0)
    for n, g in grads0.items():
        assert torch.equal(grads[n], g), n
    for k, v in rng0.items():
        assert torch.equal(rng[k], v), k


def test_the_dropouts_are_on(stack_baseline):
    """Another seed moves the loss: the equalities above hold with masks
    and flash seeds drawn."""
    other, _, _ = _stack_step("none", "float32", seed=4)
    assert not torch.equal(other, stack_baseline["float32"][0])


def test_frontend_remat_equals_no_remat(monkeypatch):
    """The whole tiny model in train mode with ``frontend_remat`` (and
    ``full`` layer remat) against no remat, every dropout on: the loss,
    every gradient and every BN running statistic bit-equal, so the
    ResNet's recompute neither draws nor updates the running averages a
    second time."""
    cfg = tiny_port_cfg()
    model = AVSRModel(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    batch = PT.to_device(synthetic_train_batch(
        np.random.RandomState(0), 2, 8, 5, video_lengths=[8, 6],
        label_lengths=[5, 3], vocab=59), "cpu")
    runs = []
    for mode, front in (("none", False), ("full", True)):
        m = copy.deepcopy(model)
        m.cfg.encoder.scan_remat, m.cfg.encoder.frontend_remat = mode, front
        loss, _ = PT.loss_fn(m, batch, DropoutRng(3), True)
        loss.backward()
        runs.append((loss.detach(),
                     {n: p.grad for n, p in m.named_parameters()},
                     dict(m.named_buffers())))
    (loss0, grads0, bufs0), (loss, grads, bufs) = runs
    assert torch.equal(loss, loss0)
    for n, g in grads0.items():
        assert (g is None and grads[n] is None) or torch.equal(grads[n], g), n
    for n, b in bufs0.items():
        assert torch.equal(bufs[n], b), n
    assert not torch.equal(bufs0[FRONT_BN], model.state_dict()[FRONT_BN])


def test_remat_saves_only_the_named_tensors():
    """Under ``ffn`` the marker saves the FFN activation and nothing else
    is marked; outside a checkpoint ``mark`` returns its input."""
    x = torch.randn(3, 4)
    assert remat.mark(x, "enc_ffn_act") is x
    assert remat.SAVED["qkv_ffn"] == ("enc_q", "enc_k", "enc_v",
                                      "enc_ffn_pre", "enc_ffn_act")
    with pytest.raises(ValueError):
        remat.checkpoint(torch.nn.Identity(), (x,), mode="none")


# ---------------------------------------------------------------- vs JAX


def _jax_cfg(mode):
    from avsr_tpu.core.config import AVHubertEncoderConfig

    return AVHubertEncoderConfig(
        encoder_embed_dim=32, num_hidden_layers=3, num_attention_heads=2,
        intermediate_size=48, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, scan_remat=mode,
        use_flash_attention=True)


def _entries():
    """The layer stack's rows of the avsr encoder mapping, under a prefix
    ``m.encoder.`` (torch) / ("m", "encoder") (flax)."""
    return [e for e in avhubert_encoder_entries("m", ("m",), 3)
            if (e[0][0] if isinstance(e[0], list) else e[0]
                ).startswith("m.encoder.")]


@pytest.fixture(scope="module")
def jax_layers():
    """Parameters of the JAX package's layer stack (``tests/test_remat.py``'s,
    with its flash path) carried from seed-0 port weights (a jitted flax
    init costs seconds); x (2, 12, 32) with a padded tail."""
    from avsr_tpu.core.checkpoint import convert_state

    from avsr_tpu_torch.core.config import AVHubertEncoderConfig

    cfg = AVHubertEncoderConfig(**{
        k: getattr(_jax_cfg("none"), k)
        for k in AVHubertEncoderConfig.__dataclass_fields__})
    stack = AVHubertTransformer(cfg)
    init_weights(stack, torch.Generator().manual_seed(0))
    state = {"m.encoder." + k: v.numpy()
             for k, v in stack.state_dict().items()}
    params = convert_state(state, _entries())["params"]["m"]["encoder"]
    x = np.random.RandomState(0).randn(2, 12, 32).astype(np.float32)
    mask = np.arange(12)[None, :] < np.asarray([12, 9])[:, None]
    return params, x, mask


@pytest.fixture(scope="module")
def jax_remat_grads(jax_layers):
    """mode -> jax.grad of sum(stack(x)^2) under that remat mode, float64,
    the five in one jitted program (one compile)."""
    from avsr_tpu.models.avhubert import AVHubertTransformer as JaxStack

    params, x, mask = jax_layers
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           params)

        def grads(p):
            return {m: jax.grad(lambda q, jm=JaxStack(_jax_cfg(m)): jnp.sum(
                jm.apply({"params": q}, jnp.asarray(x, jnp.float64),
                         jnp.asarray(mask)) ** 2))(p) for m in MODES}

        return jax.device_get(jax.jit(grads)(p64))


@pytest.mark.parametrize("mode", MODES)
def test_layer_stack_remat_grads_match_jax(jax_layers, jax_remat_grads,
                                           mode):
    """jax.grad of sum(stack(x)^2) under each remat mode against the
    port's stack under the same mode, dropout off (the two packages draw
    different masks), both in float64: the weight-norm gain's gradient is
    a sum of ~1e4 terms that cancel to ~1e-2 of their size, so fp32 leaves
    it percent-level off on either side. Each gradient within 2e-6 of its
    largest entry (measured: at most 6e-7) plus 1e-10 (the key bias's
    gradient is exactly 0, softmax's shift invariance; measured 2e-11)."""
    params, x, mask = jax_layers
    want = jax_remat_grads[mode]
    strip = len("m.encoder.")

    def to_port(tree):
        out = flax_to_torch({"params": {"m": {"encoder": tree}}}, _entries())
        return {k[strip:]: torch.from_numpy(np.array(v, np.float64))
                for k, v in out.items()}

    from avsr_tpu_torch.core.config import AVHubertEncoderConfig

    cfg = AVHubertEncoderConfig(**{
        k: getattr(_jax_cfg(mode), k)
        for k in AVHubertEncoderConfig.__dataclass_fields__})
    stack = AVHubertTransformer(cfg).double()
    stack.load_state_dict(to_port(params), strict=True)
    xt = torch.from_numpy(x).double()
    # a DropoutRng with every rate 0 (the configs' dropouts are off here)
    for k in ("hidden_dropout", "attention_dropout", "activation_dropout"):
        setattr(cfg, k, 0.0)
    for layer in stack.layers:
        layer.hidden_dropout = 0.0
        layer.attention.dropout = 0.0
        layer.feed_forward.activation_dropout = 0.0
    stack.hidden_dropout = 0.0
    out = stack(xt, torch.from_numpy(mask), DropoutRng(0))
    out.pow(2).sum().backward()
    want_t = to_port(want)
    for name, p in stack.named_parameters():
        ref = want_t[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 2e-6 * float(np.abs(ref).max()) + 1e-10, (name, err)
