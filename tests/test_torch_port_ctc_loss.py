"""The port's CTC loss (``ops/kernels/ctc_loss.py``) on the CPU.

On the CPU the wrappers run the plain twin, which repeats the CUDA
kernel's algorithm (``csrc/ctc_loss.cu``): both recursions normalised at
every frame and run in float64, the posteriors formed from O(1) numbers.
The kernel is held against the twin on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase 3).

- The repair: at T=384, where the NLL is ~1,440 nats a sample, the fp32
  gradient lies within 1e-5 relative L2 of float64 (optax.ctc_loss in
  float64); ``F.ctc_loss`` and the JAX package's fp32 ctc_loss, whose
  posteriors carry the NLL's fp32 ulp, lie ~3e-4 away.
- Parity with the JAX package's ``ctc_loss`` at tiny shapes: infeasible
  samples, shorter logit lengths, repeated labels, empty labels, labels
  padded with -1 or with ids past the vocabulary, another blank id.
- The twin's hand-written backward against ``gradcheck`` in float64.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from torch.nn import functional as F  # noqa: E402

from avsr_tpu_torch.ops import ctc as pctc  # noqa: E402
from avsr_tpu_torch.ops.kernels import ctc_loss as pcl  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    close_to_largest,
    setup_torch,
    t,
)


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port(logits, llen, labels, lablen, blank=0):
    """The port's batch-mean loss and its logits' gradient."""
    x = t(logits).requires_grad_()
    loss = pctc.ctc_loss(x, t(llen), t(labels), t(lablen), blank_id=blank)
    (g,) = torch.autograd.grad(loss, x)
    return loss.item(), g.numpy()


def _jax(logits, llen, labels, lablen, blank=0):
    """The JAX package's batch-mean loss and gradient (fp32)."""
    from avsr_tpu.ops.ctc import ctc_loss

    def f(x):
        return ctc_loss(x, jnp.asarray(llen), jnp.asarray(labels),
                        jnp.asarray(lablen), blank_id=blank)

    loss, g = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(loss), np.asarray(g)


# ---------------------------------------------------------------- the repair


def test_fp32_gradient_near_float64_at_the_training_length():
    """B=4, T=384, V=64, L=48, logits of std 1, every frame valid: the
    port's fp32 gradient within 1e-5 relative L2 of float64, its loss
    within 1e-6 of the JAX package's fp32 loss. The float64 reference is
    optax.ctc_loss on float64 logits under x64, as the JAX package calls
    it (its wrapper casts the logits to fp32, so under x64 it is not a
    float64 evaluation). F.ctc_loss in fp32 misses 1e-5 (3.2e-4), and so
    does the JAX package's ctc_loss in fp32 without x64 (2.9e-4): both
    form the posteriors from log-domain numbers of the NLL's size."""
    rng = np.random.RandomState(0)
    b, tt, v, l = 4, 384, 64, 48
    logits = rng.randn(b, tt, v).astype(np.float32)
    labels = rng.randint(1, v, size=(b, l))
    llen, lablen = np.full(b, tt), np.full(b, l)

    with jax.enable_x64(True):
        pads = jnp.zeros((b, tt), jnp.float64)
        lpads = jnp.zeros((b, l), jnp.float64)
        want_loss, want = jax.value_and_grad(
            lambda x: optax.ctc_loss(x, pads, jnp.asarray(labels),
                                     lpads).sum() / b)(
            jnp.asarray(logits, jnp.float64))
        want_loss, want = float(want_loss), np.asarray(want)

    loss, grad = _port(logits, llen, labels, lablen)
    err = _rel_l2(grad, want)
    assert err <= 1e-5, f"port fp32 gradient {err:.2e} off float64"
    jax_loss, jax_grad = _jax(logits, llen, labels, lablen)
    assert abs(loss - jax_loss) <= 1e-6 * abs(jax_loss)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)

    # what the repair repairs: both libraries' fp32 gradients miss
    x = t(logits).requires_grad_()
    lib = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), t(labels),
                     t(llen), t(lablen), reduction="sum") / b
    (lib_grad,) = torch.autograd.grad(lib, x)
    assert _rel_l2(lib_grad.numpy(), want) > 1e-5
    assert _rel_l2(jax_grad, want) > 1e-5


# ---------------------------------------------------------------- parity


def _case(name):
    """(logits, logit_lengths, labels, label_lengths, blank) at tiny
    shapes, from a numpy seed."""
    rng = np.random.RandomState(sum(map(ord, name)))
    logits = (rng.randn(4, 12, 7) * 2).astype(np.float32)
    if name == "infeasible":
        # sample 2: T=4 < L + repeats = 3 + 2; labels padded with -1
        return (logits, np.asarray([12, 7, 4, 12]),
                np.asarray([[1, 2, 2, 3], [4, 5, -1, -1], [6, 6, 6, -1],
                            [3, 1, 4, 1]]),
                np.asarray([4, 2, 3, 4]), 0)
    if name == "short_repeats":
        # shorter frames, repeated labels: sample 1 infeasible (T=3 <
        # 3 + 1), samples 0 and 2 just feasible
        return (logits, np.asarray([9, 3, 6, 12]),
                np.asarray([[2, 2, 2, 1], [3, 3, 5, 5], [3, 3, 5, 5],
                            [1, 1, 1, 1]]),
                np.asarray([4, 3, 4, 4]), 0)
    if name == "empty_labels":
        return (logits, np.asarray([12, 1, 6, 12]),
                np.asarray([[-1, -1, -1], [-1, -1, -1], [2, 5, -1],
                            [4, -1, -1]]),
                np.asarray([0, 0, 2, 1]), 0)
    if name == "pad_past_vocab":
        # padding past the vocabulary, and a sample of no frames
        return (logits, np.asarray([12, 10, 0, 12]),
                np.asarray([[1, 2, 99, 7], [3, 5, 1000, 9], [5, 7, 7, 7],
                            [6, 5, 4, 3]]),
                np.asarray([2, 2, 0, 4]), 0)
    assert name == "blank_id"
    return (logits, np.asarray([12, 8, 11, 3]),
            np.asarray([[0, 1, 2, 0], [5, 5, 0, -1], [4, 0, 4, -1],
                        [2, -1, -1, -1]]),
            np.asarray([4, 3, 3, 1]), 6)


@pytest.mark.parametrize("name", ["infeasible", "short_repeats",
                                  "empty_labels", "pad_past_vocab",
                                  "blank_id"])
def test_ctc_loss_matches_jax_at_the_edges(name):
    """The batch loss within 1e-5 relative and the gradient within 1e-5 of
    its largest entry of the JAX package's; a sample the JAX package zeroes
    (infeasible) has exactly zero loss and gradient in the port."""
    logits, llen, labels, lablen, blank = _case(name)
    want_loss, want = _jax(logits, llen, labels, lablen, blank)
    loss, grad = _port(logits, llen, labels, lablen, blank)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert np.isfinite(grad).all()
    close_to_largest(grad, want, 1e-5, f"dlogits ({name})")
    per_seq = pcl.ctc_loss(t(logits), t(llen), t(labels), t(lablen),
                           blank).numpy()
    valid = np.arange(labels.shape[1] - 1)[None, :] < (lablen - 1)[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid).sum(1)
    feasible = llen >= lablen + repeats
    assert not want[~feasible].any()
    assert not per_seq[~feasible].any() and not grad[~feasible].any()
    assert (per_seq[feasible & (llen > 0)] > 0).all()
    # frames past a sample's length take no gradient
    frames = np.arange(logits.shape[1])[None, :] >= llen[:, None]
    assert not grad[frames].any()


def test_twin_and_wrapper_agree_and_are_deterministic():
    """On the CPU the wrapper runs the twin: the same per-sample NLL and
    gradient, bit for bit, and two calls bit-equal."""
    logits, llen, labels, lablen, blank = _case("short_repeats")
    outs = []
    for fn in (pcl.ctc_loss, pcl.ctc_loss_plain, pcl.ctc_loss):
        x = t(logits).requires_grad_()
        nll = fn(x, t(llen), t(labels), t(lablen), blank)
        w = torch.arange(1.0, len(llen) + 1)
        (g,) = torch.autograd.grad((nll * w).sum(), x)
        outs.append((nll.detach(), g))
    for nll, g in outs[1:]:
        assert torch.equal(nll, outs[0][0]) and torch.equal(g, outs[0][1])


# ---------------------------------------------------------------- gradcheck


@pytest.mark.parametrize("name", ["infeasible", "short_repeats",
                                  "blank_id"])
def test_twin_backward_passes_gradcheck(name):
    """The twin's hand-written backward against finite differences of its
    forward, float64, every sample's NLL an output."""
    logits, llen, labels, lablen, blank = _case(name)
    x = torch.tensor(logits[:, :8], dtype=torch.float64, requires_grad=True)
    llen = np.minimum(llen, 8)

    def f(x):
        return pcl.ctc_loss_plain(x, t(llen), t(labels), t(lablen), blank)

    assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8,
                                    rtol=1e-6)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(2, 5, 7)
    lens = torch.tensor([5, 5])
    with pytest.raises(TypeError):
        pcl.ctc_loss(x.double(), lens, torch.zeros(2, 2, dtype=torch.long),
                     lens)
    with pytest.raises(ValueError):
        pcl.ctc_loss(x, lens, torch.zeros(3, 2, dtype=torch.long), lens)
    with pytest.raises(ValueError):
        pcl.ctc_loss(x[:, :0], lens, torch.zeros(2, 2, dtype=torch.long),
                     lens)
