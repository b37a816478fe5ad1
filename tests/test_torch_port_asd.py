"""The port's active-speaker model and trainer
(``avsr_tpu_torch/frontends/asd.py``, ``asd_trainer.py``) against the JAX
package's, on the CPU, in fp32.

Weights are seeded on the JAX side (``torch_port_common.seeded_variables``:
numpy fills the shapes of a flax ``init``) and cross through
``asd_flax_to_torch``, loaded strictly. The batch: 2 tracks of 10 frames
of 48x48 (the network is fully convolutional) and 40 MFCC frames, the
second track zero past frame 7 (a padded T: the backward GRU runs over
the padding as in JAX). Tolerances:

- the weight round trip through ``asd_torch_to_flax``, the GRUs' folded
  biases included: bit-exact;
- scores and ``train_logits`` in eval mode: within 1e-4 of the largest;
  in train mode within 1e-4 of the largest, and the BN running statistics
  after the pass within 1e-6;
- ``ASDTrainer`` (2 unpadded tracks of 6 frames of 32x32): 3 epochs of
  one step (lr and r change each epoch) against the JAX trainer's, losses
  within 1e-5 relative, running statistics within 1e-5, parameters
  within 1e-5 but for at most 1e-4 of them (see the test);
  ``evaluate_network`` scores within 1e-4 of the largest and the same
  AP; ``save``/``load`` and ``load_torch`` bit-exact.

Train mode and the trainer are held against the JAX package run in
float64 (``jax.enable_x64``, flax's ``GRUCell`` given a float64 carry;
the port stays in fp32), and the trainer eagerly (``jax.disable_jit``).
In fp32 on the CPU, XLA's batch statistics over the 11,520 positions a
channel of the first visual block are off by up to 6e-4 relative (its
running variance by 7.2e-6 after one update, the port's by 1.2e-7,
against a float64 evaluation of the same update). And the JAX trainer's
jitted step takes gradients that finite differences refute, in float64
too (a BN scale's 0.00764 where the eager gradient, the port's and the
central difference give 0.00117): ROADMAP C39.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.frontends import asd as JA  # noqa: E402
from avsr_tpu.frontends import asd_trainer as JAT  # noqa: E402
from avsr_tpu_torch.frontends import asd as PA  # noqa: E402
from avsr_tpu_torch.frontends import asd_trainer as PAT  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    assert_same_tree,
    close_to_largest,
    seeded_variables,
    setup_torch,
)

B, T, HW, VALID = 2, 10, 48, 7


@pytest.fixture(scope="module", autouse=True)
def _torch():
    setup_torch()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, size=(B, T)).astype(np.int32)
    visual = rng.rand(B, T, HW, HW).astype(np.float32) * 40 + 80
    visual += 80.0 * labels[..., None, None]
    audio = rng.randn(B, 4 * T, 13).astype(np.float32) * 0.1
    audio += 2.0 * np.repeat(labels, 4, axis=1)[..., None]
    visual[1, VALID:] = 0.0
    audio[1, 4 * VALID:] = 0.0
    labels[1, VALID:] = 0
    return audio, visual, labels


@pytest.fixture(scope="module")
def variables(batch):
    audio, visual, _ = batch
    return seeded_variables(JA.ASDModel(), 11, jnp.asarray(audio[:1]),
                            jnp.asarray(visual[:1]), method="train_logits")


def _port_model(variables):
    model = PA.ASDModel()
    model.load_state_dict(PA.asd_flax_to_torch(variables), strict=True)
    return model


def f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


@contextlib.contextmanager
def jax_float64(eager: bool = False):
    """JAX in float64, the JAX ASD model's GRU cells with a float64 carry
    (flax makes it in the cells' ``param_dtype``, float32 by default);
    ``eager``: jit off."""
    from flax import linen

    cell = functools.partial(linen.GRUCell, param_dtype=jnp.float64)
    with jax.enable_x64(True), jax.disable_jit(eager), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA.nn, "GRUCell", cell)
        yield


def _numpy_state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def test_asd_weights_round_trip(variables):
    state = PA.asd_flax_to_torch(variables)
    gru = state["model.GRU.gru_forward.bias_hh_l0"]
    assert not gru[:256].any() and gru[256:].any()
    assert_same_tree(JA.asd_torch_to_flax(
        {k: v.numpy() for k, v in state.items()}), variables)


def test_asd_model_matches_jax(variables, batch):
    audio, visual, _ = batch
    jm = JA.ASDModel()
    model = _port_model(variables)
    a, v = torch.from_numpy(audio), torch.from_numpy(visual)
    with torch.no_grad():
        got = model(a, v)
        got_eval = model.train_logits(a, v, train=False)
    want = jm.apply(variables, jnp.asarray(audio), jnp.asarray(visual))
    close_to_largest(got.numpy(), want, 1e-4, "scores")
    want_eval = jm.apply(variables, jnp.asarray(audio), jnp.asarray(visual),
                         False, method="train_logits")
    for g, w, what in zip(got_eval, want_eval, ("lossAV", "lossV")):
        close_to_largest(g.numpy(), w, 1e-4, f"eval {what}")

    # train mode: batch statistics, and the running averages they update
    with jax_float64():
        (la, lv), upd = jm.apply(f64(variables), f64(audio), f64(visual),
                                 method="train_logits",
                                 mutable=["batch_stats"])
        la, lv, upd = np.asarray(la), np.asarray(lv), f64(upd)
    with torch.no_grad():
        got_train = model.train_logits(a, v, train=True)
    for g, w, what in zip(got_train, (la, lv), ("lossAV", "lossV")):
        close_to_largest(g.numpy(), w, 1e-4, f"train {what}")
    stats = JA.asd_torch_to_flax(_numpy_state(model))["batch_stats"]
    flat_g = jax.tree_util.tree_leaves_with_path(stats)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(upd["batch_stats"]))
    assert len(flat_g) == len(flat_w) == 2 * 5 * 3 * 2
    for path, g in flat_g:
        np.testing.assert_allclose(g, np.asarray(flat_w[path]), rtol=1e-6,
                                   atol=1e-6, err_msg=str(path))


@pytest.fixture(scope="module")
def train_batch():
    """The trainer's batch: 2 unpadded tracks of 4 frames of 32x32 (at 4
    frames the JAX package's jitted gradient is right; ROADMAP C39)."""
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 2, size=(2, 4)).astype(np.int32)
    visual = rng.rand(2, 4, 32, 32).astype(np.float32) * 40 + 80
    visual += 80.0 * labels[..., None, None]
    audio = rng.randn(2, 16, 13).astype(np.float32) * 0.1
    audio += 2.0 * np.repeat(labels, 4, axis=1)[..., None]
    return audio, visual, labels


def _flat(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _flat(x, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(x)


@pytest.fixture(scope="module")
def trained(variables, train_batch):
    """The JAX trainer (float64) and the port's (fp32) after 3 epochs of
    one step each from the same weights: (JAX trainer, port trainer, each
    epoch's ((loss, lr) JAX, (loss, lr) port), after the first epoch (JAX
    parameters, JAX Adam second moments, port parameters), the JAX
    trainer's scores of the batch)."""
    ptr = PAT.ASDTrainer(lr=1e-3, seed=0, device="cpu")
    ptr.load_state_dict(PA.asd_flax_to_torch(variables))
    jtr = JAT.ASDTrainer(lr=1e-3, seed=0)
    runs = []
    with jax_float64():
        jtr.params = f64(variables["params"])
        jtr.batch_stats = f64(variables["batch_stats"])
        jtr.opt_state = jtr.tx.init(jtr.params)
        for epoch in (1, 2, 3):
            runs.append((
                jtr.train_network([f64(train_batch)], epoch, verbose=False),
                ptr.train_network([train_batch], epoch, verbose=False)))
            if epoch == 1:
                first = (f64(jtr.params), f64(jtr.opt_state.inner_state[0].nu),
                         JA.asd_torch_to_flax(_numpy_state(ptr.model)))
        scores = jtr.evaluate_network([f64(train_batch)])
    return jtr, ptr, runs, first, scores


def test_asd_trainer_matches_jax(trained):
    """The port's trainer (loss, Adam, lr and r schedules, BN statistics,
    the GRUs' hidden r/z biases held) against the JAX trainer's: each
    epoch's loss within 1e-5 relative, the running statistics after the
    third within 1e-5. Parameters: Adam's first step is lr * g / (|g| +
    1e-8), so after it every element whose gradient is above 1e-6 (the
    JAX trainer's second moment says so) is within 1e-5; the others,
    where the fp32 port's rounding of g moves the step, within one step,
    lr (and at least 95% of the elements are held to 1e-5). The next
    steps spread those elements' differences; after the third every
    element is within 3 lr."""
    jtr, ptr, runs, (jp1, nu1, pp1), _ = trained
    for (jloss, jlr), (ploss, plr) in runs:
        assert plr == pytest.approx(jlr, rel=1e-12)
        assert ploss == pytest.approx(jloss, rel=1e-5)
    assert runs[-1][1][0] < runs[0][1][0]
    nu1 = dict(_flat(nu1))
    small_n = total = 0
    for path, w in _flat(jp1):
        g = dict(_flat(pp1["params"]))[path]
        err = np.abs(g - w)
        small = np.sqrt(nu1[path] / (1 - 0.999)) < 1e-6
        assert (err[~small] <= 1e-5 + 1e-5 * np.abs(w[~small])).all(), path
        assert (err[small] <= 1e-3).all(), path
        small_n, total = small_n + small.sum(), total + err.size
    assert small_n <= 0.05 * total, (small_n, total)
    got = JA.asd_torch_to_flax(_numpy_state(ptr.model))
    for coll, tol in (("params", 3e-3), ("batch_stats", 1e-5)):
        want = dict(_flat(getattr(jtr, coll)))
        for path, g in _flat(got[coll]):
            np.testing.assert_allclose(g, want[path], rtol=tol, atol=tol,
                                       err_msg=f"{coll} {path}")
    # the hidden side's r and z biases stayed at their folded zeros
    for gru in (ptr.model.model.GRU.gru_forward,
                ptr.model.model.GRU.gru_backward):
        assert not gru.bias_hh_l0[:256].any()


def test_asd_gradient_matches_jax_differences(variables):
    """The port's fp32 gradient of the trainer's loss on 2 tracks of 6
    frames (where the JAX package's jitted gradient is wrong, C39; no
    padded frames, whose constant maps tie in the max-pools, where a
    difference straddles the kink) against central differences of the
    JAX package's float64 loss, at each leaf's largest-gradient element:
    within 1e-4 relative."""
    rng = np.random.RandomState(2)
    labels = rng.randint(0, 2, size=(2, 6)).astype(np.int32)
    visual = (rng.rand(2, 6, 32, 32) * 40 + 80 + 80.0 * labels[..., None, None]
              ).astype(np.float32)
    audio = (rng.randn(2, 24, 13) * 0.1
             + 2.0 * np.repeat(labels, 4, axis=1)[..., None]).astype(np.float32)
    r = 1.3
    model = _port_model(variables)
    la, lv = model.train_logits(torch.from_numpy(audio),
                                torch.from_numpy(visual), train=True)
    y = torch.from_numpy(labels.reshape(-1).astype(np.float32))
    loss = (PAT._bce(torch.softmax(la.reshape(-1, 2) / r, -1)[:, 1], y)
            + 0.5 * PAT._bce(torch.softmax(lv.reshape(-1, 2) / r, -1)[:, 1],
                             y))
    loss.backward()
    grads = JA.asd_torch_to_flax(
        {k: (p.grad if p.grad is not None else p).detach().numpy()
         for k, p in dict(model.named_parameters(),
                          **dict(model.named_buffers())).items()})["params"]
    with jax_float64():
        yj = jnp.asarray(labels.reshape(-1), jnp.float64)

        @jax.jit
        def jloss(params):
            (a, v), _ = JA.ASDModel().apply(
                {"params": params, "batch_stats": f64(variables["batch_stats"])},
                f64(audio), f64(visual), method="train_logits",
                mutable=["batch_stats"])
            return (JAT._bce(jax.nn.softmax(a.reshape(-1, 2) / r, -1)[:, 1], yj)
                    + 0.5 * JAT._bce(
                        jax.nn.softmax(v.reshape(-1, 2) / r, -1)[:, 1], yj))

        base = f64(variables["params"])
        checked = 0
        for path, g in list(_flat(grads))[::2]:
            if path[0] == "GRU" and path[-1] == "bias" and path[2] != "hn":
                continue  # the converter folded both sides' gradients in
            i = np.unravel_index(np.abs(g).argmax(), g.shape)
            diff = []
            for h in (1e-6, -1e-6):
                p = jax.tree_util.tree_map(np.copy, base)
                leaf = p
                for k in path[:-1]:
                    leaf = leaf[k]
                leaf[path[-1]][i] += h
                diff.append(float(jloss(p)))
            fd = (diff[0] - diff[1]) / 2e-6
            assert abs(g[i] - fd) <= 1e-4 * abs(g[i]), (path, g[i], fd)
            checked += 1
    assert checked > 50


def test_asd_evaluate_network_matches_jax(trained, train_batch, tmp_path):
    """Scores and AP of the float64 trainers, and the AVA CSV."""
    pandas = pytest.importorskip("pandas")
    _, ptr, _, _, want = trained
    batch = train_batch
    want_ap = JAT.average_precision(want, batch[2])
    labels = batch[2].reshape(-1)
    truth = pandas.DataFrame({
        "video_id": ["v"] * len(labels),
        "frame_timestamp": np.arange(len(labels)) / 25.0,
        "label": ["SPEAKING_AUDIBLE" if x else "NOT_SPEAKING" for x in labels],
        "label_id": labels,
        "instance_id": [f"i{i}" for i in range(len(labels))],
    })
    orig = tmp_path / "orig.csv"
    truth.to_csv(orig, index=False)
    got, got_ap = ptr.evaluate_network(
        [batch], eval_csv_save=str(tmp_path / "pred.csv"),
        eval_orig=str(orig))
    assert got.shape == (labels.size,) and got.dtype == np.float32
    close_to_largest(got, want, 1e-4, "scores")
    assert got_ap == pytest.approx(want_ap, abs=1e-12)
    saved = pandas.read_csv(tmp_path / "pred.csv")
    assert "label_id" not in saved and "instance_id" not in saved
    np.testing.assert_allclose(saved["score"].to_numpy(), got, rtol=1e-6)
    assert PAT.average_precision(np.array([0.9, 0.8, 0.2, 0.1]),
                                 np.array([1, 1, 0, 0])) == 1.0
    assert PAT.average_precision(np.zeros(4), np.zeros(4)) == 0.0


def test_asd_trainer_save_load_and_load_torch(trained, batch, tmp_path):
    ptr = trained[1]
    scores = ptr.evaluate_network([batch])
    path = tmp_path / "asd.pt"
    ptr.save(str(path))
    other = PAT.ASDTrainer(seed=123, device="cpu")
    assert not np.array_equal(other.evaluate_network([batch]), scores)
    other.load(str(path))
    np.testing.assert_array_equal(other.evaluate_network([batch]), scores)
    # a reference-format state dict: numpy arrays, num_batches_tracked
    state = _numpy_state(ptr.model)
    state.update({k.replace("running_mean", "num_batches_tracked"):
                  np.array(3) for k in state if k.endswith("running_mean")})
    third = PAT.ASDTrainer(seed=7, device="cpu")
    third.load_torch(state)
    np.testing.assert_array_equal(third.evaluate_network([batch]), scores)
