"""What the port's training CLI stands on, against the JAX package on the
CPU: ``data/dataset.py`` (synthetic samples, the interferer pool, per-rank
shards), ``train/loop.batches_from_samples`` and the trainer's
``CheckpointManager``."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from avsr_tpu.data import dataset as jds  # noqa: E402
from avsr_tpu.train import loop as jloop  # noqa: E402
from avsr_tpu_torch.data import dataset as pds  # noqa: E402
from avsr_tpu_torch.train import loop as ploop  # noqa: E402
from avsr_tpu_torch.train import trainer as PT  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    LOOP_BUCKETS,
    loop_collators,
    loop_samples,
    port_cfg,
    setup_torch,
    tiny_cfg,
)


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


@pytest.fixture
def small_buckets(monkeypatch):
    for mod in (jloop, ploop):
        monkeypatch.setattr(mod, "T_BUCKETS", LOOP_BUCKETS)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------- data


def test_synthetic_samples_and_interferer_pool_match_jax():
    """The same samples from the same seed; the pool's warm entries and
    draws equal JAX's (decode stubbed, refresher idle), and a draw never
    blocks on the refresher."""
    for seed in (0, 3):
        want = list(jds.synthetic_samples(5, seed=seed))
        got = list(pds.synthetic_samples(5, seed=seed))
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    data = [{"video": i} for i in range(40)]

    def decode(sample):
        return np.full(3, sample["video"], np.float32)

    pools = [mod.InterfererPool(data, size=8, decode_fn=decode, warm_start=6,
                                refresh_per_draw=0.0, seed=4)
             for mod in (jds, pds)]
    np.testing.assert_array_equal(np.stack(pools[0]._entries),
                                  np.stack(pools[1]._entries))
    draws = [[p(np.random.RandomState(9)) for _ in range(5)] for p in pools]
    np.testing.assert_array_equal(np.stack(draws[0]), np.stack(draws[1]))
    # with refreshes asked for, draws still return at once
    pool = pds.InterfererPool(data, size=8, decode_fn=decode, warm_start=2,
                              refresh_per_draw=1.0, seed=1)
    rng = np.random.RandomState(0)
    assert all(pool(rng).shape == (3,) for _ in range(50))


def test_shard_for_host_is_disjoint_and_complete():
    """Each rank's share of an iterable: every 2nd sample from its rank,
    together the whole stream once."""
    shards = [list(pds.shard_for_host(iter(range(11)), r, 2))
              for r in range(2)]
    assert shards == [list(range(0, 11, 2)), list(range(1, 11, 2))]
    assert list(pds.shard_for_host(range(5), 0, 1)) == list(range(5))


# ---------------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def tiny_state():
    def make():
        cfg = port_cfg(tiny_cfg())
        return PT.init_state(cfg, PT.TrainConfig(warmup_steps=1,
                                                 max_steps=10),
                             seed=5, device="cpu")
    return make


def test_checkpoint_manager(tmp_path, tiny_state):
    """Retention keeps the last max_to_keep steps; best.json holds the
    lowest eval loss and NaN never counts; a save queued in the background
    is complete after close(); restore gives the saved state back
    (parameters, buffers, Adam moments, schedule, step, generators)."""
    state = tiny_state()
    batch = PT.to_device(_tiny_batch(), "cpu")
    root = str(tmp_path / "ck")
    mgr = PT.CheckpointManager(root, max_to_keep=2)
    saved = {}
    for step in (1, 2, 3):
        if step != 2:
            PT.train_step(state, batch)
        mgr.save(step, state)
        saved[step] = {k: v.clone() for k, v in
                       state.model.state_dict().items()}
    adam = {n: state.optimizer.state[p]["exp_avg"].clone()
            for n, p in state.model.named_parameters()}
    rng = state.rng.state()
    mgr.close()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(root)) == ["2", "3"]
    assert mgr.note_eval(1, {"loss": 5.0})
    assert not mgr.note_eval(2, {"loss": float("nan")})
    assert not mgr.note_eval(3, {"loss": 6.0})
    assert mgr.note_eval(4, {"loss": 4.5})
    with open(os.path.join(root, "best.json")) as f:
        assert json.load(f) == {"step": 4, "loss": 4.5}
    fresh = mgr.restore(3, tiny_state())
    assert fresh.step == state.step == 2
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[3][k]), k
    for n, p in fresh.model.named_parameters():
        assert torch.equal(fresh.optimizer.state[p]["exp_avg"], adam[n]), n
    for k, v in fresh.rng.state().items():
        assert torch.equal(v, rng[k]), k
    # one more step from either is the same step
    m_a, m_b = PT.train_step(state, batch), PT.train_step(fresh, batch)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


def _tiny_batch():
    from avsr_tpu_torch.data.synthetic import synthetic_train_batch

    return synthetic_train_batch(np.random.RandomState(7), 2, 4, 3,
                                 video_lengths=[4, 3], label_lengths=[3, 2],
                                 vocab=59)




# ---------------------------------------------------------------- batches


@pytest.mark.parametrize("workers,processes", [(0, False), (2, False),
                                               (2, True)])
def test_batches_from_samples_match_jax(small_buckets, workers, processes):
    """The port's batches equal JAX's inline batches, (accum, B, ...)
    reshaped, with train-mode augmentation seeded by the group index:
    inline, with a thread pool, and with 2 spawn workers."""
    samples = loop_samples(12)
    jc, pc = loop_collators("train", seed=11)
    want = list(jloop.batches_from_samples(samples, jc, 3, grad_accum=2))
    got = list(ploop.batches_from_samples(samples, pc, 3, grad_accum=2,
                                          num_workers=workers,
                                          use_processes=processes))
    assert want[0]["videos"].shape[:3] == (2, 3, 6)
    _assert_batches_equal(got, want)
