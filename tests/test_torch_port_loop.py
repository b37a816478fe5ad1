"""The port's training loop (``train/loop.py``) against the JAX package, on
the CPU: ``run_training`` and its resume (``batches_from_samples``, the
datasets and the ``CheckpointManager``: ``tests/test_torch_port_data.py``;
the CLI: ``tests/test_torch_port_cli.py``).

Inputs come from numpy seeds; the model is the tiny config of
``tests/torch_port_common.py`` with JAX-initialised weights. Frame buckets
are cut to (6, 12) in both packages, and the clips to 4-6 frames, so a
step takes about a second on the CPU.
Tolerances are stated in each test.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from avsr_tpu.train import loop as jloop  # noqa: E402
from avsr_tpu_torch.core.checkpoint import avsr_mapping, flax_to_torch  # noqa: E402
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


# ---------------------------------------------------------------- loop


def _no_dropout(cfg):
    cfg.dropout_rate = 0.0
    cfg.transformer_attn_dropout_rate = 0.0
    e = cfg.encoder
    e.hidden_dropout = e.attention_dropout = e.activation_dropout = 0.0
    e.dropout_input = e.modality_dropout = 0.0
    return cfg


class _Recorder:
    """Collects every (prefix, step, metrics) a MetricsLogger logs."""

    def __init__(self, monkeypatch, *modules):
        self.logs = {m: [] for m in modules}
        for m in modules:
            real = m.MetricsLogger.log

            def log(this, step, metrics, prefix="train", _m=m, _real=real):
                self.logs[_m].append((prefix, step, {
                    k: float(v) for k, v in metrics.items()}))
                return _real(this, step, metrics, prefix)

            monkeypatch.setattr(m.MetricsLogger, "log", log)


def test_run_training_matches_jax(tmp_path, small_buckets, monkeypatch):
    """The port's run_training against JAX's: 3 steps over the same
    synthetic stream with every dropout at 0 and the audio-only modality
    (C16's fp32 conditioning of the frontend's gradient stays out, as in
    ``test_train_steps_match_jax``). JAX on the 8 virtual CPU devices at
    batch_size=1, the port on one process at batch_size=8: the same
    global batch. Each step's logged metrics within 1e-5 relative;
    parameters after the run at ``test_train_steps_match_jax``'s
    tolerance (every element within 2 x 1.01 x the lrs' sum, all but 0.2%
    within 1e-5), BN statistics within 1e-4 + 1e-4 relative (the fp32
    batch variance mean(x^2) - mean^2 cancels: both packages' summation
    orders differ by ~6e-5 relative here). Then the port resumes from
    its step-2 checkpoint on the stream's third batch and ends at the
    uninterrupted run's step-3 parameters bit for bit."""
    from avsr_tpu.train import trainer as JT

    from avsr_tpu.core.checkpoint import torch_to_flax

    cfg = _no_dropout(tiny_cfg())
    cfg.encoder.modality = "audio"
    # seed-0 port weights carried to JAX (a jitted flax init costs ~15 s)
    pvars = PT.init_state(port_cfg(cfg), PT.TrainConfig(), seed=0,
                          device="cpu").model.state_dict()
    variables = torch_to_flax({k: v.numpy() for k, v in pvars.items()}, cfg,
                              prefix="")
    samples = loop_samples(40)
    jc, pc = loop_collators("test")
    rec = _Recorder(monkeypatch, jloop, ploop)
    jcfg = JT.TrainConfig(learning_rate=1e-3, warmup_steps=2, max_steps=10)
    pcfg = PT.TrainConfig(learning_rate=1e-3, warmup_steps=2, max_steps=10)

    def loop_cfg(path, batch_size, save_steps=2):
        return jloop.LoopConfig(
            output_dir=str(path), max_steps=3, batch_size=batch_size,
            grad_accum=1, save_steps=save_steps, eval_steps=100,
            log_interval=1)

    jstate = jloop.run_training(cfg, loop_cfg(tmp_path / "jax", 1, 100),
                                iter(samples), jc, train_cfg=jcfg,
                                pretrained_variables=variables)
    pstate = ploop.run_training(port_cfg(cfg), ploop.LoopConfig(
        **vars(loop_cfg(tmp_path / "port", 8))), iter(samples), pc,
        train_cfg=pcfg, pretrained_variables=pvars, device="cpu")
    assert pstate.step == 3
    jlog, plog = rec.logs[jloop], rec.logs[ploop]
    assert [s for _, s, _ in plog] == [1, 2, 3] == [s for _, s, _ in jlog]
    for (_, step, pm), (_, _, jm) in zip(plog, jlog):
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} step {step}")
    jstate = jax.device_get(jstate)
    want = flax_to_torch({"params": jstate.params,
                          "batch_stats": jstate.batch_stats},
                         avsr_mapping(port_cfg(cfg), prefix=""))
    sd = pstate.model.state_dict()
    buffers = dict(pstate.model.named_buffers())
    lrs = [PT.lr_schedule(pcfg)(c) for c in range(3)]
    bound = 2 * 1.01 * sum(lrs) + 1e-5
    far = total = 0
    for name, ref in want.items():
        got = sd[name].numpy()
        if name in buffers:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
            continue
        err = np.abs(got - ref)
        assert err.max() <= bound, name
        far += int((err > 1e-5).sum())
        total += err.size
    assert far <= 2e-3 * total, f"{far} of {total} elements beyond 1e-5"

    # resume from step 2 on the stream's third batch (the data stream
    # restarts on resume, as in the JAX package)
    ckpts = tmp_path / "port" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["2"]
    resumed = ploop.run_training(
        port_cfg(cfg), ploop.LoopConfig(**vars(loop_cfg(tmp_path / "port",
                                                        8))),
        iter(samples[16:]), pc, train_cfg=pcfg, pretrained_variables=pvars,
        resume_from_checkpoint=True, device="cpu")
    assert resumed.step == 3
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
