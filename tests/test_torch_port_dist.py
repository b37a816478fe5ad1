"""The port's data parallelism (``core/dist.py``) on the CPU: two
processes over ``gloo``, each a rank with half of a global batch of 8,
against one process taking the whole batch (the port only; the JAX
package's data mesh is ``tests/test_multiprocess.py``'s)."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from avsr_tpu_torch.train import trainer as PT
from tests.torch_dist_worker import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_step_equals_one_process_step(tmp_path):
    """One train step, tiny config, every dropout 0, modality 'av' (the
    BatchNorms' all-reduced statistics and their backward both run).
    Against the step on the whole batch in one process: the loss and its
    parts within 1e-5 relative, the gradient norm within 1e-4 (the video
    frontend's gradient is fp32-ill-conditioned, C16, and its reduction
    order differs); every parameter within 2 x 1.01 x lr + 1e-5 and all
    but 0.2% within 1e-5 (the first Adam step is +-lr a parameter, so only
    gradients near 0 can flip), the BN running statistics within 1e-4
    relative + 1e-5. Both ranks end with the same parameters and
    generators of their own; ``shard_for_host`` gives them disjoint
    halves of the stream; rank 0 alone writes the checkpoint, and every
    rank restores it. The ranks run in subprocesses with a 120 s timeout,
    so a hang fails this test, not the suite's clock."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in out, out[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]

    torch.set_num_threads(2)
    state, batch = build()
    want = {k: v.item() for k, v in
            PT.train_step(state, PT.to_device(batch, "cpu")).items()}
    ref = state.model.state_dict()
    buffers = {n for n, _ in state.model.named_buffers()}
    lr = 1e-3
    for rank in ranks:
        got = rank["metrics"]
        for k in ("loss", "loss_ctc", "loss_att"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        far = total = 0
        for name, w in ref.items():
            g = rank["state"][name]
            if name in buffers:
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                           msg=name)
                continue
            err = (g - w).abs()
            assert err.max().item() <= 2 * 1.01 * lr + 1e-5, name
            far += int((err > 1e-5).sum())
            total += err.numel()
        assert far <= 2e-3 * total, f"{far} of {total} beyond 1e-5"
    for a, b in zip(ranks[0]["state"].values(), ranks[1]["state"].values()):
        assert torch.equal(a, b)
    assert not torch.equal(ranks[0]["rng"]["gen"], ranks[1]["rng"]["gen"])
    assert torch.equal(ranks[0]["rng"]["shared"], ranks[1]["rng"]["shared"])
    assert ranks[0]["shard"] == [0, 2, 4, 6, 8]
    assert ranks[1]["shard"] == [1, 3, 5, 7, 9]
    assert [r["wrote"] for r in ranks] == [True, False]
    assert all(r["restored"] for r in ranks)
    assert os.listdir(tmp_path / "ck") == ["1"]
