"""One rank of the port's 2-process data-parallel test
(``tests/test_torch_port_dist.py``): ``python tests/torch_dist_worker.py
RANK WORLD PORT OUT_DIR``. Joins a ``gloo`` process group on localhost
through ``core/dist.init`` (torchrun's environment variables), takes one
train step on its half of the global batch, saves and restores a
checkpoint through ``CheckpointManager``, and writes what it saw to
``OUT_DIR/rank<RANK>.pt``. Imports nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

GLOBAL_BATCH = 8


def build():
    """(train state, global batch) of the tiny config, every dropout 0,
    seed-0 weights; lr 1e-3 from the first step."""
    from avsr_tpu_torch.data.synthetic import synthetic_train_batch
    from avsr_tpu_torch.train import trainer as PT
    from tests.torch_port_common import tiny_port_cfg

    cfg = tiny_port_cfg()
    cfg.dropout_rate = cfg.transformer_attn_dropout_rate = 0.0
    e = cfg.encoder
    e.hidden_dropout = e.attention_dropout = e.activation_dropout = 0.0
    e.dropout_input = e.modality_dropout = 0.0
    state = PT.init_state(cfg, PT.TrainConfig(learning_rate=1e-3,
                                              warmup_steps=0, max_steps=10),
                          seed=0, device="cpu")
    batch = synthetic_train_batch(
        np.random.RandomState(1), GLOBAL_BATCH, 8, 5,
        video_lengths=[8, 7, 6, 8, 5, 8, 8, 6],
        label_lengths=[5, 4, 3, 5, 2, 5, 5, 3], vocab=59)
    return state, batch


def main(rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    from avsr_tpu_torch.core import dist
    from avsr_tpu_torch.data.dataset import shard_for_host
    from avsr_tpu_torch.train import trainer as PT

    dist.init("cpu")
    assert dist.world_size() == world and dist.rank() == rank
    state, batch = build()
    n = GLOBAL_BATCH // world
    shard = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    metrics = PT.train_step(state, PT.to_device(shard, "cpu"))
    mgr = PT.CheckpointManager(os.path.join(out, "ck"))
    mgr.save(1, state)
    wrote = mgr._thread is not None
    mgr.close()
    dist.tdist.barrier()
    fresh, _ = build()
    fresh = mgr.restore(1, fresh)
    restored = all(torch.equal(a, b) for a, b in zip(
        fresh.model.state_dict().values(), state.model.state_dict().values()))
    torch.save({"metrics": {k: v.item() for k, v in metrics.items()},
                "state": state.model.state_dict(),
                "shard": list(shard_for_host(iter(range(10)))),
                "wrote": wrote, "restored": restored,
                "rng": fresh.rng.state()},
               os.path.join(out, f"rank{rank}.pt"))
    dist.close()
    print(f"rank {rank}: OK")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
