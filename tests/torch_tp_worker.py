"""One rank of the port's tensor-parallel tests (``tests/test_torch_port_
tp.py``): ``python tests/torch_tp_worker.py RANK WORLD PORT DIR CASE...``.

Joins a ``gloo`` process group on localhost through ``core/dist.init``
(torchrun's environment variables), then runs each case on the tiny
config's weights in ``DIR/weights.pt`` and the global batch in
``DIR/batch.pt`` (every dropout 0 unless the case says otherwise, lr 1e-3
from the first step), and writes what it saw to
``DIR/<case>_rank<RANK>.pt``:

- ``tp`` (data 1 x model 2), ``dp_tp`` (data 2 x model 2) and ``dp``
  (data 2 x model 1): step 1's metrics and its gathered gradients; with
  ``tp`` also step 2's metrics, the replicated parameters and the
  gathered model after it, a ``CheckpointManager`` save of step 2 into
  ``DIR/ck`` and step 3's metrics;
- ``tp_drop`` and ``tp_remat`` (data 1 x model 2, every dropout on,
  ``dropout_cfg``; ``tp_remat`` with the encoder layers rematerialised):
  two steps' metrics and the replicated parameters after them;
- ``tp_skew`` (data 1 x model 2): two steps on batches that each rank
  collates itself, with the train CLI's collator, from the same 4 clips
  of ``SKEW_FRAMES`` frames and the same seed, its audio mixed with
  interferers from an ``InterfererPool`` whose waves differ between the
  processes (``skew_batches``): what each rank collated, the two steps'
  metrics and the replicated parameters after them;
- ``stem`` (data 2 x model 1, ``AVSR_FUSED_STEM=1``): step 1's metrics.

Each data rank takes its shard of the global batch. Imports nothing of JAX.
"""

import os
import sys

import torch

SKEW_FRAMES = 50  # 2 s of audio: the shortest that mixes interferers
LAYOUTS = {"tp": (1, 2), "dp_tp": (2, 2), "dp": (2, 1), "stem": (2, 1),
           "tp_drop": (1, 2), "tp_remat": (1, 2), "tp_skew": (1, 2)}


def no_dropout_cfg():
    from tests.torch_port_common import tiny_port_cfg

    cfg = tiny_port_cfg()
    cfg.dropout_rate = cfg.transformer_attn_dropout_rate = 0.0
    e = cfg.encoder
    e.hidden_dropout = e.attention_dropout = e.activation_dropout = 0.0
    e.dropout_input = e.modality_dropout = 0.0
    return cfg


def dropout_cfg(scan_remat: str = "none"):
    """The tiny config with every dropout on (the encoder FFN's at 0.1
    too) and the encoder layers' remat mode ``scan_remat``."""
    from tests.torch_port_common import tiny_port_cfg

    cfg = tiny_port_cfg()
    cfg.encoder.activation_dropout = 0.1
    cfg.encoder.scan_remat = scan_remat
    return cfg


def case_cfg(case: str):
    return {"tp_drop": dropout_cfg, "tp_remat": lambda: dropout_cfg("full")
            }.get(case, no_dropout_cfg)()


def fresh_state(out: str, cfg=None):
    """A train state of the tiny config (or ``cfg``) on ``out``'s weights,
    sliced for this rank's model group."""
    from avsr_tpu_torch.models.e2e import AVSRModel
    from avsr_tpu_torch.train import trainer as PT

    cfg = cfg or no_dropout_cfg()
    model = AVSRModel(cfg)
    model.load_state_dict(torch.load(os.path.join(out, "weights.pt"),
                                     weights_only=True))
    return PT.init_state(cfg, PT.TrainConfig(learning_rate=1e-3,
                                             warmup_steps=0, max_steps=10),
                         seed=0, device="cpu", model=model)


def skew_batches(labels, steps: int = 2):
    """``steps`` batches (group indices 0, 1, ...) collated here as the
    train CLI collates (``DataCollator`` seed 11, uint8 crops, the train
    ``AudioTransform``) from 4 synthetic clips of ``SKEW_FRAMES`` frames,
    mixed with interferers from an ``InterfererPool`` whose waves are
    drawn from this process's rank; ``labels`` supplies the labels."""
    import numpy as np

    from avsr_tpu_torch.core import dist
    from avsr_tpu_torch.data.collate import DataCollator
    from avsr_tpu_torch.data.dataset import InterfererPool, synthetic_samples
    from avsr_tpu_torch.data.transforms import AudioTransform, VideoTransform
    from avsr_tpu_torch.train import trainer as PT

    waves = np.random.RandomState(100 + dist.rank())
    pool = InterfererPool([{}] * 8, size=8, seed=0, decode_fn=lambda _: (
        0.1 * waves.randn(3 * 16000)).astype(np.float32))
    collator = DataCollator(
        video_transform=VideoTransform("train", device_norm=True),
        audio_transform=AudioTransform("train", sample_interferer=pool),
        seed=11)
    clips = list(synthetic_samples(4, seed=3, min_frames=SKEW_FRAMES,
                                   max_frames=SKEW_FRAMES))
    return [dict(PT.host_tensors(collator(clips, group_index=i)),
                 labels=labels["labels"],
                 label_lengths=labels["label_lengths"])
            for i in range(steps)]


def shard(batch, rank: int, size: int):
    n = batch["videos"].shape[0] // size
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def run_case(case: str, out: str) -> dict:
    from avsr_tpu_torch.core import dist
    from avsr_tpu_torch.core import tensor_parallel as tp
    from avsr_tpu_torch.train import trainer as PT

    dist.set_layout(*LAYOUTS[case])
    batch = shard(torch.load(os.path.join(out, "batch.pt"),
                             weights_only=True),
                  dist.data_rank(), dist.data_size())
    feeds = skew_batches(batch) if case == "tp_skew" else None
    collated = feeds and [{k: v.clone() for k, v in b.items()}
                          for b in feeds]

    def feed():
        return feeds.pop(0) if feeds else batch

    if case == "stem":
        os.environ["AVSR_FUSED_STEM"] = "1"
    try:
        state = fresh_state(out, case_cfg(case))

        def step():
            return {k: v.item() for k, v in PT.train_step(state,
                                                          feed()).items()}

        res = {"metrics": [step()], "layout": (dist.data_size(),
                                               dist.model_size())}
    finally:
        os.environ.pop("AVSR_FUSED_STEM", None)
    if case in ("tp", "dp_tp", "dp"):
        res["grads"] = tp.gather_state_dict(
            {n: p.grad for n, p in state.model.named_parameters()})
    if case.startswith("tp"):
        res["metrics"].append(step())
        res["replicated"] = {
            n: p.detach().clone() for n, p in state.model.named_parameters()
            if tp.shard_dim(n, p.dim()) is None}
    if collated:
        res["collated"] = collated
    if case == "tp":
        res["full"] = {n: t.clone() for n, t in
                       tp.full_state_dict(state.model).items()}
        mgr = PT.CheckpointManager(os.path.join(out, "ck"))
        mgr.save(2, state)
        mgr.close()
        res["metrics"].append(step())
    return res


def main(rank: int, world: int, port: int, out: str, cases) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from avsr_tpu_torch.core import dist

    dist.init("cpu")
    for case in cases:
        torch.save(run_case(case, out),
                   os.path.join(out, f"{case}_rank{rank}.pt"))
    dist.tdist.barrier()
    dist.close()
    print(f"rank {rank}: OK")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5:])
