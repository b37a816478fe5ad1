"""Training loop: batching, logging, checkpoints, eval, resume.

Counterpart of ``avsr_tpu/train/loop.py`` (the reference's HF Trainer
usage, script/train.py:259-314): a steps-based eval and save cadence, the
metrics logged every ``log_interval`` steps, step checkpoints with the
optimizer state written in the background, and resume from the latest
checkpoint (with the reference's ``ignore_data_skip=True``: the data
stream restarts).

Under data parallelism (``core/dist.py``) each data rank collates
``batch_size`` samples of its own share of the stream, so the global
batch is ``batch_size`` x the data size; under tensor parallelism the
ranks of one model group take the same samples. Rank 0 alone logs and
writes.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from avsr_tpu_torch.core import dist
from avsr_tpu_torch.core import tensor_parallel as tp
from avsr_tpu_torch.data.dataset import shard_for_host
from avsr_tpu_torch.train import trainer as T

# static shape buckets: video frames and label lengths
T_BUCKETS = (64, 128, 192, 256, 384, 512, 640)
L_BUCKETS = (16, 32, 48, 64, 96, 128)


@dataclasses.dataclass
class LoopConfig:
    output_dir: str = "model-bin/avsr_tpu"
    max_steps: int = 400_000
    batch_size: int = 6  # per-device micro batch (reference per_device_train_batch_size)
    grad_accum: int = 2
    save_steps: int = 2000
    # keep-last-N retention (reference save_total_limit, script/train.py:280)
    save_total_limit: int = 500
    eval_steps: int = 2000
    eval_batches: int = 50
    log_interval: int = 25
    seed: int = 0
    # collator worker-pool size (reference dataloader_num_workers=10,
    # script/train.py:278); 0 = collate inline on the feeding thread
    num_workers: int = 0
    # True = spawn process pool (GIL-free), False = threads
    use_process_workers: bool = False
    report_to: str = "none"  # 'none' | 'wandb' | 'tensorboard'
    run_name: str = "avsr_tpu"
    # write a torch.profiler trace (Chrome JSON) of steps 10-12 here
    profile_dir: str = ""


_WORKER_COLLATOR = None


def _init_collate_worker(collator) -> None:
    global _WORKER_COLLATOR
    _WORKER_COLLATOR = collator


def _collate_in_worker(group, group_index):
    return _WORKER_COLLATOR(group, group_index=group_index)


def batches_from_samples(
    samples: Iterable[Dict],
    collator,
    batch_size: int,
    grad_accum: int = 1,
    drop_last: bool = True,
    num_workers: int = 0,
    use_processes: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Group samples into (accum, B, ...) collated batches with bucketing.

    ``num_workers`` > 0 runs the collator (media decode, augmentation,
    fbank) in a pool with up to 2 * num_workers groups in flight (the
    reference's dataloader_num_workers): threads by default, or with
    ``use_processes`` a ``spawn`` process pool that sidesteps the GIL.
    Results are yielded in order either way.
    """
    collator.t_buckets = T_BUCKETS
    collator.l_buckets = L_BUCKETS
    want = batch_size * grad_accum

    def groups() -> Iterator[List[Dict]]:
        group: List[Dict] = []
        for sample in samples:
            group.append(sample)
            if len(group) == want:
                yield group
                group = []
        if group and not drop_last:
            yield group

    def shape(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if grad_accum > 1:
            batch = {
                k: v.reshape((grad_accum, batch_size) + v.shape[1:])
                for k, v in batch.items()
            }
        return batch

    if num_workers <= 0:
        for idx, group in enumerate(groups()):
            yield shape(collator(group, group_index=idx))
        return

    import concurrent.futures as cf

    if use_processes:
        # spawn, not fork: the parent holds CUDA state and threads
        import multiprocessing as mp

        pool = cf.ProcessPoolExecutor(
            max_workers=num_workers, mp_context=mp.get_context("spawn"),
            initializer=_init_collate_worker, initargs=(collator,),
        )
        submit = lambda g, i: pool.submit(_collate_in_worker, g, i)  # noqa: E731
    else:
        pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        submit = lambda g, i: pool.submit(collator, g, group_index=i)  # noqa: E731

    try:
        pending: collections.deque = collections.deque()
        for idx, group in enumerate(groups()):
            pending.append(submit(group, idx))
            if len(pending) >= 2 * num_workers:
                yield shape(pending.popleft().result())
        while pending:
            yield shape(pending.popleft().result())
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def device_prefetch(batches: Iterator[Dict], device,
                    depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches on ``device``, ``depth`` in flight: on the card each batch
    is pinned and copied without blocking on a side stream, and the
    compute stream waits for its copy only when it takes the batch, so the
    transfer of batch N+1 overlaps step N. Plain copies on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield T.to_device(batch, device)
        return
    side = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def take():
        dev, ready = queue.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(ready)
        for v in dev.values():  # allocated on the side stream
            v.record_stream(compute)
        return dev

    for batch in batches:
        host = {k: v.pin_memory() for k, v in T.host_tensors(batch).items()}
        with torch.cuda.stream(side):
            dev = {k: v.to(device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        queue.append((dev, ready))
        if len(queue) >= depth:
            yield take()
    while queue:
        yield take()


def param_summary(model: torch.nn.Module) -> str:
    """Parameter counts per top-level module and the total (the reference
    prints a torchsummary of the model at startup, script/train.py:256);
    this rank's slices under tensor parallelism."""
    counts: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        counts[top] = counts.get(top, 0) + p.numel()
    lines = [f"  {k:<32s} {v:>14,d}" for k, v in sorted(counts.items())]
    lines.append(f"  {'total':<32s} {sum(counts.values()):>14,d}")
    return "\n".join(lines)


class MetricsLogger:
    """stdout + optional wandb/tensorboard metric sink (reference report_to,
    script/train.py:291); the backends are imported only when asked for."""

    def __init__(self, cfg: LoopConfig):
        self.cfg = cfg
        self.backend = None
        self.tb = None
        if cfg.report_to == "wandb":
            try:
                import wandb

                wandb.init(project=os.environ.get("WANDB_PROJECT", "avsr_tpu"),
                           name=cfg.run_name)
                self.backend = wandb
            except ImportError:
                print("wandb not available; logging to stdout")
        elif cfg.report_to == "tensorboard":
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(
                    os.path.join(cfg.output_dir, "runs", cfg.run_name)
                )
            except ImportError:
                print("tensorboardX not available; logging to stdout")
        self._last = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train"):
        now = time.time()
        dt = now - self._last
        self._last = now
        line = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"[{prefix} step {step}] {line} ({dt:.1f}s)", flush=True)
        if self.backend is not None:
            self.backend.log(
                {f"{prefix}/{k}": float(v) for k, v in metrics.items()},
                step=step)
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        if self.tb is not None:
            self.tb.close()


def _fetch_mean(window: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The mean of each metric over ``window`` and over the ranks, fetched
    to the host in one transfer."""
    keys = list(window[0])
    means = torch.stack([torch.stack([m[k] for k in keys])
                         for m in window]).mean(0)
    dist.all_reduce_mean_([means])
    return dict(zip(keys, means.tolist()))


def run_training(
    model_cfg,
    loop_cfg: LoopConfig,
    train_samples: Iterable[Dict],
    collator,
    valid_samples: Optional[Callable[[], Iterable[Dict]]] = None,
    valid_collator=None,
    pretrained_variables: Optional[Dict[str, torch.Tensor]] = None,
    train_cfg: Optional[T.TrainConfig] = None,
    resume_from_checkpoint: bool = False,
    pretrain_cfg=None,
    device="cuda",
) -> T.TrainState:
    """Run the training loop on ``device``; returns the final state.

    ``pretrained_variables`` is a port state dict of the model trained,
    loaded strictly; without it the weights are random from
    ``loop_cfg.seed``. ``pretrain_cfg`` (a ``train.pretrain.
    PretrainConfig``) switches the objective to AV-HuBERT masked
    prediction, with a collator that emits pretraining batches
    (``train.pretrain.PretrainCollator``). The samples are this rank's
    share of the stream when they come sharded (``shard_for_host``);
    ``valid_samples()`` is sharded here."""
    tcfg = train_cfg or T.TrainConfig(max_steps=loop_cfg.max_steps)
    main = dist.is_main()
    if main:
        os.makedirs(loop_cfg.output_dir, exist_ok=True)

    state = T.init_state(model_cfg, tcfg, seed=loop_cfg.seed, device=device,
                         pretrain_cfg=pretrain_cfg)
    if pretrained_variables is not None:
        tp.load_full_state_dict(state.model, pretrained_variables)
    if main:
        print("Model parameters:\n" + param_summary(state.model))

    ckpt_root = os.path.abspath(os.path.join(loop_cfg.output_dir,
                                             "checkpoints"))
    manager = T.CheckpointManager(ckpt_root,
                                  max_to_keep=loop_cfg.save_total_limit)
    if resume_from_checkpoint:
        latest = manager.latest_step()
        if latest is not None:
            if main:
                print(f"Resuming from {ckpt_root}/{latest}")
            state = manager.restore(latest, state)
    logger = MetricsLogger(loop_cfg) if main else None

    batches = batches_from_samples(
        train_samples, collator, loop_cfg.batch_size, loop_cfg.grad_accum,
        num_workers=loop_cfg.num_workers,
        use_processes=loop_cfg.use_process_workers,
    )
    # The step counter lives on the host (state.step), and the metrics
    # stay device tensors until one fetch per log_interval: a per-step
    # fetch would make the host wait for every step before queueing the
    # next (~28% of the wall in the JAX package's profile).
    window: list = []
    profiler = None
    for batch in device_prefetch(batches, device):
        if state.step >= loop_cfg.max_steps:
            break
        if loop_cfg.profile_dir and state.step == 10:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            profiler = profile(activities=acts)
            profiler.start()
        window.append(T.train_step(state, batch))
        step_no = state.step
        if profiler is not None and step_no == 13:
            profiler.stop()
            if main:
                os.makedirs(loop_cfg.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(
                    loop_cfg.profile_dir, f"trace_rank{dist.rank()}.json"))
            profiler = None

        if step_no % loop_cfg.log_interval == 0:
            metrics = _fetch_mean(window)
            window = []
            if main:
                logger.log(step_no, metrics)

        if valid_samples is not None and step_no % loop_cfg.eval_steps == 0:
            ev = []
            vbatches = batches_from_samples(
                shard_for_host(valid_samples()), valid_collator or collator,
                loop_cfg.batch_size, 1)
            for vb in itertools.islice(vbatches, loop_cfg.eval_batches):
                ev.append(T.eval_step(state, T.to_device(vb, device)))
            if ev:
                eval_metrics = _fetch_mean(ev)
                if main:
                    logger.log(step_no, eval_metrics, "eval")
                if manager.note_eval(step_no, eval_metrics) and main:
                    print(f"New best eval loss at step {step_no}")

        if step_no % loop_cfg.save_steps == 0:
            manager.save(step_no, state)  # background write
            if main:
                print(f"Queued checkpoint {ckpt_root}/{step_no}")

    manager.close()
    if logger is not None:
        logger.close()
    return state
