"""Training: optimizer, train/eval steps, checkpoints.

Counterpart of ``avsr_tpu/train/trainer.py``, one device a process. The
recipe is the reference run's (HF Trainer defaults, as the JAX package
has it): AdamW lr 1e-4, linear warmup then linear decay to
``max_steps``, weight decay 0.005 except on biases, PReLU weights and
1-D norm scales, global-norm clipping at 1.0, gradient accumulation,
loss = 0.1 * CTC + 0.9 * label-smoothed CE.

Mixed precision as in the JAX package: the parameters stay fp32 masters,
and with ``compute_dtype="bfloat16"`` the forward and backward run on a
differentiable bf16 cast of every float parameter and of the inputs
(``torch.func.functional_call``), so each op runs in the dtype the JAX
package gives it; ``torch.autocast`` would keep LayerNorm and others in
fp32 where JAX does not. BatchNorm reads its running statistics at the
compute dtype and keeps them in fp32.

Every random draw comes from the ``DropoutRng`` the state owns, seeded at
``init_state`` (with the data rank's offset under data parallelism).

Data parallelism (``core/dist.py``, one process a card): each data rank
runs its shard of the global batch, and ``train_step`` all-reduces the
mean of the gradients and of the metrics over the data group once a step,
after the micro-batches and before the global norm and clipping; the
frontend's BatchNorms take global batch statistics. Both losses are batch
means over equal shards, so the step is the JAX package's step over the
global batch.

Tensor parallelism (``core/tensor_parallel.py``, the JAX package's
Megatron layout over the 'model' axis): ``init_state`` slices the model
for its model rank before it makes the optimizer, so each rank keeps its
slice of the split weights and of their AdamW moments. The ranks of one
model group take the same batch (``train_step`` and ``eval_step``
broadcast the first rank's over the group: a collator's own state, as an
interferer pool's, may differ between the processes) and draw the same
dropout masks, so their replicated parameters get equal gradients; the global norm sums the
squares of the slices over the model group and counts each replicated
tensor once. Checkpoints hold the full tensors, gathered before rank 0
writes and sliced on restore, so they load at any model size.

A batch with a ``targets`` field is a pretraining batch
(``train/pretrain.py``): the model is then ``AVHubertPretrainModel`` and
the metrics are its five.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as tdist
from torch.func import functional_call

from avsr_tpu_torch.core import dist
from avsr_tpu_torch.core import tensor_parallel as tp
from avsr_tpu_torch.core.checkpoint import avsr_mapping, pretrain_mapping
from avsr_tpu_torch.core.config import AVHubertAVSRConfig
from avsr_tpu_torch.data.wire import VIDEO_MEAN, VIDEO_STD
from avsr_tpu_torch.models.e2e import AVSRModel
from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.dropout import DropoutRng
from avsr_tpu_torch.ops.masks import make_non_pad_mask

METRICS = ("loss", "loss_ctc", "loss_att", "acc")


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    warmup_steps: int = 4000
    max_steps: int = 400_000
    weight_decay: float = 0.005
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # forward/backward dtype over fp32 master weights and optimizer state
    compute_dtype: str = "float32"


@dataclass
class TrainState:
    cfg: TrainConfig
    model: torch.nn.Module  # AVSRModel, or AVHubertPretrainModel
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    rng: DropoutRng
    step: int = 0


def lr_schedule(cfg: TrainConfig):
    """The learning rate of update ``count`` (0 for the first update):
    optax's join of a linear warmup 0 -> lr over ``warmup_steps`` and a
    linear decay lr -> 0 over the remaining steps, in fp32 by optax's
    formula ``(init - end) * (1 - clip(c) / steps) + end``."""

    def linear(init, end, steps, count):
        c = torch.tensor(min(max(count, 0), steps), dtype=torch.float32)
        frac = 1.0 - c / steps
        return float((init - end) * frac + end)

    def schedule(count: int) -> float:
        w = cfg.warmup_steps
        if count < w:
            return linear(0.0, cfg.learning_rate, w, count)
        return linear(cfg.learning_rate, 0.0, cfg.max_steps - w, count - w)

    return schedule


def decay_mask(model_cfg: AVHubertAVSRConfig,
               mapping=None) -> Dict[str, bool]:
    """Parameter name -> whether AdamW decays it, by the JAX package's rule
    on the flax path of the same leaf (``mapping``, by default
    ``avsr_mapping``): no decay on ``bias``, PReLU ``alpha`` or 1-D norm
    ``scale`` leaves; the weight-norm ``weight_g`` and everything else
    (the pretraining head's ``mask_emb`` and ``label_embs`` too)
    decays."""
    mask = {}
    if mapping is None:
        mapping = avsr_mapping(model_cfg, prefix="")
    for tkey, fpath, _, coll in mapping:
        if coll != "p":
            continue
        decays = not ({"bias", "alpha"} & set(fpath) or fpath[-1] == "scale")
        for key in tkey if isinstance(tkey, list) else [tkey]:
            mask[key] = decays
    return mask


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig):
    """(AdamW over two parameter groups, its LambdaLR). torch's AdamW
    decays decoupled, p -= lr * wd * p beside the Adam step, which is optax
    ``adamw``'s ``add_decayed_weights`` before the learning-rate scale.
    Global-norm clipping happens in ``train_step``, before ``step()``."""
    if hasattr(model, "pretrain_cfg"):
        mask = decay_mask(None, pretrain_mapping(model.encoder_cfg))
    else:
        mask = decay_mask(model.cfg)
    params = dict(model.named_parameters())
    if set(params) != set(mask):
        raise ValueError(f"parameters without a decay rule: "
                         f"{sorted(set(params) ^ set(mask))}")
    groups = [
        {"params": [p for n, p in params.items() if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in params.items() if not mask[n]],
         "weight_decay": 0.0},
    ]
    opt = torch.optim.AdamW(groups, lr=cfg.learning_rate,
                            betas=(cfg.b1, cfg.b2), eps=cfg.eps)
    sched = lr_schedule(cfg)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: sched(count) / cfg.learning_rate)


def init_state(model_cfg: AVHubertAVSRConfig, train_cfg: TrainConfig,
               seed: int = 0, device="cuda",
               model: Optional[torch.nn.Module] = None,
               pretrain_cfg=None) -> TrainState:
    """The training state: ``model`` (moved to ``device``) or a new one
    with seeded random weights (``AVSRModel``, or with ``pretrain_cfg``
    the pretraining model over ``model_cfg.encoder``), the optimizer, its
    schedule, and the run's ``DropoutRng`` from ``seed`` at this data
    rank. Under tensor parallelism the model (made or given, full) is
    sliced for this model rank first."""
    device = torch.device(device)
    if device.type == "cpu":
        warm_exp()
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        if pretrain_cfg is not None:
            from avsr_tpu_torch.train.pretrain import (
                AVHubertPretrainModel, init_pretrain_weights)

            with torch.device(device):
                model = AVHubertPretrainModel(model_cfg.encoder, pretrain_cfg)
            init_pretrain_weights(model, gen)
        else:
            from avsr_tpu_torch.core.weights import init_weights

            with torch.device(device):
                model = AVSRModel(model_cfg)
            init_weights(model, gen)
    model = tp.shard_model_(model.to(device), dist.model_rank(),
                            dist.model_size())
    opt, sched = make_optimizer(model, train_cfg)
    return TrainState(train_cfg, model, opt, sched,
                      DropoutRng(seed + 1, device, rank=dist.data_rank()))


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy or torch batch -> torch tensors on ``device`` (int64 ids)."""
    return {k: v.to(device) for k, v in host_tensors(batch).items()}


def host_tensors(batch: Dict) -> Dict[str, torch.Tensor]:
    """numpy or torch batch -> torch tensors where they lie: ids and
    lengths int64; floats, uint8 crops and bool masks as they are."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if not v.is_floating_point() and v.dtype not in (torch.uint8,
                                                         torch.bool):
            v = v.to(torch.int64)
        out[k] = v
    return out


def loss_fn(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
            rng: Optional[DropoutRng], train: bool = True,
            compute_dtype: str = "float32"):
    """(loss, metrics) of one batch; ``train`` runs the dropouts (from
    ``rng``) and updates the BatchNorm running statistics. A batch with
    ``targets`` goes through the pretraining model."""
    videos, audios = batch["videos"], batch["audios"]
    if videos.dtype == torch.uint8:
        # crops travel as uint8; normalise on the device (data/wire.py)
        videos = (videos.float() / 255.0 - VIDEO_MEAN) / VIDEO_STD
    pretrain = "targets" in batch
    if pretrain:
        valid = make_non_pad_mask(batch["video_lengths"], videos.shape[1])
        inputs = [audios, videos, batch["audio_mask"],
                  batch["video_src_index"], batch["targets"], valid]
    else:
        inputs = [videos, audios, batch["labels"], batch["video_lengths"],
                  batch["label_lengths"]]
    kw = {"train": train, "rng": rng if train else None}
    if compute_dtype == "float32":
        out = model(*inputs, **kw)
    else:
        dt = getattr(torch, compute_dtype)
        params = {n: p.to(dt) for n, p in model.named_parameters()}
        inputs[:2] = [x.to(dt) for x in inputs[:2]]
        out = functional_call(model, params, tuple(inputs), kw)
    if pretrain:
        loss, metrics = out
        return loss, {k: v.detach().float() for k, v in metrics.items()}
    metrics = {k: getattr(out, k).detach().float() for k in METRICS}
    return out.loss, metrics


def _global_norm(named) -> torch.Tensor:
    """The norm of every (name, gradient) together; under tensor
    parallelism the slices' squares are summed over the model group and
    each replicated tensor counts once."""
    # sums of squares, not linalg.vector_norm: on the CPU the latter
    # accumulates fp32 with ~1e-4 relative error at 5 M elements (C18)
    def sq(ts):
        return torch.stack([t.float().pow(2).sum() for t in ts]).sum()

    if dist.model_size() == 1:
        return sq([g for _, g in named]).sqrt()
    split = [tp.shard_dim(n, g.dim()) is not None for n, g in named]
    sliced = dist.all_reduce_(sq([g for (_, g), s in zip(named, split) if s]),
                              "model")
    whole = sq([g for (_, g), s in zip(named, split) if not s])
    return (whole + sliced).sqrt()


def train_step(state: TrainState,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One optimizer update in ``state.cfg.compute_dtype``. With a leading
    micro-batch axis on every tensor (videos (A, B, T, H, W, C)) the
    gradient is the mean over the A micro-batches, which run in order and
    thread the BatchNorm statistics; the metrics are their means.
    ``grad_norm`` is the global norm before clipping. Returns device
    tensors (no host sync). Under tensor parallelism every rank of a
    model group steps on its first rank's batch."""
    model, opt, cfg = state.model, state.optimizer, state.cfg
    dist.broadcast_(list(batch.values()), "model")
    accum = batch["videos"].dim() > 5
    micro = ([{k: v[i] for k, v in batch.items()}
              for i in range(batch["videos"].shape[0])] if accum else [batch])
    opt.zero_grad(set_to_none=True)
    sums = None
    for mb in micro:
        loss, m = loss_fn(model, mb, state.rng, True, cfg.compute_dtype)
        loss.backward()
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
    named = [(n, p.grad) for n, p in model.named_parameters()
             if p.grad is not None]
    grads = [g for _, g in named]
    if accum:
        for g in grads:
            g.div_(len(micro))
    metrics = {k: v / len(micro) for k, v in sums.items()}
    if dist.data_size() > 1:
        # the global batch's gradient and metrics: one collective a step
        vals = list(metrics.values())
        dist.all_reduce_mean_(grads + vals)
    norm = _global_norm(named)
    # optax clip_by_global_norm: g / norm * max_norm once norm >= max_norm
    clip = norm >= cfg.max_grad_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * cfg.max_grad_norm, g))
    opt.step()
    state.scheduler.step()
    state.step += 1
    metrics["grad_norm"] = norm
    return metrics


def eval_step(state: TrainState,
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    dist.broadcast_(list(batch.values()), "model")
    with torch.no_grad():
        return loss_fn(state.model, batch, None, False,
                       state.cfg.compute_dtype)[1]


def _optimizer_names(state: TrainState) -> List[str]:
    """The parameter names in the order of the optimizer's state dict."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]]


def _optimizer_state(state: TrainState, sd: Dict, slice_: bool) -> Dict:
    """The optimizer state dict ``sd`` with each sliced parameter's AdamW
    moments gathered to the full tensor (``slice_=False``: this rank's
    optimizer's state dict) or sliced for this model rank (``slice_=True``:
    a full one)."""
    if dist.model_size() == 1:
        return sd
    names = _optimizer_names(state)
    out = dict(sd, state=dict(sd["state"]))
    for i, st in sd["state"].items():
        d = tp.shard_dim(names[i], st["exp_avg"].dim())
        if d is None:
            continue
        out["state"][i] = {
            k: (v if k not in ("exp_avg", "exp_avg_sq") else
                tp.chunk(v, d, dist.model_rank(), dist.model_size()).clone()
                if slice_ else tp.gather(v, d))
            for k, v in st.items()}
    return out


def save_checkpoint(path: str, state: TrainState) -> None:
    """Blocking save of the model, optimizer, schedule, step and the
    random generators' states; the full tensors under tensor parallelism
    (every rank calls it, rank 0 writes)."""
    tree = {"model": tp.full_state_dict(state.model),
            "optimizer": _optimizer_state(
                state, state.optimizer.state_dict(), slice_=False),
            "scheduler": state.scheduler.state_dict(),
            "step": state.step, "rng": state.rng.state()}
    if dist.is_main():
        torch.save(tree, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a ``save_checkpoint`` file, or a ``CheckpointManager`` step's,
    into ``state`` (same model config and device, any model size) and
    return it. Each data rank takes its own generators' states."""
    ck = torch.load(path, map_location=state.rng.device, weights_only=True)
    tp.load_full_state_dict(state.model, ck["model"])
    state.optimizer.load_state_dict(
        _optimizer_state(state, ck["optimizer"], slice_=True))
    state.scheduler.load_state_dict(ck["scheduler"])
    rng = ck["rng"]
    if isinstance(rng, list):  # a CheckpointManager step: one a data rank
        if len(rng) != dist.data_size():
            raise ValueError(f"{path} holds the generators of {len(rng)} "
                             f"data ranks, not {dist.data_size()}")
        rng = rng[dist.data_rank()]
    state.rng.load_state({k: v.cpu() for k, v in rng.items()})
    state.step = ck["step"]
    return state


class CheckpointManager:
    """Step checkpoints written in the background, with keep-last-N
    retention and best-model tracking.

    Counterpart of the JAX package's orbax ``CheckpointManager`` (the
    reference HF Trainer's ``save_total_limit``, ``metric_for_best_model=
    'loss'`` and non-blocking saves). The layout: a directory a step,
    named by the bare step, under ``root``, holding ``state.pt`` (the
    model, the optimizer, the schedule, the step and every rank's
    generator states, as ``save_checkpoint`` holds them); ``best.json``
    with ``{"step": n, "loss": v}``. The port's own format: it does not
    read orbax directories.

    ``save`` copies the state into pinned host buffers with non-blocking
    copies on the current stream (later updates queue behind them), and
    returns; a background thread waits for the copies, writes the step
    into a temporary directory, renames it into place and prunes the
    oldest steps. One save is in flight at a time: the next ``save``,
    ``wait`` or ``close`` joins it and raises what it raised. Under data
    and tensor parallelism rank 0 writes (every data rank's generator
    states and the tensor-parallel slices, model and AdamW moments,
    gathered to it) and every rank restores.
    """

    FILE = "state.pt"

    def __init__(self, root: str, max_to_keep: Optional[int] = None):
        self.root = root
        self.max_to_keep = max_to_keep
        if dist.is_main():
            os.makedirs(root, exist_ok=True)
        self._best: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[tuple, torch.Tensor] = {}

    def _host_copy(self, tree, path=()):
        if isinstance(tree, dict):
            return {k: self._host_copy(v, path + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._host_copy(v, path + (i,))
                              for i, v in enumerate(tree))
        if not isinstance(tree, torch.Tensor):
            return copy.deepcopy(tree)
        if tree.device.type != "cuda":
            return tree.detach().clone()
        buf = self._pinned.get(path)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            buf = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
            self._pinned[path] = buf
        buf.copy_(tree.detach(), non_blocking=True)
        return buf

    def save(self, step: int, state: TrainState) -> None:
        """Snapshot ``state`` and write it as step ``step`` in the
        background; returns once the copies are queued."""
        self.wait()
        rngs = [state.rng.state()]
        if dist.world_size() > 1:
            rngs = [None] * dist.world_size()
            tdist.all_gather_object(rngs, state.rng.state())
            # a model group's ranks draw alike: keep its first rank's
            rngs = rngs[::dist.model_size()]
        model = tp.full_state_dict(state.model)
        optimizer = _optimizer_state(state, state.optimizer.state_dict(),
                                     slice_=False)
        if not dist.is_main():
            return
        tree = self._host_copy({
            "model": model, "optimizer": optimizer,
            "scheduler": state.scheduler.state_dict(),
            "step": state.step})
        tree["rng"] = rngs
        done = None
        if state.rng.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._thread = threading.Thread(
            target=self._write, args=(step, tree, done), daemon=True)
        self._thread.start()

    def _write(self, step: int, tree, done) -> None:
        try:
            if done is not None:
                done.synchronize()
            tmp = os.path.join(self.root, f".tmp-{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(tree, os.path.join(tmp, self.FILE))
            final = os.path.join(self.root, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            steps = self.steps()
            if self.max_to_keep is not None:
                for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                    shutil.rmtree(os.path.join(self.root, str(old)))
        except BaseException as e:  # raised again by wait()
            self._error = e

    def steps(self) -> List[int]:
        """The steps written, oldest first."""
        if not os.path.isdir(self.root):
            return []
        return sorted(int(d) for d in os.listdir(self.root) if d.isdigit()
                      and os.path.exists(os.path.join(self.root, d,
                                                      self.FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: TrainState) -> TrainState:
        return restore_checkpoint(
            os.path.join(self.root, str(step), self.FILE), template)

    def note_eval(self, step: int, metrics: Dict[str, float],
                  metric: str = "loss") -> bool:
        """Track the best eval metric (lower is better, NaN never best);
        returns True if it improved."""
        value = float(metrics.get(metric, float("nan")))
        if value != value:  # NaN
            return False
        if self._best is None or value < self._best:
            self._best = value
            if dist.is_main():
                with open(os.path.join(self.root, "best.json"), "w") as f:
                    json.dump({"step": step, metric: value}, f)
            return True
        return False

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
