"""Training: optimizer, train/eval steps, checkpoints.

Counterpart of ``avsr_tpu/train/trainer.py``, one device. The recipe is the
reference run's (HF Trainer defaults, as the JAX package has it): AdamW
lr 1e-4, linear warmup then linear decay to ``max_steps``, weight decay
0.005 except on biases, PReLU weights and 1-D norm scales, global-norm
clipping at 1.0, gradient accumulation, loss = 0.1 * CTC + 0.9 *
label-smoothed CE.

Mixed precision as in the JAX package: the parameters stay fp32 masters,
and with ``compute_dtype="bfloat16"`` the forward and backward run on a
differentiable bf16 cast of every float parameter and of the inputs
(``torch.func.functional_call``), so each op runs in the dtype the JAX
package gives it; ``torch.autocast`` would keep LayerNorm and others in
fp32 where JAX does not. BatchNorm reads its running statistics at the
compute dtype and keeps them in fp32.

Every random draw comes from the ``DropoutRng`` the state owns, seeded at
``init_state``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.func import functional_call

from avsr_tpu_torch.core.checkpoint import avsr_mapping
from avsr_tpu_torch.core.config import AVHubertAVSRConfig
from avsr_tpu_torch.data.wire import VIDEO_MEAN, VIDEO_STD
from avsr_tpu_torch.models.e2e import AVSRModel
from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.dropout import DropoutRng

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
    model: AVSRModel
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


def decay_mask(model_cfg: AVHubertAVSRConfig) -> Dict[str, bool]:
    """Parameter name -> whether AdamW decays it, by the JAX package's rule
    on the flax path of the same leaf (``avsr_mapping``): no decay on
    ``bias``, PReLU ``alpha`` or 1-D norm ``scale`` leaves; the weight-norm
    ``weight_g`` and everything else decays."""
    mask = {}
    for tkey, fpath, _, coll in avsr_mapping(model_cfg, prefix=""):
        if coll != "p":
            continue
        decays = not ({"bias", "alpha"} & set(fpath) or fpath[-1] == "scale")
        for key in tkey if isinstance(tkey, list) else [tkey]:
            mask[key] = decays
    return mask


def make_optimizer(model: AVSRModel, cfg: TrainConfig):
    """(AdamW over two parameter groups, its LambdaLR). torch's AdamW
    decays decoupled, p -= lr * wd * p beside the Adam step, which is optax
    ``adamw``'s ``add_decayed_weights`` before the learning-rate scale.
    Global-norm clipping happens in ``train_step``, before ``step()``."""
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
               model: Optional[AVSRModel] = None) -> TrainState:
    """The training state: ``model`` (moved to ``device``) or a new one
    with seeded random weights, the optimizer, its schedule, and the
    run's ``DropoutRng`` from ``seed``."""
    device = torch.device(device)
    if device.type == "cpu":
        warm_exp()
    if model is None:
        from avsr_tpu_torch.core.weights import init_weights

        with torch.device(device):
            model = AVSRModel(model_cfg)
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    model = model.to(device)
    opt, sched = make_optimizer(model, train_cfg)
    return TrainState(train_cfg, model, opt, sched,
                      DropoutRng(seed + 1, device))


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy or torch batch -> torch tensors on ``device`` (int64 ids)."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if not v.is_floating_point() and v.dtype != torch.uint8:
            v = v.to(torch.int64)
        out[k] = v.to(device)
    return out


def loss_fn(model: AVSRModel, batch: Dict[str, torch.Tensor],
            rng: Optional[DropoutRng], train: bool = True,
            compute_dtype: str = "float32"):
    """(loss, metrics) of one batch; ``train`` runs the dropouts (from
    ``rng``) and updates the BatchNorm running statistics."""
    videos, audios = batch["videos"], batch["audios"]
    if videos.dtype == torch.uint8:
        # crops travel as uint8; normalise on the device (data/wire.py)
        videos = (videos.float() / 255.0 - VIDEO_MEAN) / VIDEO_STD
    rest = (batch["labels"], batch["video_lengths"], batch["label_lengths"])
    kw = {"train": train, "rng": rng if train else None}
    if compute_dtype == "float32":
        out = model(videos, audios, *rest, **kw)
    else:
        dt = getattr(torch, compute_dtype)
        params = {n: p.to(dt) for n, p in model.named_parameters()}
        out = functional_call(model, params,
                              (videos.to(dt), audios.to(dt), *rest), kw)
    metrics = {k: getattr(out, k).detach().float() for k in METRICS}
    return out.loss, metrics


def _global_norm(tensors) -> torch.Tensor:
    # sums of squares, not linalg.vector_norm: on the CPU the latter
    # accumulates fp32 with ~1e-4 relative error at 5 M elements (C18)
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum().sqrt()


def train_step(state: TrainState,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One optimizer update in ``state.cfg.compute_dtype``. With a leading
    micro-batch axis on every tensor (videos (A, B, T, H, W, C)) the
    gradient is the mean over the A micro-batches, which run in order and
    thread the BatchNorm statistics; the metrics are their means.
    ``grad_norm`` is the global norm before clipping. Returns device
    tensors (no host sync)."""
    model, opt, cfg = state.model, state.optimizer, state.cfg
    accum = batch["videos"].dim() > 5
    micro = ([{k: v[i] for k, v in batch.items()}
              for i in range(batch["videos"].shape[0])] if accum else [batch])
    opt.zero_grad(set_to_none=True)
    sums = None
    for mb in micro:
        loss, m = loss_fn(model, mb, state.rng, True, cfg.compute_dtype)
        loss.backward()
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
    params = [p for p in model.parameters() if p.grad is not None]
    if accum:
        for p in params:
            p.grad.div_(len(micro))
    metrics = {k: v / len(micro) for k, v in sums.items()}
    grads = [p.grad for p in params]
    norm = _global_norm(grads)
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
    with torch.no_grad():
        return loss_fn(state.model, batch, None, False,
                       state.cfg.compute_dtype)[1]


def save_checkpoint(path: str, state: TrainState) -> None:
    """Blocking save of the model, optimizer, schedule, step and the
    random generators' states."""
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": state.step, "rng": state.rng.state()}, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a ``save_checkpoint`` file into ``state`` (same model config
    and device) and return it."""
    ck = torch.load(path, map_location=state.rng.device, weights_only=True)
    state.model.load_state_dict(ck["model"], strict=True)
    state.optimizer.load_state_dict(ck["optimizer"])
    state.scheduler.load_state_dict(ck["scheduler"])
    state.rng.load_state({k: v.cpu() for k, v in ck["rng"].items()})
    state.step = ck["step"]
    return state
