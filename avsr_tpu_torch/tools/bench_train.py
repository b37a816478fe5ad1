"""Training-step benchmark of the port on the flagship model.

    python -m avsr_tpu_torch.tools.bench_train [--batch 6] [--frames 384]
        [--labels 48] [--steps 10] [--accum 1] [--fp32] [--device cuda]
        [--remat none] [--frontend-remat] [--pretrain] [--trace PATH]

Counterpart of the root ``bench_train.py`` (the JAX package's training
entry at realistic shapes): AV-HuBERT-large joint CTC/attention
fine-tuning of the flagship configuration (24x1024 encoder, ResNet-18
frontend, 6x1024 decoder, vocab 5049) with random weights from seed 0, on a
synthetic batch of ``--batch`` clips of ``--frames`` frames (384: 15 s
padded to the 384 bucket) and ``--labels`` tokens; bf16 compute over fp32
master weights unless ``--fp32``; the config's dropouts on, attention
dropout inside the flash kernels; AdamW with clipping (``TrainConfig``
defaults). ``--remat`` (the encoder layers: none, dots, full, ffn, ffn2,
qkv_ffn) and ``--frontend-remat`` rematerialise in the backward
(``models/remat.py``); ``--pretrain`` trains the AV-HuBERT
masked-prediction objective at the same shapes instead (span masks, the
'same_seq' video gather, random cluster targets), as the root
``bench_train.py`` does. Runs on ``cuda`` unless ``--device cpu``.

Counts the model FLOPs of a step with ``torch.utils.flop_counter.
FlopCounterMode`` over one sample's forward and backward with remat off
(the recompute is overhead, not model work), times the step's samples,
plus the flash kernels', which it cannot see, at 4 N T^2 D a forward
call and 2.5 times that a backward. After two untimed steps, times
``--steps`` steps on the device-synchronised host clock and prints one
JSON line: ``sec_per_step``, ``samples_per_sec``, ``step_tflops`` (those
model FLOPs), ``mfu`` (those FLOPs
over the step time and the H100 SXM dense bf16 peak, 989 TFLOP/s; null on
the CPU), ``loss``, ``grad_norm`` (of the last step), ``peak_mem_gb``
(null on the CPU) and the kernels' launches per timed step (the three
flash kernels, the CTC loss's two, and the four of the fused stem tail,
which run when ``AVSR_FUSED_STEM=1`` is set, the JAX package's switch). With
``--trace`` (card only) one more step runs under ``torch.profiler``: the
record gains the device's busy time (the union of the CUDA op intervals),
its idle share of the traced step and of the untraced step time, and the
top device operations; the per-kernel table goes to PATH.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVHubertAVSRConfig
from avsr_tpu_torch.data.synthetic import synthetic_train_batch
from avsr_tpu_torch.models import remat
from avsr_tpu_torch.ops.kernels import ctc_loss as pcl
from avsr_tpu_torch.ops.kernels import flash_attention as pfa
from avsr_tpu_torch.ops.kernels import stem_fuse as psf
from avsr_tpu_torch.train import trainer as T

H100_PEAK_BF16 = 989e12  # dense bf16 FLOP/s of one H100 SXM (data sheet)
WARMUP = 2  # untimed steps: allocator and cuDNN engine choice settle
SEED = 0
FLASH = (pfa.flash_attention_fwd, pfa.flash_attention_bwd_dq,
         pfa.flash_attention_bwd_dkv)
STEM = (psf.bn_prelu_pool_stats, psf.bn_prelu_pool_apply,
        psf.bn_prelu_pool_bwd1, psf.bn_prelu_pool_bwd2)
CTC = (pcl.ctc_loss_fwd, pcl.ctc_loss_bwd)
KERNELS = FLASH + STEM + CTC


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--frames", type=int, default=384)
    ap.add_argument("--labels", type=int, default=48)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--remat", default="none", choices=remat.MODES)
    ap.add_argument("--frontend-remat", action="store_true")
    ap.add_argument("--pretrain", action="store_true",
                    help="AV-HuBERT masked-prediction objective at the same "
                         "shapes (mask gather + cosine-logit head instead of "
                         "the CTC/CE decoder)")
    ap.add_argument("--trace", default=None,
                    help="profile one more step; per-kernel table to PATH")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    return args


def setup(args, model_cfg: Optional[AVHubertAVSRConfig] = None):
    """(train state, device batch) for ``args``; the flagship config
    unless ``model_cfg`` is given."""
    cfg = model_cfg or AVHubertAVSRConfig()
    cfg.encoder.scan_remat = args.remat
    cfg.encoder.frontend_remat = args.frontend_remat
    tcfg = T.TrainConfig(compute_dtype="float32" if args.fp32 else "bfloat16")
    pcfg = None
    if args.pretrain:
        from avsr_tpu_torch.train.pretrain import PretrainConfig

        pcfg = PretrainConfig()
    state = T.init_state(cfg, tcfg, seed=SEED, device=args.device,
                         pretrain_cfg=pcfg)
    rng = np.random.RandomState(SEED)
    if pcfg is not None:
        mbs = [_pretrain_batch(rng, args, pcfg) for _ in range(args.accum)]
    else:
        mbs = [synthetic_train_batch(rng, args.batch, args.frames,
                                     args.labels,
                                     vocab=min(5000, cfg.odim - 1))
               for _ in range(args.accum)]
    batch = mbs[0] if args.accum == 1 else {
        k: np.stack([b[k] for b in mbs]) for k in mbs[0]}
    return state, T.to_device(batch, args.device)


def _pretrain_batch(rng, args, pcfg):
    """The root ``bench_train.py --pretrain`` batch: N(0, 1) clips, span
    masks and the 'same_seq' gather map, random cluster targets."""
    from avsr_tpu_torch.train.pretrain import sample_pretrain_masks

    b, t = args.batch, args.frames
    audio_mask, _, src = sample_pretrain_masks(pcfg, b, t, rng=rng)
    return {
        "videos": rng.randn(b, t, 88, 88, 1).astype(np.float32),
        "audios": rng.randn(b, t, 104).astype(np.float32),
        "audio_mask": audio_mask,
        "video_src_index": src,
        "targets": rng.randint(0, pcfg.num_classes, (b, t)).astype(np.int32),
        "video_lengths": np.full((b,), t, np.int32),
    }


def flash_flops(cfg, args) -> tuple[float, float]:
    """Model FLOPs of one flash forward call and of one backward (the
    dq + dkv pair) at the step's shapes: 4 N T^2 D, and 2.5 times that.
    ``cfg`` is the model's config or its encoder's."""
    enc = getattr(cfg, "encoder", cfg)
    t = -(-args.frames // 128) * 128  # mha_flash pads T to 128
    n = args.batch * enc.num_attention_heads
    d = enc.encoder_embed_dim // enc.num_attention_heads
    fwd = 4.0 * n * t * t * d
    return fwd, 2.5 * fwd


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def model_flops(state: T.TrainState, batch, args) -> float:
    """Model FLOPs of one step: one sample's forward and backward counted
    with remat off, times the step's samples (every op is linear in the
    batch), plus the flash kernels' analytic FLOPs at the full batch."""
    from torch.utils.flop_counter import FlopCounterMode

    enc = state.model.hubert.cfg if args.pretrain else state.model.cfg.encoder
    saved = enc.scan_remat, enc.frontend_remat
    enc.scan_remat, enc.frontend_remat = "none", False
    first = {k: v[0] if args.accum > 1 else v for k, v in batch.items()}
    one = {k: v[:1] for k, v in first.items()}
    for fn in FLASH:
        fn.launches = 0
    try:
        with FlopCounterMode(display=False) as counter:
            loss, _ = T.loss_fn(state.model, one, state.rng, True,
                                state.cfg.compute_dtype)
            loss.backward()
    finally:
        enc.scan_remat, enc.frontend_remat = saved
        state.optimizer.zero_grad(set_to_none=True)
    fwd, bwd = flash_flops(enc, args)
    # kernels are invisible to the counter; the CPU twins are not
    return args.accum * (args.batch * counter.get_total_flops()
                         + FLASH[0].launches * fwd + FLASH[1].launches * bwd)


def measure(state: T.TrainState, batch, args) -> dict:
    """Model FLOPs, warm-up steps, timed steps, the JSON record."""
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    step_flops = model_flops(state, batch, args)
    for _ in range(WARMUP):
        T.train_step(state, batch)
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = T.train_step(state, batch)
    _sync(dev)
    sec = (time.perf_counter() - t0) / args.steps
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "batch": args.batch, "frames": args.frames, "labels": args.labels,
        "accum": args.accum, "compute_dtype": state.cfg.compute_dtype,
        "remat": args.remat, "frontend_remat": args.frontend_remat,
        "pretrain": args.pretrain,
        "steps": args.steps,
        "sec_per_step": sec,
        "samples_per_sec": args.batch * args.accum / sec,
        "step_tflops": step_flops / 1e12,
        "mfu": step_flops / sec / H100_PEAK_BF16 if cuda else None,
        "loss": metrics["loss"].item(),
        "grad_norm": metrics["grad_norm"].item(),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None),
        "launches_per_step": {fn.__name__: fn.launches / args.steps
                              for fn in KERNELS},
    }


def trace(state: T.TrainState, batch, sec_per_step: float,
          path: str) -> dict:
    """One step under torch.profiler: device busy ms, op count, idle
    shares, the top device operations; the table to ``path``."""
    from avsr_tpu_torch.tools import trace as tr

    _, wall, summary, prof = tr.profiled(lambda: T.train_step(state, batch))
    busy = summary.busy_ms
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=80) + "\n")
    return {"traced_wall_ms": wall, "device_busy_ms": busy,
            "device_ops": summary.events,
            "idle_share_traced": 1 - busy / wall,
            "idle_share_untraced": 1 - busy / (1e3 * sec_per_step),
            "top_device_ms": {name: ms for name, ms, _ in summary.top(10)}}


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif args.trace:
        raise SystemExit("--trace needs the card")
    state, batch = setup(args)
    res = measure(state, batch, args)
    if args.trace:
        res["trace"] = trace(state, batch, res["sec_per_step"], args.trace)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
