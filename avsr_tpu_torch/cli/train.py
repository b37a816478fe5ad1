"""Training CLI, flag-compatible with the JAX package's ``cli/train.py``
(the reference script/train.py:171-188), plus ``--device``.

    python -m avsr_tpu_torch.cli.train --synthetic_dataset --max_steps 8 ...
    torchrun --nproc_per_node N -m avsr_tpu_torch.cli.train ...
    torchrun --nproc_per_node 4 -m avsr_tpu_torch.cli.train \
        --data_parallel 2 --model_parallel 2 ...

Joint CTC/attention fine-tuning (or with ``--pretrain`` AV-HuBERT
masked-prediction pretraining) through ``train/loop.run_training``, on
``cuda`` unless ``--device cpu``; under ``torchrun`` over the processes,
one card each (``core/dist.py``; ``--multihost`` asks for that
environment), laid out as ``--data_parallel`` x ``--model_parallel``
(their product is the world size; the data size defaults to the world
over the model size): each model group of ``--model_parallel`` ranks
runs the JAX package's Megatron layout on one shard of the batch
(``core/tensor_parallel.py``), the global batch is ``--batch_size`` x
the data size. ``--synthetic_dataset``
trains on deterministic synthetic samples without network or media
backends. ``--model_name_or_path`` loads a reference-format directory
(``config.json`` and the state dict), which also sets the model config.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="AVSR training (PyTorch/CUDA)")
    p.add_argument("--streaming_dataset", action="store_true", default=False)
    p.add_argument("--include_mcorec", action="store_true", default=False)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--max_steps", type=int, default=400000)
    p.add_argument("--gradient_accumulation_steps", type=int, default=2)
    p.add_argument("--save_steps", type=int, default=2000)
    p.add_argument("--save_total_limit", type=int, default=500,
                   help="keep at most N checkpoints (reference "
                        "save_total_limit, script/train.py:280)")
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--log_interval", type=int, default=25)
    p.add_argument("--dataloader_num_workers", type=int, default=10)
    p.add_argument("--dataloader_use_processes", action="store_true",
                   default=False,
                   help="spawn process pool for collation (GIL-free)")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=4000)
    p.add_argument("--resume_from_checkpoint", action="store_true",
                   default=False)
    p.add_argument("--checkpoint_name", type=str,
                   default="avsr_avhubert_ctcattn")
    p.add_argument("--model_name_or_path", type=str,
                   default="./model-bin/avsr_cocktail")
    p.add_argument("--report_to", type=str, default="none")
    p.add_argument("--output_dir", type=str, default="./model-bin")
    p.add_argument("--synthetic_dataset", action="store_true", default=False,
                   help="train on deterministic synthetic AV data (no "
                        "network)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="forward/backward dtype over fp32 master weights")
    p.add_argument("--data_parallel", type=int, default=None,
                   help="data-parallel size (default: the torchrun world "
                        "size over --model_parallel)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel size: attention heads and FFN "
                        "columns split over this many ranks (Megatron "
                        "layout)")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="train over the processes torchrun describes in "
                        "the environment (each reads its own data shards)")
    p.add_argument("--scan_unroll", type=int, default=1,
                   help="the JAX package's XLA scan unroll; kept in the "
                        "config, no effect here")
    p.add_argument("--scan_remat", type=str, default="none",
                   choices=["none", "dots", "full", "ffn", "ffn2", "qkv_ffn"],
                   help="encoder-layer rematerialization in backward: trade "
                        "recompute for memory so larger batches fit")
    p.add_argument("--frontend_remat", action="store_true", default=False,
                   help="rematerialize the video ResNet frontend in "
                        "backward")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of steps 10-12 here")
    p.add_argument("--pretrain", action="store_true", default=False,
                   help="AV-HuBERT masked-prediction pretraining instead of "
                        "CTC/attention fine-tuning (train/pretrain.py); the "
                        "run's 'hubert' weights load into AVSRModel "
                        "fine-tuning")
    p.add_argument("--use_flash_attention", type=str, default="auto",
                   choices=["auto", "true", "false"],
                   help="recorded in the config; the port's encoder always "
                        "runs its flash-attention wrapper (the kernels on "
                        "the card, their twins on the CPU). 'auto' = on "
                        "when the device is cuda")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (one card a process) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from avsr_tpu_torch.core import dist

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to train on the CPU")
    if args.multihost and "WORLD_SIZE" not in os.environ:
        sys.exit("--multihost needs torchrun's environment (WORLD_SIZE, "
                 "RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    device = dist.init(args.device, args.data_parallel, args.model_parallel)
    main_rank = dist.is_main()

    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.data.collate import DataCollator
    from avsr_tpu_torch.data.dataset import shard_for_host
    from avsr_tpu_torch.data.tokenizer import TextTransform
    from avsr_tpu_torch.data.transforms import AudioTransform, VideoTransform
    from avsr_tpu_torch.train.loop import LoopConfig, run_training
    from avsr_tpu_torch.train.trainer import TrainConfig

    output_dir = os.path.join(args.output_dir, args.checkpoint_name)
    if main_rank:
        os.makedirs(output_dir, exist_ok=True)

    text_transform = TextTransform()

    pretrained = None
    model_cfg = AVHubertAVSRConfig(odim=text_transform.vocab_size)
    if args.model_name_or_path and os.path.exists(args.model_name_or_path):
        from avsr_tpu_torch.core.weights import load_released

        if main_rank:
            print(f"Loading pretrained model from {args.model_name_or_path}")
        model_cfg, model = load_released(args.model_name_or_path)
        pretrained = model.state_dict()
        del model
    elif main_rank:
        print("Training from scratch (random init)")

    if args.use_flash_attention == "auto":
        model_cfg.encoder.use_flash_attention = device.type == "cuda"
    else:
        model_cfg.encoder.use_flash_attention = (
            args.use_flash_attention == "true")
    if model_cfg.encoder.use_flash_attention and main_rank:
        print("Flash attention: on")
    model_cfg.encoder.scan_unroll = args.scan_unroll
    model_cfg.encoder.scan_remat = args.scan_remat
    model_cfg.encoder.frontend_remat = args.frontend_remat

    if args.synthetic_dataset:
        from avsr_tpu_torch.data.dataset import synthetic_samples

        n = (args.batch_size * dist.data_size()
             * args.gradient_accumulation_steps * (args.max_steps + 1))
        train_samples = shard_for_host(synthetic_samples(n, seed=0))
        valid_fn = lambda: synthetic_samples(  # noqa: E731
            args.batch_size * 4, seed=1
        )
        interferer = None
    else:
        from avsr_tpu_torch.data.dataset import (InterfererPool,
                                                 load_avsr_mixture)

        train_ds, valid_ds, interferer_ds = load_avsr_mixture(
            include_mcorec=args.include_mcorec,
            streaming=args.streaming_dataset)
        train_samples = shard_for_host(train_ds)
        valid_fn = lambda: valid_ds  # noqa: E731
        # draws come from a rotating pool of decoded waveforms that a
        # background thread refreshes: the collator never decodes one
        interferer = InterfererPool(interferer_ds, size=256)

    collator = DataCollator(
        text_transform=text_transform,
        # uint8 crops to the card, normalised there (trainer.loss_fn)
        video_transform=VideoTransform("train", device_norm=True),
        audio_transform=AudioTransform("train", sample_interferer=interferer),
        seed=11,
    )
    valid_collator = DataCollator(
        text_transform=text_transform,
        video_transform=VideoTransform("test", device_norm=True),
        audio_transform=AudioTransform("test"),
    )

    pretrain_cfg = None
    if args.pretrain:
        from avsr_tpu_torch.train.pretrain import (PretrainCollator,
                                                   PretrainConfig)

        pretrain_cfg = PretrainConfig()
        collator = PretrainCollator(collator, pretrain_cfg, seed=11)
        valid_collator = PretrainCollator(valid_collator, pretrain_cfg)

    if main_rank:
        mesh = {"data": dist.data_size(), "model": dist.model_size()}
        print(f"Mesh: {mesh}; {dist.world_size()} process(es); device "
              f"{device}")

    loop_cfg = LoopConfig(
        output_dir=output_dir,
        max_steps=args.max_steps,
        batch_size=args.batch_size,
        grad_accum=args.gradient_accumulation_steps,
        save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        eval_steps=args.eval_steps,
        log_interval=args.log_interval,
        num_workers=args.dataloader_num_workers,
        use_process_workers=args.dataloader_use_processes,
        report_to=args.report_to,
        run_name=args.checkpoint_name,
        profile_dir=args.profile_dir,
    )
    train_cfg = TrainConfig(
        learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        max_steps=args.max_steps,
        compute_dtype=args.compute_dtype,
    )
    try:
        return run_training(
            model_cfg,
            loop_cfg,
            train_samples,
            collator,
            valid_samples=valid_fn,
            valid_collator=valid_collator,
            pretrained_variables=pretrained,
            train_cfg=train_cfg,
            resume_from_checkpoint=args.resume_from_checkpoint,
            pretrain_cfg=pretrain_cfg,
            device=device,
        )
    finally:
        dist.close()


if __name__ == "__main__":
    main()
