"""Entry points: the flagship's loss as a function of its weights, and a
multi-process dry run of training and decoding.

Counterpart of the root ``__graft_entry__.py``:

- ``entry(device="cuda")`` returns ``(fn, args)``: ``fn(*args)`` is the
  flagship ``AVSRModel``'s loss (eval mode) at b=1, t=8, l=6 on inputs
  from ``RandomState(0)``, with the weights as the explicit first
  argument (a state dict, through ``torch.func.functional_call``), seeded
  random weights from seed 0; ``cfg`` replaces the flagship config.
- ``dryrun_multichip(n)`` starts n CPU processes joined over ``gloo``
  through ``core/dist.py``, laid out as the JAX dry run lays n devices
  out: a model axis of 2 when n is even and at least 4 (tensor
  parallelism, ``core/tensor_parallel.py``), else 1, and a data axis of
  the rest. They run one full train step of a tiny config (loss,
  gradients all-reduced, clipping, AdamW) on a global batch of n clips of
  4 frames and 3 labels, each data rank on its share, check step 1 and a
  finite loss, and rank 0 prints the mesh, the loss and the gradient
  norm; then each rank loads the gathered weights into an unsharded model
  and decodes its share of n utterances with beam 2 (a data axis of n),
  and rank 0 gathers the token lists and prints their lengths.

    python -m avsr_tpu_torch.dryrun [N]

runs ``dryrun_multichip(N)`` (2 by default).
"""

from __future__ import annotations

import os
import socket
import sys

import numpy as np
import torch

TINY = dict(odim=31, adim=16, ddim=16, dheads=2, dunits=32, dlayers=1)
TINY_ENCODER = dict(encoder_embed_dim=16, num_hidden_layers=1,
                    num_attention_heads=2, intermediate_size=32,
                    num_conv_pos_embeddings=8,
                    num_conv_pos_embedding_groups=2)


def entry(device="cuda", cfg=None):
    """(fn, args): ``fn(weights, videos, audios, labels, video_lengths,
    label_lengths)`` is the model's loss; ``args`` the seed-0 weights (a
    state dict on ``device``) and the b=1, t=8, l=6 inputs."""
    from torch.func import functional_call

    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.models.e2e import AVSRModel

    cfg = cfg or AVHubertAVSRConfig()
    dev = torch.device(device)
    with torch.device(dev):
        model = AVSRModel(cfg).eval()
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    b, t, l = 1, 8, 6
    rng = np.random.RandomState(0)
    videos = rng.randn(b, t, 88, 88, 1).astype(np.float32)
    audios = rng.randn(b, t, 104).astype(np.float32)
    labels = rng.randint(1, cfg.odim - 1, size=(b, l))
    inputs = [torch.from_numpy(x).to(dev) for x in (
        videos, audios, labels, np.full((b,), t), np.full((b,), l))]

    def fn(weights, videos, audios, labels, video_lengths, label_lengths):
        out = functional_call(model, weights, (videos, audios, labels,
                                               video_lengths, label_lengths))
        return out.loss

    return fn, (dict(model.state_dict()), *inputs)


def tiny_config():
    """The JAX dry run's tiny model: 1x16 encoder, 1x16 decoder, vocab 31."""
    from avsr_tpu_torch.core.config import (AVHubertAVSRConfig,
                                            AVHubertEncoderConfig)

    return AVHubertAVSRConfig(**TINY,
                              encoder=AVHubertEncoderConfig(**TINY_ENCODER))


def _rank(rank: int, n: int, port: int, out) -> None:
    """One rank of ``dryrun_multichip``; puts (rank, text printed) on
    ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from avsr_tpu_torch.core import dist
    from avsr_tpu_torch.core import tensor_parallel as tp
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models.e2e import AVSRModel
    from avsr_tpu_torch.train import trainer as T

    lines = []
    model_par = 2 if n % 2 == 0 and n >= 4 else 1
    dist.init("cpu", data_parallel=n // model_par, model_parallel=model_par)
    try:
        cfg = tiny_config()
        b, t, l = n, 4, 3
        rng = np.random.RandomState(0)
        batch = {
            "videos": rng.randn(b, t, 88, 88, 1).astype(np.float32),
            "audios": rng.randn(b, t, 104).astype(np.float32),
            "labels": rng.randint(1, 30, size=(b, l)),
            "video_lengths": np.full((b,), t),
            "label_lengths": np.full((b,), l),
        }
        per = n // dist.data_size()
        d = dist.data_rank()
        shard = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
        state = T.init_state(cfg, T.TrainConfig(warmup_steps=2,
                                                max_steps=10),
                             seed=0, device="cpu")
        metrics = T.train_step(state, T.to_device(shard, "cpu"))
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        if state.step != 1 or not np.isfinite(loss):
            raise RuntimeError(f"rank {rank}: step {state.step}, loss {loss}")
        mesh = {"data": dist.data_size(), "model": dist.model_size()}
        lines.append(f"dryrun_multichip({n}): mesh={mesh} loss={loss:.4f} "
                     f"grad_norm={norm:.4f}")

        # serving weights whole on every rank (the train state may hold
        # tensor-parallel slices); the decode mesh is a data axis of n
        model = AVSRModel(cfg)
        model.load_state_dict(tp.full_state_dict(state.model))
        mesh = {"data": n, "model": 1}
        rec = Recognizer(model=model, cfg=cfg, beam_size=2,
                         t_buckets=(8,), device="cpu")
        rng = np.random.RandomState(1)
        feats_a = [rng.randn(t, 104).astype(np.float32) for _ in range(n)]
        feats_v = [rng.randn(t, 88, 88, 1).astype(np.float32)
                   for _ in range(n)]
        # one utterance a rank; rank 0 gathers the token lists
        tokens = rec.transcribe_batch([feats_a[rank]], [feats_v[rank]],
                                      mode="beam")
        gathered = [None] * n if rank == 0 else None
        dist.tdist.gather_object([int(tk) for tk in tokens[0]], gathered,
                                 dst=0)
        if rank == 0:
            if len(gathered) != n:
                raise RuntimeError(f"{len(gathered)} token lists of {n}")
            lines.append(f"dryrun_multichip({n}): decode mesh={mesh} beam "
                         f"decode ok (lens={[len(tk) for tk in gathered]})")
    finally:
        dist.close()
        out.put((rank, "\n".join(lines)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """One train step (data x model as the JAX dry run lays the devices
    out) and a beam-2 decode over ``n_devices`` CPU processes (``gloo``);
    raises if a rank fails or hangs."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, n_devices, port, out))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    texts = {}
    try:
        # drain the queue before joining its writers
        for _ in procs:
            rank, text = out.get(timeout=timeout)
            texts[rank] = text
        for p in procs:
            p.join(timeout=60)
    except queue.Empty:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks "
                           f"{sorted(set(range(n_devices)) - set(texts))} "
                           f"sent nothing in {timeout:.0f} s") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad or len(texts.get(0, "").splitlines()) != 2:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {bad} "
                           f"failed; rank 0 printed {texts.get(0)!r}")
    print(texts[0], flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
