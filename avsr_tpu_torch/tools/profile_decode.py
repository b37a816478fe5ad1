"""Device-trace profile of the batched beam decode on one CUDA card.

    python -m avsr_tpu_torch.tools.profile_decode [--batch 16]
        [--frames 375] [--top 40] [--encode_dtype bfloat16]
        [--fused_bookkeeping 1]

Counterpart of ``tools/profile_decode.py``: the flagship model (24x1024
encoder, 6x1024 decoder, vocab 5049) with seed-0 weights, as
``profile_serving.flagship_recognizer`` builds it (bf16 decoder weights
and K|V cache, the 192-token cap, the delta2 wire), joint CTC/attention
beam 3 at ``ctc_weight=0.1`` in its device loop, on ``--batch``
synthetic utterances of ``--frames`` frames. After one warm-up
``transcribe_batch`` in beam mode, one more is timed on the
device-synchronised host clock and one more runs under
``torch.profiler``; the trace's device events (``tools/trace.py``) give
the batch's device busy time, the sum of the ops' self times and, by op,
each op's ms and count (in-loop ops appear once a step, ~375 times) and
by source. Prints the card's nvidia-smi name and power limit, the table,
and one JSON object as the last line: the busy, untraced and traced wall
ms, the device-side audio-s/s, the idle shares of the untraced and the
traced batch and the beam loop's steps, host reads, replays and captures
(``beam_search_batched.last_run``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from avsr_tpu_torch.tools import trace
from avsr_tpu_torch.tools.profile_serving import flagship_recognizer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=375)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--encode_dtype", default="bfloat16")
    ap.add_argument("--fused_bookkeeping", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: torch sees no CUDA device")
    smi = trace.card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from avsr_tpu_torch.data.synthetic import synthetic_batch
    from avsr_tpu_torch.decode.beam import beam_search_batched

    dev = torch.device("cuda:0")
    rec = flagship_recognizer(dev, frames=args.frames,
                              encode_dtype=args.encode_dtype,
                              fused_bookkeeping=bool(args.fused_bookkeeping))
    audio, video = synthetic_batch(np.random.RandomState(0),
                                   [args.frames] * args.batch)
    rec.transcribe_batch(audio, video, mode="beam")  # warm-up, graphs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.transcribe_batch(audio, video, mode="beam")
    torch.cuda.synchronize()
    untraced = 1e3 * (time.perf_counter() - t0)
    _, wall, summary, _ = trace.profiled(
        lambda: rec.transcribe_batch(audio, video, mode="beam"),
        with_stack=True)
    audio_s = args.batch * args.frames / 25.0
    print(smi)
    print(f"device busy {summary.busy_ms:.3f} ms/batch; wall "
          f"{untraced:.3f} ms untraced (idle "
          f"{1 - summary.busy_ms / untraced:.1%}), {wall:.3f} ms traced "
          f"({audio_s:.0f} audio-s => "
          f"{audio_s / summary.busy_ms * 1e3:.1f} audio-s/s device-side); "
          f"self times sum to {summary.total_ms:.3f} ms over "
          f"{summary.events} device events on {summary.lanes} streams")
    print(trace.report(summary, args.top))
    print(json.dumps({
        "card": smi, "batch": args.batch, "frames": args.frames,
        "encode_dtype": args.encode_dtype,
        "fused_bookkeeping": bool(args.fused_bookkeeping),
        "device_busy_ms": summary.busy_ms, "self_ms": summary.total_ms,
        "untraced_wall_ms": untraced, "traced_wall_ms": wall,
        "idle_share_untraced": 1 - summary.busy_ms / untraced,
        "idle_share_traced": 1 - summary.busy_ms / wall,
        "device_audio_s_per_s": audio_s / summary.busy_ms * 1e3,
        "device_events": summary.events,
        "loop": dict(beam_search_batched.last_run)}))


if __name__ == "__main__":
    main()
