"""Device-trace profile of the training step on one CUDA card.

    python -m avsr_tpu_torch.tools.profile_train [--batch 6] [--frames 384]
        [--labels 48] [--remat none] [--frontend-remat] [--unroll 1]
        [--steps 4] [--top 30] [--fp32]

Counterpart of ``tools/profile_train.py``: the flagship train step of
``bench_train`` (``bench_train.setup``: seed-0 weights, a synthetic batch
of ``--batch`` clips of ``--frames`` frames and ``--labels`` tokens, bf16
compute over fp32 masters unless ``--fp32``, the config's dropouts, AdamW
with clipping). ``--unroll`` is accepted and does nothing, as
``scan_unroll`` does in the port (the encoder's layers are a Python
loop). After ``bench_train.WARMUP`` steps, ``--steps`` steps are timed
untraced on the device-synchronised host clock, then ``--steps`` more,
with the same random draws (dropouts, the modality drop), run under
``torch.profiler`` with Python stacks; the trace's device events
(``tools/trace.py``: kernels and copies, self time on each stream) give
the step's device busy time, ms a step by op with launches a step, by the
port's module that launched it, and by the port's kernels. Prints the
card's nvidia-smi name and power limit, the tables and one JSON object
as the last line: the busy, self, traced and untraced wall ms a step, the
idle shares of the traced and untraced step, and the kernels' ms and
launches a step.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from avsr_tpu_torch.models import remat
from avsr_tpu_torch.tools import bench_train, trace
from avsr_tpu_torch.train import trainer as T


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--frames", type=int, default=384)
    ap.add_argument("--labels", type=int, default=48)
    ap.add_argument("--remat", default="none", choices=remat.MODES)
    ap.add_argument("--unroll", type=int, default=1,
                    help="accepted for the JAX tool's flags; no effect")
    ap.add_argument("--frontend-remat", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--fp32", action="store_true")
    args = ap.parse_args(argv)
    # the fields bench_train.setup reads that this tool does not vary
    args.device, args.accum, args.pretrain = "cuda", 1, False
    return args


def profile_steps(state, batch, steps: int) -> tuple:
    """(untraced wall ms a step, traced wall ms a step, ``Summary`` a
    step) of ``steps`` train steps each, after the warm-up steps. Both
    runs take the same random draws (the traced one restarts the state's
    ``DropoutRng``), so they drop the same modalities and do the same
    work."""
    for _ in range(bench_train.WARMUP):
        T.train_step(state, batch)
    draws = state.rng.state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        T.train_step(state, batch)
    torch.cuda.synchronize()
    untraced = 1e3 * (time.perf_counter() - t0) / steps
    state.rng.load_state(draws)
    _, traced, summary, _ = trace.profiled(
        lambda: T.train_step(state, batch), steps, with_stack=True)
    return untraced, traced, summary


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: torch sees no CUDA device")
    smi = trace.card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, batch = bench_train.setup(args)
    untraced, traced, s = profile_steps(state, batch, args.steps)
    print(smi)
    print(f"device busy {s.busy_ms:.3f} ms/step, self times "
          f"{s.total_ms:.3f} ms/step over {args.steps} traced steps "
          f"(untraced wall {untraced:.3f} ms/step -> idle "
          f"{1 - s.busy_ms / untraced:.1%}; traced wall {traced:.3f})")
    print(trace.report(s, args.top, "ms/step"))
    print("port kernels:")
    for name, (ms, count) in sorted(s.kernels.items()):
        print(f"  {ms:10.3f} ms/step  x{count:<6g} {name}")
    print(json.dumps({
        "card": smi, "batch": args.batch, "frames": args.frames,
        "labels": args.labels, "compute_dtype": state.cfg.compute_dtype,
        "remat": args.remat, "frontend_remat": args.frontend_remat,
        "steps": args.steps, "device_busy_ms": s.busy_ms,
        "self_ms": s.total_ms, "untraced_wall_ms": untraced,
        "traced_wall_ms": traced,
        "idle_share_untraced": 1 - s.busy_ms / untraced,
        "idle_share_traced": 1 - s.busy_ms / traced,
        "device_events": s.events, "streams": s.lanes,
        "kernels": {k: {"ms": ms, "launches": n}
                    for k, (ms, n) in s.kernels.items()},
        "sources": s.sources}))


if __name__ == "__main__":
    main()
