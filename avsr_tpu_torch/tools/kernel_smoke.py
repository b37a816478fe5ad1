"""Check the port's kernels on the card against their plain twins.

    python -m avsr_tpu_torch.tools.kernel_smoke

Counterpart of ``tools/kernel_smoke.py``: prints the card's nvidia-smi
name and power limit, builds the kernels, runs
``ops/kernels/selfcheck.check_serving_kernels`` on ``cuda:0`` and prints
``serving kernels OK``, then ``check_train_kernels`` and ``ALL KERNELS
OK``. A failed check raises and exits non-zero. Without a CUDA device it
exits non-zero at once, naming the missing card: it never checks the CPU
twins in place of the kernels.
"""

from __future__ import annotations

import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_smoke: torch sees no CUDA device; the kernels can "
              "only be checked on the card", file=sys.stderr)
        return 2
    from avsr_tpu_torch.ops.kernels import _build, selfcheck
    from avsr_tpu_torch.tools import trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(trace.card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    _, seconds = _build.build()
    print(f"kernels built in {seconds:.1f} s", flush=True)
    selfcheck.check_serving_kernels(dev)
    torch.cuda.synchronize()
    print("serving kernels OK", flush=True)
    selfcheck.check_train_kernels(dev)
    torch.cuda.synchronize()
    print("ALL KERNELS OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
