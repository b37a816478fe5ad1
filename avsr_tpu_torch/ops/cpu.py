"""The port's CPU route: torch's CPU exp, warmed once a process.

In a fresh process under CPU contention, the first CPU ``torch.exp`` that
torch's intra-op threads share can come out less accurate (~2^-15
relative); every later call agrees with the next to the bit (ROADMAP C21).
The CPU route calls ``warm_exp`` before its first exp: the kernel wrappers'
plain twins that take exps, ``Recognizer`` and ``init_state`` on the CPU.
"""

from __future__ import annotations

import functools

import torch

# torch's intra-op grain: the elements below which one thread takes a call
_GRAIN = 32768


@functools.cache
def warm_exp() -> None:
    """One CPU exp of which every intra-op thread takes a share."""
    torch.exp(torch.linspace(-30.0, 0.0,
                             _GRAIN * max(2, torch.get_num_threads())))
