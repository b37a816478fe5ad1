"""Training-time randomness: dropout masks, flash-attention seeds, the
modality draw.

Every draw of a training step comes from one ``DropoutRng``, which the
trainer creates from a seed and owns: masks from a generator on the
activations' device, and the few scalars (the two seed words of each
flash-attention call, the whole-batch modality draw) from a host
generator, so that no draw makes the host wait for the card. Under data
parallelism (``rank``, the data rank, > 0) the masks and flash seeds
differ between ranks, as the JAX package's do over the shards of one
global batch, while the ranks of one model group, which hold one shard,
draw alike; the whole-batch modality draw comes from a third generator
seeded alike on every rank: one draw over the global batch, as in JAX. The JAX
package draws from ``jax.random`` keys; the two never give the same
numbers, so the parity tests run with every rate at 0 or hand both sides
the same explicit mask.
"""

from __future__ import annotations

from typing import Optional

import torch


RANK_STRIDE = 1_000_003  # seed offset between ranks' mask streams


class DropoutRng:
    def __init__(self, seed: int, device="cpu", rank: int = 0):
        self.device = torch.device(device)
        own = seed + RANK_STRIDE * rank
        self.gen = torch.Generator(device=self.device).manual_seed(own)
        self.host = torch.Generator().manual_seed(own + 1)
        self.shared = torch.Generator().manual_seed(seed + 2)

    def flash_seed(self) -> tuple[int, int]:
        """Two uint32 words keying one flash-attention call's dropout."""
        s0, s1 = torch.randint(0, 2**32, (2,), generator=self.host).tolist()
        return s0, s1

    def uniform(self, n: int) -> list[float]:
        """n uniforms in [0, 1) on the host, the same on every rank."""
        return torch.rand(n, generator=self.shared,
                          dtype=torch.float64).tolist()

    def state(self) -> dict:
        return {"gen": self.gen.get_state(), "host": self.host.get_state(),
                "shared": self.shared.get_state()}

    def load_state(self, state: dict) -> None:
        self.gen.set_state(state["gen"])
        self.host.set_state(state["host"])
        self.shared.set_state(state["shared"])


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRng],
            shard: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the kept
    entries by 1 / (1 - rate) in x's dtype; the identity without ``rng``
    (eval) or at rate 0. ``shard`` = (dim, rank, size): x is slice ``rank``
    of ``size`` along ``dim`` of a wider activation (a tensor-parallel
    block's); the mask is drawn at the wider shape and sliced, so every
    model rank takes the generator's draw of one model size."""
    if rng is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if shard is not None:
        dim, rank, size = shard
        shape[dim] *= size
    mask = torch.rand(shape, generator=rng.gen, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(dim, rank * x.shape[dim], x.shape[dim])
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
