"""Rematerialisation of the encoder layers and the video frontend.

The counterpart of the JAX package's ``nn.remat`` switches
(``avsr_tpu/models/avhubert.py``: ``scan_remat`` around the layer body,
``frontend_remat`` around the ResNet), on ``torch.utils.checkpoint``
(non-reentrant). ``checkpoint(module, args, rng, mode)`` runs
``module(*args)`` and keeps for the backward only its inputs and, by
``mode``:

- ``full``: nothing more (the whole module is recomputed);
- ``ffn``, ``ffn2``, ``qkv_ffn``: the tensors the JAX package names with
  ``checkpoint_name`` (``SAVED``), which the module marks with
  ``mark(x, name)``; a selective-checkpoint policy saves the marker's
  output and recomputes the rest;
- ``dots``: every matmul output (``aten.mm``, ``addmm``, ``bmm``).

Two things JAX's remat gives for free are done here by hand:

- the recompute draws the same randomness: the ``DropoutRng``'s
  generators (dropout masks, flash-attention seeds) are set back to their
  state before the forward for the recompute, then to where they were;
- the recompute of a train-mode BatchNorm does not update its running
  statistics a second time (``recomputing()``, read by
  ``BatchNorm._update``).

The module's parameters are those it had at the forward, so a forward
under ``torch.func.functional_call`` (the trainer's bf16 cast of the fp32
masters) recomputes with the same cast tensors.
"""

from __future__ import annotations

import functools
import threading
from typing import Sequence

import torch
from torch.func import functional_call
from torch.utils import checkpoint as tcp

MODES = ("none", "dots", "full", "ffn", "ffn2", "qkv_ffn")
SAVED = {
    "ffn": ("enc_ffn_act",),
    "ffn2": ("enc_ffn_pre", "enc_ffn_act"),
    "qkv_ffn": ("enc_q", "enc_k", "enc_v", "enc_ffn_pre", "enc_ffn_act"),
}
_aten = torch.ops.aten
_MATMULS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default)
_state = threading.local()


def recomputing() -> bool:
    """True inside a checkpointed module's recompute."""
    return getattr(_state, "recompute", False)


def mark(x: torch.Tensor, name: str) -> torch.Tensor:
    """``checkpoint_name``: under a mode that saves ``name``, an alias of
    ``x`` that the policy saves; ``x`` itself otherwise."""
    if name not in getattr(_state, "names", ()):
        return x
    _state.marking = True
    try:
        return _aten.alias.default(x)
    finally:
        _state.marking = False


def _policy(mode: str, ctx, op, *args, **kwargs):
    if mode == "dots":
        save = op in _MATMULS
    else:
        save = getattr(_state, "marking", False) and op is _aten.alias.default
    return (tcp.CheckpointPolicy.MUST_SAVE if save
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def _context(mode: str):
    return tcp.create_selective_checkpoint_contexts(
        functools.partial(_policy, mode))


def checkpoint(module: torch.nn.Module, args: Sequence, rng=None,
               mode: str = "full"):
    """``module(*args)`` rematerialised in the backward by ``mode``
    (``MODES`` but ``none``); ``rng`` is the ``DropoutRng`` the module
    draws from, or None."""
    if mode not in MODES or mode == "none":
        raise ValueError(f"remat mode {mode!r} not in {MODES[1:]}")
    params = dict(module.named_parameters())
    before = rng.state() if rng is not None else None
    names = SAVED.get(mode, ())
    calls = [0]

    def body(*a):
        calls[0] += 1
        recompute = calls[0] > 1
        now = None
        if recompute and rng is not None:
            now = rng.state()
            rng.load_state(before)
        prev = (getattr(_state, "names", ()), recomputing())
        _state.names, _state.recompute = names, recompute
        try:
            return functional_call(module, params, tuple(a))
        finally:
            _state.names, _state.recompute = prev
            if now is not None:
                rng.load_state(now)

    kw = {}
    if mode != "full":
        kw["context_fn"] = functools.partial(_context, mode)
    return tcp.checkpoint(body, *args, use_reentrant=False, **kw)
