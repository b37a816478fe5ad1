"""The beam's step loop with one host read every k steps, and on the card
as replays of CUDA graphs.

Counterpart of the JAX beam's one ``jax.lax.while_loop``
(``avsr_tpu/decode/beam.py`` ``cond`` and ``body``). The step is a
function of fixed-shape state tensors whose index ``i`` lives on the
device, where the kernels read it (``decode/beam.py`` ``beam_step``). The
host still decides when to stop, from the stop flag, but reads it once
every ``k`` steps (``STOP_EVERY`` by default), after steps k, 2k, ...
and the last: a run of ``steps`` steps makes ceil(steps / k) reads. The
steps past the one where every lane stopped leave the result as it is
(the lanes are masked), and no step runs at or past the largest frame
count, which the host knows.

On the card, step 0 runs eagerly (it builds the kernels, sizes their
scratch and warms the libraries on the loop's stream); the steps up to
the next read, and each later run of steps between two reads, run as one
replay of a CUDA graph captured once: ``n`` steps of the step function
into the state's own buffers. The graphs of a search are kept per owner
(the model whose ``decoder_step`` it is) and per shape and configuration
(``GRAPHS_KEPT`` of them), so a later batch of the same shape copies its
state in and replays without a capture. A capture that fails raises; no
path falls back to the Python loop. Replays do not pass through the
kernels' Python wrappers, so each graph records the launches its capture
made of each kernel and every replay adds them to the wrappers' counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable

import torch

STOP_EVERY = 8  # steps between two reads of the stop flag
GRAPHS_KEPT = 4  # searches of other shapes kept per owner

_STREAMS: dict = {}
_LOCK = threading.Lock()  # one search on the loop streams at a time
_ENTRIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_POOLS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def leaves(x) -> list:
    """The tensors of a state, in order: tensors, tuples, lists and
    dataclasses are walked; None and plain values are left out."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in leaves(e)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in leaves(getattr(x, f.name))]
    if x is None or isinstance(x, (bool, int, float, str)):
        return []
    raise TypeError(f"a loop state holds no {type(x).__name__}")


def signature(x) -> tuple:
    """The shapes, dtypes and devices of a state's tensors."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(x))


def copy_into(dst, src) -> None:
    """dst's tensors take src's values, where src's are other tensors."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        if s is not d:
            d.copy_(s)


def launch_counts() -> dict:
    """Every kernel wrapper's launch counters: (function, attribute) ->
    count."""
    from avsr_tpu_torch.ops.kernels import (beam_update, decode_attention,
                                            decoder_layer, row_gather,
                                            scan_logsumexp, topk)

    out = {}
    for mod in (beam_update, decode_attention, decoder_layer, row_gather,
                scan_logsumexp, topk):
        for fn in vars(mod).values():
            if callable(fn) and getattr(fn, "__module__", "") == mod.__name__:
                for attr, n in vars(fn).items():
                    if attr.endswith("launches") and isinstance(n, int):
                        out[(fn, attr)] = n
    return out


@contextlib.contextmanager
def on_loop_stream(dev):
    """Within the block, the current stream is the device's loop stream
    (a capture needs one that is not the default stream, and the step
    warms its libraries on the stream it is captured on), after the
    caller's stream, and no other thread runs a search (the cached
    graphs' buffers are shared); the caller's stream waits for it after
    the block. Yields the caller's stream, on which tensors made in the
    block and handed out must be recorded."""
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    caller = torch.cuda.current_stream(dev)
    with _LOCK:
        stream = _STREAMS.get(dev.index)
        if stream is None:
            stream = _STREAMS[dev.index] = torch.cuda.Stream(dev)
        stream.wait_stream(caller)
        try:
            with torch.cuda.stream(stream):
                yield caller
        finally:
            caller.wait_stream(stream)


class _Search:
    """One shape's graphs: the state and inputs they read and write, and
    per number of steps (graph, the launches its capture made, its ms)."""

    def __init__(self, state, inputs):
        self.state, self.inputs = state, inputs
        self.graphs = {}


def _search(key, state, inputs):
    """The cached search of ``key``'s owner and shape, with this batch's
    state and inputs copied in; else a new one holding them."""
    cfg, step_fn = key
    owner = getattr(step_fn, "__self__", step_fn)
    ident = (cfg, getattr(step_fn, "__func__", step_fn), signature(state),
             signature(inputs))
    searches = _ENTRIES.setdefault(owner, OrderedDict())
    found = searches.get(ident)
    if found is None:
        found = searches[ident] = _Search(state, inputs)
        if len(searches) > GRAPHS_KEPT:
            torch.cuda.synchronize()  # nothing still reads the oldest
            searches.popitem(last=False)
    else:
        copy_into((found.state, found.inputs), (state, inputs))
        searches.move_to_end(ident)
    if owner not in _POOLS:
        _POOLS[owner] = torch.cuda.graph_pool_handle()
    return found, _POOLS[owner]


def _capture(search, pool, step: Callable, n: int, stats: dict):
    """Captures n steps into the search's state buffers: (graph, launches
    a replay makes, ms the capture took). The capture's own counts are
    taken back."""
    before = launch_counts()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          stream=torch.cuda.current_stream(),
                          capture_error_mode="thread_local"):
        st = search.state
        for _ in range(n):
            st = step(st, search.inputs)
        copy_into(search.state, st)
        del st
    ms = 1e3 * (time.perf_counter() - t0)
    stats["captures"] += 1
    stats["capture_ms"] += ms
    delta = {}
    for (fn, attr), n_after in launch_counts().items():
        n_before = before.get((fn, attr), 0)
        if n_after != n_before:
            delta[(fn, attr)] = n_after - n_before
            setattr(fn, attr, n_before)
    return graph, delta, ms


def run(step: Callable, done: Callable, state, inputs, steps_max: int,
        k: int, graph_key=None):
    """Runs ``state = step(state, inputs)`` for up to ``steps_max`` steps,
    reading ``done(state, inputs)`` (a bool tensor) on the host after steps
    k, 2k, ... and the last. With ``graph_key`` (cfg, decoder_step), on the
    card within ``on_loop_stream``: step 0 eagerly, the rest as replays of
    captured graphs. Returns (state, stats): steps, reads, replays,
    captures and capture_ms (the host's clock over this run's captures,
    their instantiation included), graph_capture_ms (over the captures of
    every graph this run replayed, whenever they were made)."""
    stats = dict(steps=0, reads=0, replays=0, captures=0, capture_ms=0.0,
                 graph_capture_ms=0.0, stop_every=k,
                 graphs=graph_key is not None)
    used = set()
    if steps_max <= 0:
        return state, stats
    state = step(state, inputs)
    i = 1
    search = None
    if graph_key is not None:
        search, pool = _search(graph_key, state, inputs)
        state, inputs = search.state, search.inputs
    while True:
        if i % k == 0 or i >= steps_max:
            stats["reads"] += 1
            if bool(done(state, inputs)):
                break
            if i >= steps_max:
                raise RuntimeError(f"lanes still decoding after the last "
                                   f"frame's step {steps_max - 1}")
        n = min(k - i % k, steps_max - i)
        if search is None:
            for _ in range(n):
                state = step(state, inputs)
        else:
            if n not in search.graphs:
                search.graphs[n] = _capture(search, pool, step, n, stats)
            graph, delta, ms = search.graphs[n]
            graph.replay()
            stats["replays"] += 1
            if n not in used:
                used.add(n)
                stats["graph_capture_ms"] += ms
            for (fn, attr), d in delta.items():
                setattr(fn, attr, getattr(fn, attr) + d)
        i += n
    stats["steps"] = i
    return state, stats
