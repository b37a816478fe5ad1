"""Device time of a ``torch.profiler`` trace, by op and by source.

Counterpart of ``tools/profile_train.py`` ``parse_trace`` (the JAX
package's device-lane parser) over the Chrome trace that
``torch.profiler`` exports:

- keeps the device's kernel, copy and set events only (``cat`` in
  ``DEVICE_CATS``), the kernels of replayed CUDA graphs included; host
  lanes and the profiler's annotation spans are left out;
- charges each event its self time on its lane (device, stream), by the
  JAX parser's rule: events sorted by (start, -duration), an event that
  starts before the open one on its lane ends is its child, and the
  parent is charged its duration less its children's, at least 0;
- gives the busy time: the union of the device events' intervals over
  every lane;
- groups the self time by the port's module that launched each op (the
  counterpart of JAX's "by source"): the launch is the host's runtime
  call with the event's correlation id, and its module is the innermost
  ``avsr_tpu_torch/`` Python frame open on that host thread at the call
  (``with_stack=True`` records them). A launch of the autograd engine's
  backward, with no such frame, takes the module of the forward op with
  the same sequence number (the last to start, the one that made the
  autograd node), as ``<module> backward``. Anything else is ``other``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's hand-written kernels, the __global__ functions of csrc/*.cu,
# by the wrapper that launches them; csrc declares them in a file-level
# anonymous namespace, so a kernel's demangled name starts with
# "(anonymous namespace)::<name>", where a library kernel of the same bare
# name sits in a named namespace ("at::native::(anonymous namespace)::...")
KERNELS = {
    "flash_fwd_mma": "flash_attention_fwd",
    "flash_fwd_tf32": "flash_attention_fwd",
    "flash_bwd_dq_mma": "flash_attention_bwd_dq",
    "flash_bwd_dq_tf32": "flash_attention_bwd_dq",
    "flash_bwd_dkv_mma": "flash_attention_bwd_dkv",
    "flash_bwd_dkv_tf32": "flash_attention_bwd_dkv",
    "decode_attention_kernel": "decode_attention",
    "decoder_layer_kernel": "decoder_layer_step",
    "beam_update_kernel": "beam_update",
    "beam_update_wide_kernel": "beam_update",
    "row_gather_kernel": "row_gather",
    "cumlogsumexp_kernel": "cumlogsumexp",
    "topk_row_kernel": "topk_lastdim",
    "topk_warp_kernel": "topk_lastdim",
    "topk_wide_kernel": "topk_lastdim",
    "stats_kernel": "bn_prelu_pool_stats",
    "apply_kernel": "bn_prelu_pool_apply",
    "bwd1_kernel": "bn_prelu_pool_bwd1",
    "bwd2_kernel": "bn_prelu_pool_bwd2",
    "ctc_forward_kernel": "ctc_loss_fwd",
    "ctc_grad_kernel": "ctc_loss_bwd",
}
_KERNEL_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::("
                          + "|".join(KERNELS) + r")[<(]")
PORT = "avsr_tpu_torch/"
BACKWARD = "autograd::engine::evaluate_function: "
OTHER = "other"


class Summary(NamedTuple):
    """Device time of a trace in ms: ``ops`` name -> [self ms, count],
    ``kernels`` the port kernels' wrapper -> [self ms, count], ``sources``
    module -> self ms, ``op_sources`` op name -> the module that launched
    most of its time, ``total_ms`` the sum of self times, ``busy_ms`` the
    union of the device intervals, ``events`` the device events and
    ``lanes`` their (device, stream) lanes."""
    ops: Dict[str, list]
    kernels: Dict[str, list]
    sources: Dict[str, float]
    op_sources: Dict[str, str]
    total_ms: float
    busy_ms: float
    events: int
    lanes: int

    def top(self, n: int) -> list:
        """The n ops with the most self time: (name, ms, count)."""
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:n]
        return [(name, ms, count) for name, (ms, count) in rows]


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def events_of(prof) -> List[dict]:
    """The Chrome trace events of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="avsr_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def profiled(fn, steps: int = 1, with_stack: bool = False):
    """``fn()`` run ``steps`` times under ``torch.profiler`` (CPU and CUDA
    activities), the device synchronised before and after: (the last
    result, the traced wall ms a step on the host clock, the ``Summary``
    a step, the profiler)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=with_stack) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    return out, wall, summarize(events_of(prof), steps), prof


def device_events(events: Iterable[dict]) -> List[dict]:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def self_times(events: List[dict]) -> List[float]:
    """Each event's self time (the trace's unit), lane by lane, by the JAX
    parser's nesting rule; in the order of ``events``."""
    lanes = collections.defaultdict(list)
    for i, e in enumerate(events):
        lanes[(e.get("pid"), e.get("tid"))].append(i)
    out = [0.0] * len(events)
    for idx in lanes.values():
        idx.sort(key=lambda i: (events[i]["ts"], -events[i].get("dur", 0)))
        ends: list = []  # open events' end times, innermost last
        opened: list = []  # their indices
        children = {}
        for i in idx:
            ts, dur = events[i]["ts"], events[i].get("dur", 0)
            while ends and ts >= ends[-1] - 1e-9:
                ends.pop()
                opened.pop()
            if opened:
                children[opened[-1]] = children.get(opened[-1], 0.0) + dur
            ends.append(ts + dur)
            opened.append(i)
        for i in idx:
            out[i] = max(0.0, events[i].get("dur", 0) - children.get(i, 0.0))
    return out


def busy(events: List[dict]) -> float:
    """The union of the events' intervals (the trace's unit)."""
    total, start, end = 0.0, None, None
    for ts, te in sorted((e["ts"], e["ts"] + e.get("dur", 0))
                         for e in events):
        if end is None or ts > end:
            if end is not None:
                total += end - start
            start, end = ts, te
        else:
            end = max(end, te)
    return total + (end - start if end is not None else 0.0)


def _innermost(spans: dict, queries: list) -> list:
    """For each query (lane, ts), the payload of the innermost span of
    ``spans[lane]`` ((start, end, payload) tuples, properly nested: one
    thread's call stack) open at ts, or None. One sweep a lane."""
    out = [None] * len(queries)
    by_lane = collections.defaultdict(list)
    for i, (lane, ts) in enumerate(queries):
        if lane in spans:
            by_lane[lane].append((ts, i))
    for lane, qs in by_lane.items():
        ss = sorted(spans[lane], key=lambda s: (s[0], -s[1]))
        stack: list = []
        j = 0
        for ts, i in sorted(qs):
            while j < len(ss) and ss[j][0] <= ts:
                while stack and stack[-1][1] <= ss[j][0]:
                    stack.pop()
                stack.append(ss[j])
                j += 1
            while stack and stack[-1][1] <= ts:
                stack.pop()
            out[i] = stack[-1][2] if stack else None
    return out


def _module(name: str) -> Optional[str]:
    """'avsr_tpu_torch/models/e2e.py(88): forward' -> 'models/e2e.py'."""
    at = name.find(PORT)
    if at < 0:
        return None
    return name[at + len(PORT):].split("(", 1)[0]


def _sources(events: List[dict], dev: List[dict]) -> List[str]:
    """The launching module of each device event (see the module doc)."""
    frames = collections.defaultdict(list)
    ops = collections.defaultdict(list)
    launches = {}
    forward = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, lane = e.get("cat"), (e.get("pid"), e.get("tid"))
        end = e["ts"] + e.get("dur", 0)
        if cat == "python_function":
            mod = _module(e.get("name", ""))
            if mod is not None:
                frames[lane].append((e["ts"], end, mod))
        elif cat == "cpu_op":
            args = e.get("args") or {}
            seq = args.get("Sequence number")
            if e.get("name", "").startswith(BACKWARD):
                ops[lane].append((e["ts"], end, seq))
            elif (seq is not None and seq >= 0
                  and not args.get("Fwd thread id")  # a backward op's is set
                  and (seq not in forward or e["ts"] > forward[seq][1])):
                # every op between two autograd nodes' creations records
                # the same number; the last of them creates the node
                forward[seq] = (lane, e["ts"])
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (lane, e["ts"])
    points = [launches.get((e.get("args") or {}).get("correlation"),
                           (None, None)) for e in dev]
    mods = _innermost(frames, points)
    # launches of the autograd engine with no port frame: the module of
    # the forward op of the same sequence number
    todo = [i for i, m in enumerate(mods) if m is None]
    seqs = _innermost(ops, [points[i] for i in todo])
    fwd = [(i, forward[q]) for i, q in zip(todo, seqs) if q in forward]
    for (i, _), m in zip(fwd, _innermost(frames, [p for _, p in fwd])):
        if m is not None:
            mods[i] = m + " backward"
    return [m or OTHER for m in mods]


def summarize(events: List[dict], steps: int = 1) -> Summary:
    """The device time of ``events`` (a Chrome trace's, in µs), in ms a
    step over ``steps`` steps; counts a step too."""
    dev = device_events(events)
    own = self_times(dev)
    ops = collections.defaultdict(lambda: [0.0, 0])
    kernels = collections.defaultdict(lambda: [0.0, 0])
    sources = collections.Counter()
    by_op = collections.defaultdict(collections.Counter)
    for e, us, src in zip(dev, own, _sources(events, dev)):
        by_op[e["name"]][src] += us
        rows = [ops[e["name"]]]
        port = _KERNEL_NAME.search(e["name"])
        if port:
            rows.append(kernels[KERNELS[port.group(1)]])
        for row in rows:
            row[0] += us / 1e3 / steps
            row[1] += 1
        sources[src] += us / 1e3 / steps
    for row in (*ops.values(), *kernels.values()):
        row[1] /= steps
    return Summary(
        ops=dict(ops), kernels=dict(kernels), sources=dict(sources),
        op_sources={k: c.most_common(1)[0][0] for k, c in by_op.items()},
        total_ms=sum(own) / 1e3 / steps, busy_ms=busy(dev) / 1e3 / steps,
        events=len(dev), lanes=len({(e.get("pid"), e.get("tid"))
                                    for e in dev}))


def report(summary: Summary, top: int, unit: str = "ms") -> str:
    """The table of the sources and of the ``top`` ops (self time, count,
    the module that launched most of it, name), one line each."""
    lines = ["by source:"]
    for src, ms in sorted(summary.sources.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {ms:10.3f} {unit}  {src}")
    lines.append(f"top {top} ops:")
    for name, ms, count in summary.top(top):
        lines.append(f"  {ms:10.3f} {unit}  x{count:<8g} "
                     f"[{summary.op_sources[name]}] {name[:140]}")
    return "\n".join(lines)
