"""Time and trace the full-width serving path on one CUDA card.

    python -m avsr_tpu_torch.tools.profile_serving [--table PATH]

Builds the serving configuration of ``chip_smoke.py`` phase 4: the flagship
model (24x1024 encoder, 6x1024 decoder, vocab 5049) with seeded random
weights, bf16 encode, bf16 decoder weights and K|V cache, beam 3, a
192-token K|V cap, the joint CTC/attention beam at the default
``ctc_weight=0.1`` and the delta2 video wire, on a batch of 8 synthetic
15 s utterances (375 frames). Then, per batch, each in ``REPEATS``
untraced runs on the device-synchronised host clock:

- host batching: the numpy wire encode alone, and all of ``_pad_batch``
  (padding, wire encode, upload);
- greedy CTC on the device, and ``transcribe_batch`` in greedy mode;
- encode; the beam with its bookkeeping unfused (the default) and fused
  (``fused_bookkeeping``, one ``beam_update`` launch a step), each in its
  device loop (the default: the stop flag read every k steps, the steps
  between replayed as one CUDA graph, captured in the warm-up) and the
  unfused one in the host loop too (``device_loop=False``: a read and
  ~370 launches from the host every step); and ``transcribe_batch`` in
  beam mode, unfused;

and one encode and one beam of each kind under ``torch.profiler``: device
busy time (the union of the CUDA op intervals, the replayed graphs'
kernels included), op count, and the idle share of the traced window and
of the median untraced run. The profiler slows the host, so wall times
come from the untraced runs. ``loop``: the device loop's steps, host
reads, replays and the capture ms of its graphs (``beam_search_batched.
last_run``). The per-kernel table (``key_averages``, by device time) is
written to ``--table``.

With ``--fused-layer`` the decoder runs ``decode_fused_layer`` (one
``decoder_layer_step`` launch a layer and step).

With ``--muavic`` it profiles ``chip_smoke.py`` phase 11's batch instead:
``AV2TextConfig()`` (12x256 encoder, 6x256 decoder, vocab 10,000) with
seed-0 weights through ``S2TGenerator`` at the eval CLI's defaults (fp32,
beam 3, the eager beam) on 32 random 15 s utterances: the encode and the
beam (device loop; and the host loop, untraced) untraced, then one of each
under ``torch.profiler`` as above.

Prints the card's nvidia-smi name and power limit, then one JSON object
as the last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from avsr_tpu_torch.tools import trace

BATCH = 8
MUAVIC_BATCH = 32
FRAMES = 375
REPEATS = 3
KV_CAP = 192


def _timed(fn, repeats: int):
    """(last result, host-clock ms of each run), device-synchronised."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, times


def _trace(res: dict, runs, smi: str) -> list:
    """Each of ``runs`` ((name, fn), its untraced times in ``res[name +
    "_ms"]``) once under the profiler: traced wall, device busy time, op
    count and idle shares into ``res``; returns the per-kernel tables."""
    tables = []
    for name, fn in runs:
        _, wall, summary, prof = trace.profiled(fn)
        busy, count = summary.busy_ms, summary.events
        res[f"{name}_traced_wall_ms"] = wall
        res[f"{name}_device_busy_ms"] = busy
        res[f"{name}_device_ops"] = count
        res[f"{name}_idle_share_traced"] = 1 - busy / wall
        res[f"{name}_idle_share_untraced"] = (
            1 - busy / statistics.median(res[f"{name}_ms"]))
        tables.append(f"==== {name}: traced wall {wall:.3f} ms, device busy "
                      f"{busy:.3f} ms, {count} device ops ({smi})\n"
                      + prof.key_averages().table(
                          sort_by="self_device_time_total", row_limit=60))
    return tables


def _muavic(dev, smi: str) -> tuple:
    """(results, profiler tables) of phase 11's B=32 batch."""
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode.beam import beam_search_batched
    from avsr_tpu_torch.decode.s2t_generate import S2TGenerator
    from avsr_tpu_torch.models.av2text import AV2TextConfig, AV2TextModel

    with torch.device(dev):
        model = AV2TextModel(AV2TextConfig())
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    gen = S2TGenerator(model, beam_size=3, device=str(dev))
    rng = np.random.RandomState(0)
    aud = torch.from_numpy(rng.randn(MUAVIC_BATCH, FRAMES, 104).astype(
        np.float32)).to(dev)
    vid = torch.from_numpy(rng.randn(MUAVIC_BATCH, FRAMES, 88, 88, 1).astype(
        np.float32)).to(dev)
    lens = np.full((MUAVIC_BATCH,), FRAMES)
    res = {"card": smi, "model": "muavic_en AV2TextConfig()",
           "batch": MUAVIC_BATCH, "frames": FRAMES}
    feats = gen.encode(aud, vid, lens)
    gen.beam(feats, lens)  # warm-up: the kernels, the loop's graphs
    torch.cuda.reset_peak_memory_stats()
    feats, res["encode_ms"] = _timed(lambda: gen.encode(aud, vid, lens),
                                     REPEATS)

    def beam(device_loop: bool = True):
        gen.device_loop = device_loop
        return gen.beam(feats, lens)

    _, res["beam_ms"] = _timed(beam, REPEATS)
    res["loop"] = dict(beam_search_batched.last_run)
    _, res["beam_host_loop_ms"] = _timed(lambda: beam(False), REPEATS)
    steps = res["loop"]["steps"]
    res["beam_steps"] = steps
    tables = _trace(res, (("encode", lambda: gen.encode(aud, vid, lens)),
                          ("beam", beam)), smi)
    res["beam_device_busy_ms_a_step"] = res["beam_device_busy_ms"] / steps
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res, tables


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--table", default=None,
                    help="file for the profiler's per-kernel tables")
    ap.add_argument("--fused-layer", action="store_true",
                    help="decode_fused_layer: one decoder_layer_step a "
                         "layer and step")
    ap.add_argument("--muavic", action="store_true",
                    help="profile the muavic_en generator's B=32 batch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: torch sees no CUDA device")
    smi = trace.card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    if args.muavic:
        res, tables = _muavic(dev, smi)
    else:
        res, tables = _flagship(dev, smi, args.fused_layer)
    if args.table:
        with open(args.table, "w") as f:
            f.write("\n\n".join(tables) + "\n")
    print(smi)
    print(json.dumps(res))


def flagship_recognizer(dev, fused_layer: bool = False,
                        frames: int = FRAMES,
                        encode_dtype: str = "bfloat16",
                        fused_bookkeeping: bool = False):
    """The serving ``Recognizer`` of ``chip_smoke.py`` phase 4: the
    flagship model with seed-0 weights, bf16 decoder weights and K|V
    cache, fused decode attention, flash attention in the encoder, one
    frame bucket of ``frames`` + 2, the 192-token cap and the delta2 wire;
    ``decode_fused_layer`` with ``fused_layer``."""
    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.core.weights import init_weights
    from avsr_tpu_torch.decode.recognizer import Recognizer
    from avsr_tpu_torch.models.e2e import AVSRModel

    cfg = AVHubertAVSRConfig(decoder_cache_dtype="bfloat16",
                             decoder_param_dtype="bfloat16",
                             decode_fused_attention=True)
    cfg.encoder.use_flash_attention = True
    cfg.decode_fused_layer = fused_layer
    with torch.device(dev):
        model = AVSRModel(cfg)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    return Recognizer(model=model, cfg=cfg, device=dev,
                      t_buckets=(frames + 2,), max_decode_tokens=KV_CAP,
                      encode_dtype=encode_dtype, video_wire="delta2",
                      fused_bookkeeping=fused_bookkeeping)


def _flagship(dev, smi: str, fused_layer: bool) -> tuple:
    """(results, profiler tables) of phase 4's serving batch."""
    from avsr_tpu_torch.data import wire
    from avsr_tpu_torch.data.synthetic import synthetic_batch
    from avsr_tpu_torch.decode.beam import beam_search_batched, greedy_ctc

    rec = flagship_recognizer(dev, fused_layer)
    audio, video = synthetic_batch(np.random.RandomState(0), [FRAMES] * BATCH)
    rec.transcribe_batch(audio, video, mode="beam")  # warm-up
    rec.transcribe_batch(audio, video, mode="greedy")

    res = {"card": smi, "batch": BATCH, "frames": FRAMES,
           "fused_layer": fused_layer}
    n = REPEATS
    padded = np.zeros((BATCH, FRAMES + 2, 88, 88, 1), np.uint8)
    for i, v in enumerate(video):
        padded[i, : len(v)] = v
    _, res["wire_encode_ms"] = _timed(
        lambda: wire.delta2_encode_video(padded), n)
    (aud, vid, lens, _), res["pad_batch_ms"] = _timed(
        lambda: rec._pad_batch(audio, video), n)
    (feats, ctc), res["encode_ms"] = _timed(
        lambda: rec.encode(aud, vid, lens), n)
    _, res["greedy_ctc_ms"] = _timed(lambda: greedy_ctc(ctc, lens), n)
    _, res["transcribe_greedy_ms"] = _timed(
        lambda: rec.transcribe_batch(audio, video, mode="greedy"), n)

    def beam(fused: bool, device_loop: bool = True):
        rec.fused_bookkeeping, rec.device_loop = fused, device_loop
        return rec.beam(feats, ctc, lens)

    beam(True)  # warm-up: the fused bookkeeping's graphs
    _, res["beam_ms"] = _timed(lambda: beam(False), n)
    res["loop"] = dict(beam_search_batched.last_run)
    _, res["beam_fused_ms"] = _timed(lambda: beam(True), n)
    res["loop_fused"] = dict(beam_search_batched.last_run)
    _, res["beam_host_loop_ms"] = _timed(lambda: beam(False, False), n)
    res["beam_steps"] = res["loop"]["steps"]
    rec.fused_bookkeeping, rec.device_loop = False, True
    _, res["transcribe_beam_ms"] = _timed(
        lambda: rec.transcribe_batch(audio, video, mode="beam"), n)

    torch.cuda.reset_peak_memory_stats()
    tables = _trace(res, (("encode", lambda: rec.encode(aud, vid, lens)),
                          ("beam", lambda: beam(False)),
                          ("beam_fused", lambda: beam(True))), smi)
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res, tables


if __name__ == "__main__":
    main()
